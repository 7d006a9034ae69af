"""extract_roofline_pct: kernel B1 (csrc/extract_kmers.cu through
ops/extract_cuda) against the bytes its launches need at the published HBM
bandwidth. Bytes per launch from the launch's shapes (peaks.py, the
arithmetic of chip_smoke.py's kernel phase), device time from the profiler's
extract_kernel events of the window. Where the profiler missed launches, the
mean launch's bytes stand for each launch it saw."""
from benchmark import peaks
from benchmark.tracing import Wrap

KERNEL = "extract_kernel"


def _ragged(args, kwargs):
    codes, starts, _lens, _offs, _k, out = args
    return {"bytes": peaks.ragged_launch_bytes(
        codes.numel(), starts.numel(), out.numel())}


def _dense(args, kwargs):
    codes, _k, out = args
    return {"bytes": peaks.dense_launch_bytes(codes.numel(), out.numel())}


WRAPS = (Wrap("metacherchant_tpu_torch.ops.sortcount",
              "extract_append_ragged", "extract_launch", before=_ragged),
         Wrap("metacherchant_tpu_torch.ops.sortcount",
              "extract_append", "extract_launch", before=_dense))


def read(trace):
    launches = [s.info["bytes"] for s in trace.spans("extract_launch")
                if "bytes" in s.info]
    kernels = trace.kernels(KERNEL)
    if not launches or not kernels:
        return None
    seconds = sum(b - a for _, a, b in kernels)
    nbytes = sum(launches) / len(launches) * len(kernels)
    return 100.0 * peaks.bound_s(nbytes) / seconds
