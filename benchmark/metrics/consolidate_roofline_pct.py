"""consolidate_roofline_pct: the sort engine's consolidations
(ops/sortcount.StreamCounter._consolidate, by whichever route) against the
bytes a merge of the buffer into the store needs at the published HBM
bandwidth: the store's keys and counts and the buffer's filled lanes read
once, the new store written once (peaks.py). Time is the device's, between
CUDA events recorded around each call."""
from benchmark import peaks
from benchmark.tracing import Wrap


def _before(args, kwargs):
    sc = args[0]
    return {"store_in": sc.store_keys.numel(), "lanes": sc.offset}


def _after(info, args, kwargs, result):
    info["store_out"] = args[0].store_keys.numel()


WRAPS = (Wrap("metacherchant_tpu_torch.ops.sortcount",
              "StreamCounter._consolidate", "consolidate",
              before=_before, after=_after, cuda_events=True),)


def read(trace):
    calls = [s for s in trace.spans("consolidate")
             if s.info.get("lanes") and "store_out" in s.info
             and s.device_s]
    if not calls:
        return None
    nbytes = sum(peaks.consolidate_bytes(s.info["store_in"], s.info["lanes"],
                                         s.info["store_out"]) for s in calls)
    return 100.0 * peaks.bound_s(nbytes) / sum(s.device_s for s in calls)
