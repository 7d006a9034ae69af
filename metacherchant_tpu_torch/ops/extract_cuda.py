"""CUDA kernel: rolling canonical k-mer extraction fused with the append.

Counterpart of metacherchant_tpu/ops/pallas_kmers.py::_extract_kernel (and of
the append in ops/sortcount.py::_append_kernel). The source and its notes on
design and limits are in csrc/extract_kmers.cu. It is compiled with nvcc for
sm_90a at its first use into the port's build directory and called through
ctypes on the current CUDA stream.

Two entry points share the kernel:

- extract_append: a dense (B, L) int8 batch (the classifier's);
- extract_append_ragged: rows of a flat int8 code array, each given by its
  start, length and output offset (exact counting's chunks, straight from
  the parser's layout).

On CPU tensors each runs its plain torch version (extract_append_plain,
extract_append_ragged_plain); on CUDA tensors it launches the kernel or
raises. Each launch of the kernel, and nothing else, adds 1 to the counter
extract.launches (trace.py), so that a run can show its main path went
through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from .. import trace
from ..native import BUILD_DIR
from .kmers import exact_canonical_kmers

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "extract_kmers.cu"
_LIB = BUILD_DIR / "libextract_kmers.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "extraction kernel cannot be built")


def build_library(source: Path, lib: Path) -> str:
    """Compile a .cu source of csrc/ into `lib` unless an up-to-date one
    exists.

    Returns nvcc's report (ptxas registers/spills per kernel), or '' when
    nothing was compiled. Raises when nvcc is missing or fails."""
    if lib.exists() and lib.stat().st_mtime >= source.stat().st_mtime:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, str(source), "-o", str(tmp)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{res.stderr}")
    os.replace(tmp, lib)
    return res.stdout + res.stderr


def build() -> str:
    """Compile the kernel library unless an up-to-date one exists
    (build_library)."""
    return build_library(SOURCE, _LIB)


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C entry points' parameters, in the order of csrc/extract_kmers.cu
ARGTYPES = {
    "mc_extract_append": [_PTR, _PTR, _I32, _I32, _I32, _PTR],
    "mc_extract_append_ragged": [_PTR, _I64, _PTR, _PTR, _PTR, _I32, _I32,
                                 _PTR, _I64, _PTR, _PTR],
}


#: threads that launch the kernel first (the classifier's pool) wait for
#: one build: two builds of one process share a temporary file
_library_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    with _library_lock:
        return _load_library()


@functools.cache
def _load_library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(_LIB))
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def _check_k(k: int) -> None:
    if not 1 <= k <= 31:
        raise ValueError(f"exact keys need 1 <= k <= 31; got {k}")


def _check_out(out: torch.Tensor, n: int) -> None:
    if out.dim() != 1 or out.dtype != torch.int64:
        raise ValueError("out must be a 1-D int64 tensor")
    if out.numel() != n:
        raise ValueError(f"out holds {out.numel()} keys; the rows give {n}")


def _check(codes: torch.Tensor, k: int, out: torch.Tensor) -> None:
    _check_k(k)
    if codes.dim() != 2 or codes.dtype != torch.int8:
        raise ValueError(f"codes must be a 2-D int8 tensor; got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    rows, length = codes.shape
    if length < k:
        raise ValueError(f"rows of {length} codes hold no {k}-mer")
    if rows * length >= 1 << 31:
        raise ValueError(f"batch of {rows}x{length} codes is too large")
    _check_out(out, rows * (length - k + 1))
    if out.device != codes.device:
        raise ValueError(f"codes on {codes.device}, out on {out.device}")
    if not (codes.is_contiguous() and out.is_contiguous()):
        raise ValueError("codes and out must be contiguous")


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def extract_append_plain(codes: torch.Tensor, k: int,
                         out: torch.Tensor) -> None:
    """Plain torch version of the kernel: keys of columns k-1.. of every row,
    row-major, into `out`."""
    keys, _ = exact_canonical_kmers(codes, k)
    out.copy_(keys[:, k - 1:].reshape(-1))


def extract_append(codes: torch.Tensor, k: int, out: torch.Tensor) -> None:
    """Write the canonical keys of a (B, L) int8 code batch, without its
    first k-1 columns, flat into `out` (B*(L-k+1) int64 lanes).

    CPU tensors take the plain version; CUDA tensors the kernel."""
    _check(codes, k, out)
    if codes.device.type == "cpu":
        extract_append_plain(codes, k, out)
        return
    if codes.device.type != "cuda":
        raise ValueError(f"no extraction kernel for device {codes.device}")
    if out.numel() == 0:
        return
    lib = _library()
    rows, length = codes.shape
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mc_extract_append(codes.data_ptr(), out.data_ptr(), rows,
                                    length, k, stream)
    _raise_on(err, "extract_append")
    trace.count("extract.launches")


def row_offsets(lens: np.ndarray, k: int) -> np.ndarray:
    """The output offsets of ragged rows: the running sum of their window
    counts len - k + 1, from 0 (int64)."""
    n = np.asarray(lens, np.int64) - (k - 1)
    return np.cumsum(n) - n


def _check_ragged(codes: torch.Tensor, starts: torch.Tensor,
                  lens: torch.Tensor, offs: torch.Tensor, k: int,
                  out: torch.Tensor) -> None:
    """Shapes, types and devices of the ragged entry's arguments (the
    tables' values are checked by _table_faults, or by the kernel)."""
    _check_k(k)
    for name, t, dtype in (("codes", codes, torch.int8),
                           ("starts", starts, torch.int64),
                           ("lens", lens, torch.int32),
                           ("offs", offs, torch.int64),
                           ("out", out, torch.int64)):
        if t.dim() != 1 or t.dtype != dtype:
            raise ValueError(f"{name} must be a 1-D {dtype} tensor; got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != codes.device:
            raise ValueError(f"codes on {codes.device}, {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    rows = starts.numel()
    if lens.numel() != rows or offs.numel() != rows:
        raise ValueError(f"{rows} starts, {lens.numel()} lens, "
                         f"{offs.numel()} offs")
    if rows >= 1 << 31:
        raise ValueError(f"{rows} rows are too many for one launch")
    if rows == 0:
        _check_out(out, 0)


#: the tables' faults, as bits (the kernel reports the same ones)
_FAULTS = {1: "a row is shorter than k",
           2: "a row reaches outside the codes",
           4: "offs are not the running sum of lens - k + 1 from 0",
           8: "out does not hold exactly the rows' windows"}


def _table_faults(codes: torch.Tensor, starts: torch.Tensor,
                  lens: torch.Tensor, offs: torch.Tensor, k: int,
                  out: torch.Tensor) -> int:
    """The tables' faults in _FAULTS bits, computed with torch."""
    n_keys = lens.to(torch.int64) - (k - 1)
    ends = torch.cumsum(n_keys, 0)
    return (1 * bool((lens < k).any())
            | 2 * bool(((starts < 0)
                        | (starts + lens > codes.numel())).any())
            | 4 * bool((offs != ends - n_keys).any())
            | 8 * (int(ends[-1]) != out.numel()))


def _raise_faults(faults: int, k: int) -> None:
    if faults:
        raise ValueError(f"bad ragged rows for k={k}: " + "; ".join(
            msg for bit, msg in _FAULTS.items() if faults & bit))


def extract_append_ragged_plain(codes: torch.Tensor, starts: torch.Tensor,
                                lens: torch.Tensor, offs: torch.Tensor,
                                k: int, out: torch.Tensor) -> None:
    """Plain torch version of the ragged kernel: gather every row into a
    -1 padded (rows, max len) matrix, take its keys from
    exact_canonical_kmers and keep columns k-1 .. len-1 of each row, in
    order (offs is their running sum, so that order is out's)."""
    if starts.numel() == 0:
        return
    lens64 = lens.to(torch.int64)
    width = int(lens64.max())
    col = torch.arange(width, device=codes.device)
    inside = col[None, :] < lens64[:, None]
    src = (starts[:, None] + col[None, :]).clamp_(max=codes.numel() - 1)
    padded = torch.where(inside, codes[src], torch.full_like(src, -1,
                                                             dtype=torch.int8))
    keys, _ = exact_canonical_kmers(padded, k)
    out.copy_(keys[inside & (col[None, :] >= k - 1)])


def _launch_ragged(codes: torch.Tensor, starts: torch.Tensor,
                   lens: torch.Tensor, offs: torch.Tensor, k: int,
                   out: torch.Tensor, faults: torch.Tensor) -> None:
    """The ragged kernel on CUDA tensors; it ORs the tables' faults into
    `faults` (one int32, zeroed by the caller) and then writes nothing from
    the tiles that hold them."""
    lib = _library()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mc_extract_append_ragged(
            codes.data_ptr(), codes.numel(), starts.data_ptr(),
            lens.data_ptr(), offs.data_ptr(), starts.numel(), k,
            out.data_ptr(), out.numel(), faults.data_ptr(), stream)
    _raise_on(err, "extract_append_ragged")
    trace.count("extract.launches")


def extract_append_ragged(codes: torch.Tensor, starts: torch.Tensor,
                          lens: torch.Tensor, offs: torch.Tensor, k: int,
                          out: torch.Tensor) -> None:
    """Write the canonical keys of every k-window of ragged rows into
    `out`: row r is codes[starts[r]:starts[r] + lens[r]] (lens[r] >= k) and
    its lens[r] - k + 1 keys go to out[offs[r]:], offs the running sum
    (row_offsets). codes int8, starts and offs int64, lens int32, out
    int64, all 1-D on one device. Raises ValueError on bad tables.

    CPU tensors take the plain version; CUDA tensors the kernel, which
    checks the tables as it reads them (one int32 read back per call)."""
    _check_ragged(codes, starts, lens, offs, k, out)
    if starts.numel() == 0:
        return
    if codes.device.type == "cpu":
        _raise_faults(_table_faults(codes, starts, lens, offs, k, out), k)
        extract_append_ragged_plain(codes, starts, lens, offs, k, out)
        return
    if codes.device.type != "cuda":
        raise ValueError(f"no extraction kernel for device {codes.device}")
    faults = torch.zeros(1, dtype=torch.int32, device=codes.device)
    _launch_ragged(codes, starts, lens, offs, k, out, faults)
    _raise_faults(int(faults), k)
