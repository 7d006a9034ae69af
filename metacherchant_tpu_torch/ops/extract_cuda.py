"""CUDA kernel: rolling canonical k-mer extraction fused with the append.

Counterpart of metacherchant_tpu/ops/pallas_kmers.py::_extract_kernel (and of
the append in ops/sortcount.py::_append_kernel). The source and its notes on
design and limits are in csrc/extract_kmers.cu. It is compiled with nvcc for
sm_90a at its first use into the port's build directory and called through
ctypes on the current CUDA stream.

extract_append is the one entry point. On a CPU tensor it runs the plain
torch version beside it (extract_append_plain); on a CUDA tensor it launches
the kernel or raises. LAUNCHES counts the kernel's launches, so that a run can
show its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..native import BUILD_DIR
from .kmers import exact_canonical_kmers

#: kernel launches since the process started (or since a caller reset it)
LAUNCHES = 0

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


def build() -> str:
    """Compile the kernel library unless an up-to-date one exists.

    Returns nvcc's report (ptxas registers/spills per kernel), or '' when
    nothing was compiled. Raises when nvcc is missing or fails."""
    if _LIB.exists() and _LIB.stat().st_mtime >= SOURCE.stat().st_mtime:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f"{_LIB.name}.tmp{os.getpid()}")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, str(SOURCE), "-o", str(tmp)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{res.stderr}")
    os.replace(tmp, _LIB)
    return res.stdout + res.stderr


@functools.cache
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(_LIB))
    lib.mc_extract_append.restype = ctypes.c_int
    lib.mc_extract_append.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    return lib


def _check(codes: torch.Tensor, k: int, out: torch.Tensor) -> None:
    if not 1 <= k <= 31:
        raise ValueError(f"exact keys need 1 <= k <= 31; got {k}")
    if codes.dim() != 2 or codes.dtype != torch.int8:
        raise ValueError(f"codes must be a 2-D int8 tensor; got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    rows, length = codes.shape
    if length < k:
        raise ValueError(f"rows of {length} codes hold no {k}-mer")
    if rows * length >= 1 << 31:
        raise ValueError(f"batch of {rows}x{length} codes is too large")
    if out.dim() != 1 or out.dtype != torch.int64:
        raise ValueError("out must be a 1-D int64 tensor")
    if out.numel() != rows * (length - k + 1):
        raise ValueError(f"out holds {out.numel()} keys; the batch gives "
                         f"{rows * (length - k + 1)}")
    if out.device != codes.device:
        raise ValueError(f"codes on {codes.device}, out on {out.device}")
    if not (codes.is_contiguous() and out.is_contiguous()):
        raise ValueError("codes and out must be contiguous")


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
    global LAUNCHES
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
    if err != 0:
        raise RuntimeError(f"extract_append kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
