"""Merge a buffer of appended keys into the sort engine's compact store:
the CUDA merge kernel on the card, the plain sort-and-reduce on the CPU.

The kernel replaces no Pallas kernel: on the card it takes the place of the
JAX package's consolidation routes (the sort2 and merge-split routes of
metacherchant_tpu/ops/sortcount.py), full-length passes over every lane of
the padded total. Its bound is peaks.consolidate_bytes (the store read
once, the buffer's filled lanes read once, the new store written once)
over 3.35 TB/s; the design that nears it (a merge-path partition into
tiles, a counting pass, a scan of the tiles and a writing pass) is noted in
csrc/consolidate.cu. It is compiled with nvcc for sm_90a at its first use
into the port's build directory and called through ctypes on the current
CUDA stream.

merge_into_store takes the plain version, consolidate, on CPU tensors. On
CUDA tensors it sorts the buffer's filled lanes with torch.sort and
launches the kernel; on any other device it raises. Each launch adds 1 to
the counter consolidate.launches (trace.py), so that a run can show its
consolidations went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch

from .. import trace
from ..native import BUILD_DIR
from .extract_cuda import build_library
from .kmers import SENTINEL

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "consolidate.cu"
_LIB = BUILD_DIR / "libconsolidate.so"
#: store counts clamp far above the 32767 output saturation, so repeated
#: consolidations cannot overflow int32 yet keep min(total, 32767)
_COUNT_CLAMP = 1_000_000_000


def build() -> str:
    """Compile the kernel library unless an up-to-date one exists
    (extract_cuda.build_library)."""
    return build_library(SOURCE, _LIB)


_PTR, _I64 = ctypes.c_void_p, ctypes.c_longlong
#: the C entry points' parameters, in the order of csrc/consolidate.cu
ARGTYPES = {
    "mc_consolidate_tile_lanes": [],
    "mc_consolidate_count": [_PTR, _PTR, _I64, _PTR, _I64, _I64, _PTR, _PTR,
                             _PTR, _PTR],
    "mc_consolidate_write": [_PTR, _PTR, _I64, _PTR, _I64, _I64, _PTR, _PTR,
                             _PTR, _PTR, _PTR, _PTR, _I64, _PTR],
}

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


def load() -> None:
    """Build (once per checkout) and load the kernel library now, so that
    no consolidation pays for nvcc."""
    _library()


def _check(store_keys: torch.Tensor, store_cnts: torch.Tensor,
           buf: torch.Tensor, offset: int, store_cap: int) -> None:
    for name, t, dtype in (("store_keys", store_keys, torch.int64),
                           ("store_cnts", store_cnts, torch.int32),
                           ("buf", buf, torch.int64)):
        if t.dim() != 1 or t.dtype != dtype:
            raise ValueError(f"{name} must be a 1-D {dtype} tensor; got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != buf.device:
            raise ValueError(f"buf on {buf.device}, {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if store_cnts.numel() != store_keys.numel():
        raise ValueError(f"{store_keys.numel()} store keys, "
                         f"{store_cnts.numel()} counts")
    if store_keys.numel() > store_cap:
        raise ValueError(f"{store_keys.numel()} store keys exceed store_cap "
                         f"{store_cap}")
    if not 0 < offset <= buf.numel():
        raise ValueError(f"offset {offset} outside the {buf.numel()}-lane "
                         f"buffer")


def consolidate(store_keys: torch.Tensor, store_cnts: torch.Tensor,
                new_keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: merge appended keys (SENTINEL lanes allowed)
    into a sorted store by one sort of both.

    Weights: store counts, 1 per appended lane, 0 for SENTINEL. Returns the
    new store: distinct keys ascending and int32 counts clamped at 1e9."""
    keys = torch.cat([store_keys, new_keys])
    w = torch.cat([store_cnts.to(torch.int64),
                   torch.ones_like(new_keys)])
    w.masked_fill_(keys == SENTINEL, 0)
    s, order = torch.sort(keys)
    pc = torch.cumsum(w[order], 0)
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    last &= s != SENTINEL
    out_keys = s[last]
    pref = pc[last]
    cnts = torch.diff(pref, prepend=pref.new_zeros(1))
    return out_keys, cnts.clamp_max_(_COUNT_CLAMP).to(torch.int32)


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def _merge_sorted_run(store_keys: torch.Tensor, store_cnts: torch.Tensor,
                      run: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors: the compact store merged with an
    ascending run of raw keys. One readback, the distinct count."""
    lib = _library()
    dev = run.device
    na, nb = store_keys.numel(), run.numel()
    tile = lib.mc_consolidate_tile_lanes()
    n_tiles = -(-(na + nb) // tile)
    splits = torch.empty(n_tiles + 1, dtype=torch.int64, device=dev)
    # each tile's run-lasts (row 0) and weight (row 1)
    tiles = torch.empty((2, n_tiles), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mc_consolidate_count(
            store_keys.data_ptr(), store_cnts.data_ptr(), na, run.data_ptr(),
            nb, n_tiles, splits.data_ptr(), tiles[0].data_ptr(),
            tiles[1].data_ptr(), stream)
        _raise_on(err, "consolidate (count)")
        trace.count("consolidate.launches")
        incl = torch.cumsum(tiles, 1)
        nd = int(incl[0, -1])
        keys = torch.empty(nd, dtype=torch.int64, device=dev)
        cnts = torch.empty(nd, dtype=torch.int32, device=dev)
        if nd == 0:
            return keys, cnts
        pref = torch.empty(nd, dtype=torch.int64, device=dev)
        excl = incl.sub_(tiles)
        err = lib.mc_consolidate_write(
            store_keys.data_ptr(), store_cnts.data_ptr(), na, run.data_ptr(),
            nb, n_tiles, splits.data_ptr(), excl[0].data_ptr(),
            excl[1].data_ptr(), keys.data_ptr(), pref.data_ptr(),
            cnts.data_ptr(), nd, stream)
    _raise_on(err, "consolidate (write)")
    return keys, cnts


def merge_into_store(store_keys: torch.Tensor, store_cnts: torch.Tensor,
                     buf: torch.Tensor, offset: int, store_cap: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge buf[:offset] (SENTINEL lanes weigh 0) into the compact store
    (distinct keys ascending, int32 counts; at most store_cap of them) and
    return the new compact store, counts clamped at 1e9.

    CPU tensors take the plain version (consolidate); CUDA tensors
    torch.sort of the filled lanes and the kernel. A caller that passes its
    only reference to `buf` has it freed on the card once its lanes are
    sorted."""
    _check(store_keys, store_cnts, buf, offset, store_cap)
    if buf.device.type == "cpu":
        return consolidate(store_keys, store_cnts, buf[:offset])
    if buf.device.type != "cuda":
        raise ValueError(f"no consolidation kernel for device {buf.device}")
    run = torch.sort(buf[:offset]).values
    del buf
    return _merge_sorted_run(store_keys, store_cnts, run)
