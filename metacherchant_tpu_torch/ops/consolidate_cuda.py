"""CUDA kernel: the sort engine's merge route, the sorted buffer merged into
the compact store with the reduce by key.

Replaces no Pallas kernel: on the card it takes the place of the JAX
package's plain merge-split route (metacherchant_tpu/ops/sortcount.py
::_consolidate_merge_split), some 52 eager passes over every lane of the
power-of-two total. Its bound is peaks.consolidate_bytes (the store read
once, the buffer's filled lanes read once, the new store written once) over
3.35 TB/s; the design that nears it (a merge-path partition into tiles, a
counting pass, a scan of the tiles and a writing pass) is noted in
csrc/consolidate.cu. It is compiled with nvcc for sm_90a at its first use
into the port's build directory and called through ctypes on the current
CUDA stream.

merge_into_store takes the plain version on CPU tensors: the JAX route as
it is, on the store padded to store_cap lanes, cut to its distinct keys
(merge_into_store_plain). On CUDA tensors it sorts the buffer's filled
lanes with torch.sort and launches the kernel, or raises. Each launch adds
1 to the counter consolidate.launches (trace.py), so that a run can show
its merge-route consolidations went through the kernel.
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

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "consolidate.cu"
_LIB = BUILD_DIR / "libconsolidate.so"


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


def merge_into_store_plain(store_keys: torch.Tensor, store_cnts: torch.Tensor,
                           buf: torch.Tensor, offset: int, store_cap: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: the JAX package's merge-split route
    (sortcount._consolidate_merge_split) on the store as the JAX engine
    holds it, store_cap lanes with SENTINEL behind, cut to its distinct
    keys."""
    # sortcount imports this module
    from .sortcount import _consolidate_merge_split, _pad_store
    keys, cnts, nd = _consolidate_merge_split(
        *_pad_store(store_keys, store_cnts, store_cap), buf, offset)
    nd = int(nd)
    return keys[:nd].clone(), cnts[:nd].clone()


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
    """The merge route: merge buf[:offset] (SENTINEL lanes weigh 0) into the
    compact store (distinct keys ascending, int32 counts; at most store_cap
    of them) and return the new compact store, counts clamped at 1e9.

    CPU tensors take the plain version; CUDA tensors torch.sort of the
    filled lanes and the kernel. A caller that passes its only reference to
    `buf` has it freed once its lanes are sorted."""
    _check(store_keys, store_cnts, buf, offset, store_cap)
    if buf.device.type == "cpu":
        return merge_into_store_plain(store_keys, store_cnts, buf, offset,
                                      store_cap)
    if buf.device.type != "cuda":
        raise ValueError(f"no consolidation kernel for device {buf.device}")
    run = torch.sort(buf[:offset]).values
    del buf
    return _merge_sorted_run(store_keys, store_cnts, run)
