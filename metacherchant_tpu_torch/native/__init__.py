"""Native (C++) host engines of the main path, loaded with ctypes.

- fastio: FASTA/FASTQ(.gz) parsing + 2-bit packing with the exact N-split
  semantics of the Python readers (io/readers.py), and the whole-read FASTQ
  parse of the classifier (no N-splitting);
- bfs: the FIFO environment BFS, exact and hashed regimes.

The sources are the port's own (csrc/fastio.cpp, byte-equal to the JAX
package's; csrc/bfs.cpp, whose count lookups search the map's sorted arrays
where the JAX package's build a table of the whole map on each call).
They are compiled by file path with g++ into the port's own build
directory, never next to the sources, and loaded with the same C ABI as
metacherchant_tpu/native/__init__.py. A missing compiler leaves the
Python readers and the Python FIFO BFS in charge, as in the JAX package.

MC_NATIVE_IO=0 / MC_NATIVE_BFS=0 turn either engine off; both are read on
every call.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .. import trace

_REPO = Path(__file__).resolve().parents[2]
SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
#: where the port writes every library it builds (listed in .gitignore)
BUILD_DIR = _REPO / "build" / "metacherchant_tpu_torch"

_lock = threading.Lock()


class NativeIOError(RuntimeError):
    pass


def _build(src: Path, name: str, extra: tuple[str, ...] = ()) -> Path | None:
    """Compile `src` into BUILD_DIR/name unless an up-to-date copy exists;
    None when the toolchain is missing or the compile fails."""
    lib = BUILD_DIR / name
    try:
        if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{name}.tmp{os.getpid()}")
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(src),
             "-o", str(tmp), *extra],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return lib
    except (OSError, subprocess.SubprocessError):
        return None


@functools.cache
def _load_fastio():
    path = _build(SRC_DIR / "fastio.cpp", "libfastio.so", ("-lz",))
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.fastio_parse.restype = ctypes.c_int
    lib.fastio_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int8)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.c_int]
    lib.fastio_parse_reads.restype = ctypes.c_int
    lib.fastio_parse_reads.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int8)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.c_int]
    lib.fastio_free.restype = None
    lib.fastio_free.argtypes = [ctypes.c_void_p]
    return lib


@functools.cache
def _load_bfs():
    path = _build(SRC_DIR / "bfs.cpp", "libbfs.so")
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mc_bfs_exact.restype = ctypes.c_int
    lib.mc_bfs_exact.argtypes = [
        i64p, i32p, ctypes.c_int64, i64p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(i64p), i64p, ctypes.POINTER(i64p), i64p]
    lib.mc_bfs_hashed.restype = ctypes.c_int
    lib.mc_bfs_hashed.argtypes = [
        i64p, i32p, ctypes.c_int64, u8p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(u8p), i64p, ctypes.POINTER(u8p), i64p]
    lib.mc_bfs_free.restype = None
    lib.mc_bfs_free.argtypes = [ctypes.c_void_p]
    return lib


def _fastio():
    if os.environ.get("MC_NATIVE_IO") == "0":
        return None
    with _lock:
        return _load_fastio()


def _bfs():
    if os.environ.get("MC_NATIVE_BFS") == "0":
        return None
    with _lock:
        return _load_bfs()


def available() -> bool:
    return _fastio() is not None


def bfs_available() -> bool:
    return _bfs() is not None


def supports(fmt: str) -> bool:
    """Formats the native parser handles (others use the Python readers)."""
    return fmt in ("fasta", "fastq", "fasta.gz", "fastq.gz")


def parse_fragments(path: str, fmt: str, qoffset: int = 33
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Parse a whole file natively.

    Returns (codes int8 (total,), offsets int64 (n_frags+1,)); fragment i is
    codes[offsets[i]:offsets[i+1]]. Raises NativeIOError on parse failure.
    """
    lib = _fastio()
    if lib is None:
        raise NativeIOError("native fastio unavailable")
    format_id = 0 if fmt.split(".")[0] == "fasta" else 1
    codes_p = ctypes.POINTER(ctypes.c_int8)()
    offs_p = ctypes.POINTER(ctypes.c_int64)()
    n_frags = ctypes.c_int64()
    total = ctypes.c_int64()
    errbuf = ctypes.create_string_buffer(512)
    rc = lib.fastio_parse(str(path).encode(), format_id, qoffset,
                          ctypes.byref(codes_p), ctypes.byref(offs_p),
                          ctypes.byref(n_frags), ctypes.byref(total),
                          errbuf, len(errbuf))
    if rc != 0:
        raise NativeIOError(errbuf.value.decode(errors="replace"))
    try:
        codes = np.ctypeslib.as_array(codes_p, shape=(max(total.value, 1),))
        codes = codes[: total.value].copy()
        offs = np.ctypeslib.as_array(offs_p, shape=(n_frags.value + 1,)).copy()
    finally:
        lib.fastio_free(codes_p)
        lib.fastio_free(offs_p)
    return codes, offs


def parse_reads(path: str, qoffset: int = 33
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Whole-read FASTQ parse, NO N-splitting (classifier semantics,
    io/readers.py::iter_dnaq): returns (codes int8 (total,), phred int16
    (total,), offsets int64 (n_reads+1,)); read i is
    codes[offsets[i]:offsets[i+1]]. Raises NativeIOError on failure."""
    lib = _fastio()
    if lib is None:
        raise NativeIOError("native fastio unavailable")
    codes_p = ctypes.POINTER(ctypes.c_int8)()
    phred_p = ctypes.POINTER(ctypes.c_int16)()
    offs_p = ctypes.POINTER(ctypes.c_int64)()
    n_reads = ctypes.c_int64()
    total = ctypes.c_int64()
    errbuf = ctypes.create_string_buffer(512)
    rc = lib.fastio_parse_reads(str(path).encode(), qoffset,
                                ctypes.byref(codes_p), ctypes.byref(phred_p),
                                ctypes.byref(offs_p), ctypes.byref(n_reads),
                                ctypes.byref(total), errbuf, len(errbuf))
    if rc != 0:
        raise NativeIOError(errbuf.value.decode(errors="replace"))
    try:
        codes = np.ctypeslib.as_array(
            codes_p, shape=(max(total.value, 1),))[: total.value].copy()
        phred = np.ctypeslib.as_array(
            phred_p, shape=(max(total.value, 1),))[: total.value].copy()
        offs = np.ctypeslib.as_array(offs_p, shape=(n_reads.value + 1,)).copy()
    finally:
        lib.fastio_free(codes_p)
        lib.fastio_free(phred_p)
        lib.fastio_free(offs_p)
    return codes, phred, offs


def bfs_exact(map_keys: np.ndarray, map_counts: np.ndarray,
              seeds: np.ndarray, k: int, min_occ: int, direction: int,
              max_radius: int | None, max_kmers: int | None,
              collect_last: bool) -> tuple[np.ndarray, np.ndarray]:
    """Native FIFO BFS, exact regime. Returns (visited, last) sorted codes.
    Counts are searched in the sorted `map_keys`; no table is built."""
    lib = _bfs()
    if lib is None:
        raise NativeIOError("native bfs unavailable")
    map_keys = np.ascontiguousarray(map_keys, np.int64)
    map_counts = np.ascontiguousarray(map_counts, np.int32)
    seeds = np.ascontiguousarray(seeds, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    vis_p, last_p = i64p(), i64p()
    nvis, nlast = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.mc_bfs_exact(
        map_keys.ctypes.data_as(i64p),
        map_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        map_keys.size, seeds.ctypes.data_as(i64p), seeds.size,
        k, min_occ, direction,
        -1 if max_radius is None else int(max_radius),
        -1 if max_kmers is None else int(max_kmers),
        1 if collect_last else 0,
        ctypes.byref(vis_p), ctypes.byref(nvis),
        ctypes.byref(last_p), ctypes.byref(nlast))
    if rc != 0:
        raise NativeIOError(f"mc_bfs_exact rc={rc}")
    try:
        vis = np.ctypeslib.as_array(vis_p, shape=(max(nvis.value, 1),))
        vis = vis[: nvis.value].copy()
        last = np.ctypeslib.as_array(last_p, shape=(max(nlast.value, 1),))
        last = last[: nlast.value].copy()
    finally:
        lib.mc_bfs_free(vis_p)
        lib.mc_bfs_free(last_p)
    return vis, last


def bfs_hashed(map_keys: np.ndarray, map_counts: np.ndarray,
               seeds: np.ndarray, k: int, min_occ: int, direction: int,
               max_radius: int | None, max_kmers: int | None, hasher: str,
               collect_last: bool) -> tuple[np.ndarray, np.ndarray]:
    """Native FIFO BFS, hashed regime. seeds: (N, k) uint8 oriented rows.
    Returns ((nvis, k), (nlast, k)) uint8 state rows (unordered). Counts are
    searched in the sorted `map_keys`; no table is built."""
    lib = _bfs()
    if lib is None:
        raise NativeIOError("native bfs unavailable")
    map_keys = np.ascontiguousarray(map_keys, np.int64)
    map_counts = np.ascontiguousarray(map_counts, np.int32)
    seeds = np.ascontiguousarray(seeds, np.uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    vis_p, last_p = u8p(), u8p()
    nvis, nlast = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.mc_bfs_hashed(
        map_keys.ctypes.data_as(i64p),
        map_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        map_keys.size, seeds.ctypes.data_as(u8p), seeds.shape[0],
        k, min_occ, direction,
        -1 if max_radius is None else int(max_radius),
        -1 if max_kmers is None else int(max_kmers),
        {"poly": 0, "fnv1a": 1}[hasher],
        1 if collect_last else 0,
        ctypes.byref(vis_p), ctypes.byref(nvis),
        ctypes.byref(last_p), ctypes.byref(nlast))
    if rc != 0:
        raise NativeIOError(f"mc_bfs_hashed rc={rc}")
    try:
        vis = np.ctypeslib.as_array(vis_p, shape=(max(nvis.value * k, 1),))
        vis = vis[: nvis.value * k].copy().reshape(nvis.value, k)
        last = np.ctypeslib.as_array(last_p, shape=(max(nlast.value * k, 1),))
        last = last[: nlast.value * k].copy().reshape(nlast.value, k)
    finally:
        lib.mc_bfs_free(vis_p)
        lib.mc_bfs_free(last_p)
    return vis, last
