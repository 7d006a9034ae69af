"""Counted-table checkpointing: the data checkpoint between counting and
downstream tools.

Counterpart of metacherchant_tpu/checkpoint.py, with the same manifest,
format string and shard file names, so a dump written by either package
loads in the other. The reference's de-facto data checkpoint is the
kmers.bin dump (src/io/IOUtils.java:39-65 + loader :94-126) plus the Tool
framework's SUCCESS/in.properties stage skip (tool.py); this is a sharded,
manifest-carrying dump of the counted map, so multi-process runs can persist
and restore per-shard (keys, counts) without re-counting.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .kmer_map import KmerMap

MANIFEST = "manifest.json"


def save_kmer_map(directory: str, kmap: KmerMap, k: int,
                  hasher: str | None, n_shards: int = 1,
                  inputs: list[str] | None = None) -> None:
    """Dump a KmerMap as n_shards .npz shards + a manifest.

    Sharding is by contiguous key ranges (shards stay individually sorted, so
    a distributed reload can route each shard straight to its owner)."""
    os.makedirs(directory, exist_ok=True)
    bounds = np.linspace(0, len(kmap), n_shards + 1).astype(np.int64)
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        np.savez(os.path.join(directory, f"shard_{s:05d}.npz"),
                 keys=kmap.keys[lo:hi], counts=kmap.counts[lo:hi])
    with open(os.path.join(directory, MANIFEST), "w") as fh:
        json.dump({
            "format": "metacherchant-tpu-kmer-map-v1",
            "k": k,
            "hasher": hasher,
            "n_shards": n_shards,
            "n_kmers": int(len(kmap)),
            "inputs": inputs or [],
        }, fh, indent=2)


def load_kmer_map(directory: str, expect_k: int | None = None,
                  expect_hasher: str | None = "__unchecked__") -> tuple[KmerMap, dict]:
    """Reload a dumped map; validates k / hasher against the manifest."""
    with open(os.path.join(directory, MANIFEST)) as fh:
        manifest = json.load(fh)
    if manifest.get("format") != "metacherchant-tpu-kmer-map-v1":
        raise ValueError(f"unrecognized checkpoint format in {directory}")
    if expect_k is not None and manifest["k"] != expect_k:
        raise ValueError(
            f"checkpoint k={manifest['k']} does not match requested k={expect_k}")
    if expect_hasher != "__unchecked__" and manifest["hasher"] != expect_hasher:
        raise ValueError(
            f"checkpoint hasher={manifest['hasher']} does not match "
            f"requested {expect_hasher}")
    keys_parts, cnt_parts = [], []
    for s in range(manifest["n_shards"]):
        z = np.load(os.path.join(directory, f"shard_{s:05d}.npz"))
        keys_parts.append(z["keys"])
        cnt_parts.append(z["counts"])
    kmap = KmerMap(np.concatenate(keys_parts) if keys_parts else np.empty(0, np.int64),
                   np.concatenate(cnt_parts) if cnt_parts else np.empty(0, np.int32))
    return kmap, manifest
