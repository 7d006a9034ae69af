"""The port's checkpoint.py: tests/test_checkpoint.py's cases, and dumps
that load in the other package, both ways."""
import json

import numpy as np
import pytest

from metacherchant_tpu import checkpoint as jax_ckpt
from metacherchant_tpu.kmer_map import KmerMap as JaxKmerMap
from metacherchant_tpu_torch.checkpoint import load_kmer_map, save_kmer_map
from metacherchant_tpu_torch.kmer_map import KmerMap


def _kmap(n=1000, seed=0, cls=KmerMap):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(-2**62, 2**62, size=n, dtype=np.int64))
    counts = rng.integers(1, 100, size=keys.size).astype(np.int32)
    return cls(keys, counts)


@pytest.mark.parametrize("n_shards", [1, 4, 7])
def test_roundtrip(tmp_path, n_shards):
    km = _kmap()
    save_kmer_map(str(tmp_path), km, k=31, hasher=None, n_shards=n_shards,
                  inputs=["a.fastq"])
    got, manifest = load_kmer_map(str(tmp_path), expect_k=31,
                                  expect_hasher=None)
    assert isinstance(got, KmerMap)
    assert (got.keys == km.keys).all() and (got.counts == km.counts).all()
    assert manifest["n_shards"] == n_shards
    assert manifest["inputs"] == ["a.fastq"]


def test_manifest_validation(tmp_path):
    km = _kmap(50)
    save_kmer_map(str(tmp_path), km, k=31, hasher="poly")
    with pytest.raises(ValueError, match="k=31"):
        load_kmer_map(str(tmp_path), expect_k=21)
    with pytest.raises(ValueError, match="hasher"):
        load_kmer_map(str(tmp_path), expect_k=31, expect_hasher="fnv1a")
    with open(tmp_path / "manifest.json") as fh:
        manifest = json.load(fh)
    manifest["format"] = "something-else"
    with open(tmp_path / "manifest.json", "w") as fh:
        json.dump(manifest, fh)
    with pytest.raises(ValueError, match="unrecognized checkpoint format"):
        load_kmer_map(str(tmp_path))


def test_empty_map(tmp_path):
    km = KmerMap(np.empty(0, np.int64), np.empty(0, np.int32))
    save_kmer_map(str(tmp_path), km, k=31, hasher=None, n_shards=3)
    got, _ = load_kmer_map(str(tmp_path))
    assert len(got) == 0


@pytest.mark.parametrize("n_shards", [1, 5])
@pytest.mark.parametrize("hasher", [None, "fnv1a"])
def test_dumps_load_in_both_packages(tmp_path, n_shards, hasher):
    """A dump of either package loads in the other with the same map and
    manifest; the two packages write the same files."""
    port, jax = tmp_path / "port", tmp_path / "jax"
    save_kmer_map(str(port), _kmap(seed=3), k=55, hasher=hasher,
                  n_shards=n_shards, inputs=["x.fastq"])
    jax_ckpt.save_kmer_map(str(jax), _kmap(seed=3, cls=JaxKmerMap), k=55,
                           hasher=hasher, n_shards=n_shards,
                           inputs=["x.fastq"])
    assert (port / "manifest.json").read_bytes() == \
        (jax / "manifest.json").read_bytes()
    for src, load in ((port, jax_ckpt.load_kmer_map),
                      (jax, load_kmer_map)):
        got, manifest = load(str(src), expect_k=55, expect_hasher=hasher)
        want = _kmap(seed=3)
        assert np.array_equal(got.keys, want.keys)
        assert np.array_equal(got.counts, want.counts)
        assert manifest["n_shards"] == n_shards
    for s in range(n_shards):
        a = np.load(port / f"shard_{s:05d}.npz")
        b = np.load(jax / f"shard_{s:05d}.npz")
        assert sorted(a.files) == sorted(b.files) == ["counts", "keys"]
        for name in a.files:
            assert a[name].dtype == b[name].dtype
            assert np.array_equal(a[name], b[name])
