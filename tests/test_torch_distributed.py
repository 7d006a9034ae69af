"""The port's process group (parallel/distributed.py) in separate processes
joined through MC_COORDINATOR (workers as in test_torch_parallel.py), and
environment-finder under MC_COUNT_ENGINE=sharded on two ranks against the
JAX package's single-process run, file for file."""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from metacherchant_tpu.runner import main as jax_main
from metacherchant_tpu_torch.parallel.distributed import (
    global_mesh, initialize_distributed, shard_files_for_host)
from test_torch_parallel import run_workers


@pytest.fixture
def no_group_left():
    """Destroys the process group the test formed (the sharded engine forms
    one of world size 1 in this process), so that no later test meets it."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _tree(root) -> dict[str, bytes]:
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, root)] = fh.read()
    return files


def test_two_processes_share_files_and_reduce(tmp_path):
    """Each rank takes the files i with i mod 2 == rank; an all_reduce of
    rank + 1 gives 3 on both."""
    files = [f"f{i}" for i in range(7)]
    got = run_workers(2, {"files": dict(kind="files", files=files)},
                      tmp_path)["files"]
    for rank, res in enumerate(got):
        assert list(res["mine"]) == files[rank::2]
        assert int(res["total"]) == 3 and int(res["world"]) == 2


def test_group_is_reused_and_keeps_its_backend(no_group_left):
    """Without MC_COORDINATOR a group of world size 1 forms on a free local
    port; a second call reuses it; a device whose backend differs raises
    instead of switching."""
    cpu = torch.device("cpu")
    initialize_distributed(device=cpu)
    group, n = global_mesh()
    initialize_distributed(device=cpu)
    assert global_mesh() == (group, n)
    if n == 1:
        assert shard_files_for_host(["a", "b", "c"]) == ["a", "b", "c"]
    with pytest.raises(RuntimeError, match="needs nccl"):
        initialize_distributed(device=torch.device("cuda"))


def test_sharded_cli_on_two_ranks_matches_jax(tmp_path, monkeypatch):
    """environment-finder -k 21 over two read files under
    MC_COUNT_ENGINE=sharded: each rank counts one file, both write the
    whole environment, byte-identical to the JAX package's run in one
    process."""
    rng = np.random.default_rng(11)
    g = "".join(rng.choice(list("ACGT"), size=3000))
    reads = [str(tmp_path / f"reads{i}.fastq") for i in (1, 2)]
    for i, s in enumerate(rng.integers(0, 2940, size=500)):
        with open(reads[i % 2], "a") as fh:
            fh.write(f"@r{i}\n{g[s:s + 60]}\n+\n{'I' * 60}\n")
    genes = tmp_path / "genes.fasta"
    genes.write_text(f">geneA\n{g[1000:1120]}\n>geneB\n{g[2200:2300]}\n")

    def argv(out: str, wd: str) -> list[str]:
        return ["-t", "environment-finder", "-k", "21", "-i", *reads,
                "--seq", str(genes), "-o", out, "--coverage", "3",
                "--maxradius", "100", "--work-dir", wd]

    monkeypatch.setenv("MC_COUNT_ENGINE", "sharded")
    assert jax_main(argv(str(tmp_path / "oj"), str(tmp_path / "wj"))) == 0
    want = _tree(tmp_path / "oj")
    got = run_workers(2, {"cli": dict(
        kind="cli", env={"MC_COUNT_ENGINE": "sharded"},
        argv=argv(str(tmp_path / "o{rank}"), str(tmp_path / "w{rank}")))},
        tmp_path / "workers")["cli"]
    assert len(want) == 10
    for rank, res in enumerate(got):
        assert int(res["rc"]) == 0
        assert _tree(tmp_path / f"o{rank}") == want, rank
        assert os.path.exists(tmp_path / f"w{rank}" / "SUCCESS")
