"""The port's sharded counter (parallel/sharded_count.py) against the JAX
package's on a mesh of the same n, at world sizes 1-4.

Each world size runs once per file: n worker processes (gloo on the CPU),
started with `python -c WORKER` and importing only the port, run every
scenario of the file in turn and write one npz per scenario and rank. Every
scenario is its own test case here, held to JAX's ShardedCounter on
make_mesh(jax.devices()[:n]) and to the host oracle: the whole map on every
rank, and rank r's shard against JAX's shard row r. The scenarios are those
of tests/test_parallel.py, with batches of 12 reads so that every n in 1-4
divides them; test_torch_parallel_*.py hold the rest, split so that no file
runs long. run_workers and the scenarios are shared with those files.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metacherchant_tpu.counting import count_sequences_host
from metacherchant_tpu.dna import encode
from metacherchant_tpu.parallel import sharded_count as jsc
from metacherchant_tpu.parallel.sharded_bfs import _owner as jax_owner
from metacherchant_tpu_torch.parallel.sharded_count import _owner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_SIZES = (1, 2, 3, 4)
BATCH = 12

#: one worker process: joins the group from MC_COORDINATOR, runs the jobs of
#: the JSON file argv[1] and writes <name>_<rank>.npz beside it; any
#: unexpected error exits at once, so that the peers' collectives fail fast
WORKER = r"""
import json, os, sys, traceback
sys.modules["jax"] = None
sys.modules["metacherchant_tpu"] = None
sys.path.insert(0, os.environ["MC_REPO"])
import numpy as np
import torch
import torch.distributed as dist
from metacherchant_tpu_torch.kmer_map import KmerMap
from metacherchant_tpu_torch.parallel.distributed import (
    initialize_distributed, shard_files_for_host)


def count(j, dev, rank, n):
    from metacherchant_tpu_torch.parallel.sharded_count import ShardedCounter
    p = j["params"]
    batches = np.load(j["data"])["batches"]
    geom = dict(batch=BATCH, max_len=batches.shape[2], slack=p["slack"],
                device=dev)
    if "state" in j:
        s = np.load(j["state"])
        sc = ShardedCounter.from_state(s["tkeys"], s["tcnts"], s["ov_keys"],
                                       s["ov_cnts"], p["k"], p["hasher"],
                                       **geom)
        batches = batches[int(s["done"]):]
    else:
        sc = ShardedCounter(p["k"], p["hasher"],
                            capacity_log2_per_shard=p["cap"],
                            overflow_buf=p["m"], **geom)
    if p["no_room"]:
        sc._ensure_room = lambda incoming: None
    rows = BATCH // n
    for b in batches:
        sc.add_codes(b[rank * rows:(rank + 1) * rows])
    keys, cnts = sc.items_host()
    sk, scn = sc.shard_items()
    return dict(keys=keys, cnts=cnts, shard_keys=sk.numpy(),
                shard_cnts=scn.numpy(), shard_cap=sc.shard_cap)


def engine(j, dev, rank, n):
    from metacherchant_tpu_torch.counting import count_kmers_device
    m = count_kmers_device(j["files"], j["k"], j["hasher"], engine="sharded",
                           device=dev, **j["geom"])
    return dict(keys=m.keys, cnts=m.counts)


def bfs(j, dev, rank, n):
    from metacherchant_tpu_torch.parallel.sharded_bfs import run_sharded_bfs
    z = np.load(j["data"])
    got = run_sharded_bfs(z["seeds"], KmerMap(z["keys"], z["counts"]),
                          j["k"], 1, j["direction"], j["radius"],
                          j["frontier_cap"], device=dev)
    return dict(visited=got)


def cli(j, dev, rank, n):
    from metacherchant_tpu_torch.runner import main
    os.environ.update(j["env"])
    argv = [a.replace("{rank}", str(rank)) for a in j["argv"]]
    return dict(rc=main(argv))


def files(j, dev, rank, n):
    t = torch.tensor([rank + 1], dtype=torch.int64)
    dist.all_reduce(t)
    return dict(mine=np.array(shard_files_for_host(j["files"])),
                total=int(t), world=n)


JOBS = dict(count=count, engine=engine, bfs=bfs, cli=cli, files=files)
BATCH = int(os.environ["MC_TEST_BATCH"])

try:
    dev = torch.device("cpu")
    initialize_distributed(device=dev)
    rank, n = dist.get_rank(), dist.get_world_size()
    assert n == int(os.environ["MC_NUM_PROCESSES"])
    with open(sys.argv[1]) as fh:
        jobs = json.load(fh)
    out = os.path.dirname(sys.argv[1])
    for name, j in jobs.items():
        try:
            res = JOBS[j["kind"]](j, dev, rank, n)
        except Exception as e:
            if type(e).__name__ != j.get("expect"):
                raise
            res = dict(raised=type(e).__name__)
        np.savez(os.path.join(out, f"{name}_{rank}.npz"), **res)
    dist.destroy_process_group()
except BaseException:
    traceback.print_exc()
    sys.stderr.flush()
    os._exit(1)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(n: int, jobs: dict, workdir, timeout: float = 240,
                env: dict | None = None) -> dict[str, list[dict]]:
    """Run `jobs` on n worker processes; returns, per job, each rank's npz
    contents. Fails (and kills every worker) on a timeout or an error."""
    os.makedirs(workdir, exist_ok=True)
    spec = os.path.join(str(workdir), "jobs.json")
    with open(spec, "w") as fh:
        json.dump(jobs, fh)
    port = _free_port()
    procs = []
    for rank in range(n):
        penv = dict(os.environ, MC_REPO=REPO, MC_PLATFORM="cpu",
                    OMP_NUM_THREADS="1",
                    MC_COORDINATOR=f"127.0.0.1:{port}",
                    MC_NUM_PROCESSES=str(n), MC_PROCESS_ID=str(rank),
                    MC_TEST_BATCH=str(BATCH), **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, spec], env=penv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{n} workers timed out after {timeout} s")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} of {n} failed:\n{out[-4000:]}"
    return {name: [dict(np.load(os.path.join(str(workdir),
                                             f"{name}_{r}.npz")))
                   for r in range(n)] for name in jobs}


def mesh_of(n: int):
    return jsc.make_mesh(jax.devices()[:n])


# ---------------------------------------------------------------------------
# scenarios (tests/test_parallel.py's, in batches of BATCH reads)
# ---------------------------------------------------------------------------

def pack_batches(seqs: list[str], length: int) -> np.ndarray:
    """(batches, BATCH, length) int32 codes, -1 padded, the last batch
    padded with empty rows."""
    nb = -(-len(seqs) // BATCH)
    codes = np.full((nb, BATCH, length), -1, np.int32)
    for j, s in enumerate(seqs):
        c = encode(s)
        codes[j // BATCH, j % BATCH, :len(c)] = c
    return codes


def _random_seqs(seed: int, count: int, length: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGT"), size=length))
            for _ in range(count)]


def _skewed_seqs(n: int, k: int = 15) -> list[str]:
    """160 k-mers that all belong to shard 0 of n (JAX's uint64 owner)."""
    from metacherchant_tpu.dna import canonical_code, kmer_to_code
    rng = np.random.default_rng(5)
    seqs = []
    while len(seqs) < 160:
        s = "".join(rng.choice(list("ACGT"), size=k))
        key = canonical_code(kmer_to_code(s), k)
        if int(jax_owner(jnp.asarray([key], jnp.int64), n)[0]) == 0:
            seqs.append(s)
    return seqs


def _params(k, hasher=None, cap=12, m=4096, slack=2, no_room=False):
    return dict(k=k, hasher=hasher, cap=cap, m=m, slack=slack,
                no_room=no_room)


def scenario(name: str, n: int) -> tuple[list[str], int, dict]:
    """(sequences, batch length, parameters) of a scenario at world size n."""
    return {
        "exact": (_random_seqs(0, 64, 100), 128, _params(21)),
        "hashed": (_random_seqs(1, 32, 80), 96, _params(35, "poly")),
        "carry": (_random_seqs(2, 32, 120), 128,
                  _params(15, m=8192, slack=1)),
        "growth": (_random_seqs(3, 32, 120), 128, _params(21, cap=6)),
        "requeue": (_random_seqs(4, 16, 120), 128,
                    _params(17, cap=5, no_room=True)),
        "skew": (_skewed_seqs(n), 15, _params(15, m=1024)),
    }[name]


def jax_counter(n: int, p: dict, length: int):
    sc = jsc.ShardedCounter(mesh_of(n), p["k"], p["hasher"],
                            capacity_log2_per_shard=p["cap"], batch=BATCH,
                            max_len=length, overflow_buf=p["m"])
    if p["slack"] != 2:
        sc.step = jsc.make_sharded_count_step(mesh_of(n), p["k"], p["hasher"],
                                              slack=p["slack"])
    if p["no_room"]:
        sc._ensure_room = lambda incoming: None
    return sc


def count_jobs(names, n: int, workdir) -> dict:
    """The worker jobs of the named scenarios at n, their data written to
    workdir; 'handover' starts from a JAX counter's state after half the
    carry scenario's batches."""
    jobs = {}
    for name in names:
        base = "carry" if name == "handover" else name
        seqs, length, p = scenario(base, n)
        data = os.path.join(str(workdir), f"{name}.npz")
        batches = pack_batches(seqs, length)
        np.savez(data, batches=batches)
        jobs[name] = dict(kind="count", data=data, params=p)
        if name == "handover":
            sc = jax_counter(n, p, length)
            done = len(batches) // 2
            for b in batches[:done]:
                sc.add_codes(b)
            sc._sync()
            state = os.path.join(str(workdir), "handover_state.npz")
            np.savez(state, done=done, **{a: np.asarray(getattr(sc, a))
                                         for a in ("tkeys", "tcnts",
                                                   "ov_keys", "ov_cnts")})
            jobs[name]["state"] = state
    return jobs


def check_count(got: list[dict], name: str, n: int, cap_too: bool = False
                ) -> int:
    """Every rank's map equals JAX's and the host oracle; rank r's shard
    holds JAX's shard row r; with cap_too the shard capacity is JAX's.
    Returns JAX's shard capacity."""
    base = "carry" if name == "handover" else name
    seqs, length, p = scenario(base, n)
    sc = jax_counter(n, p, length)
    for b in pack_batches(seqs, length):
        sc.add_codes(b)
    keys, cnts = sc.items_host()
    host = count_sequences_host(seqs, p["k"], p["hasher"])
    assert np.array_equal(keys, host.keys)
    assert np.array_equal(cnts, host.counts)
    assert len(keys) > 100
    tk, tc = np.asarray(sc.tkeys), np.asarray(sc.tcnts)
    for r, res in enumerate(got):
        assert np.array_equal(res["keys"], keys), r
        assert np.array_equal(res["cnts"], cnts), r
        live = tk[r] != jsc.SENTINEL
        order = np.argsort(tk[r][live])
        assert np.array_equal(res["shard_keys"], tk[r][live][order]), r
        assert np.array_equal(res["shard_cnts"], tc[r][live][order]), r
        if cap_too:
            assert int(res["shard_cap"]) == sc.shard_cap, r
    assert sum(res["shard_keys"].size for res in got) == len(keys)
    return sc.shard_cap


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def results_fixture(names, more_jobs=None):
    """A module fixture: per world size n, the workers' results for the
    named scenarios and the jobs more_jobs(n, workdir) gives (one run of n
    workers each)."""
    @pytest.fixture(scope="module")
    def results(tmp_path_factory):
        cache = {}

        def get(n: int) -> dict:
            if n not in cache:
                wd = tmp_path_factory.mktemp(f"workers{n}")
                jobs = count_jobs(names, n, wd)
                jobs.update(more_jobs(n, wd) if more_jobs else {})
                cache[n] = run_workers(n, jobs, wd)
            return cache[n]
        return get
    return results


NAMES = ("exact", "hashed")
results = results_fixture(NAMES)


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_counter_matches_jax(results, name, n):
    """Exact (k = 21) and hashed (k = 35, poly) keys."""
    check_count(results(n)[name], name, n)


@pytest.mark.parametrize("n", [2, 3, 5, 6, 7, 8])
def test_owner_matches_jax_uint64(n):
    """ROADMAP C13: the owner is mix64(key) mod n in uint64; keys whose mix
    has bit 63 set are where int64 remainders would differ."""
    import torch
    from metacherchant_tpu.ops.hashtable import _mix64 as jax_mix64
    rng = np.random.default_rng(n)
    keys = np.concatenate([
        rng.integers(0, 1 << 62, 20000, dtype=np.int64),
        rng.integers(np.iinfo(np.int64).min, 0, 20000, dtype=np.int64),
        np.array([0, 1, -1, np.iinfo(np.int64).max, np.iinfo(np.int64).min],
                 np.int64)])
    mixed = np.asarray(jax_mix64(jnp.asarray(keys))).view(np.int64)
    assert (mixed < 0).sum() > 15000  # bit 63 set in about half
    want = np.asarray(jax_owner(jnp.asarray(keys), n))
    got = _owner(torch.from_numpy(keys), n).numpy()
    assert np.array_equal(got, want)
    assert set(np.unique(got)) == set(range(n))
