"""A cell's inputs: the community's reads and genes keep their bytes, a
tool's input hook runs once a run in set-up before the warm-up job, its
files reach the jobs and the reference, and the pairs it can draw are the
two ends of one fragment."""
import hashlib
import json
import os

import pytest
import torch

from benchmark import core, datagen
from conftest import ROOT, STAND_IN, STAND_IN_DIR, TINY_CELLS

SEED = 2**31 + 5
#: sha256 of each input file of the tiny cells at SEED on the CPU, as the
#: generator wrote them before input hooks existed
DIGESTS = {
    "envfinder-tiny.genes3": {
        "genes_0.fasta": "01d4e87d68ecb0a1aad2ac1fd9446d24"
                         "a425229fd8dfcb014da7f97b2a301916",
        "genes_1.fasta": "d063501449291dbdee672ed39ba0319d"
                         "695b2068fe432c993a3f35af4881fe98",
        "genes_2.fasta": "ad10349333b48abee61533c519d41b02"
                         "ed55af227192ef10abb93b436468bff8",
        "genes_3.fasta": "f72a2c27058e064aea2351e91a269636"
                         "e27d51a2a5325f192a82d89f00b316da",
        "reads.fastq": "7bddcaf1e16296246517abc22fefa9a8"
                       "23cd92a790270076fb39126712ffed89",
        "warm/reads.fastq": "33f1f3f9ed530a4142d62bda47cf6475"
                            "87372ef62c5a16ec26d9d13df69fdf7b"},
    "fmt-tiny.count": {
        "reads.fastq": "92b297dbfc0a33d2295acf3719d22bd3"
                       "3a717a5e1bb82e8a84b40407ee477890",
        "warm/reads.fastq": "f7d05554afb78cc20dbbfcad57eb6534"
                            "d724f0a2835db446f25016a340dab0be"}}


def digests(where) -> dict[str, str]:
    out = {}
    for d, _, files in os.walk(where):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, where)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_inputs_of_a_tool_without_a_hook_keep_their_bytes(tiny_root, cell,
                                                          tmp_path):
    c = core.load_cell(tiny_root, cell)
    assert c.inputs is None
    where = tmp_path / "data"
    where.mkdir()
    inputs = datagen.make_inputs(c.cfg, c.mix, SEED, str(where), "cpu",
                                 c.inputs)
    assert inputs.files == {} and inputs.warm_files == {}
    assert core.hook_files(inputs) == {}
    assert digests(where) == DIGESTS[cell]


def test_hook_runs_once_in_set_up_and_its_files_reach_the_jobs(
        tiny_root, monkeypatch):
    """The hook runs before the warm-up job's launch and never again; the
    warm-up job gets the warm files, each window job the files, and the
    reference the files."""
    (cell,) = STAND_IN
    c = core.load_cell(tiny_root, cell)
    events, made = [], []
    make, run_job, solve = c.inputs.make, core.Run._run_job, c.reference.solve
    run_window = core.run_window

    def hook(*args):
        events.append("hook")
        made.append(make(*args))
        return made[-1]

    def job(self, j):
        events.append(("job", j.index, j.files))
        run_job(self, j)

    def window(*args):
        events.append("window")
        return run_window(*args)

    def reference(*args, **kwargs):
        events.append(("reference", kwargs.get("files")))
        return solve(*args, **kwargs)

    monkeypatch.setattr(c.inputs, "make", hook)
    monkeypatch.setattr(core.Run, "_run_job", job)
    monkeypatch.setattr(core, "run_window", window)
    monkeypatch.setattr(c.reference, "solve", reference)
    run = core.Run(c, SEED, 0.5, False, device="cpu",
                   scratch=str(tiny_root / "scratch"))
    try:
        res = run.execute()
    finally:
        run.cleanup()
    assert res["correct"], res["compared"]
    (files, warm), = made
    assert sorted(files) == sorted(warm) == ["mate1", "mate2"]
    assert events[:3] == ["hook", ("job", -1, warm), "window"]
    assert events.count("hook") == 1
    jobs = [e for e in events[3:] if e[0] == "job"]
    assert jobs == [("job", i, files) for i in range(res["attempted"])]
    assert events[-1] == ("reference", files)


def test_the_hook_writes_pairs_and_their_warm_quarter(tiny_root, tmp_path):
    (cell,) = STAND_IN
    c = core.load_cell(tiny_root, cell)
    where = tmp_path / "data"
    where.mkdir()
    inputs = datagen.make_inputs(c.cfg, c.mix, SEED, str(where), "cpu",
                                 c.inputs)
    # the reads are those of the same community without a hook
    fmt = core.load_cell(tiny_root, "fmt-tiny.count")
    assert fmt.cfg["reads"] == c.cfg["reads"]
    got = digests(where)
    assert {k: got[k] for k in DIGESTS["fmt-tiny.count"]} == \
        DIGESTS["fmt-tiny.count"]
    lines = {}
    for name in ("mate1", "mate2"):
        for which, path in (("all", inputs.files[name]),
                            ("warm", inputs.warm_files[name])):
            assert path.startswith(str(where))
            with open(path) as fh:
                lines[name, which] = fh.read().split("\n")
    n = c.cfg["reads"] // 2
    assert len(lines["mate1", "all"]) == 4 * n + 1
    assert len(lines["mate1", "warm"]) == 4 * (n // datagen.WARM_SHARE) + 1
    # mates share their record numbers; the warm files are the first pairs
    assert lines["mate1", "all"][0::4] == lines["mate2", "all"][0::4]
    for name in ("mate1", "mate2"):
        warm = lines[name, "warm"]
        assert warm[:-1] == lines[name, "all"][:len(warm) - 1]
    # the same seed gives the same files; the hook's stream is its own
    again = datagen.make_inputs(c.cfg, c.mix, SEED, str(tmp_path / "again"),
                                "cpu", c.inputs)
    assert again.files != inputs.files
    with open(again.files["mate2"]) as fh:
        assert fh.read().split("\n") == lines["mate2", "all"]


def test_sample_pairs_are_the_two_ends_of_one_fragment():
    gen = datagen.generator(SEED, "cpu", salt=3)
    genomes = torch.randint(0, 4, (3, 5000), generator=gen, dtype=torch.int8)
    which = torch.tensor([0, 1, 2, 2, 1])
    m1, m2 = datagen.sample_pairs(genomes, which, 150, 400, 0.0, gen)
    assert m1.shape == m2.shape == (5, 150) and m1.dtype == torch.int8
    for g, a, b in zip(which.tolist(), m1, 3 - m2.flip(-1)):
        seq = genomes[g].numpy().tobytes()
        at = seq.find(a.numpy().tobytes())
        assert at >= 0 and seq[at + 250:at + 400] == b.numpy().tobytes()
    # from one state, the same fragments with 5% of the bases replaced
    many = which.repeat(400)
    exact = datagen.sample_pairs(genomes, many, 150, 400, 0.0,
                                 datagen.generator(SEED, "cpu", salt=4))
    noisy = datagen.sample_pairs(genomes, many, 150, 400, 0.05,
                                 datagen.generator(SEED, "cpu", salt=4))
    for e, n in zip(exact, noisy):
        assert 0.045 < (e != n).double().mean().item() < 0.055
        assert int(n.min()) == 0 and int(n.max()) == 3


def test_salted_generators_are_streams_of_their_own():
    draw = [torch.rand(4, generator=datagen.generator(SEED, "cpu", salt))
            for salt in (0, 0, 1, 2)]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    assert not torch.equal(draw[2], draw[3])
    plain = torch.Generator()
    plain.manual_seed(SEED)
    assert torch.equal(draw[0], torch.rand(4, generator=plain))


def test_the_copy_keeps_every_file_and_entry_of_the_benchmark(tiny_root):
    """The tiny cells, the stand-in's tool among them, come as new files
    and entries: no file the copy took from the benchmark changed, and the
    stand-in's files are new to it."""
    bench = ROOT / "benchmark"
    for path in bench.rglob("*"):
        rel = path.relative_to(bench)
        if path.is_file() and rel.parts[0] != "tests" and \
                "__pycache__" not in rel.parts:
            assert (tiny_root / "benchmark" / rel).read_bytes() == \
                path.read_bytes(), rel
    for path in STAND_IN_DIR.rglob("*.py"):
        rel = path.relative_to(STAND_IN_DIR)
        assert not (bench / rel).exists(), rel
        assert (tiny_root / "benchmark" / rel).read_bytes() == \
            path.read_bytes()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    copy = json.loads((tiny_root / "BENCHMARK.json").read_text())
    added = set(TINY_CELLS) | set(STAND_IN)
    for key, entries in spec.items():
        if not isinstance(entries, list) or not entries or \
                not isinstance(entries[0], dict):
            assert copy[key] == entries
            continue
        kept = [dict(e, **({"workloads": [w for w in e["workloads"]
                                          if w not in added]}
                           if "workloads" in e else {}))
                for e in copy[key][:len(entries)]]
        assert kept == entries, key
