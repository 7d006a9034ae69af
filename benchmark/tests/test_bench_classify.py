"""The reads-classifier cell, added as files alone, at a tiny size on the
CPU: its runs agree with the plain reference and read the classifier's
four per-layer metrics, a run whose classifier is broken underneath comes
out as not correct, and so does the control; the input hook's dump is the
recount of the donor's reads, and the launcher's change to the
environment stays inside the test."""
import json
import os

import numpy as np
import pytest

from benchmark import core, datagen
from benchmark.reference import recount
from classify_faults import FAULTS
from conftest import TINY

BASE = "fmt-classify-k31"
CELL = "fmt-classify-tiny.recipient-pairs"
#: the recipient's size at which a job takes a fraction of a second
TINY_PAIRS = {"recipient_pairs": 2000}
METRICS = {"graph_load_s", "find_s", "bins_s", "classify_parse_s"}
SEED = 2**31 + 7


@pytest.fixture
def classify_root(tiny_root, monkeypatch):
    """tiny_root's copy with a tiny fmt-classify-k31 and a cell on it, as
    new files and entries; the variables a run sets are restored after the
    test."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv("MC_DEVICE_CLASSIFY", "0")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    conf = next(c for c in spec["configs"] if c["name"] == BASE)
    cfg = json.loads((tiny_root / conf["file"]).read_text())
    name = CELL.split(".")[0]
    cfg.update({k: v for k, v in {**TINY, **TINY_PAIRS}.items() if k in cfg},
               name=name)
    path = f"benchmark/configs/{name}.json"
    (tiny_root / path).write_text(json.dumps(cfg))
    spec["configs"].append({**conf, "name": name, "file": path})
    spec["workloads"].append({"name": CELL, "config": name,
                              "traffic": "recipient-pairs", "chips": 1,
                              "why": "tiny, for the CPU tests"})
    for m in spec["per_layer"]:
        if any(w.startswith(BASE + ".") for w in m.get("workloads", [])):
            m["workloads"].append(CELL)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    return tiny_root


def run_cell(root, trace=0, seconds=0.5):
    run = core.Run(core.load_cell(root, CELL), SEED, seconds, bool(trace),
                   device="cpu", scratch=str(root / "scratch"))
    try:
        return run.execute()
    finally:
        run.cleanup()


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_agrees_with_its_reference(classify_root, trace):
    res = run_cell(classify_root, trace)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert all(v["value"] == 0 for v in res["compared"].values())
    assert set(res["compared"]) == {"found_pairs_wrong",
                                    "not_found_pairs_wrong",
                                    "found_s_wrong", "not_found_s_wrong"}
    assert set(res["metrics"]) == (METRICS if trace else
                                   {"job_s", "setup_s", "peak_host_gib"})
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_reference_fills_every_bin(classify_root, tmp_path):
    """The tiny recipient has pairs in every bin, so a fault in any one
    shows."""
    c = core.load_cell(classify_root, CELL)
    inputs = datagen.make_inputs(c.cfg, c.mix, SEED, str(tmp_path), "cpu",
                                 c.inputs)
    (want,) = c.reference.solve(c.cfg, inputs.reads, [None], "cpu",
                                files=inputs.files)
    sizes = {b: sum(want[b].values()) for b in want}
    assert all(n >= 50 for n in sizes.values()), sizes
    assert 2 * (sizes["found"] + sizes["not_found"]) + sizes["found_s"] + \
        sizes["not_found_s"] == 2 * c.cfg["recipient_pairs"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_classifier_is_not_correct(classify_root, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res = run_cell(classify_root)
    assert not res["correct"]
    assert any(v["value"] > v["limit"] for v in res["compared"].values())


def test_control_fails(classify_root):
    """At this size 32-bit keys rarely collide, so the test narrows to 12
    bits; the card's run of the control keeps 32 (benchmark/control.py)."""
    from benchmark.control import control_numbers
    narrow = control_numbers(classify_root, CELL, 7, 2, key_bits=12,
                             device="cpu", where=str(classify_root))
    assert any(v["value"] > v["limit"] for v in narrow.values())


def test_hooks_dump_is_the_recount_of_the_donors_reads(classify_root,
                                                       tmp_path):
    c = core.load_cell(classify_root, CELL)
    inputs = datagen.make_inputs(c.cfg, c.mix, SEED, str(tmp_path), "cpu",
                                 c.inputs)
    assert inputs.files["dump"] == inputs.warm_files["dump"]
    assert inputs.files["dump"].endswith("kmers.bin")
    rec = np.fromfile(inputs.files["dump"],
                      np.dtype([("k", ">i8"), ("c", ">i2")]))
    keys, counts = recount.count(recount.read_fastq_codes(inputs.reads),
                                 c.cfg["k"], "cpu")
    keep = counts > c.cfg["threshold"]
    assert rec.size == np.count_nonzero(keep) > 0
    assert np.array_equal(rec["k"], keys[keep])
    assert np.array_equal(rec["c"], counts[keep])
    n = c.cfg["recipient_pairs"]
    for m in ("mate1", "mate2"):
        assert len(recount.read_fastq_codes(inputs.files[m])) == n
        assert len(recount.read_fastq_codes(inputs.warm_files[m])) == \
            n // datagen.WARM_SHARE


def test_launcher_sets_the_configs_environment_inside_the_test(
        classify_root, monkeypatch):
    c = core.load_cell(classify_root, CELL)
    assert c.cfg["env"] == {"MC_DEVICE_CLASSIFY": "1"}
    before = os.environ["MC_DEVICE_CLASSIFY"]
    job = core.Job(0, "reads.fastq", None, "out", "wd",
                   {"dump": "donor.kmers.bin", "mate1": "m1.fastq",
                    "mate2": "m2.fastq"})
    with monkeypatch.context() as m:
        m.setenv("MC_DEVICE_CLASSIFY", "")
        argv = c.launcher.argv(c.cfg, job)
        assert os.environ["MC_DEVICE_CLASSIFY"] == "1"
    assert os.environ["MC_DEVICE_CLASSIFY"] == before == "0"
    assert argv == ["-t", "reads-classifier", "-k", "31",
                    "-i", "donor.kmers.bin", "-r", "m1.fastq", "m2.fastq",
                    "-o", "out", "--work-dir", "wd"]
