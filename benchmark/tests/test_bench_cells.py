"""Cells added as files alone run end to end on the CPU at a tiny size,
a tool that brings its own inputs among them: the port's jobs agree with
each plain reference, and a run whose timed path is broken underneath comes
out as not correct."""
import pytest

from benchmark import core
from faults import FAULTS, unitig_altered

CELLS = ["envfinder-tiny.genes3", "fmt-tiny.count", "pairs-tiny.count"]
#: each cell's metrics on a CPU: untraced, the end-to-end ones but the
#: device's; traced, the per-layer ones that name its configuration's cells
UNTRACED = {"job_s", "setup_s", "peak_host_gib"}
TRACED = {"envfinder-tiny.genes3": {"count_s", "bfs_s", "picture_s",
                                    "parse_s", "seed_s", "fifo_s",
                                    "table_builds"},
          "fmt-tiny.count": {"count_s", "parse_s", "dump_s"},
          "pairs-tiny.count": {"count_s", "parse_s", "dump_s"}}
#: counts that read 0 on these paths: the environment-finder's BFS searches
#: the sorted map and builds no table
ZERO = {"table_builds"}


def run_cell(root, cell, trace=0, seed=2**31 + 5, seconds=0.5):
    c = core.load_cell(root, cell)
    run = core.Run(c, seed, seconds, bool(trace), device="cpu",
                   scratch=str(root / "scratch"))
    try:
        return run.execute()
    finally:
        run.cleanup()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_new_cell_runs_and_agrees_with_its_reference(tiny_root, cell, trace):
    res = run_cell(tiny_root, cell, trace)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert all(v["value"] == 0 for v in res["compared"].values())
    assert list(res)[-1] == "compared"
    assert set(res["metrics"]) == (TRACED[cell] if trace else UNTRACED)
    assert all(m["value"] > 0 for k, m in res["metrics"].items()
               if k not in ZERO)
    assert all(res["metrics"][k]["value"] == 0 for k in ZERO
               if k in res["metrics"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                          fault):
    FAULTS[fault](monkeypatch)
    res = run_cell(tiny_root, cell)
    assert not res["correct"]
    assert any(v["value"] > v["limit"] for v in res["compared"].values())


def test_altered_unitig_is_not_correct(tiny_root, monkeypatch):
    unitig_altered(monkeypatch)
    res = run_cell(tiny_root, "envfinder-tiny.genes3")
    assert not res["correct"] and res["compared"]["unitigs_wrong"]["value"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny_root, cell):
    """At this size 32-bit keys rarely collide, so the test narrows to 12
    bits; the card's run of the control keeps 32 (benchmark/control.py)."""
    from benchmark.control import control_numbers
    narrow = control_numbers(tiny_root, cell, 7, 2, key_bits=12,
                             device="cpu", where=str(tiny_root))
    assert any(v["value"] > v["limit"] for v in narrow.values())
