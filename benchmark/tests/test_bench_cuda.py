"""On the card, at each cell's own size: the control comes out as not
correct on three seeds, and a run whose timed path is broken underneath
(the store left unchanged, half of each launch's batch left out) comes out
as not correct (the readings PERF.md keeps)."""
import json

import pytest

from benchmark import core
from conftest import ROOT
from faults import FAULTS

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: these run at the cell's size")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(card, cell, tmp_path):
    from benchmark.control import control_numbers
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        nums = control_numbers(ROOT, cell, seed, 3, device=card,
                               where=str(tmp_path))
        print(cell, seed, json.dumps(nums))
        assert any(v["value"] > v["limit"] for v in nums.values())


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct_at_cell_size(card, cell, fault,
                                                       monkeypatch, tmp_path):
    FAULTS[fault](monkeypatch)
    run = core.Run(core.load_cell(ROOT, cell), 2**31 + 21, 1.0, False,
                   device=card, scratch=str(tmp_path / "run"))
    try:
        res = run.execute()
    finally:
        run.cleanup()
    print(cell, fault, json.dumps(res["compared"]))
    assert not res["correct"]
