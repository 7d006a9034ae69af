"""On the card, at the reads-classifier cell's own size: the control (32
key bits) comes out as not correct on three seeds, and so does a run whose
classifier is broken underneath (half the coverage lookups dropped, a found
pair routed to not_found, a bin record altered); the readings PERF.md
keeps."""
import json

import pytest

from benchmark import core
from classify_faults import FAULTS
from conftest import ROOT

CELL = "fmt-classify-k31.recipient-pairs"


@pytest.fixture
def card(monkeypatch):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: these run at the cell's size")
    # the launcher sets MC_DEVICE_CLASSIFY; the test gives it back
    monkeypatch.setenv("MC_DEVICE_CLASSIFY", "0")
    return "cuda"


@pytest.mark.cuda
def test_control_fails_at_cell_size(card, tmp_path):
    from benchmark.control import control_numbers
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        nums = control_numbers(ROOT, CELL, seed, 3, device=card,
                               where=str(tmp_path))
        print(CELL, seed, json.dumps(nums))
        assert any(v["value"] > v["limit"] for v in nums.values())


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_classifier_is_not_correct_at_cell_size(card, fault,
                                                       monkeypatch, tmp_path):
    FAULTS[fault](monkeypatch)
    run = core.Run(core.load_cell(ROOT, CELL), 2**31 + 21, 1.0, False,
                   device=card, scratch=str(tmp_path / "run"))
    try:
        res = run.execute()
    finally:
        run.cleanup()
    print(CELL, fault, json.dumps(res["compared"]))
    assert not res["correct"]
