"""The port's reads-classifier against the benchmark's plain reference
(benchmark/reference/reads-classifier.py, loaded by its path), on a seeded
tiny donor and recipient made by the benchmark's input hook of the tool: a
donor's -b 1 dump and the recipient's mate files. The six bins agree with
the reference's on the host route and the device route (MC_DEVICE_CLASSIFY
on the CPU device), with the tool's default interval and --interval95."""
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from metacherchant_tpu_torch.runner import main as port_main

ROOT = Path(__file__).resolve().parents[1]
#: a donor shallow enough that the Poisson interval decides some reads
#: (z = 1 and z = 1.96 then bin them differently)
TINY = {"species": 3, "strain_species": 2, "genome_bp": 20000, "reads": 3000,
        "abundance_sigma": 0.5, "recipient_pairs": 2000}


def _load(rel: str):
    name = "bench_" + rel.replace("/", "_").replace("-", "_")[:-3]
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def classify_case(tmp_path_factory):
    """The tiny configuration, the hook's files and the reference."""
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(str(ROOT))
    try:
        from benchmark import datagen
        hook = _load("benchmark/inputs/reads-classifier.py")
        ref = _load("benchmark/reference/reads-classifier.py")
        cfg = json.loads(
            (ROOT / "benchmark/configs/fmt-classify-k31.json").read_text())
        cfg.update(TINY)
        where = tmp_path_factory.mktemp("classify_inputs")
        inputs = datagen.make_inputs(cfg, {"genes_per_job": 0}, 2**31 + 3,
                                     str(where), "cpu", hook)
    finally:
        mp.undo()
    return cfg, inputs.files, ref


@pytest.mark.parametrize("interval95", [False, True],
                         ids=["z1", "interval95"])
@pytest.mark.parametrize("device_classify", ["", "1"], ids=["host", "device"])
def test_bins_agree_with_the_plain_reference(classify_case, device_classify,
                                             interval95, tmp_path,
                                             monkeypatch):
    cfg, files, ref = classify_case
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv("MC_DEVICE_CLASSIFY", device_classify)
    out = tmp_path / "out"
    assert port_main(["-t", "reads-classifier", "-k", str(cfg["k"]),
                      "-i", files["dump"],
                      "-r", files["mate1"], files["mate2"],
                      "-o", str(out), "--work-dir", str(tmp_path / "wd")]
                     + (["--interval95"] if interval95 else [])) == 0
    z = 1.96 if interval95 else cfg["z"]
    (want,) = ref.solve(dict(cfg, z=z), None, [None], torch.device("cpu"),
                        files=files)
    got = ref.read_outputs(cfg, SimpleNamespace(out_dir=str(out)))
    assert ref.compare(want, got) == dict.fromkeys(ref.LIMITS, 0)
    assert all(sum(want[b].values()) >= 100 for b in want)
    if interval95:  # the wider interval bins some pairs otherwise
        (plain,) = ref.solve(cfg, None, [None], torch.device("cpu"),
                             files=files)
        assert plain["found"] != want["found"]
