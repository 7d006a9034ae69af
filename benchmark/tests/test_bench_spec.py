"""BENCHMARK.json keeps to its schema, and every cell, configuration,
traffic mix, job launcher, reference and per-layer metric it names loads by
name."""
import json
import re

import pytest

from benchmark import core
from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_lines():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in SPEC[key]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("benchmark/configs/")
        assert all(NAME.match(r) for r in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.match(w["why"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_metrics_reach_every_cell():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for cell in CELLS:
        assert len([m for m in SPEC["end_to_end"] if cell in
                    m.get("workloads", CELLS)]) >= 2
        assert any(cell in m.get("workloads", CELLS)
                   for m in SPEC["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = core.load_cell(ROOT, cell)
    assert c.cfg["name"] == next(w["config"] for w in SPEC["workloads"]
                                 if w["name"] == cell)
    assert callable(c.launcher.argv)
    assert c.inputs is None or callable(c.inputs.make)
    for fn in ("solve", "read_outputs", "compare"):
        assert callable(getattr(c.reference, fn))
    assert set(c.reference.LIMITS.values()) == {0}
    assert c.per_layer and all(callable(mod.read) and
                               isinstance(mod.WRAPS, tuple)
                               for _, mod in c.per_layer)


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cut(conf):
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"]
    assert cfg["reduced"] == conf["reduced"]
    assert set(cfg["reduced"]) <= set(cfg["published"])
    assert cfg["source"] and cfg["assumed"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        core.load_cell(ROOT, "no-such.cell")
