"""Fixtures of the benchmark's CPU tests: the checkout's root on sys.path,
and a temporary copy of the benchmark with tiny cells added as files and
entries alone, one of them a stand-in tool that brings its own inputs."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: sizes at which a job takes a fraction of a second on the CPU (each
#: applied where the configuration has the key); abundances less skewed
#: than the cells', so that strains lie above --coverage and the
#: environments branch
TINY = {"species": 3, "strain_species": 2, "genome_bp": 20000, "reads": 8000,
        "abundance_sigma": 0.5, "panel_genes": 4, "gene_bp": 300,
        "gene_host_ranks": [[0, 1], [1, 2], [2, 5]], "maxradius": 100}
TINY_CELLS = {"envfinder-tiny.genes3": ("envfinder-k31", "genes3"),
              "fmt-tiny.count": ("fmt-k31", "count")}
#: a tiny cell whose tool brings an input hook: kmer-counter over the mate
#: files of a paired-end run (-i <mate 1> <mate 2>), on fmt-k31's
#: community; its launcher, reference and hook are the files of standin/,
#: copied in by name, and its configuration states the fragment
STAND_IN = {"pairs-tiny.count": ("fmt-k31", "count")}
STAND_IN_TOOL = {"tool": "kmer-counter-pairs", "fragment_bp": 400}
STAND_IN_DIR = Path(__file__).resolve().parent / "standin"


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ with one tiny configuration
    per tool and a cell on each, added without editing a file the
    benchmark has."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in STAND_IN_DIR.rglob("*.py"):
        dest = root / "benchmark" / path.relative_to(STAND_IN_DIR)
        dest.parent.mkdir(exist_ok=True)
        shutil.copy(path, dest)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (base, traffic) in {**TINY_CELLS, **STAND_IN}.items():
        conf = next(c for c in spec["configs"] if c["name"] == base)
        cfg = json.loads((ROOT / conf["file"]).read_text())
        name = cell.split(".")[0]
        cfg.update({k: v for k, v in TINY.items() if k in cfg}, name=name)
        if cell in STAND_IN:
            cfg.update(STAND_IN_TOOL)
        path = f"benchmark/configs/{name}.json"
        (root / path).write_text(json.dumps(cfg))
        spec["configs"].append({**conf, "name": name, "file": path})
        spec["workloads"].append({"name": cell, "config": name,
                                  "traffic": traffic, "chips": 1,
                                  "why": "tiny, for the CPU tests"})
        for m in spec["per_layer"]:
            if any(w.startswith(base + ".") for w in m.get("workloads", [])):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
