"""No file of the benchmark imports JAX or the JAX package, the references
import nothing of the port, and a run loads neither JAX nor the JAX
package (module names compared by their whole top-level name)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import core
from conftest import ROOT

BENCH = ROOT / "benchmark"
PORT = "metacherchant_tpu_torch"


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax(path):
    assert not core.forbidden_modules(_imports(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert PORT not in tops and not core.forbidden_modules(tops)
    assert tops <= {"__future__", "os", "collections", "numpy", "torch",
                    "benchmark"}
    assert {n for n in _imports(path) if n.startswith("benchmark")} <= \
        {"benchmark.reference"}


def test_a_run_loads_no_jax(tiny_root):
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
sys.modules["jax"] = None  # an import of JAX would raise
from benchmark import core
from pathlib import Path
root = Path({str(tiny_root)!r})
run = core.Run(core.load_cell(root, "envfinder-tiny.genes3"), 3, 0.2,
               True, device="cpu", scratch={str(tiny_root / "s")!r})
res = run.execute()
run.cleanup()
assert res["correct"], res
print("LOADED", core.forbidden_modules(
    n for n, m in sys.modules.items() if m is not None))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout
