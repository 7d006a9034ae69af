"""The port's surface holds every public name of the JAX package.

Both packages are parsed with `ast`; neither is imported. For each module
file of metacherchant_tpu/, every public top-level function and class,
every public method of those classes (plus __init__ and __call__) and every
module-level UPPER_CASE constant must have a counterpart in the module of
metacherchant_tpu_torch/ at the same relative path: a definition or an
import of the same name (a method: one defined in the class, or in a base
class the port's module defines or imports from the port).

The only way round is EXEMPT, which maps (module, name) -- name "*" for a
whole module -- to the port's counterpart. test_exemptions_are_live keeps
it honest: every entry names something the JAX package still has and the
port still lacks.
"""
import ast
import functools
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "metacherchant_tpu"
PORT = REPO / "metacherchant_tpu_torch"
MODULES = sorted(p.relative_to(JAX_PKG).as_posix()
                 for p in JAX_PKG.rglob("*.py"))
WHOLE = "*"
_UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")
_DUNDER = ("__init__", "__call__")

EXEMPT = {
    ("ops/pallas_kmers.py", WHOLE):
        "the Pallas kernel B1: ops/extract_cuda.py and csrc/extract_kmers.cu",
    ("ops/sortcount.py", "fast_scalar"):
        "JAX device-scalar readback: torch's .item()",
    ("ops/sortcount.py", "to_host"):
        "JAX device-array readback: torch's .cpu()",
    ("parallel/sharded_count.py", "make_mesh"):
        "jax.sharding mesh factory: parallel/distributed.global_mesh",
    ("parallel/sharded_count.py", "make_sharded_count_step"):
        "shard_map factory: parallel/sharded_count.ShardedCounter",
    ("parallel/sharded_count.py", "make_grow_step"):
        "shard_map factory: parallel/sharded_count.ShardedCounter",
    ("parallel/sharded_bfs.py", "make_sharded_bfs"):
        "shard_map factory: parallel/sharded_bfs.run_sharded_bfs",
    ("utils/__init__.py", WHOLE): "an empty package",
}


def _top_level(tree: ast.Module) -> list[ast.stmt]:
    """Module-level statements, looking inside if/try blocks."""
    out: list[ast.stmt] = []

    def walk(stmts):
        for n in stmts:
            if isinstance(n, (ast.If, ast.Try)):
                walk(n.body)
                walk(n.orelse)
                for h in getattr(n, "handlers", []):
                    walk(h.body)
                walk(getattr(n, "finalbody", []))
            else:
                out.append(n)
    walk(tree.body)
    return out


def _assigned(n: ast.stmt) -> list[str]:
    targets = n.targets if isinstance(n, ast.Assign) else [n.target]
    return [e.id for t in targets for e in ast.walk(t)
            if isinstance(e, ast.Name)]


@functools.lru_cache(maxsize=None)
def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def public_names(rel: str) -> set[str]:
    """The JAX module's public surface: 'f', 'C', 'C.m', 'CONST'."""
    names: set[str] = set()
    for n in _top_level(_parse(JAX_PKG / rel)):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not n.name.startswith("_"):
                names.add(n.name)
        elif isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            names.add(n.name)
            names.update(
                f"{n.name}.{m.name}" for m in n.body
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                and (not m.name.startswith("_") or m.name in _DUNDER))
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            names.update(x for x in _assigned(n) if _UPPER.match(x))
    return names


def _resolve(rel: str, node: ast.ImportFrom) -> str | None:
    """The port module a relative `from ... import` names, or None."""
    if node.level == 0:
        return None
    base = Path(rel).parent
    for _ in range(node.level - 1):
        base = base.parent
    if not node.module:
        cands = [base / "__init__.py"]
    else:
        mod = base.joinpath(*node.module.split("."))
        cands = [mod.with_suffix(".py"), mod / "__init__.py"]
    for cand in cands:
        if (PORT / cand).exists():
            return cand.as_posix()
    return None


@functools.lru_cache(maxsize=None)
def _class_members(rel: str, cls: str, depth: int = 0) -> frozenset[str]:
    """Names a class of the port's module `rel` defines, with its bases'."""
    if depth > 8:
        return frozenset()
    members: set[str] = set()
    for n in _top_level(_parse(PORT / rel)):
        if isinstance(n, ast.ClassDef) and n.name == cls:
            for m in n.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                    members.add(m.name)
                elif isinstance(m, (ast.Assign, ast.AnnAssign)):
                    members.update(_assigned(m))
            for b in n.bases:
                if isinstance(b, ast.Name):
                    members |= _class_members(rel, b.id, depth + 1)
        elif isinstance(n, ast.ImportFrom):
            for a in n.names:
                if (a.asname or a.name) == cls:
                    src = _resolve(rel, n)
                    if src is not None:
                        members |= _class_members(src, a.name, depth + 1)
    return frozenset(members)


def port_names(rel: str) -> set[str]:
    """What the port's module at `rel` offers: top-level definitions and
    imports, and 'C.m' for the members of each class C whose methods the
    JAX module's surface lists."""
    path = PORT / rel
    if not path.exists():
        return set()
    names: set[str] = set()
    for n in _top_level(_parse(path)):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Import):
            names.update((a.asname or a.name).split(".")[0] for a in n.names)
        elif isinstance(n, ast.ImportFrom):
            names.update(a.asname or a.name for a in n.names)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            names.update(_assigned(n))
    classes = {n.split(".")[0] for n in public_names(rel) if "." in n}
    for cls in classes & names:
        names.update(f"{cls}.{m}" for m in _class_members(rel, cls))
    return names


@pytest.mark.parametrize("rel", MODULES)
def test_port_has_every_public_name(rel):
    if (rel, WHOLE) in EXEMPT:
        return
    assert (PORT / rel).exists(), f"metacherchant_tpu_torch/{rel} is missing"
    have = port_names(rel)
    missing = sorted(name for name in public_names(rel) - have
                     if (rel, name) not in EXEMPT)
    assert not missing, (f"metacherchant_tpu_torch/{rel} lacks the JAX "
                         f"package's {missing}")


def test_exemptions_are_live():
    for (rel, name), reason in EXEMPT.items():
        assert reason
        assert (JAX_PKG / rel).exists(), f"{rel}: gone from the JAX package"
        if name == WHOLE:
            assert not (PORT / rel).exists(), f"{rel}: the port now has it"
            continue
        assert name in public_names(rel), f"{rel}:{name}: gone from JAX"
        assert name not in port_names(rel), f"{rel}:{name}: the port has it"
