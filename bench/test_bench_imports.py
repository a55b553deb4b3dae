"""No module the benchmark runs imports JAX or the JAX package ``repro``,
and the reference imports nothing of the program either. Every module the
harness and the reference import is parsed, following imports of the
repository's own packages (``bench``, ``repro_torch``) to the end; a name
is compared by its top-level part (before the first dot) as a whole, since
``repro_torch`` begins with ``repro``."""
from __future__ import annotations

import ast
from pathlib import Path

from bench._testing import ROOT

BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
OWN = {"bench": ROOT / "bench", "repro_torch": ROOT / "src" / "repro_torch"}


def module_file(name: str) -> Path | None:
    top, *rest = name.split(".")
    if top not in OWN:
        return None
    base = OWN[top].joinpath(*rest)
    for cand in (base.with_suffix(".py"), base / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def imports(path: Path) -> set[str]:
    """Absolute names a module imports (``from a import b`` gives both ``a``
    and ``a.b``, which may be a module)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level:
                continue
            out.add(node.module)
            out |= {f"{node.module}.{a.name}" for a in node.names}
    return out


def closure(start: list[Path]) -> dict[Path, set[str]]:
    seen, todo = {}, list(start)
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen[p] = imports(p)
        for name in seen[p]:
            f = module_file(name)
            if f is not None and f not in seen:
                todo.append(f)
    return seen


def tops(found: dict[Path, set[str]]) -> dict[str, set[str]]:
    return {str(p.relative_to(ROOT)): {n.split(".")[0] for n in names}
            for p, names in found.items()}


def test_harness_imports_neither_jax_nor_the_jax_package():
    start = [p for p in BENCH.rglob("*.py") if not p.name.startswith("test_")]
    found = tops(closure(start))
    assert any(f.startswith("src/repro_torch") for f in found)
    bad = {f: t & FORBIDDEN for f, t in found.items() if t & FORBIDDEN}
    assert not bad


def test_reference_imports_nothing_of_the_program():
    start = list((BENCH / "reference").glob("*.py"))
    found = tops(closure(start))
    bad = {f: t & (FORBIDDEN | {"repro_torch"}) for f, t in found.items()
           if t & (FORBIDDEN | {"repro_torch"})}
    assert not bad
    assert all(f.startswith("bench/reference") for f in found)


def test_the_check_sees_through_names(tmp_path):
    """The check itself: whole top-level names, not prefixes."""
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom repro.core import gumbel\n"
                 "import jax.numpy as jnp\nimport jaxtyping\n")
    assert {n.split(".")[0] for n in imports(f)} == {
        "repro_torch", "repro", "jax", "jaxtyping"}
    assert {n.split(".")[0] for n in imports(f)} & FORBIDDEN == {"repro",
                                                                  "jax"}
