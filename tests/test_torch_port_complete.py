"""The port is whole: every ``.py`` module under ``src/repro/`` has its
counterpart at the same relative path under ``src/repro_torch/``, apart
from a named list, each with its reason; and no module of the port (nor
``chip_smoke.py``) imports ``jax`` or the JAX package."""
import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

# reference modules without a file of the same path in the port, and why
NO_COUNTERPART = {
    "compat.py": "shims for JAX's module layout (shard_map, axis_size): "
                 "nothing to port",
    "launch/hlo_analysis.py": "parses XLA HLO; its job (a step's flops, "
                              "HBM and collective bytes) is "
                              "launch/cost_model.py's, on an eager trace",
}


def _modules(root: Path) -> set[str]:
    return {p.relative_to(root).as_posix() for p in root.rglob("*.py")
            if "__pycache__" not in p.parts}


def test_every_reference_module_has_its_counterpart():
    missing = _modules(REF) - _modules(PORT)
    assert missing == set(NO_COUNTERPART), sorted(missing)
    assert (PORT / "launch" / "cost_model.py").is_file()


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            out.add(node.module)
    return out


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "tests" / "_torch_dist.py"]
    bad = {}
    for f in files:
        hits = {m for m in _imports(f)
                if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")}
        if hits:
            bad[str(f.relative_to(ROOT))] = sorted(hits)
    assert not bad, bad
