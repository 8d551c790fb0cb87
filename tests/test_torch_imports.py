"""The port stands alone: no module of ``sttode_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and importing the port
builds nothing.

The check reads the sources (AST): this environment may import jax at
interpreter start, so ``sys.modules`` cannot tell."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "sttode_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or \
        name == "sttode_tpu" or name.startswith("sttode_tpu.")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
            if node.module == "sttode_tpu":
                yield from (f"sttode_tpu.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom sttode_tpu.nn import core\n"
                 "from sttode_tpu import serving\nimport sttode_tpu_torch\n")
    assert [m for m in _imports(f) if _forbidden(m)] == [
        "jax.numpy", "sttode_tpu.nn", "sttode_tpu", "sttode_tpu.serving"]


def test_import_builds_nothing():
    import sttode_tpu_torch  # noqa: F401
    from sttode_tpu_torch.kernels import _build

    assert _build._lib is None


MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in (ROOT / "sttode_tpu_torch").rglob("*.py")
    if p.name != "__init__.py")


@pytest.mark.parametrize("name", [m for m in MODULES if ".cli." in m
                                  or m.endswith(("packed_mhgsa", "evaluation",
                                                 "checkpoint", "schedulers",
                                                 ".nba", "metrics",
                                                 "profiling", ".eth_ucy",
                                                 ".sdd", ".batching",
                                                 ".prefetch", ".binding",
                                                 ".graph", ".counters",
                                                 ".guards", ".supervisor",
                                                 ".logging", ".flat_params",
                                                 ".visualize", ".transformer",
                                                 ".ode_block", ".euclidean",
                                                 ".riemannian", ".hyperbolic",
                                                 ".dot_attention", ".gumbel",
                                                 ".delta", ".analysis"))])
def test_module_import_builds_and_parses_nothing(monkeypatch, name):
    """Importing a module of the port (the CLIs among them) compiles no
    kernel and reads no command line: a bad argv changes nothing."""
    import importlib

    from sttode_tpu_torch.kernels import _build

    monkeypatch.setattr("sys.argv", ["x", "--no-such-flag"])
    importlib.import_module(name)
    assert _build._lib is None


def test_visualize_imports_matplotlib_lazily():
    """``utils.visualize`` imports matplotlib inside its plot functions, not
    at module level: the card's machine may not have it."""
    tree = ast.parse((ROOT / "sttode_tpu_torch" / "utils" /
                      "visualize.py").read_text())
    top = [a.name for node in tree.body if isinstance(node, ast.Import)
           for a in node.names] + [node.module for node in tree.body
                                   if isinstance(node, ast.ImportFrom)]
    assert not any(m and m.startswith("matplotlib") for m in top), top
    assert any(isinstance(node, ast.Import) and any(
        a.name.startswith("matplotlib") for a in node.names)
        for node in ast.walk(tree))


# JAX names the port leaves out: what serves only the TPU or XLA (ROADMAP
# "Not to port"); ode/solvers' Pytree alias is the port's Tree
NOT_PORTED = {
    "utils/compilation_cache": None,
    "kernels/mhgsa": {"FLASH_GRAM_3PASS"},
    "kernels/packed_mhgsa": {"packed_vmem_fit"},
    "models/sttode": {"GRU_UNROLL", "SELECT_FUSED_MIN_ROWS",
                      "SELECT_GRU_HOIST_MAX_ROWS"},
    "ode/solvers": {"Pytree"},
    "utils/profiling": {"PEAK_HBM_GBPS", "PEAK_TFLOPS", "cost_analysis",
                        "roofline"},
}


def _top_level_names(package: str) -> dict:
    """Module (path under the package, no suffix) → its public top-level
    names: functions, classes, assigned names, and an __init__'s imports."""
    out = {}
    for path in sorted((ROOT / package).rglob("*.py")):
        names = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                names.add(node.target.id)
            elif isinstance(node, ast.ImportFrom) and \
                    path.name == "__init__.py":
                names.update(a.asname or a.name for a in node.names)
        rel = path.relative_to(ROOT / package).with_suffix("")
        out[str(rel)] = {n for n in names if not n.startswith("_")}
    return out


def test_port_has_every_jax_name_but_the_ones_not_ported():
    """The name comparison of the two packages: every module of the JAX
    package has a counterpart with each of its public top-level names,
    except those listed in NOT_PORTED (None: the whole module)."""
    jax_names = _top_level_names("sttode_tpu")
    port_names = _top_level_names("sttode_tpu_torch")
    missing = {}
    for mod, names in jax_names.items():
        if mod not in port_names:
            missing[mod] = None
        elif names - port_names[mod]:
            missing[mod] = names - port_names[mod]
    assert missing == NOT_PORTED
