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
