"""Import guard: the port, its chip smoke script and its GPU scripts import
neither JAX nor the JAX package (``repro``), not even a numpy-only module
of it."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("*.py"))


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists()
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_guard_catches_jax_and_repro_but_not_repro_torch():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.binning")
    assert _forbidden("repro") and not _forbidden("repro_torch.core")


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.core, "
            "repro_torch.data, repro_torch.kernels.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
