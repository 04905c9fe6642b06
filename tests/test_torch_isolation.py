"""The port stands alone: nothing under src/repro_torch/ (nor chip_smoke.py,
nor the card's kernel tests, nor the port's examples/torch_*.py) imports
jax or the reference package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
#: the port, the card's smoke test, the card's kernel tests and the port's
#: examples (which run on a machine that has no jax)
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels_cuda.py"] \
    + sorted((ROOT / "examples").glob("torch_*.py"))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.wire")
    assert not _forbidden("repro_torch.core.wire")


def test_train_import_pulls_in_no_jax():
    code = ("import sys; import repro_torch.launch.train; "
            "import repro_torch.kernels.build; "
            "import repro_torch.kernels.efsign.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
