"""The port stands alone: no file of ``mixstage_tpu_torch``, ``tools/`` nor
``chip_smoke.py`` imports jax, flax, optax or the JAX package, and importing
the port loads no JAX."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mixstage_tpu"}
FILES = sorted((ROOT / "mixstage_tpu_torch").rglob("*.py")) + \
    sorted((ROOT / "tools").glob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, mixstage_tpu_torch, mixstage_tpu_torch.serve, "
            "mixstage_tpu_torch.serving, mixstage_tpu_torch.interop, "
            "mixstage_tpu_torch.train, mixstage_tpu_torch.train.losses, "
            "mixstage_tpu_torch.ops.cuda.train_decoder, "
            "mixstage_tpu_torch.models.speech2gesture; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
