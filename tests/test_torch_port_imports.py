"""The port stands alone: no file of ``mixstage_tpu_torch``, ``tools/``,
``chip_smoke.py`` nor the multi-rank tests' children imports jax, flax,
optax or the JAX package, nor the host libraries the card's machine lacks
or the port replaced (pandas, scikit-learn, joblib, PyYAML); and importing
the port loads no JAX."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mixstage_tpu"}
# the JAX package's host libraries the port does without: the master CSV
# is read with ``csv``, the k-means fit is its own, the thread map runs on
# ``concurrent.futures``, the OpenPose YAML reader is not ported
HOST_FORBIDDEN = {"pandas", "sklearn", "joblib", "yaml"}
# the multi-rank tests' children run the port without JAX too
FILES = sorted((ROOT / "mixstage_tpu_torch").rglob("*.py")) + \
    sorted((ROOT / "tools").glob("*.py")) + [ROOT / "chip_smoke.py"] + \
    sorted((ROOT / "tests").glob("_torch_port_parallel*.py"))


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


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_replaced_host_library_imports(path):
    bad = sorted(set(_imported_roots(path)) & HOST_FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, mixstage_tpu_torch, mixstage_tpu_torch.serve, "
            "mixstage_tpu_torch.serving, mixstage_tpu_torch.interop, "
            "mixstage_tpu_torch.train, mixstage_tpu_torch.train.losses, "
            "mixstage_tpu_torch.ops.cuda.train_decoder, "
            "mixstage_tpu_torch.ops.cuda.quant, "
            "mixstage_tpu_torch.streaming, mixstage_tpu_torch.data.audio, "
            "mixstage_tpu_torch.models.speech2gesture, "
            "mixstage_tpu_torch.models.style_classifier, "
            "mixstage_tpu_torch.models.registry, "
            "mixstage_tpu_torch.train.state, mixstage_tpu_torch.train.steps, "
            "mixstage_tpu_torch.interop.weights, "
            "mixstage_tpu_torch.config, mixstage_tpu_torch.bookkeeping, "
            "mixstage_tpu_torch.data.common, mixstage_tpu_torch.data.hdf5, "
            "mixstage_tpu_torch.data.skeleton, "
            "mixstage_tpu_torch.data.synthetic, "
            "mixstage_tpu_torch.data.dataset, "
            "mixstage_tpu_torch.data.transforms, "
            "mixstage_tpu_torch.data.prefetch, "
            "mixstage_tpu_torch.evaluation, "
            "mixstage_tpu_torch.parallel, "
            "mixstage_tpu_torch.parallel.mesh, "
            "mixstage_tpu_torch.parallel.multihost, "
            "mixstage_tpu_torch.train.profiling, "
            "mixstage_tpu_torch.train.sampling, "
            "mixstage_tpu_torch.train.trainer, "
            "mixstage_tpu_torch.cli.train, mixstage_tpu_torch.cli.sample, "
            "mixstage_tpu_torch.cli.serve, mixstage_tpu_torch.cli.export, "
            "mixstage_tpu_torch.cli.import_torch, mixstage_tpu_torch.export, "
            "mixstage_tpu_torch.interop.torch_import; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN | HOST_FORBIDDEN)!r}); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
