"""The port's int8 serving tier (``build_serving_fn(quantize_int8=True)``)
against the JAX one, same weights and ``calib``, with (B,) ids and (B, S)
soft rows.

* The plain route (``use_kernel=False``: the model's classifier and
  ``decoder_int8_plain``) against JAX ``build_serving_fn(use_pallas=False,
  quantize_int8=True)``: the int8 envelope of tests/test_pallas.py:110-115
  (mean |diff| / mean |ref| < 1e-3, max < 1%).  The two calibrate on
  features that agree to float rounding, so a few requantized LSBs may
  differ.
* The kernel route (its CPU plain versions here: K1's folded classifier,
  then the int8 decoder) to the same envelope: the classifier's BN fold
  moves the mixture weights by far less than a requantized LSB moves a
  pose (measured: the same mean and max as the plain route).
* Drift of the int8 tier against the port's own f32 serving lies in
  (1e-4, 0.10), the envelope of tests/test_pallas.py:160.
* ``quantize_int8`` without ``calib`` raises a ``ValueError`` naming it.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import (B, MEL, T, jax_serving_factory,
                                 small_generators, style_rows)
from mixstage_tpu_torch import serve as tserve


@pytest.fixture(scope="module")
def setup():
    from mixstage_tpu.serve import build_serving_fn as jax_build

    jg, params, stats, port = small_generators(seed=4)
    rng = np.random.default_rng(11)
    audio = rng.normal(size=(B, T, MEL)).astype(np.float32)
    calib = (rng.normal(size=(4, T, MEL)).astype(np.float32),
             np.array([0, 1, 1, 0], np.int32))
    jax_fn = jax_build(*jax_serving_factory(jg, params, stats),
                       use_pallas=False, quantize_int8=True, calib=calib)
    return port, audio, calib, jax_fn


def _style(kind):
    return np.array([0, 1], np.int32) if kind == "ids" \
        else style_rows("soft", seed=6)


@pytest.mark.parametrize("style", ["ids", "soft"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_int8_serving_matches_jax_int8_serving(setup, style, use_kernel):
    port, audio, calib, jax_fn = setup
    sty = _style(style)
    ref = np.asarray(jax_fn(jnp.asarray(audio), sty))
    fn = tserve.build_serving_fn(port, device="cpu", use_kernel=use_kernel,
                                 quantize_int8=True, calib=calib)
    assert fn.use_kernel is use_kernel and fn.quantize_int8
    out = fn(audio, sty).numpy()
    assert out.shape == (B, T, 96) and np.isfinite(out).all()
    scale = float(np.abs(ref).mean())
    err = np.abs(out - ref)
    print(f"int8 serving (use_kernel={use_kernel}, {style}) vs JAX: "
          f"{int((err > 1e-6 * scale).sum())} of {err.size} elements differ;"
          f" mean {err.mean() / scale:.2e}, max {err.max() / scale:.2e}")
    assert err.mean() / scale < 1e-3
    assert err.max() / scale < 0.01


@pytest.mark.parametrize("use_kernel", [False, True])
def test_int8_drift_against_f32_serving(setup, use_kernel):
    port, audio, calib, _ = setup
    sty = _style("soft")
    p32 = tserve.build_serving_fn(port, device="cpu",
                                  use_kernel=use_kernel)(audio, sty).numpy()
    p8 = tserve.build_serving_fn(port, device="cpu", use_kernel=use_kernel,
                                 quantize_int8=True, calib=calib)(audio, sty)
    rel = np.abs(p8.numpy() - p32).mean() / np.abs(p32).mean()
    assert 1e-4 < rel < 0.10, rel


def test_int8_needs_calib(setup):
    with pytest.raises(ValueError, match="calib"):
        tserve.build_serving_fn(setup[0], device="cpu", quantize_int8=True)
