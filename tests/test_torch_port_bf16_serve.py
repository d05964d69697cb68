"""The port's serving path on a bfloat16 model against the JAX package's
bf16 serving, same weights.

JAX serves a ``dtype=bfloat16`` generator through its Pallas route: the
features in bf16, the cluster classifier and the mixture decoder BN-folded
through ``fused_mixstage_decoder`` with float32 weights, softmax and the
mixture in bf16.  Here that route runs with the kernel in interpret mode,
as the JAX package's own tests run it (its ``use_pallas=False`` route
raises at bf16: ``folded_decoder_xla`` hands bf16 features and float32
weights to ``lax.conv_general_dilated``).  The port's K1 route (its plain
version on the CPU) computes the same function.

Tolerances: the bf16 rule (``_torch_port_helpers.bf16_rule``) against
JAX, with JAX's float32 serving on the same bf16-valued audio as the
truth; 1% (mean |Δ| / mean |pose|, the serving contract) from the port's
own float32 serving, on both routes and on the waveform path.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import (B, MEL, SMALL, T, as_np, bf16_rule,
                                 bf16_values, jax_serving_factory,
                                 small_generators, style_rows)
from mixstage_tpu.models.mix_stage import \
    JointLateClusterSoftStyle4_G as JaxG
from mixstage_tpu_torch import serve as tserve
from mixstage_tpu_torch.interop import load_flax_state
from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G

DRIFT_TOL = 0.01


@pytest.fixture(scope="module")
def setup():
    jg, params, stats, port32 = small_generators(seed=2)
    port16 = JointLateClusterSoftStyle4_G(**SMALL, dtype=torch.bfloat16)
    load_flax_state(port16, params, stats)
    audio = bf16_values(np.random.default_rng(9).normal(size=(B, T, MEL))
                        .astype(np.float32))
    return jg, params, stats, port32, port16.eval(), audio


def _drift(out, ref):
    out, ref = as_np(out), as_np(ref)
    return float(np.abs(out - ref).mean() / np.abs(ref).mean())


@pytest.mark.parametrize("style", ["ids", "soft"])
def test_bf16_serving_follows_jax_bf16(setup, style, monkeypatch):
    from mixstage_tpu import serve as jserve
    from mixstage_tpu.ops.pallas.fused_conv import fused_mixstage_decoder

    jg, params, stats, _, port16, audio = setup
    sty = (np.array([0, 1], np.int32) if style == "ids"
           else style_rows("soft", seed=6))
    truth = jserve.build_serving_fn(*jax_serving_factory(jg, params, stats),
                                    use_pallas=False)(jnp.asarray(audio),
                                                      sty)
    monkeypatch.setattr(jserve, "fused_mixstage_decoder", functools.partial(
        fused_mixstage_decoder, interpret=True))
    jg16 = JaxG(**SMALL, dtype=jnp.bfloat16)
    q = jserve.build_serving_fn(*jax_serving_factory(jg16, params, stats),
                                use_pallas=True)(
        jnp.asarray(audio, jnp.bfloat16), sty)
    fn = tserve.build_serving_fn(port16, device="cpu", use_kernel=True)
    assert fn.dtype == torch.bfloat16
    out = fn(audio, sty)
    assert out.dtype == torch.float32 and out.shape == (B, T, 96)
    dp, dq, ok = bf16_rule(as_np(out), as_np(q), as_np(truth))
    assert ok, (dp, dq)


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel_route", "plain_route"])
def test_bf16_serving_within_contract_of_f32(setup, use_kernel):
    _, _, _, port32, port16, audio = setup
    sty = style_rows("soft", seed=7)
    ref = tserve.build_serving_fn(port32, device="cpu",
                                  use_kernel=use_kernel)(audio, sty)
    out = tserve.build_serving_fn(port16, device="cpu",
                                  use_kernel=use_kernel)(audio, sty)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert 0 < _drift(out, ref) <= DRIFT_TOL, _drift(out, ref)


def test_bf16_waveform_serving_within_contract_of_f32():
    _, params, stats, _ = small_generators(seed=3, mel=64)
    models = {}
    for dt in (torch.float32, torch.bfloat16):
        models[dt] = JointLateClusterSoftStyle4_G(**SMALL, dtype=dt)
        load_flax_state(models[dt], params, stats)
    fn32, fn16 = (tserve.build_waveform_serving_fn(models[dt], device="cpu")
                  for dt in (torch.float32, torch.bfloat16))
    wav = (0.1 * np.random.default_rng(10).normal(size=(2, fn16.n_samples))
           ).astype(np.float32)
    out = fn16(wav, [0, 1])
    assert out.dtype == torch.float32 and out.shape == (2, 64, 96)
    assert _drift(out, fn32(wav, [0, 1])) <= DRIFT_TOL
