"""The port's streaming session (mixstage_tpu_torch/streaming.py), its
log-mel frontend (data/audio.py) and waveform serving against the JAX
package's, on the CPU.

* ``StreamingSession`` against the JAX one over the same single-window
  infer function: bit for bit, fed whole, in chunks and frame by frame,
  with the padded tail of ``finish``, at three hops.
* The numpy DSP copies equal JAX's bit for bit; ``log_mel_spectrogram`` in
  float64 equals the port's numpy ``log_mel_400`` to 1e-9, and is within
  1e-3 of ``log_mel_spectrogram_jax`` (float32 there), the tolerance of
  tests/test_rendering.py:159-168.
* ``build_waveform_serving_fn`` on a 64-mel generator against JAX's, same
  weights: rtol=atol=1e-4, as the mel serving path is held.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (jax_serving_factory, small_generators,
                                 style_rows)
from mixstage_tpu_torch import serve as tserve
from mixstage_tpu_torch.data import audio as taudio
from mixstage_tpu_torch.streaming import (StreamingSession,
                                          session_over_serving_fn)

MEL, F = 8, 3


def fake_infer(window, style):
    """Output frame i mixes mel frame i with the window mean (so it depends
    on the whole window, as the real bottleneck does) and the style id."""
    window = np.asarray(window, np.float32)
    mean = window.mean(axis=0, keepdims=True)
    return window[:, :F] + mean[:, :F] + np.float32(style)


def _stream_all(session, frames, chunk):
    pieces = [session.feed(frames[i:i + chunk])
              for i in range(0, len(frames), chunk)]
    pieces.append(session.finish())
    return np.concatenate([p for p in pieces if p.size], axis=0)


@pytest.mark.parametrize("hop", [16, 32, 64])
@pytest.mark.parametrize("chunk", [1, 7, 64, 203])
def test_streaming_session_matches_jax(hop, chunk):
    from mixstage_tpu.streaming import StreamingSession as JaxSession

    x = np.random.default_rng(hop + chunk).normal(size=(203, MEL)) \
        .astype(np.float32)
    ref = _stream_all(JaxSession(fake_infer, 2, window=64, hop=hop), x,
                      chunk)
    got = _stream_all(StreamingSession(fake_infer, 2, window=64, hop=hop), x,
                      chunk)
    assert got.shape == (203, F)
    np.testing.assert_array_equal(got, ref)


def test_streaming_finish_and_guards_match_jax():
    from mixstage_tpu.streaming import StreamingSession as JaxSession

    x = np.random.default_rng(0).normal(size=(40, MEL)).astype(np.float32)
    sessions = [cls(fake_infer, 1, window=64, hop=32)
                for cls in (JaxSession, StreamingSession)]
    for s in sessions:
        assert s.feed(x).size == 0 and s.frames_buffered == 40
    ref, got = (s.finish() for s in sessions)
    assert got.shape == (40, F)
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(RuntimeError):
        sessions[1].feed(x)
    for hop in (0, 65):
        with pytest.raises(ValueError):
            StreamingSession(fake_infer, 0, window=64, hop=hop)


def test_session_over_serving_fn_returns_host_frames():
    """The wrapper hands ``infer`` a batch of one and brings a tensor pose
    back to the host."""
    def serve(audio, style):
        assert audio.shape[0] == 1 and style.shape == (1,)
        return torch.from_numpy(fake_infer(audio[0], style[0])[None])

    x = np.random.default_rng(3).normal(size=(100, MEL)).astype(np.float32)
    got = _stream_all(session_over_serving_fn(serve, 1, hop=32), x, 30)
    ref = _stream_all(StreamingSession(fake_infer, 1, 64, 32), x, 30)
    np.testing.assert_array_equal(got, ref)


def test_dsp_copies_match_jax():
    from mixstage_tpu.data import audio as jaudio

    for f in (500.0, np.linspace(0, 8000, 17)):
        np.testing.assert_array_equal(taudio.hz_to_mel(f),
                                      jaudio.hz_to_mel(f))
    np.testing.assert_array_equal(taudio.mel_to_hz(np.arange(40.0)),
                                  jaudio.mel_to_hz(np.arange(40.0)))
    np.testing.assert_array_equal(
        taudio.mel_filterbank(16000, 512, 64, 125.0, 7500.0),
        jaudio.mel_filterbank(16000, 512, 64, 125.0, 7500.0, norm=None))
    y = np.random.default_rng(1).normal(size=(8000,))
    np.testing.assert_array_equal(
        taudio.stft_mag(y), jaudio.stft_mag(y, 512, 160, 400, center=False))
    np.testing.assert_array_equal(taudio.log_mel_400(y),
                                  jaudio.log_mel_400(y, 16000))


def test_log_mel_spectrogram_matches_numpy_and_jax():
    from mixstage_tpu.data.audio import log_mel_spectrogram_jax

    y = np.random.default_rng(0).normal(size=(2, 16000))
    out = taudio.log_mel_spectrogram(torch.from_numpy(y)).numpy()
    assert out.shape == (2, 97, 64) and out.dtype == np.float64
    for row in range(2):
        np.testing.assert_allclose(out[row], taudio.log_mel_400(y[row]),
                                   rtol=1e-9, atol=1e-9)
    ref = np.asarray(log_mel_spectrogram_jax(jnp.asarray(y, jnp.float32)))
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)


def test_waveform_serving_matches_jax():
    from mixstage_tpu.serve import build_waveform_serving_fn as jax_build

    jg, params, stats, port = small_generators(seed=7, mel=64)
    fn = tserve.build_waveform_serving_fn(port, device="cpu")
    wav = np.random.default_rng(2).normal(size=(2, fn.n_samples + 100)) \
        .astype(np.float32)
    sty = style_rows("soft", seed=3)
    out = fn(wav, sty).numpy()
    assert out.shape == (2, 64, 96)
    ref = np.asarray(jax_build(*jax_serving_factory(jg, params, stats),
                               use_pallas=False)(jnp.asarray(wav), sty))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="samples"):
        fn(wav[:, :1000], sty)
