"""The log-mel speech frontend of the waveform serving path.

The port's own copy of the numpy DSP of ``mixstage_tpu/data/audio.py:24-135``
(Slaney mel scale, matching librosa's defaults) as far as ``log_mel_400``
uses it, and ``log_mel_spectrogram``, the counterpart of
``log_mel_spectrogram_jax`` (``:138-161``) on tensors, so that raw 16 kHz
audio becomes log-mel frames on the card (``torch.fft.rfft``).  Both take
audio at 16 kHz: n_fft 512, hop 160, a 400-sample Hann window, no
centring, 64 mel bins from 125 Hz to 7.5 kHz, no filterbank norm.

``Audio`` is the audio modality of the data pipeline
(``mixstage_tpu/data/audio.py:208-276``): the rows per second of each
stored representation and its h5 key.  Its offline preprocessing belongs to
``cli/preprocess``, not ported yet (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import numpy as np
import torch

from mixstage_tpu_torch.data.common import MissingData, Modality

SR, N_FFT, HOP, WIN, N_MELS, FMIN, FMAX, EPS = (16000, 512, 160, 400, 64,
                                                125.0, 7500.0, 1e-6)


def hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep,
                    mel)


def mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """Triangular mel filterbank without norm, (n_mels, 1 + n_fft//2)."""
    fft_freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    return np.maximum(0.0, np.minimum(lower, upper))


def hann_window() -> np.ndarray:
    """The periodic Hann window of WIN samples (librosa's default),
    zero-padded to N_FFT on both sides."""
    window = np.hanning(WIN + 1)[:-1]
    pad = (N_FFT - WIN) // 2
    return np.pad(window, (pad, N_FFT - WIN - pad))


def stft_mag(y: np.ndarray) -> np.ndarray:
    """Magnitude STFT of 16 kHz audio, (frames, 1 + N_FFT//2)."""
    n_frames = 1 + (len(y) - N_FFT) // HOP
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    return np.abs(np.fft.rfft(y[idx] * hann_window()[None, :], n=N_FFT,
                              axis=-1))


def log_mel_400(y: np.ndarray) -> np.ndarray:
    """16 kHz audio → (frames, 64) log magnitude mel (the reference's
    ``log_mel_400``)."""
    mel = stft_mag(np.asarray(y).reshape(-1)) @ mel_filterbank(
        SR, N_FFT, N_MELS, FMIN, FMAX).T
    return np.log(np.where(mel == 0, EPS, mel))


def log_mel_spectrogram(y: torch.Tensor) -> torch.Tensor:
    """``log_mel_400`` on a tensor of 16 kHz samples (..., samples) →
    (..., frames, 64), on the tensor's device and in its dtype: framing is
    a strided view, the FFT and the filterbank product run there."""
    window = torch.as_tensor(hann_window(), dtype=y.dtype, device=y.device)
    fb = torch.as_tensor(mel_filterbank(SR, N_FFT, N_MELS, FMIN, FMAX).T,
                         dtype=y.dtype, device=y.device)
    spec = torch.fft.rfft(y.unfold(-1, N_FFT, HOP) * window, n=N_FFT,
                          dim=-1).abs()
    return torch.log(torch.clamp_min(spec @ fb, EPS))


class Audio(Modality):
    def __init__(self, path2data="../dataset/groot/data",
                 path2outdata="../dataset/groot/data", speaker="all",
                 preprocess_methods=("log_mel_512",)):
        super().__init__(path2data=path2data, path2outdata=path2outdata,
                         speaker=speaker, preprocess_methods=preprocess_methods)
        self.missing = MissingData(self.path2data)

    @property
    def fs_map(self):
        # rows per second of each representation (reference audio.py:173-179)
        return {"log_mel_512": int(45.6 * 1000 / 512),   # 89
                "log_mel_400": int(16.52 * 1000 / 160),  # 103
                "silence": 15}

    def fs(self, modality):
        return self.fs_map[modality.split("/")[-1]]

    @property
    def h5_key(self):
        return "audio"

    def preprocess(self):
        raise NotImplementedError(
            "audio preprocessing comes with cli/preprocess (ROADMAP queue 1 "
            "item 7)")
