"""The audio modality: the log-mel speech frontend and its preprocessing.

The port's own copy of the numpy DSP of ``mixstage_tpu/data/audio.py``
(Slaney mel scale, matching librosa's defaults): ``log_mel_400`` and
``log_mel_spectrogram``, the counterpart of ``log_mel_spectrogram_jax`` on
tensors, so that raw 16 kHz audio becomes log-mel frames on the card
(``torch.fft.rfft``): n_fft 512, hop 160, a 400-sample Hann window, no
centring, 64 mel bins from 125 Hz to 7.5 kHz, no filterbank norm.  The
offline preprocessing adds ``resample_audio`` (scipy's ``resample_poly``),
``log_mel_512`` (power mel, n_fft 2048, hop 512, centred, 128 Slaney-norm
bins) and ``silence_vad`` (webrtcvad where installed, else the JAX
package's energy VAD), all host numpy as in the JAX package.

``Audio`` is the audio modality (``mixstage_tpu/data/audio.py:208-276``):
the rows per second of each stored representation, its h5 key and
``preprocess`` (``cli.preprocess``): each interval's raw mp3 (``soundfile``,
imported when a file is read) through each method into
``processed/<speaker>/<interval>.h5``, on the port's thread pool.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Optional

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
                   fmax: float, norm: Optional[str] = None) -> np.ndarray:
    """Triangular mel filterbank, (n_mels, 1 + n_fft//2); ``norm="slaney"``
    scales each band to unit area."""
    fft_freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights


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


def stft(y: np.ndarray, n_fft: int, hop_length: int, center: bool = True,
         power: float = 1.0) -> np.ndarray:
    """Magnitude (``power``) STFT with a periodic Hann window of n_fft
    samples, (frames, bins); ``center`` reflect-pads n_fft // 2 on each
    side, as librosa does."""
    if center:
        y = np.pad(y, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    window = np.hanning(n_fft + 1)[:-1]
    spec = np.abs(np.fft.rfft(y[idx] * window[None, :], n=n_fft, axis=-1))
    return spec ** power


def resample_audio(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """``y`` at ``target_sr`` by scipy's polyphase ``resample_poly`` (the
    ratio's denominator limited to 1000)."""
    if orig_sr == target_sr:
        return y
    from fractions import Fraction

    import scipy.signal

    frac = Fraction(target_sr, orig_sr).limit_denominator(1000)
    return scipy.signal.resample_poly(y, frac.numerator, frac.denominator)


def log_mel_400(y: np.ndarray, sr: int = SR) -> np.ndarray:
    """Audio at ``sr`` (resampled to 16 kHz) → (frames, 64) log magnitude
    mel (the reference's ``log_mel_400``)."""
    y = resample_audio(np.asarray(y), sr, SR)
    mel = stft_mag(y.reshape(-1)) @ mel_filterbank(
        SR, N_FFT, N_MELS, FMIN, FMAX).T
    return np.log(np.where(mel == 0, EPS, mel))


def log_mel_512(y: np.ndarray, sr: int, eps: float = 1e-10) -> np.ndarray:
    """Power mel spectrogram, n_fft 2048, hop 512, centred, 128 Slaney-norm
    mels from 0 to sr/2 → (frames, 128) (the reference's ``log_mel_512``)."""
    spec = stft(y, n_fft=2048, hop_length=512, center=True, power=2.0)
    mel = spec @ mel_filterbank(sr, 2048, 128, 0.0, sr / 2.0,
                                norm="slaney").T
    return np.log(np.where(mel == 0, eps, mel))


def silence_vad(y: np.ndarray, sr: int) -> np.ndarray:
    """Silence mask at 15 rows a second, each row followed by a 0 (the
    reference's ``silence``): webrtcvad (imported here, as in the JAX
    package) at aggressiveness 3 where installed, else an energy VAD
    (a window is speech when its RMS exceeds 0.1 of the clip's)."""
    y16 = resample_audio(y, sr, SR)
    fs_old, fs_new = SR, 15
    ranges = np.arange(0, y16.shape[0], fs_old / fs_new)
    starts, ends = ranges[:-1], ranges[1:]
    try:
        import webrtcvad

        vad = webrtcvad.Vad(3)
        pcm = (np.clip(y16, -1, 1) * 32767).astype(np.int16)

        def is_speech(s, e):
            sub = np.arange(s, e, fs_old / 100)
            flags = [vad.is_speech(pcm[int(a):int(b)].tobytes(), fs_old)
                     for a, b in zip(sub[:-1], sub[1:])]
            return np.mean(flags) > 0.5
    except ImportError:
        thresh = 0.1 * np.sqrt(np.mean(y16 ** 2) + 1e-12)

        def is_speech(s, e):
            return np.sqrt(np.mean(y16[int(s):int(e)] ** 2)) > thresh

    out = []
    for s, e in zip(starts, ends):
        out.append(int(not is_speech(s, e)))
        out.append(0)
    return np.array(out, dtype=np.int64)


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
    def preprocess_map(self):
        return {"log_mel_512": log_mel_512,
                "log_mel_400": log_mel_400,
                "silence": silence_vad}

    @property
    def h5_key(self):
        return "audio"

    def load_waveform(self, filename):
        """mp3 / wav → (mono float64 waveform, sample rate) with
        ``soundfile`` (imported here, as in the JAX package)."""
        try:
            import soundfile as sf
        except ImportError as e:
            raise RuntimeError(
                "no audio decoder available (install soundfile): cannot "
                f"read {filename}") from e
        y, sr = sf.read(str(filename), always_2d=False)
        if y.ndim > 1:
            y = y.mean(axis=-1)
        return y.astype(np.float64), sr

    def preprocess(self):
        """Each speaker's intervals through ``save_intervals`` on the
        thread pool; the intervals that fail go into the missing-interval
        ledger."""
        from mixstage_tpu_torch.parallel.parallel import parallel

        speakers = self.speaker if self.speaker[0] != "all" else self.speakers
        for speaker in speakers:
            interval_ids = self.get_df_subset("speaker",
                                              speaker).unique("interval_id")
            parent = Path(self.path2data) / "raw" / f"{speaker}_cropped"
            if not parent.exists():
                warnings.warn(f"raw audio dir missing for {speaker}")
                continue
            filenames = [f for f in parent.iterdir() if f.suffix == ".mp3"]
            filename_dict = {f.stem.split("_")[-1]: f for f in filenames}
            n = len(interval_ids)
            missing = parallel(self.save_intervals, -1, interval_ids,
                               [speaker] * n, [filename_dict] * n)
            self.missing.save_intervals(missing)

    def save_intervals(self, interval_id, speaker, filename_dict):
        """One interval's waveform through each method into its h5 file
        (``audio/<method>``); its id when it has no file or does not
        decode, else None."""
        if interval_id not in filename_dict:
            warnings.warn(f"interval_id: {interval_id} not found.")
            return interval_id
        try:
            y, sr = self.load_waveform(filename_dict[interval_id])
        except Exception:
            return interval_id
        for method in self.preprocess_methods:
            processed = self.preprocess_map[method](y, sr)
            filename = (Path(self.path2outdata) / "processed" / speaker
                        / f"{interval_id}.h5")
            self.append(filename, self.add_key(self.h5_key, [method]),
                        processed)
        return None
