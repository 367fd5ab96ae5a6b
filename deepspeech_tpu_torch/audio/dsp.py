"""Host-side DSP utilities: resample, phase-vocoder time-stretch, pitch-shift.

Self-contained numpy/scipy replacements for the librosa calls the reference's
augmentation pipeline depends on (reference data/audio_aug.py:20 time_stretch,
:74 pitch_shift; data/data_loader_aug.py:668 resample), copied from the JAX
package's ``audio/dsp.py``. These run on CPU data workers — the spectral
front-end for training runs on the device
(deepspeech_tpu_torch.audio.features.featurize_batch).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import scipy.signal


def resample(y: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (band-limited, like librosa's soxr/resampy path)."""
    if sr_in == sr_out:
        return y.astype(np.float32, copy=False)
    frac = Fraction(sr_out, sr_in).limit_denominator(1000)
    out = scipy.signal.resample_poly(y.astype(np.float32), frac.numerator,
                                     frac.denominator)
    return out.astype(np.float32)


def _stft(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    window = scipy.signal.get_window("hann", n_fft, fftbins=True).astype(np.float32)
    pad = n_fft // 2
    y = np.pad(y, pad, mode="reflect")
    t = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(t)[:, None]
    return np.fft.rfft(y[idx] * window[None, :], axis=-1).T  # (bins, frames)


def _istft(stft_matrix: np.ndarray, n_fft: int, hop: int,
           length: int) -> np.ndarray:
    window = scipy.signal.get_window("hann", n_fft, fftbins=True).astype(np.float32)
    frames = np.fft.irfft(stft_matrix.T, n=n_fft, axis=-1) * window[None, :]
    t = frames.shape[0]
    out = np.zeros(n_fft + hop * (t - 1), dtype=np.float64)
    norm = np.zeros_like(out)
    w2 = window.astype(np.float64) ** 2
    for i in range(t):
        out[i * hop:i * hop + n_fft] += frames[i]
        norm[i * hop:i * hop + n_fft] += w2
    out = out / np.maximum(norm, 1e-8)
    pad = n_fft // 2
    out = out[pad:pad + length]
    if len(out) < length:
        out = np.pad(out, (0, length - len(out)))
    return out.astype(np.float32)


def phase_vocoder(stft_matrix: np.ndarray, rate: float,
                  hop: int) -> np.ndarray:
    """Stretch an STFT in time by ``rate`` (>1 speeds up) with phase
    accumulation (the standard flanagan/laroche algorithm)."""
    n_bins, n_frames = stft_matrix.shape
    n_fft = 2 * (n_bins - 1)
    omega = 2.0 * np.pi * np.arange(n_bins) * hop / n_fft  # expected advance

    time_steps = np.arange(0, n_frames, rate)
    padded = np.concatenate(
        [stft_matrix, np.zeros((n_bins, 2), dtype=stft_matrix.dtype)], axis=1)

    out = np.empty((n_bins, len(time_steps)), dtype=np.complex128)
    phase_acc = np.angle(stft_matrix[:, 0])
    for i, step in enumerate(time_steps):
        lo = int(step)
        cols = padded[:, lo:lo + 2]
        alpha = step - lo
        mag = (1.0 - alpha) * np.abs(cols[:, 0]) + alpha * np.abs(cols[:, 1])
        out[:, i] = mag * np.exp(1j * phase_acc)
        dphase = np.angle(cols[:, 1]) - np.angle(cols[:, 0]) - omega
        dphase -= 2.0 * np.pi * np.round(dphase / (2.0 * np.pi))
        phase_acc = phase_acc + omega + dphase
    return out


def time_stretch(y: np.ndarray, rate: float, n_fft: int = 2048,
                 hop: int | None = None) -> np.ndarray:
    """Stretch duration by 1/rate without changing pitch
    (librosa.effects.time_stretch semantics: rate>1 -> shorter)."""
    if rate == 1.0:
        return y.astype(np.float32, copy=False)
    hop = hop or n_fft // 4
    stft_matrix = _stft(y.astype(np.float32), n_fft, hop)
    stretched = phase_vocoder(stft_matrix, rate, hop)
    out_len = int(round(len(y) / rate))
    return _istft(stretched, n_fft, hop, out_len)


def pitch_shift(y: np.ndarray, sr: int, n_steps: float,
                bins_per_octave: int = 12) -> np.ndarray:
    """Shift pitch by ``n_steps`` semitones, preserving duration
    (librosa.effects.pitch_shift semantics)."""
    if n_steps == 0:
        return y.astype(np.float32, copy=False)
    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    stretched = time_stretch(y, 1.0 / rate)
    # resample by 1/rate back to the original duration at the original sr
    shifted = resample(stretched, int(round(sr / rate)), sr)
    if len(shifted) < len(y):
        shifted = np.pad(shifted, (0, len(y) - len(shifted)))
    return shifted[: len(y)]
