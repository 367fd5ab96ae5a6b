"""Log-STFT spectrogram front-end on padded batches.

Reference behaviour (data/data_loader_aug.py of the reference): n_fft =
int(sr * window_size), hop = int(sr * window_stride), symmetric window,
magnitude, mirror-fill to 161 bins when sr < 16 kHz, crop to 161, then one
of the normalize modes ``mean`` / ``norm`` / ``frame`` / ``max_frame`` /
``none``. The batch path masks each utterance's statistics to its valid
frames and, in training, applies the device spectrogram masks
(``augment/spectrogram.py``) to the magnitudes before normalizing, as the
reference does. The host (numpy) parity path, ``parse_audio_np``, is the
JAX package's, copied: the dataset's ``emit="spect"`` runs it.

With ``AudioConf.n_mels`` > 0 the batch path is a log-mel front instead
(``log_mel_batch``, the Conformer's): the power of the same |STFT| through
an (n_mels x n_fft//2+1) Slaney mel matrix (``mel_filterbank``, librosa's
defaults written out), log(x + 2**-24), each band's mean and standard
deviation over the utterance's valid frames removed (NeMo's
``per_feature``); zeros past them. ``n_mels`` 0, the default, is the 161
linear bins above, and a conf's dict then carries no ``n_mels``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import scipy.ndimage
import scipy.signal
import torch

from deepspeech_tpu_torch.models.layers import length_mask
from deepspeech_tpu_torch.ops.cuda import stft as stft_kernel

N_BINS = 161  # fixed spectrogram height everywhere in the reference

WINDOWS = ("hamming", "hann", "blackman", "bartlett")


@functools.lru_cache(maxsize=16)
def make_window(name: str, length: int) -> np.ndarray:
    """Symmetric analysis window, matching scipy.signal's defaults."""
    if name not in WINDOWS:
        name = "hamming"
    return scipy.signal.get_window(name, length, fftbins=False).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class AudioConf:
    """Front-end configuration; embeds into checkpoints as ``audio_conf``."""
    sample_rate: int = 16000
    window_size: float = 0.02
    window_stride: float = 0.01
    window: str = "hamming"
    noise_dir: str | None = None
    noise_prob: float = 0.4
    noise_levels: tuple = (0.0, 0.5)
    aug_prob_8khz: float = 0.0
    aug_prob_spect: float = 0.0
    n_mels: int = 0  # 0: the 161 linear bins; else a log-mel front

    @property
    def n_fft(self) -> int:
        return int(self.sample_rate * (self.window_size + 1e-8))

    @property
    def hop(self) -> int:
        return int(self.sample_rate * (self.window_stride + 1e-8))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["noise_levels"] = tuple(d["noise_levels"])
        if not self.n_mels:
            del d["n_mels"]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "AudioConf":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        if "noise_levels" in kw and kw["noise_levels"] is not None:
            kw["noise_levels"] = tuple(kw["noise_levels"])
        return cls(**kw)


# ---------------------------------------------------------------------------
# Host (numpy) parity path, copied from the JAX package.
# ---------------------------------------------------------------------------

def stft_magnitude_np(y: np.ndarray, n_fft: int, hop: int,
                      window: np.ndarray) -> np.ndarray:
    """librosa.stft-compatible |STFT| on host: (S,) -> (n_fft//2+1, T)."""
    pad = n_fft // 2
    y = np.pad(y.astype(np.float32), pad, mode="reflect")
    t = (len(y) - n_fft) // hop + 1
    idx = np.arange(n_fft)[None, :] + hop * np.arange(t)[:, None]
    frames = y[idx] * window[None, :]
    return np.abs(np.fft.rfft(frames, n=n_fft, axis=-1)).T.astype(np.float32)


def mirror_fill_bins(spect: np.ndarray) -> np.ndarray:
    """Mirror-fill to N_BINS rows when the sample rate yields fewer bins,
    then crop (reference data_loader_aug.py:233-238, 249)."""
    shape = spect.shape
    if shape[0] < N_BINS:
        out = np.zeros((N_BINS, *shape[1:]), dtype=spect.dtype)
        out[:shape[0]] = spect
        out[81:] = out[80:0:-1][: N_BINS - 81]
        return out
    return spect[:N_BINS]


def audio_to_stft_np(y: np.ndarray, conf: AudioConf) -> np.ndarray:
    """(S,) waveform -> (161, T) magnitude spectrogram (host)."""
    window = make_window(conf.window, conf.n_fft)
    spect = stft_magnitude_np(y, conf.n_fft, conf.hop, window)
    return mirror_fill_bins(spect)


def gaussian_smooth_np(x: np.ndarray, sigma: float) -> np.ndarray:
    return scipy.ndimage.gaussian_filter1d(x, sigma)


def normalize_spectrogram_np(spect: np.ndarray, mode: str) -> np.ndarray:
    """Reference normalize_audio parity (data_loader_aug.py:274-313)."""
    if mode == "mean":
        spect = np.log1p(spect)
        return spect - spect.mean()
    if mode == "norm":
        spect = np.log1p(spect)
        spect = spect - spect.mean()
        std = spect.std(axis=0, ddof=1, keepdims=True)  # torch std is unbiased
        return spect / std.mean()
    if mode == "frame":
        spect = np.log1p(spect)
        mean = spect.mean(axis=0, keepdims=True)
        mean = gaussian_smooth_np(mean, 50)
        return spect - mean.mean()
    if mode == "max_frame":
        spect = np.log1p(spect * 1048576)
        mean = spect.mean(axis=0, keepdims=True)
        mean = gaussian_smooth_np(mean, 20)
        return spect - mean.mean()
    if not mode or mode == "none":
        return np.log1p(spect)
    raise ValueError(f"No such normalization: {mode}")


def parse_audio_np(y: np.ndarray, conf: AudioConf, normalize: str = "max_frame",
                   jitter_rng: np.random.Generator | None = None) -> np.ndarray:
    """Full host front-end: waveform -> normalized (161, T) spectrogram.

    ``jitter_rng`` enables the reference's train-time max_frame jitter
    (spect += U(-0.5, 0.5), data_loader_aug.py:213-214).
    """
    spect = audio_to_stft_np(y, conf)
    spect = normalize_spectrogram_np(spect, normalize)
    if jitter_rng is not None and normalize == "max_frame":
        spect = spect + (jitter_rng.random(1, dtype=np.float32) - 0.5)
    return spect


# ---------------------------------------------------------------------------
# Device batched path.
# ---------------------------------------------------------------------------

def masked_mean(seq: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Mean over the first ``length`` entries of each (B, T) row -> (B,).

    The reference subtracts the mean of a gaussian-smoothed per-frame mean
    (sigma 50 for ``frame``, 20 for ``max_frame``) with scipy's symmetric
    boundaries. That smoothing matrix is doubly stochastic, so the smoothed
    sequence has exactly the mean of the original: a masked mean suffices."""
    mask = length_mask(lengths, seq.shape[-1])
    return (seq * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)


def normalize_spectrogram_batch(spect: torch.Tensor,
                                frame_lengths: torch.Tensor,
                                mode: str) -> torch.Tensor:
    """Batched, masked normalize: (B, 161, T), (B,) -> (B, 161, T), with
    padded frames zeroed."""
    mask = length_mask(frame_lengths, spect.shape[-1])  # (B, T)
    m3 = mask[:, None, :]
    denom = mask.sum(-1).clamp(min=1.0) * spect.shape[1]

    if mode == "max_frame":
        spect = torch.log1p(spect * 1048576.0)
        out = spect - masked_mean(spect.mean(1), frame_lengths)[:, None, None]
    elif mode == "frame":
        spect = torch.log1p(spect)
        out = spect - masked_mean(spect.mean(1), frame_lengths)[:, None, None]
    elif mode in ("mean", "norm"):
        spect = torch.log1p(spect)
        mean = (spect * m3).sum((1, 2)) / denom
        out = spect - mean[:, None, None]
        if mode == "norm":
            # per-frame std over freq (unbiased), averaged over valid frames
            fmean = out.mean(1, keepdim=True)
            var = ((out - fmean) ** 2).sum(1) / (spect.shape[1] - 1)
            std_mean = ((torch.sqrt(var) * mask).sum(-1)
                        / mask.sum(-1).clamp(min=1.0))
            out = out / std_mean[:, None, None]
    elif not mode or mode == "none":
        out = torch.log1p(spect)
    else:
        raise ValueError(f"No such normalization: {mode}")
    return out * m3


def draw_masks(batch: int, n_frames: int, conf: AudioConf,
               generator: torch.Generator) -> dict | None:
    """The train step's spectrogram-mask draws for a batch of ``n_frames``
    padded frames (None when neither probability is set): SpecAugment's,
    then the band zero's, as the JAX ``featurize_batch`` splits its key."""
    if not (conf.aug_prob_spect > 0 or conf.aug_prob_8khz > 0):
        return None
    from deepspeech_tpu_torch.augment.spectrogram import (draw_band_zero,
                                                          draw_spec_augment)
    out = {}
    if conf.aug_prob_spect > 0:
        out["spec"] = draw_spec_augment(batch, N_BINS, n_frames, generator)
    if conf.aug_prob_8khz > 0:
        out["band"] = draw_band_zero(batch, generator)
    return out


MEL_LOG_GUARD = 2.0 ** -24  # added to the mel power before the log
PER_FEATURE_EPS = 1e-5  # added to each band's standard deviation


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney's mel scale (librosa ``hz_to_mel(htk=False)``): linear below
    1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep, f / f_sp)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) f32: librosa ``filters.mel``'s defaults
    (fmin 0, fmax sr / 2, Slaney scale, Slaney area norm): triangles
    between n_mels + 2 points even on the mel scale, each scaled by 2 over
    its width in Hz."""
    freqs = np.linspace(0.0, sample_rate / 2, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2),
                                n_mels + 2))
    width = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    lower = -ramps[:-2] / width[:-1, None]
    upper = ramps[2:] / width[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz[2:] - hz[:-2]))[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _mel_on(sample_rate: int, n_fft: int, n_mels: int,
            device: torch.device) -> torch.Tensor:
    """``mel_filterbank`` on ``device``, copied there once."""
    return torch.from_numpy(mel_filterbank(sample_rate, n_fft,
                                           n_mels)).to(device)


def log_mel_batch(mag: torch.Tensor, frame_lengths: torch.Tensor,
                  conf: AudioConf) -> torch.Tensor:
    """(B, n_fft//2+1, T) |STFT| -> (B, n_mels, T) log-mel, each band less
    its mean over the row's valid frames and over their standard deviation
    (n - 1 in the denominator) plus ``PER_FEATURE_EPS`` (NeMo's
    ``per_feature``), zero past them. The filterbank product runs in f32
    with TF32 off."""
    from deepspeech_tpu_torch.ops import fp32_matmul

    fb = _mel_on(conf.sample_rate, conf.n_fft, conf.n_mels, mag.device)
    with fp32_matmul():
        mel = torch.matmul(fb, mag.float() * mag.float())
    spect = torch.log(mel + MEL_LOG_GUARD)
    mask = length_mask(frame_lengths, spect.shape[-1])[:, None, :]
    n = mask.sum(-1, keepdim=True)
    mean = (spect * mask).sum(-1, keepdim=True) / n.clamp(min=1.0)
    var = (((spect - mean) * mask) ** 2).sum(-1, keepdim=True) / (
        n - 1).clamp(min=1.0)
    return (spect - mean) / (torch.sqrt(var) + PER_FEATURE_EPS) * mask


def featurize_batch(audio: torch.Tensor, audio_lengths: torch.Tensor,
                    conf: AudioConf, normalize: str = "max_frame",
                    jitter: torch.Tensor | None = None,
                    masks: dict | None = None):
    """Padded waveforms -> normalized spectrograms on the waveforms' device.

    audio: (B, S) f32, zero-padded; audio_lengths: (B,) valid sample counts.
    Returns (spect (B, 161, T), frame_lengths (B,)). The STFT reflect-pads
    the whole padded row, so a short utterance's last frame reflects into
    its zero padding, as the JAX package does for raw padded input.
    ``jitter`` (B,), with ``max_frame``: the train-time offset added to
    every valid frame (reference data_loader_aug.py:213-214). ``masks``
    (``draw_masks``): the SpecAugment and 8 kHz band-zero draws, applied
    to the magnitudes before normalization at ``conf``'s probabilities
    (reference data_loader_aug.py:241-248). With ``conf.n_mels`` the
    front is ``log_mel_batch`` (B, n_mels, T); ``normalize``, ``jitter``
    and ``masks`` do not act there.
    """
    window = make_window(conf.window, conf.n_fft)
    mag = stft_kernel.stft_mag(audio, conf.n_fft, conf.hop, window,
                               center=True)
    if conf.n_mels:
        frame_lengths = 1 + audio_lengths.to(mag.device) // conf.hop
        return log_mel_batch(mag, frame_lengths, conf), frame_lengths
    n_bins = conf.n_fft // 2 + 1
    if n_bins < N_BINS:
        out = mag.new_zeros((*mag.shape[:-2], N_BINS, mag.shape[-1]))
        out[..., :n_bins, :] = mag
        # mirror of the zero-filled rows 80..1, like the reference's resize
        out[..., 81:, :] = torch.flip(out[..., 1:81, :], dims=(-2,))
        mag = out
    else:
        mag = mag[..., :N_BINS, :]
    frame_lengths = 1 + audio_lengths.to(mag.device) // conf.hop
    if masks:
        from deepspeech_tpu_torch.augment.spectrogram import (
            apply_band_zero_8khz, apply_spec_augment)
        if "spec" in masks:
            mag = apply_spec_augment(mag, frame_lengths, masks["spec"],
                                     conf.aug_prob_spect)
        if "band" in masks:
            mag = apply_band_zero_8khz(mag, masks["band"], conf.aug_prob_8khz)
    spect = normalize_spectrogram_batch(mag, frame_lengths, normalize)
    if jitter is not None and normalize == "max_frame":
        mask = length_mask(frame_lengths, spect.shape[-1])
        spect = spect + jitter.to(spect.device)[:, None, None] * mask[:, None]
    return spect, frame_lengths
