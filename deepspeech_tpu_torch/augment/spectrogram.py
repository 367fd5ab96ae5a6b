"""Spectrogram augmentation (SpecAugment-style masks).

Two implementations of the same semantics (reference data/spectrogram_aug.py),
as in the JAX package's ``augment/spectrogram.py``:

* host classes (numpy, explicit RNG), copied: ``FrequencyMask``,
  ``TimeMask`` and the combinators ``SCompose/SOneOf/SComposePipelines/
  SOneOrOther`` (reference spectrogram_aug.py:8-56);
* :func:`spec_augment` and :func:`band_zero_8khz`, batched on the
  spectrogram's device: SOneOf([FrequencyMask, TimeMask]) drawn per
  utterance, and the "pretend 8 kHz" band zero (reference
  data_loader_aug.py:244-248: bins 81+ zeroed w.p. aug_prob_8khz).

Each device function is split in two: ``draw_*`` makes the per-utterance
picks, widths and centres from an explicit ``torch.Generator`` (where the
JAX package splits ``jax.random`` keys), and ``apply_*`` builds the mask
from those draws. The JAX functions' draws, recomputed from their key
chain, give the JAX outputs through ``apply_*``; the generator's draws
have the same distribution.
"""

from __future__ import annotations

import numpy as np
import torch


class FrequencyMask:
    """Up to ``bands`` zeroed frequency bands, each w.p. ``prob``, width
    ~ U{0..dropout_width}, centered uniformly (reference spectrogram_aug.py:59-83)."""

    def __init__(self, bands=2, prob=0.25, dropout_width=10):
        assert dropout_width > 0
        self.bands = bands
        self.prob = prob
        self.dropout_width = dropout_width

    def __call__(self, spect: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        freqs, _ = spect.shape
        for _ in range(self.bands):
            if rng.random() < self.prob:
                width = int(rng.integers(0, self.dropout_width + 1))
                center = int(rng.integers(0, freqs + 1))
                lo = max(0, center - width // 2)
                hi = min(center + width // 2, freqs)
                spect[lo:hi, :] = 0
        return spect


class TimeMask:
    """Up to ``bands`` zeroed time bands, width ~ U{0..dropout_length} capped
    at ``max_dropout_ratio`` of the utterance (reference spectrogram_aug.py:86-116)."""

    def __init__(self, bands=2, prob=0.25, dropout_length=50,
                 max_dropout_ratio=0.15):
        assert dropout_length > 0
        self.bands = bands
        self.prob = prob
        self.dropout_length = dropout_length
        self.max_dropout_ratio = max_dropout_ratio

    def __call__(self, spect: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        _, frames = spect.shape
        for _ in range(self.bands):
            if rng.random() < self.prob:
                width = int(rng.integers(0, self.dropout_length + 1))
                width = min(width, int(self.max_dropout_ratio * frames))
                center = int(rng.integers(0, frames + 1))
                lo = max(0, center - width // 2)
                hi = min(center + width // 2, frames)
                spect[:, lo:hi] = 0
        return spect


class SCompose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x, rng):
        for t in self.transforms:
            x = t(x, rng)
        return x


class SOneOf:
    def __init__(self, transforms, prob=0.5):
        self.transforms = transforms
        self.prob = prob

    def __call__(self, x, rng):
        if rng.random() < self.prob:
            t = self.transforms[rng.integers(len(self.transforms))]
            prev, t.prob = t.prob, 1.0
            try:
                x = t(x, rng)
            finally:
                t.prob = prev
        return x


class SComposePipelines:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x, rng):
        pipeline = self.transforms[rng.integers(len(self.transforms))]
        for t in pipeline:
            x = t(x, rng)
        return x


class SOneOrOther:
    def __init__(self, first, second, prob=0.5):
        self.first = first
        first.prob = 1.0
        self.second = second
        second.prob = 1.0
        self.prob = prob

    def __call__(self, x, rng):
        t = self.first if rng.random() < self.prob else self.second
        return t(x, rng)


# ---------------------------------------------------------------------------
# Device batched path: draw, then apply
# ---------------------------------------------------------------------------

def draw_spec_augment(batch: int, n_freq: int, n_frames: int,
                      generator: torch.Generator, freq_bands: int = 2,
                      freq_width: int = 20, time_bands: int = 2,
                      time_length: int = 50) -> dict:
    """The per-utterance draws of :func:`spec_augment` on the generator's
    device: ``u`` (B,) ~ U[0, 1) picks the mask, ``freq_width`` and
    ``freq_center`` (B, freq_bands) ~ U{0..freq_width} and U{0..n_freq},
    ``time_width`` and ``time_center`` (B, time_bands) ~ U{0..time_length}
    and U{0..n_frames} (n_frames the padded width, as the JAX draw)."""
    dev = generator.device

    def randint(hi, n):
        return torch.randint(0, hi + 1, (batch, n), generator=generator,
                             device=dev)

    return {"u": torch.rand(batch, generator=generator, device=dev),
            "freq_width": randint(freq_width, freq_bands),
            "freq_center": randint(n_freq, freq_bands),
            "time_width": randint(time_length, time_bands),
            "time_center": randint(n_frames, time_bands)}


def _band_zero(size: int, width: torch.Tensor, center: torch.Tensor,
               device) -> torch.Tensor:
    """(B, size) bool: inside any band [center - width//2,
    center + width//2) of the (B, n) draws."""
    lo = (center - width // 2).clamp(min=0)
    hi = center + width // 2
    pos = torch.arange(size, device=device)[None, None, :]
    return ((pos >= lo[..., None]) & (pos < hi[..., None])).any(1)


def apply_spec_augment(spect: torch.Tensor, frame_lengths: torch.Tensor,
                       draws: dict, prob: float,
                       max_time_ratio: float = 0.15) -> torch.Tensor:
    """SOneOf([FrequencyMask, TimeMask], prob) per utterance from
    ``draws``: u < prob/2 zeroes the frequency bands, prob/2 <= u < prob
    the time bands, each time width capped at max_time_ratio of that
    row's valid frames. spect (B, F, T) -> a masked copy."""
    if prob <= 0:
        return spect
    b, f, t = spect.shape
    dev = spect.device
    u = draws["u"].to(dev)
    pick_freq = u < prob / 2.0
    pick_time = (u >= prob / 2.0) & (u < prob)
    cap = (max_time_ratio * frame_lengths.to(dev)).to(torch.int32)
    time_width = torch.minimum(draws["time_width"].to(dev), cap[:, None])
    fzero = _band_zero(f, draws["freq_width"].to(dev),
                       draws["freq_center"].to(dev), dev)
    tzero = _band_zero(t, time_width, draws["time_center"].to(dev), dev)
    fzero = fzero & pick_freq[:, None]
    tzero = tzero & pick_time[:, None]
    keep = ~(fzero[:, :, None] | tzero[:, None, :])
    return spect * keep.to(spect.dtype)


def spec_augment(spect: torch.Tensor, frame_lengths: torch.Tensor,
                 generator: torch.Generator, prob: float,
                 freq_bands: int = 2, freq_width: int = 20,
                 time_bands: int = 2, time_length: int = 50,
                 max_time_ratio: float = 0.15) -> torch.Tensor:
    """Batched SOneOf([FrequencyMask, TimeMask], prob) on (B, 161, T)
    magnitudes, before normalization (reference data_loader_aug.py:241-242;
    its defaults dropout_width=20, dropout_length=50, :424-431)."""
    if prob <= 0:
        return spect
    draws = draw_spec_augment(spect.shape[0], spect.shape[1],
                              spect.shape[2], generator, freq_bands,
                              freq_width, time_bands, time_length)
    return apply_spec_augment(spect, frame_lengths, draws, prob,
                              max_time_ratio)


def draw_band_zero(batch: int, generator: torch.Generator) -> torch.Tensor:
    """(B,) ~ U[0, 1): the band zero's per-utterance roll."""
    return torch.rand(batch, generator=generator, device=generator.device)


def apply_band_zero_8khz(spect: torch.Tensor, u: torch.Tensor,
                         prob: float) -> torch.Tensor:
    """Rows whose roll u < prob get bins 81+ zeroed. spect (B, F, T)."""
    if prob <= 0:
        return spect
    apply = u.to(spect.device) < prob
    high = torch.arange(spect.shape[1], device=spect.device) >= 81
    zero = apply[:, None] & high[None, :]
    return spect * (~zero).to(spect.dtype)[:, :, None]


def band_zero_8khz(spect: torch.Tensor, generator: torch.Generator,
                   prob: float) -> torch.Tensor:
    """W.p. ``prob`` per utterance, zero bins 81+ — "pretend the audio is
    8 kHz" (reference data_loader_aug.py:244-248). spect: (B, 161, T)."""
    if prob <= 0:
        return spect
    return apply_band_zero_8khz(
        spect, draw_band_zero(spect.shape[0], generator), prob)
