"""Waveform augmentations (host, numpy) with explicit RNG, copied from the
JAX package's ``augment/waveform.py``: the same draws from the same
``numpy.random.Generator`` give the same samples.

Same transform set, parameters and combinator semantics as the reference
(reference data/audio_aug.py:7-174), redesigned around an explicit
``numpy.random.Generator`` so per-sample augmentation is reproducible from a
seed (the reference used process-global ``random``/``np.random`` state).

Each transform is ``t(wav, sr, rng) -> (wav, sr)``. Fixes over the
reference, replicating intent rather than bugs (SURVEY.md "known defects"):
* ``AudioDistort`` clips symmetrically to ±|peak| (the reference's
  ``np.clip(x, 0, maxval)`` at audio_aug.py:174 zeroes the negative half —
  an image-code leftover);
* ``get_stacked_noise`` concatenates noise clips (reference's ``np.stack``
  at audio_aug.py:121-128 crashes for >1 clip; undefined vars at :120,132).
"""

from __future__ import annotations

import numpy as np

from deepspeech_tpu_torch.audio.dsp import pitch_shift, resample, time_stretch
from deepspeech_tpu_torch.audio.io import load_audio_norm

MAX_DURATION_AUG = 18  # seconds; reference data_loader_aug.py:48


class ChangeAudioSpeed:
    """Speed up/down by up to ±limit via phase-vocoder time stretch
    (reference audio_aug.py:7-24); skipped if the result would exceed
    ``max_duration`` seconds."""

    def __init__(self, limit=0.15, prob=0.5, max_duration=10, sr=16000):
        self.limit = limit
        self.prob = prob
        self.max_duration = max_duration * sr

    def __call__(self, wav, sr, rng: np.random.Generator):
        if rng.random() < self.prob:
            alpha = 1.0 + self.limit * rng.uniform(-1, 1)
            stretched = time_stretch(wav, alpha)
            if stretched.shape[0] < self.max_duration:
                wav = stretched
        return wav, sr


class Shift:
    """Delay the utterance by up to ``limit`` samples of leading silence
    (reference audio_aug.py:27-46)."""

    def __init__(self, limit=512, prob=0.5, max_duration=10, sr=16000):
        self.limit = int(limit)
        self.prob = prob
        self.max_duration = max_duration * sr

    def __call__(self, wav, sr, rng: np.random.Generator):
        if rng.random() < self.prob:
            shift = round(rng.uniform(0, self.limit))
            shifted = np.zeros(wav.shape[0] + self.limit, dtype=wav.dtype)
            shifted[shift:shift + wav.shape[0]] = wav
            if shifted.shape[0] < self.max_duration:
                wav = shifted
        return wav, sr


class AudioDistort:
    """Phone-call clipping: scale by 1±limit and clip at the original peak
    (reference audio_aug.py:49-60; symmetric clip, see module docstring)."""

    def __init__(self, limit=0.3, prob=0.5):
        self.limit = limit
        self.prob = prob

    def __call__(self, wav, sr, rng: np.random.Generator):
        if rng.random() < self.prob:
            alpha = 1.0 + self.limit * rng.uniform(-1, 1)
            peak = np.abs(wav).max()
            wav = np.clip(alpha * wav, -peak, peak).astype(wav.dtype)
        return wav, sr


class PitchShift:
    """Shift pitch by up to ±limit semitones (reference audio_aug.py:63-76)."""

    def __init__(self, limit=5, prob=0.5):
        self.limit = abs(limit)
        self.prob = prob

    def __call__(self, wav, sr, rng: np.random.Generator):
        if rng.random() < self.prob:
            steps = self.limit * rng.uniform(-1, 1)
            wav = pitch_shift(wav, sr, steps)
        return wav, sr


def get_stacked_noise(noise_path: str, target_len: int, sr: int,
                      max_clips: int = 10) -> np.ndarray:
    """Concatenate up to ``max_clips`` reads of a noise file until it is at
    least ``target_len`` samples (reference audio_aug.py:110-134 intent)."""
    pieces, total = [], 0
    for _ in range(max_clips):
        clip, clip_sr = load_audio_norm(noise_path)
        if clip_sr != sr:
            clip = resample(clip, clip_sr, sr)
        pieces.append(clip)
        total += clip.shape[0]
        if total > target_len:
            break
    return np.concatenate(pieces) if len(pieces) > 1 else pieces[0]


class AddNoise:
    """Two-pass additive noise: a clip from the noise pool, then gaussian
    noise; mixed as (wav + a*noise)/(1+a), a ~ U(0, limit)
    (reference audio_aug.py:79-107)."""

    def __init__(self, limit=0.2, prob=0.5, noise_samples=()):
        self.limit = abs(limit)
        self.prob = prob
        self.noise_samples = list(noise_samples)

    def __call__(self, wav, sr, rng: np.random.Generator):
        for i in range(2):
            if rng.random() < self.prob:
                if i == 0:
                    if not self.noise_samples:
                        continue
                    path = self.noise_samples[rng.integers(len(self.noise_samples))]
                    noise = get_stacked_noise(path, wav.shape[0], sr)
                    if noise.shape[0] < wav.shape[0]:
                        return wav, sr
                else:
                    noise = rng.normal(0, 1, wav.shape[0] * 2).astype(np.float32)
                alpha = self.limit * rng.uniform(0, 1)
                pos = rng.integers(0, noise.shape[0] - wav.shape[0] + 1)
                wav = (wav + alpha * noise[pos:pos + wav.shape[0]]) / (1 + alpha)
        return wav, sr


class Compose:
    """Apply all transforms in order w.p. ``p`` (reference audio_aug.py:137-146)."""

    def __init__(self, transforms, p=1.0):
        self.transforms = [t for t in transforms if t is not None]
        self.p = p

    def __call__(self, wav, sr, rng: np.random.Generator):
        if rng.random() < self.p:
            for t in self.transforms:
                wav, sr = t(wav, sr, rng)
        return wav, sr


class OneOf:
    """W.p. ``prob`` pick one transform, weighted by each transform's own
    ``prob``, and apply it unconditionally (reference audio_aug.py:149-162)."""

    def __init__(self, transforms, prob=0.5):
        self.transforms = list(transforms)
        self.p = prob
        weights = np.asarray([t.prob for t in self.transforms], np.float64)
        self.weights = weights / weights.sum()

    def __call__(self, wav, sr, rng: np.random.Generator):
        if rng.random() < self.p:
            t = self.transforms[rng.choice(len(self.transforms), p=self.weights)]
            prev, t.prob = t.prob, 1.0
            try:
                wav, sr = t(wav, sr, rng)
            finally:
                t.prob = prev
        return wav, sr


class OneOrOther:
    """First w.p. ``prob``, else second (reference audio_aug.py:165-174)."""

    def __init__(self, first, second, prob=0.5):
        self.first = first
        first.prob = 1.0
        self.second = second
        second.prob = 1.0
        self.p = prob

    def __call__(self, wav, sr, rng: np.random.Generator):
        t = self.first if rng.random() < self.p else self.second
        return t(wav, sr, rng)


def build_waveform_pipeline(aug_prob: float, noise_samples=(),
                            sample_rate: int = 16000, aug_type: int = 0):
    """The reference's four ``aug_type`` pipelines, prob-weighted OneOf
    (reference data_loader_aug.py:361-418):

    0 — all five transforms (the only value the reference can reach: its
        ``aug_type`` is hardcoded 0 at data_loader_aug.py:355);
    1 — spatial shift only (limit 2 s there, vs 0.5 s inside type 0);
    2 — tone-affecting effects (speed + pitch);
    3 — additive noise + clip distortion (noise limit 0.05, vs 0.2 in 0).
    """
    if aug_prob <= 0:
        return None
    if aug_type == 0:
        aug_list = [
            AddNoise(limit=0.2, prob=aug_prob, noise_samples=noise_samples),
            ChangeAudioSpeed(limit=0.15, prob=aug_prob, sr=sample_rate,
                             max_duration=MAX_DURATION_AUG),
            AudioDistort(limit=0.05, prob=aug_prob),
            Shift(limit=sample_rate * 0.5, prob=aug_prob, sr=sample_rate,
                  max_duration=MAX_DURATION_AUG),
            PitchShift(limit=2, prob=aug_prob),
        ]
    elif aug_type == 1:
        aug_list = [
            Shift(limit=sample_rate * 2, prob=aug_prob, sr=sample_rate,
                  max_duration=MAX_DURATION_AUG),
        ]
    elif aug_type == 2:
        aug_list = [
            ChangeAudioSpeed(limit=0.15, prob=aug_prob, sr=sample_rate,
                             max_duration=MAX_DURATION_AUG),
            PitchShift(limit=2, prob=aug_prob),
        ]
    elif aug_type == 3:
        aug_list = [
            AddNoise(limit=0.05, prob=aug_prob, noise_samples=noise_samples),
            AudioDistort(limit=0.05, prob=aug_prob),
        ]
    else:
        raise ValueError(f"unknown aug_type {aug_type} (expected 0-3)")
    return OneOf(aug_list, prob=aug_prob)
