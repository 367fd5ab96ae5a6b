"""SNR-scaled noise injection (the reference's legacy pipeline), copied
from the JAX package's ``augment/noise.py``.

Reference NoiseInjection (data_loader_aug.py:73-105): mixes a random window
of a noise file into the signal, scaled so ``noise_level`` sets the
noise-to-signal energy ratio. The reference shelled out to ``sox`` for the
window crop (audio_with_sox, data_loader_aug.py:625-643); here the crop is a
plain array slice after an in-process resample.
"""

from __future__ import annotations

import os

import numpy as np

from deepspeech_tpu_torch.audio.dsp import resample
from deepspeech_tpu_torch.audio.io import load_audio_norm


def find_audio_files(path: str):
    exts = (".wav", ".flac", ".ogg", ".mp3")
    out = []
    for dirpath, _, files in os.walk(path):
        out += [os.path.join(dirpath, f) for f in files
                if f.lower().endswith(exts)]
    return sorted(out)


class NoiseInjection:
    def __init__(self, path=None, sample_rate: int = 16000,
                 noise_levels=(0, 0.5), rng=None):
        if path is not None and not os.path.exists(path):
            raise IOError(f"Directory doesn't exist: {path}")
        self.paths = find_audio_files(path) if path else []
        self.sample_rate = sample_rate
        self.noise_levels = noise_levels
        self.rng = rng or np.random.default_rng()

    def inject_noise(self, data: np.ndarray) -> np.ndarray:
        noise_path = self.paths[self.rng.integers(len(self.paths))]
        noise_level = self.rng.uniform(*self.noise_levels)
        return self.inject_noise_sample(data, noise_path, noise_level)

    def inject_noise_sample(self, data: np.ndarray, noise_path: str,
                            noise_level: float) -> np.ndarray:
        """data += level * noise_window * (E_signal / E_noise); the noise
        window starts at a random offset (reference data_loader_aug.py:95-105)."""
        noise, sr = load_audio_norm(noise_path)
        if sr != self.sample_rate:
            noise = resample(noise, sr, self.sample_rate)
        if len(noise) < len(data):
            reps = -(-len(data) // len(noise))
            noise = np.tile(noise, reps)
        start = int(self.rng.integers(0, len(noise) - len(data) + 1))
        window = noise[start:start + len(data)].astype(np.float64)
        noise_energy = np.sqrt(window.dot(window)) / window.size
        data_energy = np.sqrt(data.astype(np.float64).dot(data)) / data.size
        if noise_energy > 0:
            data = data + (noise_level * window * data_energy
                           / noise_energy).astype(data.dtype)
        return data
