"""WAV I/O with the reference's normalization semantics.

``load_audio_norm`` parity (reference data/audio_loader.py:4-28): scipy wav
read, peak-normalize by the integer abs-max, then channel select / average.
FLAC needs the native decoder, which this package has not ported yet.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def _read_any(path: str):
    if path.lower().endswith(".flac"):
        raise NotImplementedError(
            "FLAC input needs the native decoder, which the PyTorch port has "
            "not ported yet (see ROADMAP.md); convert the file to wav")
    return wavfile.read(path)


def load_audio_norm(path: str, channel: int = -1):
    """Returns (float32 mono signal peak-normalized to [-1, 1], sample_rate)."""
    sample_rate, sound = _read_any(path)
    abs_max = np.abs(sound).max()
    sound = sound.astype("float32")
    if abs_max > 0:
        sound *= 1.0 / abs_max
    if sound.ndim > 1:
        if sound.shape[1] == 1:
            sound = sound.squeeze()
        elif channel == -1:
            sound = sound.mean(axis=1)
        else:
            sound = sound[:, channel]
    return sound, sample_rate


def load_audio(path: str, channel: int = -1):
    """Non-peak-normalized float32 load (legacy twin, reference
    data/data_loader.py:36-46; ``noise_inject`` reads its input with it)."""
    sample_rate, sound = _read_any(path)
    if np.issubdtype(sound.dtype, np.integer):
        sound = sound.astype("float32") / float(np.iinfo(sound.dtype).max)
    else:
        sound = sound.astype("float32")
    if sound.ndim > 1:
        sound = sound.mean(axis=1) if channel == -1 else sound[:, channel]
    return sound, sample_rate


def save_wav(path: str, data: np.ndarray, sample_rate: int):
    """Write float32 [-1,1] audio as 16-bit PCM."""
    pcm = np.clip(data, -1.0, 1.0)
    wavfile.write(path, sample_rate, (pcm * 32767.0).astype(np.int16))
