"""WAV I/O with the reference's normalization semantics.

``load_audio_norm`` parity (reference data/audio_loader.py:4-28): scipy wav
read, peak-normalize by the integer abs-max, then channel select / average.
FLAC goes through the port's native decoder (``native/flac_decoder.cpp``)
and is scaled by its bit depth, as in the JAX package's ``audio/io.py``.
"""

from __future__ import annotations

import ctypes

import numpy as np
from scipy.io import wavfile

from deepspeech_tpu_torch.native import load_native


def read_flac(path: str):
    """Decode a FLAC file with the native decoder (replacing the
    reference's sox shell-out, reference data/librispeech.py:45). Returns
    (int32 array (S,) or (S, C), sample_rate, bits_per_sample)."""
    lib = load_native()
    sr = ctypes.c_int32()
    ch = ctypes.c_int32()
    bits = ctypes.c_int32()
    total = ctypes.c_int64()
    rc = lib.flac_probe(path.encode(), ctypes.byref(sr), ctypes.byref(ch),
                        ctypes.byref(bits), ctypes.byref(total))
    if rc != 0:
        raise ValueError(f"not a decodable FLAC file: {path}")
    capacity = total.value if total.value > 0 else 16000 * 60 * 60
    out = np.empty(capacity * ch.value, dtype=np.int32)
    n = lib.flac_decode(path.encode(),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        capacity)
    if n < 0:
        raise ValueError(f"FLAC decode failed: {path}")
    data = out[: n * ch.value].reshape(n, ch.value)
    if ch.value == 1:
        data = data[:, 0]
    return data, sr.value, bits.value


def _read_any(path: str):
    if path.lower().endswith(".flac"):
        data, sample_rate, bits = read_flac(path)
        # float in [-1, 1] by bit depth, whatever the container
        return sample_rate, data.astype(np.float32) / float(1 << (bits - 1))
    return wavfile.read(path)


def load_audio_norm(path: str, channel: int = -1):
    """Returns (float32 mono signal peak-normalized to [-1, 1], sample_rate).
    Reads wav (scipy) and flac (the native decoder)."""
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


def duration_seconds(path: str) -> float:
    """Duration from the wav header (replacing the reference's soxi
    shell-out, reference data/data_loader_aug.py:620-622)."""
    sample_rate, sound = wavfile.read(path, mmap=True)
    return sound.shape[0] / float(sample_rate)
