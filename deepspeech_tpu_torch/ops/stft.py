"""Framed-DFT helpers: the DFT matrices, reflect padding and framing.

Conventions match librosa.stft(center=True, pad_mode="reflect") with a
symmetric window. The |STFT| itself is ``ops/cuda/stft.py:stft_mag``: the
hand-written kernel (``csrc/stft_mag.cu``) for CUDA tensors, its plain
PyTorch twin for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def dft_matrices(n_fft: int):
    """Real/imag f32 DFT analysis matrices, shape (n_fft, n_fft//2 + 1)."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def windowed_dft(n_fft: int, window: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """DFT analysis matrices with the window folded in:
    ``(f * w) @ C == f @ (diag(w) @ C)``."""
    cos_m, sin_m = dft_matrices(n_fft)
    w = np.asarray(window, dtype=np.float32)[:, None]
    return cos_m * w, sin_m * w


def reflect_pad_1d(y: torch.Tensor, pad: int) -> torch.Tensor:
    """np.pad(mode="reflect") on the last axis."""
    shape = y.shape
    return F.pad(y.reshape(-1, 1, shape[-1]), (pad, pad),
                 mode="reflect").reshape(*shape[:-1], shape[-1] + 2 * pad)


def frame_signal(y: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., S) -> (..., T, frame_length) frames with stride ``hop``."""
    return y.unfold(-1, frame_length, hop)
