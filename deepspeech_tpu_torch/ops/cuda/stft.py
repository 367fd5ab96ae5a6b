"""Wrapper of the STFT-magnitude kernel (``csrc/stft_mag.cu``).

Replaces ``deepspeech_tpu/ops/pallas/stft_kernel.py`` (``_kernel``, via
``stft_magnitude_pallas``). For a CPU tensor the wrapper runs ``plain``,
the plain PyTorch version beside it; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from deepspeech_tpu_torch.ops import fp32_matmul
from deepspeech_tpu_torch.ops.cuda import build
from deepspeech_tpu_torch.ops.stft import (frame_signal, reflect_pad_1d,
                                           windowed_dft)

launches = 0  # kernel launches since the caller last reset it

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=8)
def _dft_on(n_fft: int, window_bytes: bytes, device: torch.device):
    window = np.frombuffer(window_bytes, np.float32)
    cos_w, sin_w = windowed_dft(n_fft, window)
    return (torch.from_numpy(cos_w).to(device),
            torch.from_numpy(sin_w).to(device))


def plain(y: torch.Tensor, n_fft: int, hop: int, window: np.ndarray,
          center: bool = True) -> torch.Tensor:
    """|STFT| of (..., S) f32 signal -> (..., n_bins, T), n_bins = n_fft//2+1.

    The windowed DFT runs as two f32 matmuls; TF32 is never used, because
    the normalization's ``log1p(mag * 2**20)`` magnifies small errors."""
    if center:
        y = reflect_pad_1d(y, n_fft // 2)
    frames = frame_signal(y.float(), n_fft, hop)
    cos_w, sin_w = windowed_dft(n_fft, window)
    cos_w = torch.from_numpy(cos_w).to(y.device)
    sin_w = torch.from_numpy(sin_w).to(y.device)
    with fp32_matmul():
        re = frames @ cos_w
        im = frames @ sin_w
    return torch.sqrt(re * re + im * im).transpose(-1, -2)


@functools.cache
def _kernel():
    lib = build.load("stft_mag")
    lib.stft_mag_f32.argtypes = [_P, _P, _P, _P] + [_I] * 7 + [_P]
    lib.stft_mag_f32.restype = _I
    return lib


def stft_mag(y: torch.Tensor, n_fft: int, hop: int, window: np.ndarray,
             center: bool = True) -> torch.Tensor:
    """|STFT| of (B, S) f32 waveforms -> (B, n_fft//2 + 1, T), librosa
    conventions (``center=True``: reflect padding, T = 1 + S // hop)."""
    if y.ndim != 2:
        raise ValueError(f"expected (B, S) waveforms, got {tuple(y.shape)}")
    if y.device.type == "cpu":
        return plain(y, n_fft, hop, window, center=center)
    if y.device.type != "cuda":
        raise ValueError(f"stft_mag: unsupported device {y.device}")
    if y.dtype != torch.float32:
        raise TypeError(f"stft_mag kernel takes float32, got {y.dtype}")
    n_bins = n_fft // 2 + 1
    pad = n_fft // 2 if center else 0
    b, s = y.shape
    if n_fft % 4 or hop % 4 or n_bins > 1024:
        raise ValueError(f"stft_mag kernel needs n_fft and hop divisible by "
                         f"4 and n_fft <= 2046 (n_fft={n_fft}, hop={hop})")
    if s <= pad or s + 2 * pad < n_fft:
        raise ValueError(f"signal of {s} samples too short for n_fft {n_fft}")
    t = (s + 2 * pad - n_fft) // hop + 1
    y = y.contiguous()
    cos_w, sin_w = _dft_on(n_fft, np.asarray(window, np.float32).tobytes(),
                           y.device)
    out = torch.empty((b, n_bins, t), dtype=torch.float32, device=y.device)
    lib = _kernel()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        code = lib.stft_mag_f32(y.data_ptr(), cos_w.data_ptr(),
                                sin_w.data_ptr(), out.data_ptr(), b, s, t,
                                n_fft, hop, n_bins, pad, stream)
    build.check(lib, code, "stft_mag kernel")
    global launches
    launches += 1
    return out
