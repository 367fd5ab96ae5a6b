"""Wrapper of the STFT-magnitude kernel (``csrc/stft_mag.cu``).

Replaces ``deepspeech_tpu/ops/pallas/stft_kernel.py`` (``_kernel``, via
``stft_magnitude_pallas``). For a CPU tensor the wrapper runs ``plain``,
the plain PyTorch version beside it; for a CUDA tensor it launches the
kernel or raises.

The kernel has two routes, chosen by a fixed rule on ``n_fft`` before the
launch (``route``): an FFT in shared memory where ``n_fft / 2`` has no odd
factor but 3 and 5 (160, 200, 320, 400, 480, 512, ...), and the windowed
DFT otherwise (448 = 2^6 * 7, ...). Both count as launches of ``stft_mag``;
a failure in either raises. The FFT's host half lives here: its plan
(``fft_plan``), its twiddles rounded once from float64 (``fft_twiddles``)
and its frames a block (``fft_frames_per_block``).
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

MAX_BINS = 1024        # the DFT route's one thread a bin
FFT_BUF_BYTES = 25_600  # the FFT route's frames a block times n_fft/2
                        # complex points, and its staged samples, at most
MAX_STAGE_RADIX = 16    # points a thread of the FFT route holds a stage

_P = ctypes.c_void_p
_I = ctypes.c_int


def fft_plan(n_fft: int) -> tuple[tuple[int, int], ...] | None:
    """Stages of the kernel's n_fft/2-point complex FFT, each a radix
    R1 R2 computed in registers: the base radices (fours, then a two, then
    threes, then fives) paired in order where their product is at most
    ``MAX_STAGE_RADIX``, else alone as (R, 1). None where n_fft/2 has
    another odd factor or n_fft is not a multiple of 4 (320: 160 = 4 4 2 5
    -> ((4, 4), (2, 5)))."""
    if n_fft < 4 or n_fft % 4:
        return None
    m, radices = n_fft // 2, []
    while m % 4 == 0:
        radices.append(4)
        m //= 4
    if m % 2 == 0:
        radices.append(2)
        m //= 2
    for r in (3, 5):
        while m % r == 0:
            radices.append(r)
            m //= r
    if m != 1:
        return None
    plan, i = [], 0
    while i < len(radices):
        pair = radices[i:i + 2]
        if len(pair) == 2 and pair[0] * pair[1] <= MAX_STAGE_RADIX:
            plan.append(tuple(pair))
            i += 2
        else:
            plan.append((radices[i], 1))
            i += 1
    return tuple(plan)


def route(n_fft: int) -> str:
    """"fft" where ``fft_plan`` has a plan, else "dft"."""
    return "dft" if fft_plan(n_fft) is None else "fft"


def plan_code(plan: tuple[tuple[int, int], ...]) -> int:
    """The plan as the kernel reads it: stage s's R1 in bits 6s..6s+2, its
    R2 in bits 6s+3..6s+5."""
    return sum((r1 | r2 << 3) << (6 * s) for s, (r1, r2) in enumerate(plan))


@functools.lru_cache(maxsize=16)
def fft_twiddles(n_fft: int) -> np.ndarray:
    """complex64 table the FFT route reads: for each stage of radix
    r = r1 r2 after stages whose radices multiply to ns, its twiddles
    exp(-2 pi i q k / (ns r)) at k (r - 1) + q - 1 (k < ns, 1 <= q < r),
    then its in-register DFT's exp(-2 pi i s2 q1 / r) at
    (s2 - 1) (r1 - 1) + q1 - 1 (1 <= s2 < r2, 1 <= q1 < r1); last, the
    real-input split's exp(-2 pi i k / n_fft), k = 0 .. n_fft/2. Computed
    in float64 and rounded once."""
    parts, ns = [], 1
    for r1, r2 in fft_plan(n_fft):
        r = r1 * r2
        k = np.arange(ns)[:, None]
        q = np.arange(1, r)[None, :]
        parts.append(np.exp(-2j * np.pi * q * k / (ns * r)).ravel())
        s2 = np.arange(1, r2)[:, None]
        q1 = np.arange(1, r1)[None, :]
        parts.append(np.exp(-2j * np.pi * s2 * q1 / r).ravel())
        ns *= r
    parts.append(np.exp(-2j * np.pi * np.arange(n_fft // 2 + 1) / n_fft))
    return np.concatenate(parts).astype(np.complex64)


def fft_frames_per_block(n_fft: int, hop: int) -> int:
    """Frames a block of the FFT route: 32, halved until the frames' n_fft/2
    complex points and the staged samples each fit ``FFT_BUF_BYTES``."""
    ft = 32
    while ft > 1 and max(ft * (n_fft // 2) * 8,
                         ((ft - 1) * hop + n_fft) * 4) > FFT_BUF_BYTES:
        ft //= 2
    return ft


@functools.lru_cache(maxsize=8)
def _dft_on(n_fft: int, window_bytes: bytes, device: torch.device):
    window = np.frombuffer(window_bytes, np.float32)
    cos_w, sin_w = windowed_dft(n_fft, window)
    return (torch.from_numpy(cos_w).to(device),
            torch.from_numpy(sin_w).to(device))


@functools.lru_cache(maxsize=8)
def _fft_on(n_fft: int, window_bytes: bytes, device: torch.device):
    window = torch.from_numpy(np.frombuffer(window_bytes, np.float32).copy())
    tw = torch.from_numpy(fft_twiddles(n_fft).view(np.float32).copy())
    return window.to(device), tw.to(device)


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
    lib.stft_mag_dft_f32.argtypes = [_P, _P, _P, _P] + [_I] * 7 + [_P]
    lib.stft_mag_dft_f32.restype = _I
    lib.stft_mag_fft_f32.argtypes = [_P, _P, _P, _P] + [_I] * 9 + [_P]
    lib.stft_mag_fft_f32.restype = _I
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
    if n_fft % 4 or hop % 4 or n_bins > MAX_BINS:
        raise ValueError(f"stft_mag kernel needs n_fft and hop divisible by "
                         f"4 and n_fft <= 2046 (n_fft={n_fft}, hop={hop})")
    if s <= pad or s + 2 * pad < n_fft:
        raise ValueError(f"signal of {s} samples too short for n_fft {n_fft}")
    t = (s + 2 * pad - n_fft) // hop + 1
    y = y.contiguous()
    key = (n_fft, np.asarray(window, np.float32).tobytes(), y.device)
    out = torch.empty((b, n_bins, t), dtype=torch.float32, device=y.device)
    lib = _kernel()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    plan = fft_plan(n_fft)
    with torch.cuda.device(y.device):
        if plan is None:
            cos_w, sin_w = _dft_on(*key)
            code = lib.stft_mag_dft_f32(
                y.data_ptr(), cos_w.data_ptr(), sin_w.data_ptr(),
                out.data_ptr(), b, s, t, n_fft, hop, n_bins, pad, stream)
        else:
            win, tw = _fft_on(*key)
            code = lib.stft_mag_fft_f32(
                y.data_ptr(), win.data_ptr(), tw.data_ptr(), out.data_ptr(),
                b, s, t, n_fft, hop, pad, plan_code(plan),
                fft_frames_per_block(n_fft, hop), tw.numel() // 2, stream)
    build.check(lib, code, f"stft_mag kernel ({route(n_fft)} route)")
    global launches
    launches += 1
    return out
