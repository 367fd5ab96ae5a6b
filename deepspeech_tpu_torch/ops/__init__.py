"""Tensor ops of the port: STFT, recurrent layers, and their CUDA kernels."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_matmul():
    """Full-f32 matmuls and cuDNN convolutions on the card (no TF32), as
    the JAX package computes them (``Precision.HIGHEST`` / f32 results)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
