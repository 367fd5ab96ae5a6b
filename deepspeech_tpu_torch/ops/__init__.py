"""Tensor ops of the port: STFT, recurrent layers, and their CUDA kernels."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_matmul():
    """Full-f32 matmuls and cuDNN convolutions on the card (no TF32), and
    bf16 matmuls that sum in f32 throughout (no bf16 split-K partial sums),
    as the JAX package computes them (``Precision.HIGHEST`` /
    ``preferred_element_type=float32``)."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (matmul.allow_tf32, cudnn.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = saved
