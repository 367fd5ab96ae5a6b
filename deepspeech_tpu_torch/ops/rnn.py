"""Recurrent layers: ``rnn_scan`` with the JAX package's semantics.

``rnn_scan`` runs each layer through the kernel wrappers of
``ops/cuda/gru.py``: the plain PyTorch versions for CPU tensors, the CUDA
kernels for CUDA tensors. When a gradient is needed (grad mode on and any
input requires grad) it goes through ``GRULayer``, the autograd Function of
the training forward (``csrc/gru_fwd.cu`` with residuals) and the backward
(``csrc/gru_bwd.cu``); otherwise it calls the residual-free forward.
"""

from __future__ import annotations

import torch

from deepspeech_tpu_torch.ops.cuda import gru as gru_kernel

CELL_GATES = {"gru": 3, "lstm": 4, "rnn": 1}


def rnn_scan(x: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
             b_ih: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
             cell: str = "gru", bidirectional: bool = True,
             compute_dtype=None) -> torch.Tensor:
    """Run a (bi)directional recurrent layer (``ops/rnn.py:rnn_scan`` of the
    JAX package).

    x: (T, B, F) time-major input; lengths: (B,) valid steps. Weights are
    stacked over directions: w_ih (D, F, G*H), b_ih (D, G*H), w_hh
    (D, H, G*H), b_hh (D, G*H). Returns (T, B, H) f32, the two directions
    summed (reference model.py:106-107); padded steps are zeros.
    ``compute_dtype`` (``torch.bfloat16``) is the matmul operand type; None
    is float32.
    """
    if cell != "gru":
        raise NotImplementedError(
            f"cell {cell!r}: the PyTorch port has only the GRU cell so far; "
            "LSTM and vanilla-RNN cells are listed in ROADMAP.md")
    ndir = 2 if bidirectional else 1
    if w_ih.shape[0] != ndir:
        raise ValueError(f"w_ih has {w_ih.shape[0]} directions, "
                         f"expected {ndir}")
    dt = torch.float32 if compute_dtype is None else compute_dtype
    params = (x, w_ih, b_ih, w_hh, b_hh)
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        out = gru_kernel.GRULayer.apply(x.to(dt), w_ih.to(dt), b_ih.float(),
                                        w_hh.float(), b_hh.float(), lengths)
    else:
        out = gru_kernel.gru_layer(x.to(dt), w_ih.to(dt), b_ih.float(),
                                   w_hh.to(dt), b_hh.float(), lengths)
    # zero at padded steps
    return out[0] + out[1] if bidirectional else out[0]
