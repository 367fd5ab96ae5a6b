"""Recurrent layers: ``rnn_scan`` with the JAX package's semantics.

``rnn_scan`` runs each GRU or LSTM layer through the kernel wrappers of
``ops/cuda/gru.py`` and ``ops/cuda/lstm.py``: the plain PyTorch versions for
CPU tensors, the CUDA kernels for CUDA tensors. The route is the JAX
package's (``ops/cuda/route.py``): where ``fused_route`` holds, the
projection-fused forward (K2, K3) with an f32 projection; elsewhere (the
wide layers, or ``DEEPSPEECH_TPU_NO_FUSED`` set) the projection x @ W_ih
per direction on cuBLAS, f32 sums rounded once to the operand type, then
the recurrence on it (K4, K6). When a gradient is needed (grad mode on and
any input requires grad) it goes through the layer's autograd Function
(``GRULayer``, ``LSTMLayer``, ``GRUScanLayer``, ``LSTMScanLayer``) of the
training forward (with residuals) and the backward kernel; otherwise it
calls the residual-free forward. The vanilla ``rnn`` cell has no TPU
kernel in the JAX package (it runs there as an XLA scan), so
``rnn_cell_scan`` is plain PyTorch on every device, differentiated by
autograd.
"""

from __future__ import annotations

import torch

from deepspeech_tpu_torch.ops import fp32_matmul
from deepspeech_tpu_torch.ops.cuda import gru as gru_kernel
from deepspeech_tpu_torch.ops.cuda import lstm as lstm_kernel
from deepspeech_tpu_torch.ops.cuda.recurrence import (to_time_order,
                                                      valid_mask, walk_index)
from deepspeech_tpu_torch.ops.cuda.route import fused_route

CELL_GATES = {"gru": 3, "lstm": 4, "rnn": 1}
# cell -> (wrapper module, the fused layer's autograd Function and forward,
# the recurrence's autograd Function and forward)
_KERNELS = {"gru": (gru_kernel, gru_kernel.GRULayer, "gru_layer",
                    gru_kernel.GRUScanLayer, "gru_scan"),
            "lstm": (lstm_kernel, lstm_kernel.LSTMLayer, "lstm_layer",
                     lstm_kernel.LSTMScanLayer, "lstm_scan")}


def project(x: torch.Tensor, w_ih: torch.Tensor) -> torch.Tensor:
    """(T, B, F) x (D, F, G) -> (D, T, B, G) in x's type: the wide route's
    projection (JAX ``ops/rnn.py:168-170``), f32 sums rounded once. On the
    card one cuBLAS product in the operand type; on the CPU in f32, then
    rounded."""
    with fp32_matmul():
        if x.is_cuda:
            return torch.einsum("tbf,dfg->dtbg", x, w_ih)
        return torch.einsum("tbf,dfg->dtbg", x.float(),
                            w_ih.float()).to(x.dtype)


def rnn_cell_scan(x: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
                  b_ih: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  compute_dtype=None) -> torch.Tensor:
    """The vanilla tanh RNN layer -> (D, T, B, H) f32, zero past each row's
    length (the JAX package's XLA scan, ``ops/rnn.py:_rnn_step``): the
    projection in f32 plus b_ih, then h = tanh(xp + h @ W_hh + b_hh) with
    the operands of both products rounded to ``compute_dtype``, sums and
    state in f32, direction 1 reversed within each row's length."""
    dt = torch.float32 if compute_dtype is None else compute_dtype
    ndir, hidden = w_hh.shape[0], w_hh.shape[1]
    t, b = x.shape[0], x.shape[1]
    lengths = lengths.to(x.device).clamp(max=t)
    with fp32_matmul():
        xp = torch.einsum("tbf,dfg->dtbg", x.to(dt).float(),
                          w_ih.to(dt).float())
        xp = xp + b_ih.float()[:, None, None, :]
        idx = walk_index(lengths, t)
        xp = to_time_order(xp, idx)
        w32 = w_hh.to(dt).float()
        h = torch.zeros((ndir, b, hidden), dtype=torch.float32,
                        device=x.device)
        outs = []
        for s in range(t):
            hp = torch.bmm(h.to(dt).float(), w32) + b_hh.float()[:, None, :]
            h = torch.tanh(xp[:, s] + hp)
            outs.append(h)
    out = to_time_order(torch.stack(outs, dim=1), idx)
    return torch.where(valid_mask(lengths, t), out, 0.0)


def rnn_scan(x: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
             b_ih: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
             cell: str = "gru", bidirectional: bool = True,
             compute_dtype=None) -> torch.Tensor:
    """Run a (bi)directional recurrent layer (``ops/rnn.py:rnn_scan`` of the
    JAX package).

    x: (T, B, F) time-major input; lengths: (B,) valid steps. Weights are
    stacked over directions: w_ih (D, F, G*H), b_ih (D, G*H), w_hh
    (D, H, G*H), b_hh (D, G*H), with G = 3 (gru), 4 (lstm) or 1 (rnn).
    Returns (T, B, H) f32, the two directions summed (reference
    model.py:106-107); padded steps are zeros. ``compute_dtype``
    (``torch.bfloat16``) is the matmul operand type; None is float32.
    """
    if cell not in CELL_GATES:
        raise ValueError(f"unknown cell {cell!r}; choose from "
                         f"{tuple(CELL_GATES)}")
    ndir = 2 if bidirectional else 1
    if w_ih.shape[0] != ndir:
        raise ValueError(f"w_ih has {w_ih.shape[0]} directions, "
                         f"expected {ndir}")
    dt = torch.float32 if compute_dtype is None else compute_dtype
    if cell == "rnn":
        out = rnn_cell_scan(x, lengths, w_ih, b_ih, w_hh, b_hh, dt)
        return out[0] + out[1] if bidirectional else out[0]
    module, layer_fn, layer, scan_fn, scan = _KERNELS[cell]
    params = (x, w_ih, b_ih, w_hh, b_hh)
    grad = torch.is_grad_enabled() and any(p.requires_grad for p in params)
    hidden = w_hh.shape[1]
    if fused_route(x.shape[2], hidden, CELL_GATES[cell], x.shape[1], ndir,
                   dt):
        if grad:
            out = layer_fn.apply(x.to(dt), w_ih.to(dt), b_ih.float(),
                                 w_hh.float(), b_hh.float(), lengths)
        else:
            out = getattr(module, layer)(x.to(dt), w_ih.to(dt), b_ih.float(),
                                         w_hh.to(dt), b_hh.float(), lengths)
    else:
        xp = project(x.to(dt), w_ih.to(dt))
        if grad:
            out = scan_fn.apply(xp, b_ih.float(), w_hh.float(),
                                b_hh.float(), lengths)
        else:
            out = getattr(module, scan)(xp, b_ih.float(), w_hh.to(dt),
                                        b_hh.float(), lengths)
    # zero at padded steps
    return out[0] + out[1] if bidirectional else out[0]
