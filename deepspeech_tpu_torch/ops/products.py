"""Products whose operands are rounded to a compute type and whose sums and
results are f32, forward and backward.

This is what ``compute_dtype`` bf16 means for the Conformer
(``models/conformer.py``, ``ops/attention.py``), as for DS2's kernels and
their layers' backward products (``ops/cuda/recurrence.py``): each operand
is rounded to bf16, and nothing a product returns is: the outputs, the
input gradients and the weight gradients of every product come out in f32.

* ``mm_f32(a, b)``, ``bmm_f32(a, b)``: a @ b of operands in their own
  type, with f32 sums and an f32 result;
* ``rounded(x, dtype)``: ``x`` rounded to ``dtype`` and held in f32; the
  gradient passes unchanged (straight through), for an f32 product whose
  operands are to be bf16 (a convolution: bf16 x bf16 products are exact
  in f32, so the f32 product of the rounded operands is the bf16 one with
  f32 sums);
* ``cast_through(x, dtype)``: ``x`` cast to ``dtype`` and back to f32 by
  autograd's casts, so its gradient is rounded to ``dtype`` too;
* ``matmul_nt(x, w, dtype)``: x (..., K) times w (N, K) transposed ->
  (..., N); its backward takes the incoming gradient in ``dtype`` as the
  operand of both products;
* ``bmm_nt(a, b, dtype)``: (G, M, K) times (G, N, K) transposed ->
  (G, M, N), the same batched.

On the card the products run on the bf16 tensor cores with an f32 output
(``torch.mm``/``torch.bmm`` with ``out_dtype``); elsewhere as f32 products
of the rounded operands.
"""

from __future__ import annotations

import torch


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 sums and an f32 result, operands in their own type
    (bf16 products are exact in f32)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``mm_f32`` batched: a @ b with f32 sums and an f32 result."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).float()

    @staticmethod
    def backward(ctx, g):
        return g, None


def rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype``, in f32; the gradient straight through."""
    return _Rounded.apply(x, dtype)


def cast_through(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` cast to ``dtype`` (None: as it is) and back to f32. Autograd
    differentiates both casts, so the gradient is rounded to ``dtype`` as
    the cast's is; ``rounded`` passes it straight through."""
    return x.float() if dtype is None else x.to(dtype).float()


class _MatmulNT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dtype):
        lead = x.shape[:-1]
        x2 = x.to(dtype).reshape(-1, x.shape[-1])
        wc = w.to(dtype)
        ctx.save_for_backward(x2, wc)
        ctx.dtype, ctx.x_shape = dtype, x.shape
        return mm_f32(x2, wc.t()).view(*lead, w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x2, wc = ctx.saved_tensors
        g2 = g.to(ctx.dtype).reshape(-1, g.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = mm_f32(g2, wc).view(ctx.x_shape)
        if ctx.needs_input_grad[1]:
            dw = mm_f32(g2.t(), x2)
        return dx, dw, None


def matmul_nt(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """x (..., K) @ w (N, K)^T -> (..., N) f32, operands in ``dtype``."""
    return _MatmulNT.apply(x, w, dtype)


class _BmmNT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, dtype):
        ac, bc = a.to(dtype), b.to(dtype)
        ctx.save_for_backward(ac, bc)
        ctx.dtype = dtype
        return bmm_f32(ac, bc.transpose(1, 2))

    @staticmethod
    def backward(ctx, g):
        ac, bc = ctx.saved_tensors
        g2 = g.to(ctx.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = bmm_f32(g2, bc)
        if ctx.needs_input_grad[1]:
            db = bmm_f32(g2.transpose(1, 2), ac)
        return da, db, None


def bmm_nt(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a (G, M, K) @ b (G, N, K)^T -> (G, M, N) f32, operands in
    ``dtype``."""
    return _BmmNT.apply(a, b, dtype)
