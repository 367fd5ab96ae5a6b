"""CTC loss with the JAX package's contract (``ops/ctc.py:ctc_loss``).

Raw logits (B, T, C) in, per-sample negative log likelihood (B,) out, the
softmax taken inside (like warp-ctc). Variable logit and target lengths by
masking: the recursions freeze past each row's logit length. An impossible
alignment (more labels than frames can hold) gives +inf and a gradient of
exactly 0.

The forward is one launch of K8 (``ops/cuda/ctc.py:ctc_alpha``): the alpha
recursion and the loss. The backward is one launch of K9 (``ctc_beta``):
the beta recursion with the closed-form gradient of
``deepspeech_tpu/ops/pallas/ctc_kernel.py:_ctc_bwd`` fused in,

    dL/dlogit[b, t, c] = softmax[b, t, c] - sum_{s: ext_s = c} gamma[b, t, s]

with gamma = exp(alpha + beta - logP), zero on frames past the length and
on rows whose loss is not finite, scaled by the incoming grad. The kernels
gather the emissions and sum the occupancy by class themselves, where the
JAX package uses one-hot einsums; on the CPU the plain twins do it with
``torch.gather`` / ``scatter_add_``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepspeech_tpu_torch.ops.cuda import ctc as ctc_kernel
from deepspeech_tpu_torch.utils import trace


def _prep(logits, targets, blank):
    """log-probs (B, T, C) f32 and the extended labels (B, S) int32: the
    blank at even states, the targets at odd ones."""
    b = logits.shape[0]
    s = 2 * targets.shape[1] + 1
    dev = logits.device
    log_probs = F.log_softmax(logits.float(), dim=-1)
    ext = torch.full((b, s), blank, dtype=torch.int32, device=dev)
    ext[:, 1::2] = targets.to(dev)  # cast to int32 by the copy
    return log_probs, ext


class CTCLoss(torch.autograd.Function):
    """Per-sample CTC NLL; forward K8, backward K9 (the closed-form grad
    fused in)."""

    @staticmethod
    def forward(ctx, logits, logit_lengths, targets, target_lengths, blank):
        log_probs, ext = _prep(logits, targets, blank)
        # int32 once, as both kernels take them
        lens = logit_lengths.to(logits.device, torch.int32)
        tls = target_lengths.to(logits.device, torch.int32)
        alphas, loss = ctc_kernel.ctc_alpha(log_probs, ext, tls, lens)
        ctx.save_for_backward(log_probs, ext, tls, lens, alphas, loss)
        return loss

    @staticmethod
    def backward(ctx, g):
        log_probs, ext, tls, lens, alphas, loss = ctx.saved_tensors
        with trace.span("ctc.bwd"):
            dlogits = ctc_kernel.ctc_beta(log_probs, ext, tls, lens, alphas,
                                          loss, g)
        return dlogits, None, None, None, None


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             targets: torch.Tensor, target_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Per-sample CTC negative log likelihood, (B,) f32.

    logits: (B, T, C) raw (pre-softmax); logit_lengths: (B,); targets:
    (B, L) padded label ids (no blanks); target_lengths: (B,). Impossible
    alignments yield +inf, like warp-ctc."""
    return CTCLoss.apply(logits, logit_lengths, targets, target_lengths,
                         blank)


def ctc_loss_mean(logits, logit_lengths, targets, target_lengths,
                  blank: int = 0) -> torch.Tensor:
    """Batch loss with warp-ctc + reference semantics: sum over the batch /
    B, non-finite samples excluded (``ops/ctc.py:ctc_loss_mean``)."""
    per = ctc_loss(logits, logit_lengths, targets, target_lengths, blank)
    return torch.where(torch.isfinite(per), per, 0.0).sum() / logits.shape[0]
