"""CTC loss with the JAX package's contract (``ops/ctc.py:ctc_loss``).

Raw logits (B, T, C) in, per-sample negative log likelihood (B,) out, the
softmax taken inside (like warp-ctc). Variable logit and target lengths by
masking: the recursions freeze past each row's logit length. An impossible
alignment (more labels than frames can hold) gives +inf and a gradient of
exactly 0.

The forward runs the alpha recursion (K8, ``ops/cuda/ctc.py:ctc_alpha``);
the backward runs the beta recursion (K9, ``ctc_beta``) and the closed-form
gradient of ``deepspeech_tpu/ops/pallas/ctc_kernel.py:_ctc_bwd``:

    dL/dlogit[b, t, c] = softmax[b, t, c] - sum_{s: ext_s = c} gamma[b, t, s]

with gamma = exp(alpha + beta - logP), zero on frames past the length and
on rows whose loss is not finite, scaled by the incoming grad. The emission
gather and the occupancy scatter are ``torch.gather`` / ``scatter_add_``
outside the kernels, where the JAX package uses one-hot einsums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepspeech_tpu_torch.ops.cuda import ctc as ctc_kernel
from deepspeech_tpu_torch.ops.cuda.ctc import NEG_INF


def _prep(logits, targets, target_lengths, blank):
    """log-probs (B, T, C), extended labels (B, S), the skip / valid / end
    state tables (B, S) and the per-state emissions (B, T, S)."""
    b, t, c = logits.shape
    s = 2 * targets.shape[1] + 1
    dev = logits.device
    log_probs = F.log_softmax(logits.float(), dim=-1)
    ext = torch.full((b, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = targets.to(device=dev, dtype=torch.int64)
    prev2 = torch.cat([ext.new_full((b, 2), blank), ext[:, :-2]], 1)
    lane = torch.arange(s, device=dev)[None, :]
    can_skip = (lane % 2 == 1) & (ext != prev2)
    skip = torch.where(can_skip, 0.0, NEG_INF)
    tl = target_lengths.to(dev)[:, None]
    valid = torch.where(lane < 2 * tl + 1, 0.0, NEG_INF)
    end = torch.where((lane == 2 * tl) | ((lane == 2 * tl - 1) & (tl > 0)),
                      0.0, NEG_INF)
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(b, t, s))
    return log_probs, ext, skip, valid, end, emit


def _loss_from_alpha(alpha_last, target_lengths):
    tl = target_lengths.to(alpha_last.device).long()
    end_blank = alpha_last.gather(1, (2 * tl)[:, None])[:, 0]
    end_label = alpha_last.gather(1, (2 * tl - 1).clamp(min=0)[:, None])[:, 0]
    end_label = torch.where(tl > 0, end_label, NEG_INF)
    m = torch.maximum(end_blank, end_label)
    dead = m <= NEG_INF
    ms = torch.where(dead, 0.0, m)
    sm = torch.exp(end_blank - ms) + torch.exp(end_label - ms)
    sm = torch.where(dead, 1.0, sm)
    total = torch.where(dead, -torch.inf, ms + torch.log(sm))
    return -total


class CTCLoss(torch.autograd.Function):
    """Per-sample CTC NLL; forward K8, backward K9 + closed-form grad."""

    @staticmethod
    def forward(ctx, logits, logit_lengths, targets, target_lengths, blank):
        log_probs, ext, skip, valid, end, emit = _prep(
            logits, targets, target_lengths, blank)
        lens = logit_lengths.to(logits.device)
        alphas = ctc_kernel.ctc_alpha(emit, skip, valid, lens)
        idx = (lens.long() - 1).clamp(min=0)
        alpha_last = alphas[torch.arange(alphas.shape[0],
                                         device=alphas.device), idx]
        loss = _loss_from_alpha(alpha_last, target_lengths)
        ctx.save_for_backward(log_probs, ext, skip, valid, end, emit, alphas,
                              loss, lens)
        return loss

    @staticmethod
    def backward(ctx, g):
        log_probs, ext, skip, valid, end, emit, alphas, loss, lens = \
            ctx.saved_tensors
        betas = ctc_kernel.ctc_beta(emit, skip, valid, end, lens)
        sample_ok = torch.isfinite(loss)[:, None, None]
        # emission is counted in both alpha and beta: remove one copy
        log_gamma = alphas + betas - emit + loss[:, None, None]
        gamma = torch.where(sample_ok & (log_gamma > -80.0),
                            torch.exp(log_gamma.clamp(max=0.0)), 0.0)
        b, t, c = log_probs.shape
        occupancy = torch.zeros_like(log_probs).scatter_add_(
            2, ext[:, None, :].expand(b, t, ext.shape[1]), gamma)
        frame_ok = (torch.arange(t, device=lens.device)[None, :]
                    < lens[:, None])[..., None]
        dlogits = torch.where(frame_ok & sample_ok,
                              torch.exp(log_probs) - occupancy, 0.0)
        # rows zeroed above stay 0 even when g is not finite there
        dlogits = torch.where(sample_ok, dlogits * g[:, None, None], 0.0)
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
