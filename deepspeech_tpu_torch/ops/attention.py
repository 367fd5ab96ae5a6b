"""Multi-head self-attention with relative positions (Transformer-XL, as
the Conformer of arXiv:2005.08100 cites it, in ESPnet's
``RelPositionMultiHeadedAttention`` form), the core under
``models/conformer.py``'s attention module.

``rel_attention(qu, qv, k, v, p, keep, compute_dtype)`` takes the
projected heads: ``qu`` = q + u and ``qv`` = q + v (the learned per-head
biases added), the keys ``k`` and values ``v``, all (B, H, T, dk), the
projected position embeddings ``p`` (H, 2T - 1, dk) for the distances
T - 1 ... -(T - 1), and the keys each row may read (``key_mask`` of its
valid frames). Query i's score of key j is ((qu_i . k_j) + (qv_i .
p_{T-1-i+j})) / sqrt(dk): the position term reads distance i - j
(``rel_shift``). Keys at or past a row's length are masked before the
softmax (a row of no valid frame keeps its first key, so that no softmax
is empty).

Two routes, by a fixed rule (``route``):

* "sdpa" (a CUDA tensor and bf16 operands): the position term, a product
  with an f32 result (``ops/products.py``), is shifted with ``rel_shift``
  into an additive bias (padded keys -inf) and handed to
  ``F.scaled_dot_product_attention`` with the memory-efficient backend
  pinned, which returns the bias's gradient; a fallback to another
  backend raises rather than runs. The kernel takes its scores and its
  softmax in f32 and its operands (q, k, v, the probabilities) in bf16.
  Its own types make the bias, the output and the gradients it returns
  (of q, k, v and the bias) bf16: the one place where a product's result
  is rounded to bf16.
* "plain" (the CPU, and f32 anywhere): the same products spelled out,
  scores in f32 from operands rounded to the compute type, the softmax in
  f32, the probabilities rounded to the compute type before the product
  with v.

Each call counts one launch of its route (``mhsa_sdpa_launches``,
``mhsa_plain_launches``), which ``ops.cuda.read_counters`` reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deepspeech_tpu_torch.ops.products import bmm_nt, cast_through

mhsa_sdpa_launches = 0  # rel_attention calls on the SDPA route
mhsa_plain_launches = 0  # rel_attention calls on the plain route


def route(device: torch.device, compute_dtype) -> str:
    """"sdpa" for a CUDA tensor with bf16 operands, else "plain"."""
    return ("sdpa" if device.type == "cuda"
            and compute_dtype == torch.bfloat16 else "plain")


def rel_shift(bd: torch.Tensor) -> torch.Tensor:
    """(..., T, 2T - 1) position scores over the distances T - 1 ...
    -(T - 1) -> (..., T, T) with out[i, j] = bd[i, T - 1 - i + j]: one zero
    column prepended, the rows re-cut one element later each (the
    pad-and-view shift of Transformer-XL)."""
    *lead, t, n = bd.shape
    padded = F.pad(bd, (1, 0)).reshape(*lead, n + 1, t)
    return padded[..., 1:, :].reshape(*lead, t, n)[..., :t]


def key_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B, 1, 1, T) bool: the keys a row's queries may read, at least its
    first."""
    keep = lengths.clamp(min=1)
    return (torch.arange(t, device=lengths.device)[None, :]
            < keep[:, None])[:, None, None, :]


def rel_attention(qu: torch.Tensor, qv: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, p: torch.Tensor, keep: torch.Tensor,
                  compute_dtype=None) -> torch.Tensor:
    """-> (B, H, T, dk) attention outputs (module docstring), in the
    compute type on the "sdpa" route and f32 on the "plain" one; ``keep``
    is ``key_mask`` of the rows' lengths."""
    global mhsa_sdpa_launches, mhsa_plain_launches
    dk = qu.shape[-1]
    scale = 1.0 / math.sqrt(dk)
    if route(qu.device, compute_dtype) == "sdpa":
        from torch.nn.attention import SDPBackend, sdpa_kernel

        cd = compute_dtype
        b, h, t, _ = qv.shape
        bd = bmm_nt(qv.transpose(0, 1).reshape(h, b * t, dk), p, cd)
        bd = bd.view(h, b, t, -1).transpose(0, 1)
        bias = torch.where(keep, rel_shift(bd) * scale,
                           float("-inf")).to(cd)
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            out = F.scaled_dot_product_attention(
                qu.to(cd), k.to(cd), v.to(cd), attn_mask=bias, scale=scale)
        mhsa_sdpa_launches += 1
        return out
    cd = compute_dtype
    ac = torch.matmul(cast_through(qu, cd),
                      cast_through(k, cd).transpose(-1, -2))
    bd = torch.matmul(cast_through(qv, cd),
                      cast_through(p, cd).transpose(-1, -2))
    scores = torch.where(keep, (ac + rel_shift(bd)) * scale, float("-inf"))
    probs = torch.softmax(scores, -1)
    mhsa_plain_launches += 1
    return torch.matmul(cast_through(probs, cd), cast_through(v, cd))
