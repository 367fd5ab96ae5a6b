"""Conformer acoustic model with a CTC head (arXiv:2005.08100, Fig. 1).

* subsampling (ESPnet ``Conv2dSubsampling``): Conv2d(1 -> d, 3x3,
  stride 2) + ReLU, Conv2d(d -> d, 3x3, stride 2) + ReLU, no padding, over
  (time, mel band); frames past each row's length zeroed after each conv;
  Linear(d x F' -> d) over the channel-major features, then x sqrt(d);
* ``layers`` blocks, each
  x += 1/2 FFN(x); x += MHSA(x); x += Conv(x); x += 1/2 FFN(x); x = LN(x),
  with FFN = LN -> Linear(d -> ff) -> Swish -> Linear(ff -> d), MHSA = LN
  -> relative-position multi-head attention (``ops/attention.py``: learned
  per-head biases u and v, sinusoidal embeddings of the distances T' - 1
  ... -(T' - 1) through a bias-free Linear), Conv = LN -> pointwise
  d -> 2d -> GLU -> padded frames zeroed -> depthwise conv of
  ``conv_kernel`` (k // 2 frames of zeros before, k - 1 - k // 2 after)
  -> BatchNorm -> Swish -> pointwise d -> d;
* head: Linear(d -> classes); returns (logits (B, T', C), probs = softmax,
  output lengths).

The BatchNorm takes its train-mode moments over every position, padding
included (``TorchBatchNorm``, global over a data-parallel mesh). Dropout,
at ``dropout`` in train mode, follows the FFN's Swish and each module's
output before its residual sum, drawn from the step's ``generator``
(``cnn.dropout``); the attention probabilities take none.

With ``compute_dtype=torch.bfloat16`` the operands of every product (the
linear layers, the convolutions, the attention's scores, probabilities and
values) are bf16, and their sums and results f32, forward and backward
(``ops/products.py``): the linear layers and the subsampling's second conv
(as a product over its unfolded 3x3 patches) on bf16 tensor cores with an
f32 output, the first conv and the depthwise conv as f32 convolutions of
the rounded operands. The residual stream, the norms, the softmax and the
BatchNorm stay f32. The one exception is the card's attention kernel,
whose output, its gradients and the position term it takes as its bias are
bf16 (``ops/attention.py``). At f32 every product is f32 with TF32 off
(the train step's ``fp32_matmul``).

Output lengths: T1 = (T - 3) // 2 + 1, T' = (T1 - 3) // 2 + 1, at least 1
(a bucket-padding row of one frame keeps one frame, so that no softmax
and no CTC row is empty).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from deepspeech_tpu_torch.models.cnn import dropout as drop, swish
from deepspeech_tpu_torch.models.layers import TorchBatchNorm, length_mask
from deepspeech_tpu_torch.ops.attention import key_mask, rel_attention
from deepspeech_tpu_torch.ops.products import matmul_nt, rounded
from deepspeech_tpu_torch.utils import trace

LN_EPS = 1e-5


def subsampled_lengths(lengths: torch.Tensor) -> tuple:
    """(B,) frames -> (after the first conv, after the second, at least
    1)."""
    t1 = torch.div(lengths - 3, 2, rounding_mode="floor") + 1
    t2 = torch.div(t1 - 3, 2, rounding_mode="floor") + 1
    return t1.clamp(min=0), t2.clamp(min=1)


def linear(x: torch.Tensor, layer: nn.Linear, cd) -> torch.Tensor:
    """``layer(x)`` with the operands in ``cd`` (None: f32), the sum, the
    result and the bias f32."""
    if cd is None:
        return F.linear(x.float(), layer.weight, layer.bias)
    y = matmul_nt(x, layer.weight, cd)
    return y if layer.bias is None else y + layer.bias


def conv(x: torch.Tensor, layer: nn.Module, cd, **kw) -> torch.Tensor:
    """``layer``'s convolution of ``x`` (``F.conv1d`` or ``F.conv2d`` by
    its weight) in f32, of operands rounded to ``cd`` (None: as they are),
    with the f32 bias."""
    w = layer.weight
    if cd is not None:
        x, w = rounded(x, cd), rounded(w, cd)
    op = F.conv1d if w.dim() == 3 else F.conv2d
    return op(x.float(), w, layer.bias, **kw)


def rel_positions(t: int, d: int, device) -> torch.Tensor:
    """(2T - 1, d) sinusoids of the distances T - 1 ... -(T - 1): column
    2m sin(P / 10000^(2m/d)), column 2m + 1 its cos."""
    pos = torch.arange(t - 1, -t, -1, device=device, dtype=torch.float32)
    div = torch.exp(torch.arange(0, d, 2, device=device, dtype=torch.float32)
                    * (-math.log(10000.0) / d))
    angle = pos[:, None] * div[None, :]
    return torch.stack([torch.sin(angle), torch.cos(angle)], -1).reshape(
        2 * t - 1, d)


class ConvSubsampling(nn.Module):
    """(B, n_mels, T) -> (B, T', d), x sqrt(d)."""

    def __init__(self, n_mels: int, d: int, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv0 = nn.Conv2d(1, d, 3, 2)
        self.conv1 = nn.Conv2d(d, d, 3, 2)
        f = ((n_mels - 3) // 2 + 1 - 3) // 2 + 1
        self.out = nn.Linear(d * f, d)
        self.xscale = math.sqrt(d)

    def forward(self, spect: torch.Tensor, lengths: torch.Tensor):
        cd = self.compute_dtype
        t1, t2 = subsampled_lengths(lengths)
        h = spect.transpose(1, 2)[:, None]  # (B, 1, T, n_mels)
        h = F.relu(conv(h, self.conv0, cd, stride=2))
        h = h * length_mask(t1, h.shape[2])[:, None, :, None]
        if cd is None:
            h = F.relu(F.conv2d(h, self.conv1.weight, self.conv1.bias, 2))
            h = h.permute(0, 2, 3, 1)  # (B, T', F', d)
        else:  # over the unfolded patches, channel-major as the weight
            b, _, t, f = h.shape
            t, f = (t - 3) // 2 + 1, (f - 3) // 2 + 1
            cols = F.unfold(h, 3, stride=2).transpose(1, 2)
            w = self.conv1.weight
            h = F.relu(matmul_nt(cols, w.view(w.shape[0], -1), cd)
                       + self.conv1.bias).view(b, t, f, -1)
        h = h * length_mask(t2, h.shape[1])[:, :, None, None]
        b, t, f, c = h.shape
        h = h.transpose(2, 3).reshape(b, t, c * f)
        return linear(h, self.out, cd) * self.xscale


class FeedForward(nn.Module):
    mesh = None

    def __init__(self, d: int, ff: int, rate: float, compute_dtype=None):
        super().__init__()
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.linear1 = nn.Linear(d, ff)
        self.linear2 = nn.Linear(ff, d)
        self.rate, self.compute_dtype = rate, compute_dtype

    def forward(self, x, generator=None):
        cd = self.compute_dtype
        h = swish(linear(self.norm(x), self.linear1, cd))
        if self.rate > 0 and self.training:
            h = drop(h, self.rate, generator, self.mesh)
        return linear(h, self.linear2, cd)


class RelMultiHeadAttention(nn.Module):
    def __init__(self, d: int, heads: int, compute_dtype=None):
        super().__init__()
        self.heads, self.dk = heads, d // heads
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.linear_q = nn.Linear(d, d)
        self.linear_k = nn.Linear(d, d)
        self.linear_v = nn.Linear(d, d)
        self.linear_out = nn.Linear(d, d)
        self.linear_pos = nn.Linear(d, d, bias=False)
        bound = math.sqrt(6.0 / (heads + self.dk))  # xavier_uniform
        self.pos_bias_u = nn.Parameter(
            torch.empty(heads, self.dk).uniform_(-bound, bound))
        self.pos_bias_v = nn.Parameter(
            torch.empty(heads, self.dk).uniform_(-bound, bound))
        self.compute_dtype = compute_dtype

    def forward(self, x, pos, masks):
        cd = self.compute_dtype
        b, t, d = x.shape
        h = self.norm(x)

        def heads(y):  # (B, T, d) -> (B, H, T, dk)
            return y.view(b, t, self.heads, self.dk).transpose(1, 2)

        q = heads(linear(h, self.linear_q, cd))
        k = heads(linear(h, self.linear_k, cd))
        v = heads(linear(h, self.linear_v, cd))
        p = linear(pos, self.linear_pos, cd).view(
            2 * t - 1, self.heads, self.dk).transpose(0, 1)
        out = rel_attention(q + self.pos_bias_u[:, None],
                            q + self.pos_bias_v[:, None], k, v, p,
                            masks["keys"], cd)
        out = out.transpose(1, 2).reshape(b, t, d)
        return linear(out, self.linear_out, cd)


class ConvModule(nn.Module):
    def __init__(self, d: int, kernel: int, bnm: float = 0.1,
                 compute_dtype=None):
        super().__init__()
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.pointwise1 = nn.Linear(d, 2 * d)
        self.depthwise = nn.Conv1d(d, d, kernel, groups=d)
        self.bn = TorchBatchNorm(d, bnm, axis=1)
        self.pointwise2 = nn.Linear(d, d)
        self.pad = (kernel // 2, kernel - 1 - kernel // 2)
        self.compute_dtype = compute_dtype

    def forward(self, x, masks):
        cd = self.compute_dtype
        h = F.glu(linear(self.norm(x), self.pointwise1, cd), -1)
        h = (h * masks["frames"]).transpose(1, 2)
        h = conv(F.pad(h, self.pad), self.depthwise, cd,
                 groups=self.depthwise.weight.shape[0])
        h = swish(self.bn(h))
        return linear(h.transpose(1, 2), self.pointwise2, cd)


class ConformerBlock(nn.Module):
    mesh = None

    def __init__(self, d: int, heads: int, ff: int, kernel: int,
                 rate: float, bnm: float = 0.1, compute_dtype=None):
        super().__init__()
        self.ffn1 = FeedForward(d, ff, rate, compute_dtype)
        self.mhsa = RelMultiHeadAttention(d, heads, compute_dtype)
        self.conv_module = ConvModule(d, kernel, bnm, compute_dtype)
        self.ffn2 = FeedForward(d, ff, rate, compute_dtype)
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.rate = rate

    def _drop(self, x, generator):
        if self.rate > 0 and self.training:
            return drop(x, self.rate, generator, self.mesh)
        return x

    def forward(self, x, pos, masks, generator=None):
        """``masks``: "keys" (``key_mask``) and "frames" (B, T', 1), the
        valid frames, of the rows' output lengths."""
        with trace.span("ffn1"):
            x = x + 0.5 * self._drop(self.ffn1(x, generator), generator)
        with trace.span("mhsa"):
            x = x + self._drop(self.mhsa(x, pos, masks), generator)
        with trace.span("conv_module"):
            x = x + self._drop(self.conv_module(x, masks), generator)
        with trace.span("ffn2"):
            x = x + 0.5 * self._drop(self.ffn2(x, generator), generator)
        return self.norm(x)


class Conformer(nn.Module):
    """The Conformer-CTC acoustic model (module docstring)."""

    mesh = None

    def __init__(self, num_classes: int, d_model: int = 512, heads: int = 8,
                 layers: int = 17, ff: int = 2048, conv_kernel: int = 32,
                 n_mels: int = 80, dropout: float = 0.0, bnm: float = 0.1,
                 compute_dtype=None):
        super().__init__()
        if d_model % heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"{heads} heads")
        self.n_mels, self.d_model, self.rate = n_mels, d_model, dropout
        self.subsample = ConvSubsampling(n_mels, d_model, compute_dtype)
        self.blocks = nn.ModuleList(
            ConformerBlock(d_model, heads, ff, conv_kernel, dropout, bnm,
                           compute_dtype) for _ in range(layers))
        self.head = nn.Linear(d_model, num_classes)
        self.compute_dtype = compute_dtype

    def _drop(self, x, generator):
        if self.rate > 0 and self.training:
            return drop(x, self.rate, generator, self.mesh)
        return x

    def forward(self, spect: torch.Tensor, lengths: torch.Tensor,
                generator: torch.Generator | None = None):
        """spect: (B, n_mels, T) normalized log-mel; lengths: (B,) valid
        frames. -> (logits (B, T', C), probs, output lengths)."""
        if spect.shape[1] != self.n_mels:
            raise ValueError(f"the Conformer takes {self.n_mels} mel bands; "
                             f"got {spect.shape[1]} rows (set the front's "
                             "n_mels)")
        out_lengths = subsampled_lengths(lengths)[1]
        with trace.span("subsample"):
            x = self._drop(self.subsample(spect, lengths), generator)
        t = x.shape[1]
        pos = rel_positions(t, self.d_model, x.device)
        masks = {"keys": key_mask(out_lengths, t),
                 "frames": length_mask(out_lengths, t)[..., None]}
        for i, block in enumerate(self.blocks):
            with trace.span(f"conformer.{i}"):
                x = block(x, pos, masks, generator)
        with trace.span("head"):
            logits = linear(x, self.head, self.compute_dtype)
        return logits, torch.softmax(logits, dim=-1), out_lengths
