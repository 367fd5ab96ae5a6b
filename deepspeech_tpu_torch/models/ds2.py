"""DeepSpeech2 acoustic model (torch.nn), the JAX package's ``models/ds2.py``.

* masked 2-D conv stack: Conv(1->32, k=(41,11), s=(2,2), p=(20,5)) + BN +
  Hardtanh(0,20); Conv(32->32, k=(21,11), s=(2,1), p=(10,5)) + BN +
  Hardtanh(0,20); activations re-zeroed past each utterance's valid frames
  after every stage (MaskConv);
* frequency collapse to a 1312-feature sequence in ``c*41 + f`` order,
  time-major;
* N recurrent layers, bidirectional direction-sum, sequence BatchNorm on
  every layer but the first;
* unidirectional models append a Lookahead conv + Hardtanh;
* head: BatchNorm folded into a bias-free Linear(H -> num_classes);
* returns (logits (B, T', C), probs = softmax, output_lengths).

With ``compute_dtype=torch.bfloat16`` the matmul and conv operands are
rounded to bf16 while every sum, the state and the gates stay f32, as in the
JAX model. On the card the two convs then run on the tensor-core kernels
of ``ops/cuda/conv.py`` (bf16 operands, f32 sums and results); in f32, and
on the CPU, they run as ``F.conv2d`` in f32 on the rounded operands (TF32
off). Either way their results are not rounded to bf16 before the
BatchNorm.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from deepspeech_tpu_torch.models.layers import (Lookahead, TorchBatchNorm,
                                                hardtanh_0_20, length_mask)
from deepspeech_tpu_torch.ops import fp32_matmul
from deepspeech_tpu_torch.ops.cuda import conv as conv_kernels
from deepspeech_tpu_torch.ops.products import cast_through
from deepspeech_tpu_torch.ops.rnn import CELL_GATES, rnn_scan
from deepspeech_tpu_torch.parallel.tp_rnn import (gathered,
                                                  maybe_direction_sharded)
from deepspeech_tpu_torch.utils import trace


def conv_out_lengths(lengths: torch.Tensor) -> torch.Tensor:
    """Time lengths after the conv stack: floor((L-1)/2)+1."""
    return (lengths - 1) // 2 + 1


class ConvFrontend(nn.Module):
    """Masked two-conv front, (B, 161, T) -> (B, 32, 41, T')."""

    def __init__(self, bnm: float = 0.1, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv0 = nn.Conv2d(1, 32, (41, 11), (2, 2), (20, 5))
        self.conv1 = nn.Conv2d(32, 32, (21, 11), (2, 1), (10, 5))
        self.bn0 = TorchBatchNorm(32, bnm, axis=1)
        self.bn1 = TorchBatchNorm(32, bnm, axis=1)

    def forward(self, x: torch.Tensor, out_lengths: torch.Tensor,
                out_start: torch.Tensor | None = None) -> torch.Tensor:
        """``out_start``: optional (B,) first valid conv-output index. The
        streaming runtime (``serve/streaming.py``) zeroes the activations
        before a window's valid range as the mask zeroes them past its
        end, so conv2 reads true zeros at both boundaries."""
        cd = self.compute_dtype
        h = x[:, None]
        for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
            if conv_kernels.on_kernels(h.device, cd):
                h = conv_kernels.conv2d_bf16(h, conv.weight, conv.bias,
                                             conv.stride, conv.padding)
            else:
                with fp32_matmul():
                    h = F.conv2d(cast_through(h, cd),
                                 cast_through(conv.weight, cd),
                                 conv.bias.float(), conv.stride,
                                 conv.padding)
            mask = length_mask(out_lengths, h.shape[-1])
            if out_start is not None:
                idx = torch.arange(h.shape[-1], device=h.device)[None, :]
                mask = mask * (idx >= out_start[:, None]).float()
            mask = mask[:, None, None, :]
            h = h * mask
            h = bn(h) * mask
            h = hardtanh_0_20(h) * mask
            if cd is not None:
                h = h.to(cd)
        return h


class RecurrentLayer(nn.Module):
    """Optional sequence BN + (bi)directional recurrence with direction sum.

    Weights keep the JAX layout, stacked over directions: w_ih (D, F, G*H),
    b_ih (D, G*H), w_hh (D, H, G*H), b_hh (D, G*H). Under tensor
    parallelism (``parallel.shard_params``) the layer holds a slice of
    each: one direction, (1, ...), of a bidirectional layer at model 2,
    which runs through ``maybe_direction_sharded`` as the JAX layer does;
    else a slice of the gate axis (or of the directions at world size 1),
    which it gathers whole before ``rnn_scan`` (``parallel/tp_rnn.py``)."""

    mesh = None

    def __init__(self, input_size: int, hidden_size: int, cell: str = "gru",
                 bidirectional: bool = True, batch_norm: bool = True,
                 bnm: float = 0.1, compute_dtype=None):
        super().__init__()
        self.cell, self.bidirectional = cell, bidirectional
        self.compute_dtype = compute_dtype
        self.bn = TorchBatchNorm(input_size, bnm) if batch_norm else None
        d = 2 if bidirectional else 1
        g = CELL_GATES[cell] * hidden_size
        stdv = 1.0 / math.sqrt(hidden_size)

        def uniform(*shape):
            return nn.Parameter(torch.empty(*shape).uniform_(-stdv, stdv))

        self.w_ih = uniform(d, input_size, g)
        self.b_ih = uniform(d, g)
        self.w_hh = uniform(d, hidden_size, g)
        self.b_hh = uniform(d, g)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        if self.bn is not None:
            x = self.bn(x)
        out = maybe_direction_sharded(
            x, lengths, self.w_ih, self.b_ih, self.w_hh, self.b_hh,
            mesh=self.mesh, cell=self.cell, bidirectional=self.bidirectional,
            compute_dtype=self.compute_dtype)
        if out is not None:
            return out
        w = [gathered(p, self.mesh, "gather_rnn")
             for p in (self.w_ih, self.b_ih, self.w_hh, self.b_hh)]
        return rnn_scan(x, lengths, *w, cell=self.cell,
                        bidirectional=self.bidirectional,
                        compute_dtype=self.compute_dtype)


class DeepSpeech2(nn.Module):
    """The DS2 conv+RNN acoustic model. On a mesh whose rule shards the
    head's classes, ``fc.weight`` is gathered whole before the fold."""

    mesh = None

    def __init__(self, num_classes: int, hidden_size: int = 800,
                 hidden_layers: int = 6, cell: str = "gru",
                 bidirectional: bool = True, context: int = 20,
                 bnm: float = 0.1, compute_dtype=None):
        super().__init__()
        self.bidirectional = bidirectional
        self.conv = ConvFrontend(bnm, compute_dtype)
        n_feat = 32 * 41
        self.rnns = nn.ModuleList(
            RecurrentLayer(n_feat if i == 0 else hidden_size, hidden_size,
                           cell, bidirectional, batch_norm=i > 0, bnm=bnm,
                           compute_dtype=compute_dtype)
            for i in range(hidden_layers))
        self.lookahead = (None if bidirectional
                          else Lookahead(hidden_size, context))
        self.fc_bn = TorchBatchNorm(hidden_size, bnm, fold=True)
        self.fc = nn.Linear(hidden_size, num_classes, bias=False)
        self.span_names = [f"rnn.{i}" for i in range(hidden_layers)]

    def forward(self, spect: torch.Tensor, lengths: torch.Tensor,
                generator: torch.Generator | None = None):
        """spect: (B, 161, T) normalized log-spectrogram; lengths: (B,)
        valid frame counts. -> (logits (B, T', C), probs, output_lengths).
        ``generator`` is ignored: the model has no dropout (a ``ConvStack``
        draws its dropout from it; the train step passes it to both)."""
        out_lengths = conv_out_lengths(lengths)
        with trace.span("conv"):
            x = self.conv(spect.float(), out_lengths)
        b, c, f, t = x.shape
        x = x.reshape(b, c * f, t).permute(2, 0, 1)  # (T', B, 1312)
        for layer, name in zip(self.rnns, self.span_names):
            with trace.span(name):
                x = layer(x, out_lengths)
        with trace.span("head"), fp32_matmul():
            if self.lookahead is not None:
                x = hardtanh_0_20(self.lookahead(x))
            # the head BN folds into the fc weight:
            # bn(x) @ W == x @ (a[:, None] * W) + b @ W
            a, sh = self.fc_bn(x)
            kernel = gathered(self.fc.weight, self.mesh,
                              "gather_head").float().t()  # (H, C)
            x = x @ (a[:, None] * kernel) + sh @ kernel
        logits = x.transpose(0, 1).float()
        return logits, torch.softmax(logits, dim=-1), out_lengths
