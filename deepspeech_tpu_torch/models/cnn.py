"""The pure-convolutional model family (torch.nn), the JAX package's
``models/cnn.py``.

Six variants share one container, :class:`ConvStack`: a sequence of
:class:`ConvBlock` specs (dicts, the JAX package's tables copied) and a 1x1
conv head.

* ``cnn``          Wav2Letter: k=13 stride-2 prolog, N body convs, k=31 +
  k=1 epilog; ReLU or GLU (GLU doubles the conv's channels);
* ``cnn_residual`` k=7 blocks with residual skips and squeeze-excitation;
* ``glu_small``    the 15-layer GLU convnet;
* ``glu_large``    the 17-layer GLU convnet (all its padding on layer 1,
  so lengths grow);
* ``large_cnn``    the 17-layer widening ReLU convnet;
* ``cnn_jasper``   5 blocks x 3 sub-blocks with SE, a dilated epilog.

Convs are ``nn.Conv1d`` over (B, C, T). Valid lengths follow each layer's
exact conv arithmetic, and every block re-masks its output, so padding never
reaches the next layer. The family runs in f32 with TF32 off whatever the
caller's ``compute_dtype`` (the JAX factory never gives a CNN one).

``ConvStack.forward(spect (B, 161, T), lengths, generator=None)`` returns
(logits (B, T', C), probs, out_lengths), as ``DeepSpeech2`` does; in train
mode dropout draws its keep masks from ``generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deepspeech_tpu_torch.models.layers import TorchBatchNorm, length_mask
from deepspeech_tpu_torch.ops import fp32_matmul
from deepspeech_tpu_torch.parallel.tp_rnn import gathered

N_BINS = 161


def conv1d_out_length(lengths, kernel: int, stride: int = 1, padding: int = 0,
                      dilation: int = 1):
    """torch Conv1d length arithmetic (ints or tensors)."""
    return (lengths + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """a * sigmoid(b), ``a`` the first half of ``dim``."""
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None, mesh=None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale the kept
    values by 1 / (1 - rate); the draws come from ``generator``. On a
    ``mesh`` the draws are the global batch's and this data shard keeps
    its rows, as the SPMD program draws them."""
    rows = x.shape[0] * (1 if mesh is None else mesh.data)
    keep = torch.rand((rows,) + tuple(x.shape[1:]), generator=generator,
                      device=x.device) < 1.0 - rate
    if mesh is not None:
        keep = mesh.data_rows(keep)
    return torch.where(keep, x / (1.0 - rate), 0.0)


class ConvBlock(nn.Module):
    """Conv1d -> [GLU] -> [BN] -> [ReLU] -> [dropout] -> mask -> [SE] ->
    [skip], on (B, C, T).

    The BatchNorm's statistics cover all T' frames, padding included, as
    the JAX block's do. ``mesh`` (``parallel.attach``) makes the dropout's
    draws the global batch's."""

    mesh = None

    def __init__(self, in_ch: int, out: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, use_glu: bool = False,
                 batch_norm: bool = True, relu: bool = True,
                 dropout: float = 0.0, bnm: float = 0.1,
                 se_ratio: float = 0.0, skip: bool = False,
                 bias: bool = True):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.padding, self.dilation = padding, dilation
        self.use_glu, self.relu, self.dropout = use_glu, relu, dropout
        self.skip = skip
        self.conv = nn.Conv1d(in_ch, out * 2 if use_glu else out, kernel,
                              stride, padding, dilation, bias=bias)
        self.bn = TorchBatchNorm(out, bnm, axis=1) if batch_norm else None
        self.se = 0 < se_ratio <= 1  # squeeze-excitation
        if self.se:
            red = max(1, int(in_ch * se_ratio))
            self.se_reduce = nn.Linear(out, red)
            self.se_expand = nn.Linear(red, out)

    def out_lengths(self, lengths):
        return conv1d_out_length(lengths, self.kernel, self.stride,
                                 self.padding, self.dilation)

    def se_gate(self, squeezed: torch.Tensor) -> torch.Tensor:
        """(B, out) squeeze -> (B, out) sigmoid gate."""
        return torch.sigmoid(self.se_expand(swish(self.se_reduce(squeezed))))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                generator: torch.Generator | None = None, bounds=None,
                defer_se: bool = False):
        """Batch mode: mask by the conv length chain of ``lengths``.

        Streaming mode (``serve/streaming_cnn.py``) passes ``bounds=(lo,
        hi)``, each (B,), the window-local valid output range, and
        ``defer_se=True`` to return before the squeeze-excitation and the
        skip, which the stream finishes with its running statistics."""
        y = self.conv(x)
        out_lengths = self.out_lengths(lengths)
        if self.use_glu:
            y = glu(y, dim=1)
        if self.bn is not None:
            y = self.bn(y)
        if self.relu and not self.use_glu:
            y = F.relu(y)
        if self.dropout > 0 and self.training:
            y = dropout(y, self.dropout, generator, self.mesh)
        if bounds is None:
            mask = length_mask(out_lengths, y.shape[-1])
        else:
            lo, hi = bounds
            idx = torch.arange(y.shape[-1], device=y.device)[None, :]
            mask = ((idx >= lo[:, None]) & (idx < hi[:, None])).float()
        y = y * mask[:, None, :]
        if self.se:
            if defer_se:
                return y, out_lengths
            squeezed = (y.sum(-1)
                        / out_lengths.clamp(min=1)[:, None].to(y.dtype))
            y = self.se_gate(squeezed)[:, :, None] * y
        if self.skip and x.shape[1] == y.shape[1] and self.stride == 1:
            y = y + x
        return y, out_lengths


class ConvStack(nn.Module):
    """A sequence of ConvBlocks defined by spec dicts + a 1x1 conv head.

    ``specs`` keeps the spec dicts (the JAX module's ``blocks``); the
    modules are ``blocks``. On a mesh whose rule shards the head's input
    channels, ``fc.weight`` is gathered whole before the 1x1 conv; the
    blocks stay replicated."""

    mesh = None

    def __init__(self, blocks, num_classes: int, in_features: int = N_BINS):
        super().__init__()
        self.specs = tuple(dict(s) for s in blocks)
        self.num_classes = num_classes
        layers, ch = [], in_features
        for spec in self.specs:
            layers.append(ConvBlock(ch, **spec))
            ch = spec["out"]
        self.blocks = nn.ModuleList(layers)
        self.fc = nn.Conv1d(ch, num_classes, 1, bias=True)

    def forward(self, spect: torch.Tensor, lengths: torch.Tensor,
                generator: torch.Generator | None = None):
        """spect: (B, 161, T); lengths: (B,) valid frames. -> (logits
        (B, T', C), probs, out_lengths)."""
        x, out_lengths = spect.float(), lengths
        with fp32_matmul():
            for block in self.blocks:
                x, out_lengths = block(x, out_lengths, generator)
            weight = gathered(self.fc.weight, self.mesh, "gather_head")
            logits = F.conv1d(x, weight, self.fc.bias).transpose(1, 2).float()
        return logits, torch.softmax(logits, dim=-1), out_lengths


def wav2letter_blocks(size: int, cnn_width: int, repeat_layers: int,
                      kernel: int, use_glu: bool, dropout: float,
                      bnm: float) -> list[dict]:
    """Wav2Letter's module list."""
    pad = kernel // 2
    common = dict(use_glu=use_glu, batch_norm=True, dropout=dropout, bnm=bnm,
                  bias=False)
    blocks = [dict(out=cnn_width, kernel=kernel, stride=2, padding=pad,
                   **common)]
    blocks += [dict(out=cnn_width, kernel=kernel, stride=1, padding=pad,
                    **common) for _ in range(repeat_layers)]
    blocks += [dict(out=size, kernel=31, stride=1, padding=15, **common),
               dict(out=size, kernel=1, stride=1, padding=0, **common)]
    return blocks


def residual_wav2letter_blocks(size: int, cnn_width: int, repeat_layers: int,
                               dropout: float, bnm: float,
                               kernel: int = 7, se_ratio: float = 0.25
                               ) -> list[dict]:
    """Residual Wav2Letter: SE + skip on every body block."""
    pad = kernel // 2
    common = dict(batch_norm=True, dropout=dropout, bnm=bnm, bias=False)
    blocks = [dict(out=cnn_width, kernel=kernel, stride=2, padding=pad,
                   **common)]
    blocks += [dict(out=cnn_width, kernel=kernel, stride=1, padding=pad,
                    se_ratio=se_ratio, skip=True, **common)
               for _ in range(repeat_layers)]
    blocks += [dict(out=size, kernel=31, stride=1, padding=15, **common),
               dict(out=size, kernel=1, stride=1, padding=0, **common)]
    return blocks


# (out_after_glu, conv_out=2*out, kernel, stride, padding) per layer
_SMALL_GLU = [
    (100, 200, 13, 1, 6), (100, 200, 3, 1, 1), (100, 200, 4, 1, 2),
    (125, 250, 5, 1, 2), (125, 250, 6, 1, 3), (150, 300, 7, 1, 3),
    (175, 350, 8, 1, 4), (200, 400, 9, 1, 4), (225, 450, 10, 1, 5),
    (250, 500, 11, 1, 5), (250, 500, 12, 1, 6), (250, 500, 13, 1, 6),
    (300, 600, 14, 1, 7), (300, 600, 15, 1, 7), (375, 750, 21, 1, 10),
]

# (padding all on layer 1)
_LARGE_GLU = [
    (200, 400, 13, 1, 170), (220, 440, 14, 1, 0), (242, 484, 15, 1, 0),
    (266, 532, 16, 1, 0), (292, 584, 17, 1, 0), (321, 642, 18, 1, 0),
    (353, 706, 19, 1, 0), (388, 776, 20, 1, 0), (426, 852, 21, 1, 0),
    (468, 936, 22, 1, 0), (514, 1028, 23, 1, 0), (565, 1130, 24, 1, 0),
    (621, 1242, 25, 1, 0), (683, 1366, 26, 1, 0), (751, 1502, 27, 1, 0),
    (826, 1652, 28, 1, 0), (908, 1816, 29, 1, 0),
]

# (out, kernel, stride, padding)
_LARGE_CNN = [
    (200, 13, 2, 6), (220, 14, 1, 7), (242, 15, 1, 7), (266, 16, 1, 8),
    (292, 17, 1, 8), (321, 18, 1, 9), (353, 19, 1, 9), (388, 20, 1, 10),
    (426, 21, 1, 10), (468, 22, 1, 11), (514, 23, 1, 11), (565, 24, 1, 12),
    (621, 25, 1, 12), (683, 26, 1, 13), (751, 27, 1, 13), (826, 28, 1, 14),
    (826, 29, 1, 14),
]

_GLU_LARGE_DROPOUT = [0.2, 0.214, 0.228, 0.245, 0.262, 0.280, 0.300, 0.321,
                      0.347, 0.368, 0.393, 0.421, 0.450, 0.482, 0.516,
                      0.552, 0.590]


def glu_blocks(table, layer_num: int, dropout, bnm: float) -> list[dict]:
    blocks = []
    for i, (out, _conv_out, k, s, p) in enumerate(table[:layer_num]):
        d = dropout[i] if isinstance(dropout, (list, tuple)) else dropout
        blocks.append(dict(out=out, kernel=k, stride=s, padding=p,
                           use_glu=True, batch_norm=True, dropout=d, bnm=bnm))
    return blocks


def jasper_blocks(dropout_block: float = 0.2, epilog_dropout: float = 0.3,
                  bnm: float = 0.1, se_ratio: float = 0.25,
                  sub_blocks: int = 3) -> list[dict]:
    """Jasper-style stack: 5 blocks x 3 sub-blocks, SE + residual on each
    block's last."""
    channels = [256, 384, 512, 640, 768]
    kernels = [11, 13, 17, 21, 25]
    common = dict(batch_norm=True, bnm=bnm, bias=False)
    blocks = [dict(out=256, kernel=11, stride=2, padding=5, dropout=0.2,
                   **common)]  # prolog
    for ch, k in zip(channels, kernels):
        for s in range(sub_blocks):
            last = s == sub_blocks - 1
            blocks.append(dict(out=ch, kernel=k, stride=1, padding=k // 2,
                               dropout=dropout_block,
                               se_ratio=se_ratio if last else 0.0,
                               skip=last, **common))
    blocks += [dict(out=896, kernel=29, stride=1, padding=56, dilation=4,
                    dropout=epilog_dropout, **common),
               dict(out=1024, kernel=1, stride=1, padding=0,
                    dropout=epilog_dropout, **common)]
    return blocks


def cnn_blocks(rnn_type: str, cnn_width: int = 256, hidden_size: int = 800,
               hidden_layers: int = 6, dropout: float = 0.0,
               bnm: float = 0.1, use_glu: bool = False) -> list[dict]:
    """The block specs of a variant. ``hidden_size`` is the epilog width
    of cnn/cnn_residual; ``hidden_layers`` the body depth of
    cnn/cnn_residual and the layer count of glu_small."""
    if rnn_type == "cnn":
        return wav2letter_blocks(hidden_size, cnn_width, hidden_layers,
                                 kernel=13, use_glu=use_glu, dropout=dropout,
                                 bnm=bnm)
    if rnn_type == "cnn_residual":
        return residual_wav2letter_blocks(hidden_size, cnn_width,
                                          hidden_layers, dropout, bnm)
    if rnn_type == "glu_small":
        layer_num = min(hidden_layers, len(_SMALL_GLU)) or len(_SMALL_GLU)
        return glu_blocks(_SMALL_GLU, layer_num, dropout, bnm)
    if rnn_type == "glu_large":
        return glu_blocks(_LARGE_GLU, len(_LARGE_GLU), _GLU_LARGE_DROPOUT,
                          bnm)
    if rnn_type == "large_cnn":
        return [dict(out=o, kernel=k, stride=s, padding=p, batch_norm=True,
                     dropout=dropout, bnm=bnm) for o, k, s, p in _LARGE_CNN]
    if rnn_type == "cnn_jasper":
        return jasper_blocks(bnm=bnm)
    raise ValueError(f"unknown CNN variant {rnn_type!r}")


def build_cnn_model(rnn_type: str, num_classes: int, cnn_width: int = 256,
                    hidden_size: int = 800, hidden_layers: int = 6,
                    dropout: float = 0.0, bnm: float = 0.1,
                    use_glu: bool = False) -> ConvStack:
    """The CNN model zoo's dispatch, on the CPU (the factory moves it)."""
    return ConvStack(cnn_blocks(rnn_type, cnn_width, hidden_size,
                                hidden_layers, dropout, bnm, use_glu),
                     num_classes)
