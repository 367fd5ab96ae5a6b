"""Tensor parallelism over the model axis (the JAX package's
``parallel/tp_rnn.py``, and what GSPMD does with the JAX rule's gate-dim
and head shardings).

Two ways to run a layer whose tensors ``parallel.shard_params`` sharded
(``parallel/mesh.py:param_spec``, the JAX rule):

* **Gathered** (every sharded tensor but a direction split over two
  ranks): the layer gathers each of its sharded f32 tensors whole over
  the model group (``gathered``: one all-gather forward, no collective
  backward) and computes on them as one card does, on the same kernels:
  K2/K5 or K4/K5 for a GRU layer, K3/K7 or K6/K7 for an LSTM layer, by
  ``fused_route``, plain PyTorch for the vanilla cell; the head folds or
  convolves with the whole ``fc.weight``. This is what the JAX package
  runs on its accelerator: GSPMD all-gathers a gate-sharded W_ih/W_hh at
  the ``pallas_call`` boundary, and the layer runs replicated over the
  model axis. What sharding saves is the memory of the tensors and
  their optimizer moments at rest. Every rank of a model group holds the
  same rows and computes the same whole gradient, so the gather's
  backward is the rank's own slice of it, with no collective; the step's
  data all-reduce then sums each slice over its data group
  (``train/step.py``).
* **Direction-sharded** (a bidirectional direction-sum layer whose two
  directions sit on the two ranks of a 2-wide model axis, the JAX
  rule's first candidate at model 2): each rank holds one direction's
  W_ih, W_hh and biases (and their optimizer moments) and runs the whole
  recurrence locally, on the same kernels as one card at D=1: K2 (with
  K5 backward) where ``fused_route`` holds at D=1, else K4. The only
  traffic is one all-reduce of the (T, B, H) f32 output a layer forward
  and one of dx backward. Model rank 1 runs the backward direction as a
  forward one on its input reversed within each row's length (an
  involution: the same gather restores the output's order); rank 0's
  order is the identity. Padding sits at the tail in both, where a zero
  output gradient stops the chain.

  Megatron's two operators carry the gradient: ``g`` (the layer output,
  summed over the model group) is an all-reduce forward and the identity
  backward; ``f`` (the layer input, replicated over the group) is the
  identity forward and an all-reduce of dx backward, so that the layers
  below, the conv front and its BatchNorms get both directions'
  gradient. The JAX package gets ``f`` from shard_map's transpose of a
  replicated input.
"""

from __future__ import annotations

import torch

from deepspeech_tpu_torch.ops.rnn import rnn_scan
from deepspeech_tpu_torch.parallel.mesh import shard_slice


class GatherFromModel(torch.autograd.Function):
    """A sharded parameter gathered whole over the model group forward
    (``Mesh.all_gather``, counted under ``tag``); backward the rank's own
    slice of the whole gradient, with no collective (module docstring)."""

    @staticmethod
    def forward(ctx, p, mesh, dim, tag):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(p, "model", dim, tag)

    @staticmethod
    def backward(ctx, grad):
        return (shard_slice(grad, ctx.dim, ctx.mesh).contiguous(), None,
                None, None)


def gathered(p: torch.Tensor, mesh, tag: str) -> torch.Tensor:
    """``p`` whole: gathered over the model group where ``shard_params``
    sharded it (its ``shard_dim``), else ``p`` itself. The f32 parameter
    is gathered, not a bf16 copy, so the layer is the one-card layer bit
    for bit."""
    dim = getattr(p, "shard_dim", None)
    if dim is None or mesh is None:
        return p
    return GatherFromModel.apply(p, mesh, dim, tag)


class CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, dx summed over the model group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        return ctx.mesh.all_reduce(grad, "model", tag="tp_grad"), None


class ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the direction outputs summed over the model group
    forward, the identity backward."""

    @staticmethod
    def forward(ctx, h, mesh):
        return mesh.all_reduce(h.clone(), "model", tag="tp")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reverse_index(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(T, B) time index reversed within each row's length, the identity
    on its padding."""
    ts = torch.arange(t, device=lengths.device)[:, None]
    lens = lengths.to(ts.device)[None, :]
    return torch.where(ts < lens, lens - 1 - ts, ts)


def direction_sharded_rnn(x, lengths, w_ih, b_ih, w_hh, b_hh, *, mesh,
                          cell: str = "gru", compute_dtype=None):
    """Bidirectional direction-sum RNN layer with its direction axis
    sharded over the 2-wide model group: ``rnn_scan(...,
    bidirectional=True)``'s contract on this rank's (1, ...) weights, model
    index 0 holding the forward direction and 1 the backward one. x
    (T, B, F) and lengths (B,) are the data shard's rows, the same on both
    model ranks; returns (T, B, H) f32, padded steps zero, on both."""
    x = CopyToModel.apply(x, mesh)
    idx = None
    if mesh.model_index == 1:
        idx = reverse_index(lengths, x.shape[0])[:, :, None]
        x = torch.take_along_dim(x, idx, dim=0)
    h = rnn_scan(x, lengths, w_ih, b_ih, w_hh, b_hh, cell=cell,
                 bidirectional=False, compute_dtype=compute_dtype)
    if idx is not None:
        h = torch.take_along_dim(h, idx, dim=0)
    return ReduceFromModel.apply(h, mesh)


def maybe_direction_sharded(x, lengths, w_ih, b_ih, w_hh, b_hh, *, mesh,
                            cell: str, bidirectional: bool,
                            sum_directions: bool = True, compute_dtype=None):
    """``direction_sharded_rnn`` where it applies (a bidirectional layer
    with a direction sum whose tensors' spec shards the direction axis,
    ``w_ih.shard_dim`` 0, over a 2-wide model axis: one direction a
    rank), else None: the caller gathers what is sharded and runs
    ``rnn_scan``. The JAX condition that the batch tile the data axis
    always holds here, each rank holding its shard's rows."""
    if (mesh is None or mesh.model != 2 or not bidirectional
            or not sum_directions or getattr(w_ih, "shard_dim", None) != 0):
        return None
    return direction_sharded_rnn(x, lengths, w_ih, b_ih, w_hh, b_hh,
                                 mesh=mesh, cell=cell,
                                 compute_dtype=compute_dtype)
