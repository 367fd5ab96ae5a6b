"""Shared model building blocks.

* :class:`TorchBatchNorm`: batch norm over one feature axis with torch's
  running-stat semantics (biased batch variance to normalize, unbiased for
  the running estimate, ``momentum`` the new-sample weight). Statistics
  include zeroed padding positions, as in the reference. On a mesh that
  spans a data group (``parallel.attach``), train mode takes the moments
  over the global batch.
* ``hardtanh_0_20``: nn.Hardtanh(0, 20).
* ``length_mask``: (B,) lengths -> (B, T) {0, 1} mask.
* :class:`Lookahead`: the lookahead convolution of unidirectional models.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from deepspeech_tpu_torch.parallel.mesh import reduce_sum


def hardtanh_0_20(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 20.0)


def length_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B,) lengths -> (B, T) f32 {0, 1} mask."""
    return (torch.arange(t, device=lengths.device)[None, :]
            < lengths[:, None]).float()


class TorchBatchNorm(nn.Module):
    """Batch norm over feature axis ``axis`` (the last by default).

    With ``fold=True`` the module returns the equivalent per-feature affine
    ``(a, b)`` with ``bn(x) == x * a + b`` instead of the normalized tensor,
    so a following matmul can fold it into its weights. Running-stat updates
    are the same in both modes. Computes in f32 whatever the input type.

    The train-mode moments are sum(x) / n and sum((x - mean)^2) / n, each
    sum through ``reduce_sum``: under data parallelism (``mesh`` spanning
    a data group) an all-reduce, differentiable, whose backward sums the
    gradient over the group, so that the moments are the global batch's
    and every shard's rows get the gradient through them, as the SPMD
    program's do; otherwise the sum itself. The running stats use the
    global n. Eval mode does not change."""

    mesh = None

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5, axis: int = -1, fold: bool = False):
        super().__init__()
        self.momentum, self.eps, self.axis, self.fold = momentum, eps, axis, fold
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _view(self, v: torch.Tensor, ndim: int) -> torch.Tensor:
        shape = [1] * ndim
        shape[self.axis] = -1
        return v.view(shape)

    def forward(self, x: torch.Tensor):
        x = x.float()
        if self.training:
            mean, var, n = self._moments(x)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(
                    m * var * (n / (n - 1).clamp(min=1)))
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        if self.fold:
            a = inv * self.weight
            return a, self.bias - mean * a
        return ((x - self._view(mean, x.ndim))
                * self._view(inv * self.weight, x.ndim)
                + self._view(self.bias, x.ndim))

    def _moments(self, x: torch.Tensor):
        """(mean, biased var, n as a (1,) tensor) over every axis but the
        feature axis, each sum taken over the mesh's data group where it
        spans one (``reduce_sum``; without, the shard is the batch);
        nothing is read back to the host."""
        axes = tuple(i for i in range(x.ndim) if i != self.axis % x.ndim)
        n = math.prod(x.shape[i] for i in axes)
        sums = reduce_sum(torch.cat([x.sum(axes), x.new_full((1,), n)]),
                          self.mesh, "data", "bn")
        n = sums[-1:].detach()
        mean = sums[:-1] / n
        sq = ((x - self._view(mean, x.ndim)) ** 2).sum(axes)
        return mean, reduce_sum(sq, self.mesh, "data", "bn") / n, n


class Lookahead(nn.Module):
    """Lookahead conv over ``context`` frames ahead, (T, B, H) -> (T, B, H):
    out[t] = sum_{j=0..context} in[t+j] * w[:, j], zero past the end."""

    def __init__(self, features: int, context: int = 20):
        super().__init__()
        self.context = context
        stdv = 1.0 / math.sqrt(context + 1)
        self.weight = nn.Parameter(
            torch.empty(features, context + 1).uniform_(-stdv, stdv))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[0]
        xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, self.context))
        windows = torch.stack([xp[j:j + t] for j in range(self.context + 1)],
                              dim=1)  # (T, C+1, B, H)
        return torch.einsum("tcbh,hc->tbh", windows, self.weight)
