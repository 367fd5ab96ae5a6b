"""Which recurrence kernel a GRU or LSTM layer takes: the port's copy of the
JAX package's route (``ops/rnn.py:137-158``).

The JAX package runs a layer through its projection-fused kernel (K2, K3
here) where ``fused_layer_fits`` (``ops/pallas/rnn_fused.py:67-87``) says
that W_ih and W_hh fit VMEM beside the streams of one grid step, and
otherwise, or when ``DEEPSPEECH_TPU_NO_FUSED`` is set, projects the input
outside and runs the recurrence kernel on the projection (K4, K6 here). The
port takes the same route for the same layer so that both packages compute
the same thing: on the wide route the projection is rounded to the operand
type before the recurrence, on the fused route it stays f32.
"""

from __future__ import annotations

import os

import torch

_VMEM_LIMIT = 100 * 1024 * 1024  # the Pallas kernels' compiler limit


def chunk_for(hidden: int) -> int:
    """Time steps per grid step of the TPU kernels (``rnn_kernel.py:75-83``);
    ``DEEPSPEECH_TPU_GRU_CHUNK`` overrides. The port's kernels do not chunk
    time (a persistent launch walks every step, or one launch runs each
    step); the chunk only enters the VMEM estimate below. Read at call
    time (the JAX package reads it when its module is imported)."""
    env = os.environ.get("DEEPSPEECH_TPU_GRU_CHUNK")
    if env:
        return int(env)
    return 4 if hidden >= 1280 else 8


def fused_layer_fits(f_in: int, hidden: int, gates: int, batch: int,
                     ndir: int = 2, bytes_per=2) -> bool:
    """The JAX package's VMEM estimate for pinning W_ih beside W_hh: both
    weights, the double-buffered streams of one grid step and the
    projection scratch, against 85% of the compiler limit."""
    chunk = chunk_for(hidden)
    gh = gates * hidden
    weights = ndir * (f_in + hidden) * gh * bytes_per
    streams = 2 * ndir * chunk * batch * (
        f_in * bytes_per          # x block
        + hidden * 4              # h out
        + gh * bytes_per          # gate residuals
        + hidden * bytes_per)     # hn residuals (GRU)
    scratch = ndir * chunk * batch * gh * 4 + ndir * batch * hidden * 4
    return weights + streams + scratch < int(_VMEM_LIMIT * 0.85)


def fused_route(f_in: int, hidden: int, gates: int, batch: int, ndir: int,
                dtype: torch.dtype) -> bool:
    """True: the layer takes the projection-fused kernel (K2, K3); False:
    the projection outside and the recurrence kernel (K4, K6).

    The batch is padded to a multiple of 8 first, as the JAX package pads
    it for its kernels. ``bytes_per`` is the operand type's element size:
    2 for bf16, the TPU route; 4 for f32, which is the route of the JAX
    package's interpret-mode CPU tests (it has no Pallas route for f32 on
    the TPU; taking the same estimate for the port's f32 kernels is the
    port's choice). ``DEEPSPEECH_TPU_NO_FUSED`` is read at each call, as
    the JAX package reads it at each trace."""
    if os.environ.get("DEEPSPEECH_TPU_NO_FUSED"):
        return False
    padded = batch + (-batch) % 8
    return fused_layer_fits(f_in, hidden, gates, padded, ndir,
                            dtype.itemsize)
