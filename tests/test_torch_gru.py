"""PyTorch port: the GRU layer against the JAX package.

The port's plain GRU layer (the CPU side of the CUDA kernel's wrapper) is
held to the fused Pallas layer kernels in interpret mode and to the XLA
scan at 1e-5 in f32 (the tolerance of tests/test_pallas_fused.py). The bf16
path (bf16 operands, f32 sums, state and gates) is held to the JAX bf16 XLA
scan at 2e-3: both round the same operands, but a state that sits on a
bf16 rounding boundary may round the other way after a 1e-7 difference in
f32 summation order, which moves that element's products by one bf16 ulp.
Padded steps must come out exactly zero.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeech_tpu.ops.pallas.rnn_fused import (bigru_layer_pallas,
                                                 gru_layer_pallas)
from deepspeech_tpu.ops.rnn import rnn_scan as jax_rnn_scan
from deepspeech_tpu_torch.ops.cuda import gru as gru_k
from deepspeech_tpu_torch.ops.rnn import rnn_scan

torch.set_num_threads(2)

T, B, F, H = 13, 3, 24, 32  # T not a multiple of 8


def _mk(seed, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    lens = np.array([T, 9, 4], np.int32)
    w_ih = (rng.standard_normal((d, F, 3 * H)) * 0.2).astype(np.float32)
    b_ih = (rng.standard_normal((d, 3 * H)) * 0.1).astype(np.float32)
    w_hh = (rng.standard_normal((d, H, 3 * H)) * 0.2).astype(np.float32)
    b_hh = (rng.standard_normal((d, 3 * H)) * 0.1).astype(np.float32)
    return x, lens, w_ih, b_ih, w_hh, b_hh


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _mask(lens):
    return (np.arange(T)[:, None] < lens[None, :])[:, :, None]


@pytest.mark.parametrize("bidir", [True, False])
def test_plain_layer_matches_pallas_f32(bidir):
    d = 2 if bidir else 1
    x, lens, w_ih, b_ih, w_hh, b_hh = _mk(3, d)
    got = gru_k.gru_layer(*_t(x, w_ih, b_ih, w_hh, b_hh, lens)).numpy()
    assert got.shape == (d, T, B, H)
    j = [jnp.asarray(a) for a in (x, w_ih, b_ih, w_hh, b_hh)]
    if bidir:
        lens_col = jnp.asarray(lens, jnp.float32)[:, None]
        refs = bigru_layer_pallas(*j, lens_col, True)
    else:
        refs = [gru_layer_pallas(*j, True)]
    m = _mask(lens)
    for di, ref in enumerate(refs):
        np.testing.assert_allclose(got[di], np.asarray(ref) * m,
                                   rtol=1e-5, atol=1e-5)
    assert not got[:, ~m[:, :, 0]].any()  # padded steps exactly zero


@pytest.mark.parametrize("bidir", [True, False])
def test_rnn_scan_matches_xla_f32(bidir):
    d = 2 if bidir else 1
    x, lens, w_ih, b_ih, w_hh, b_hh = _mk(4, d)
    ref = jax_rnn_scan(*[jnp.asarray(a) for a in
                         (x, lens, w_ih, b_ih, w_hh, b_hh)],
                       bidirectional=bidir, impl="xla")
    got = rnn_scan(*_t(x, lens, w_ih, b_ih, w_hh, b_hh), bidirectional=bidir)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bidir", [True, False])
def test_rnn_scan_matches_xla_bf16(bidir):
    d = 2 if bidir else 1
    x, lens, w_ih, b_ih, w_hh, b_hh = _mk(5, d)
    ref = jax_rnn_scan(*[jnp.asarray(a) for a in
                         (x, lens, w_ih, b_ih, w_hh, b_hh)],
                       bidirectional=bidir, compute_dtype=jnp.bfloat16,
                       impl="xla")
    got = rnn_scan(*_t(x, lens, w_ih, b_ih, w_hh, b_hh), bidirectional=bidir,
                   compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=2e-3, atol=2e-3)
    assert not got.numpy()[~_mask(lens)[:, :, 0]].any()


def test_other_cells_raise():
    x, lens, w_ih, b_ih, w_hh, b_hh = _mk(7, 2)
    with pytest.raises(ValueError, match="unknown cell"):
        rnn_scan(*_t(x, lens, w_ih, b_ih, w_hh, b_hh), cell="mgu")
