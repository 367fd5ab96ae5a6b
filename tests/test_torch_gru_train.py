"""PyTorch port: the GRU layer's training forward and backward against the
JAX package.

``GRULayer`` (the autograd Function over K2 with residuals and K5; their
plain versions on the CPU) is held, through ``rnn_scan``, to JAX
``rnn_scan(..., compute_dtype=float32, impl="pallas_interpret")``, which
runs the fused forward with residuals and ``_gru_bwd_kernel`` in interpret
mode, and to the XLA scan: output at 1e-5, the grads of x, W_ih, b_ih, W_hh
and b_hh at 2e-4 (the tolerances of tests/test_pallas_fused.py:56-69). The
explicit ``plain_bwd`` is held to autograd through the plain forward at
1e-5, the residuals to the JAX kernel's at valid steps at 1e-6, and a
forward without grad writes no residuals.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeech_tpu.ops.pallas.rnn_fused import _gru_fused_fwd
from deepspeech_tpu.ops.rnn import rnn_scan as jax_rnn_scan
from deepspeech_tpu_torch.ops.cuda import gru as gru_k
from deepspeech_tpu_torch.ops.rnn import rnn_scan

torch.set_num_threads(2)

T, B, F, H = 13, 3, 24, 32  # T not a multiple of 8; one row at full length
NAMES = ("x", "w_ih", "b_ih", "w_hh", "b_hh")


def _mk(seed, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    lens = np.array([T, 9, 4], np.int32)
    w_ih = (rng.standard_normal((d, F, 3 * H)) * 0.2).astype(np.float32)
    b_ih = (rng.standard_normal((d, 3 * H)) * 0.1).astype(np.float32)
    w_hh = (rng.standard_normal((d, H, 3 * H)) * 0.2).astype(np.float32)
    b_hh = (rng.standard_normal((d, 3 * H)) * 0.1).astype(np.float32)
    return x, lens, w_ih, b_ih, w_hh, b_hh


def _objective(out):
    return (out * out * torch.cos(out)).sum()


def _port(x, lens, *ws, bidir):
    params = [torch.from_numpy(a).requires_grad_(True) for a in (x, *ws)]
    out = rnn_scan(params[0], torch.from_numpy(lens), *params[1:],
                   bidirectional=bidir)
    _objective(out).backward()
    return out.detach().numpy(), [p.grad.numpy() for p in params]


def _jax(x, lens, *ws, bidir, impl):
    kw = dict(bidirectional=bidir, compute_dtype=jnp.float32, impl=impl)
    lens_j = jnp.asarray(lens)

    def f(params):
        out = jax_rnn_scan(params[0], lens_j, *params[1:], **kw)
        return (out * out * jnp.cos(out)).sum(), out

    (_, out), grads = jax.value_and_grad(f, has_aux=True)(
        [jnp.asarray(a) for a in (x, *ws)])
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("bidir", [True, False])
def test_function_matches_jax(bidir, impl):
    args = _mk(11, 2 if bidir else 1)
    got_out, got = _port(*args, bidir=bidir)
    want_out, want = _jax(*args, bidir=bidir, impl=impl)
    np.testing.assert_allclose(got_out, want_out, rtol=1e-5, atol=1e-5)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("bidir", [True, False])
def test_plain_bwd_matches_autograd_of_plain(bidir):
    x, lens, w_ih, b_ih, w_hh, b_hh = _mk(12, 2 if bidir else 1)
    params = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, w_ih, b_ih, w_hh, b_hh)]
    lens_t = torch.from_numpy(lens)
    out = gru_k.plain(params[0], params[1], params[2], params[3], params[4],
                      lens_t)
    _objective(out).backward()
    want = [p.grad.numpy() for p in params]

    params2 = [torch.from_numpy(a).requires_grad_(True)
               for a in (x, w_ih, b_ih, w_hh, b_hh)]
    out2 = gru_k.GRULayer.apply(*params2, lens_t)
    np.testing.assert_array_equal(out2.detach().numpy(),
                                  out.detach().numpy())
    _objective(out2).backward()
    for name, p, w in zip(NAMES, params2, want):
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("bidir", [True, False])
def test_residuals_match_jax_kernel(bidir):
    d = 2 if bidir else 1
    x, lens, w_ih, b_ih, w_hh, b_hh = _mk(13, d)
    _, g, hn = gru_k.plain(*(torch.from_numpy(a) for a in
                             (x, w_ih, b_ih, w_hh, b_hh, lens)),
                           residuals=True)
    lens_col = jnp.asarray(lens, jnp.float32)[:, None] if bidir else None
    outs, t = _gru_fused_fwd(*(jnp.asarray(a) for a in
                               (x, w_ih, b_ih, w_hh, b_hh)), lens_col,
                             True, True)
    ref_g, ref_hn = outs[d:2 * d], outs[2 * d:]
    valid = np.arange(T)[:, None] < lens[None, :]
    for di in range(d):
        np.testing.assert_allclose(g[di].numpy()[valid],
                                   np.asarray(ref_g[di])[:t][valid],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(hn[di].numpy()[valid],
                                   np.asarray(ref_hn[di])[:t][valid],
                                   rtol=1e-6, atol=1e-6)
        assert not g[di].numpy()[~valid].any()
        assert not hn[di].numpy()[~valid].any()


def test_forward_without_grad_writes_no_residuals(monkeypatch):
    seen = []
    plain = gru_k.plain

    def recorded(*args, **kwargs):
        seen.append(bool(args[6] if len(args) > 6
                         else kwargs.get("residuals", False)))
        return plain(*args, **kwargs)

    monkeypatch.setattr(gru_k, "plain", recorded)
    x, lens, *ws = (torch.from_numpy(a) for a in _mk(14, 2))
    rnn_scan(x, lens, *ws)  # no input requires grad
    ws = [w.requires_grad_(True) for w in ws]
    with torch.no_grad():
        rnn_scan(x, lens, *ws)
    assert seen == [False, False]
    out = rnn_scan(x, lens, *ws)
    assert seen == [False, False, True]
    assert out.grad_fn is not None
