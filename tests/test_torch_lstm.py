"""PyTorch port: the LSTM and vanilla-RNN layers and the DS2 LSTM model
against the JAX package.

The port's plain LSTM layer (the CPU side of the K3 wrapper) is held to the
fused Pallas layer kernels in interpret mode at 1e-5 in f32 (the tolerance
of tests/test_pallas_fused.py), with padded steps exactly zero (the JAX
kernel freezes the backward direction's padded steps with a gate of 40,
so its values there are ~1e-17, masked by its caller; the port indexes
the walk and writes zeros). The training residuals, c in f32 and the
activated gates, match the JAX kernel's at valid steps at 1e-6.
``rnn_scan`` with ``cell="lstm"`` and ``cell="rnn"`` is held to the JAX
XLA scan at 1e-5 in f32 and at 2e-3 in bf16 (as the GRU: both round the
same operands, but a state on a bf16 rounding boundary may round the other
way after a 1e-7 difference in f32 summation order). A 2-layer DS2 of each
cell, its weights carried from the JAX init through ``convert.py``, gives
the JAX model's logits at rtol 1e-3 / atol 2e-3 in f32 and 3e-2 in bf16
(the precedents of tests/test_torch_model.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeech_tpu.models import build_model as jax_build_model
from deepspeech_tpu.ops.pallas.rnn_fused import (_lstm_fused_fwd,
                                                 bilstm_layer_pallas,
                                                 lstm_layer_pallas)
from deepspeech_tpu.ops.rnn import rnn_scan as jax_rnn_scan
from deepspeech_tpu_torch.convert import jax_to_torch, torch_to_jax
from deepspeech_tpu_torch.models import build_model
from deepspeech_tpu_torch.ops.cuda import lstm as lstm_k
from deepspeech_tpu_torch.ops.rnn import rnn_scan

torch.set_num_threads(2)

T, B, F, H = 13, 3, 24, 32  # T not a multiple of 8
GATES = {"lstm": 4, "rnn": 1}


def _mk(seed, d, gates=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    lens = np.array([T, 9, 4], np.int32)
    w_ih = (rng.standard_normal((d, F, gates * H)) * 0.2).astype(np.float32)
    b_ih = (rng.standard_normal((d, gates * H)) * 0.1).astype(np.float32)
    w_hh = (rng.standard_normal((d, H, gates * H)) * 0.2).astype(np.float32)
    b_hh = (rng.standard_normal((d, gates * H)) * 0.1).astype(np.float32)
    return x, lens, w_ih, b_ih, w_hh, b_hh


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _valid(lens):
    return np.arange(T)[:, None] < lens[None, :]


@pytest.mark.parametrize("bidir", [True, False])
def test_plain_layer_matches_pallas_f32(bidir):
    d = 2 if bidir else 1
    x, lens, w_ih, b_ih, w_hh, b_hh = _mk(3, d)
    got = lstm_k.lstm_layer(*_t(x, w_ih, b_ih, w_hh, b_hh, lens)).numpy()
    assert got.shape == (d, T, B, H)
    j = [jnp.asarray(a) for a in (x, w_ih, b_ih, w_hh, b_hh)]
    if bidir:
        lens_col = jnp.asarray(lens, jnp.float32)[:, None]
        refs = bilstm_layer_pallas(*j, lens_col, True)
    else:
        refs = [lstm_layer_pallas(*j, True)]
    m = _valid(lens)[:, :, None]
    for di, ref in enumerate(refs):
        np.testing.assert_allclose(got[di], np.asarray(ref) * m,
                                   rtol=1e-5, atol=1e-5)
    assert not got[:, ~m[:, :, 0]].any()  # padded steps exactly zero


@pytest.mark.parametrize("bidir", [True, False])
def test_residuals_match_jax_kernel(bidir):
    d = 2 if bidir else 1
    x, lens, w_ih, b_ih, w_hh, b_hh = _mk(13, d)
    out, c, g = lstm_k.plain(*_t(x, w_ih, b_ih, w_hh, b_hh, lens),
                             residuals=True)
    assert c.dtype == torch.float32 and g.shape == (d, T, B, 4 * H)
    lens_col = jnp.asarray(lens, jnp.float32)[:, None] if bidir else None
    outs, t = _lstm_fused_fwd(*(jnp.asarray(a) for a in
                                (x, w_ih, b_ih, w_hh, b_hh)), lens_col,
                              True, True)
    # outs: h, c of each direction, then g of each direction
    ref_c, ref_g = outs[1:2 * d:2], outs[2 * d:]
    valid = _valid(lens)
    for di in range(d):
        np.testing.assert_allclose(c[di].numpy()[valid],
                                   np.asarray(ref_c[di])[:t][valid],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g[di].numpy()[valid],
                                   np.asarray(ref_g[di])[:t][valid],
                                   rtol=1e-6, atol=1e-6)
        for a in (out[di], c[di], g[di]):
            assert not a.numpy()[~valid].any()


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("cell", ["lstm", "rnn"])
def test_rnn_scan_matches_xla_f32(cell, bidir):
    d = 2 if bidir else 1
    args = _mk(4, d, GATES[cell])
    ref = jax_rnn_scan(*[jnp.asarray(a) for a in args], cell=cell,
                       bidirectional=bidir, impl="xla")
    got = rnn_scan(*_t(*args), cell=cell, bidirectional=bidir)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("cell", ["lstm", "rnn"])
def test_rnn_scan_matches_xla_bf16(cell, bidir):
    d = 2 if bidir else 1
    args = _mk(5, d, GATES[cell])
    ref = jax_rnn_scan(*[jnp.asarray(a) for a in args], cell=cell,
                       bidirectional=bidir, compute_dtype=jnp.bfloat16,
                       impl="xla")
    got = rnn_scan(*_t(*args), cell=cell, bidirectional=bidir,
                   compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=2e-3, atol=2e-3)
    assert not got.numpy()[~_valid(args[1])].any()


HIDDEN, LAYERS, CLASSES = 32, 2, 30


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([45, 31, 20], np.int32)  # T=45, not a multiple of 8
    x = rng.standard_normal((3, 161, 45)).astype(np.float32) * 0.5
    for i, n in enumerate(lengths):
        x[i, :, n:] = 0
    return x, lengths


def _jax_variables(model, x, lengths, seed):
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                           jnp.asarray(lengths), False)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree.map(np.asarray, variables["params"])
    # means in [-0.2, 0.2], variances in [0.6, 1.4] (tests/test_model.py)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.6, 1.4, a.shape)
                         if path[-1].key == "var"
                         else rng.uniform(-0.2, 0.2, a.shape)
                         ).astype(np.float32), variables["batch_stats"])
    return params, stats


@pytest.mark.parametrize("cell,compute_dtype,bidirectional", [
    ("lstm", None, True), ("lstm", None, False), ("lstm", "bfloat16", True),
    ("rnn", None, True), ("rnn", "bfloat16", True)])
def test_model_forward_matches_jax(cell, compute_dtype, bidirectional):
    x, lengths = _inputs(1)
    jm, _ = jax_build_model(cell, CLASSES, HIDDEN, LAYERS,
                            bidirectional=bidirectional,
                            compute_dtype=compute_dtype)
    params, stats = _jax_variables(jm, x, lengths, 2)
    rl, _, ro = (np.asarray(a) for a in jm.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        jnp.asarray(lengths), False))
    tm, meta = build_model(cell, CLASSES, HIDDEN, LAYERS,
                           bidirectional=bidirectional,
                           compute_dtype=compute_dtype, device="cpu")
    assert meta["rnn_type"] == cell
    tm.load_state_dict(jax_to_torch(params, stats))
    tm.eval()
    with torch.no_grad():
        gl, gp, go = (a.numpy() for a in tm(torch.from_numpy(x),
                                             torch.from_numpy(lengths)))
    np.testing.assert_array_equal(go, ro)
    tol = (dict(rtol=1e-3, atol=2e-3) if compute_dtype is None
           else dict(rtol=3e-2, atol=3e-2))
    for i, n in enumerate(ro):
        np.testing.assert_allclose(gl[i, :n], rl[i, :n], **tol)
    np.testing.assert_allclose(
        gp, torch.softmax(torch.from_numpy(gl), -1).numpy(), atol=1e-6)


@pytest.mark.parametrize("cell", ["lstm", "rnn"])
def test_params_round_trip_jax_port_jax(cell):
    x, lengths = _inputs()
    jm, _ = jax_build_model(cell, CLASSES, HIDDEN, LAYERS)
    params, stats = _jax_variables(jm, x, lengths, 0)
    assert params["rnn0"]["w_hh"].shape == (2, HIDDEN,
                                            GATES[cell] * HIDDEN)
    tm, _ = build_model(cell, CLASSES, HIDDEN, LAYERS, device="cpu")
    tm.load_state_dict(jax_to_torch(params, stats))
    p2, s2 = torch_to_jax(tm.state_dict())
    for a, b in ((params, p2), (stats, s2)):
        assert (jax.tree_util.tree_structure(a)
                == jax.tree_util.tree_structure(b))
        for u, v in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(u, v)
