"""PyTorch port: the wide-layer route (K4, K6) against the JAX package.

``route.fused_route`` is held to the JAX ``fused_layer_fits`` over a grid
of input widths, hidden sizes, cells, batches, directions and operand
types that holds the boundaries of the wide models (6 x BiGRU-1600 leaves
the fused route from batch 56 in layers 1-5 and from 72 in layer 0;
6 x BiLSTM-1600 leaves it at batch 20), with the JAX package's batch
padding and its ``bytes_per`` (2 in bf16; 4 in f32, its interpret route).

The plain twins of K4 and K6 (``plain_scan``, through ``GRUScanLayer`` and
``LSTMScanLayer``) are held to ``bigru_scan_pallas``, ``gru_scan_pallas``,
``bilstm_scan_pallas`` and ``lstm_scan_pallas`` in interpret mode at the
JAX tests' f32 tolerances (tests/test_pallas_fused.py:56-69): outputs at
1e-5, the grads of xp, b_ih, W_hh and b_hh at 2e-4; the training
residuals at valid steps at 1e-6. ``rnn_scan`` and a 2-layer DS2 train
step run with ``DEEPSPEECH_TPU_NO_FUSED`` set on both sides, against the
JAX ``rnn_scan(impl="pallas_interpret")`` and ``make_train_step`` with its
model's layers on the same route, at the tolerances of
tests/test_torch_train_step.py. The bf16 kernels' W_hh packing is held to
its inverse, and one step computed from the packed tiles in the kernels'
order to ``plain_scan``'s step.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeech_tpu.models.ds2 as jax_ds2
from deepspeech_tpu.audio import AudioConf as JaxAudioConf
from deepspeech_tpu.models import build_model as jax_build_model
from deepspeech_tpu.ops.pallas import rnn_kernel
from deepspeech_tpu.ops.pallas.rnn_fused import fused_layer_fits
from deepspeech_tpu.ops.pallas.rnn_kernel import (_gru_fwd, _lstm_fwd,
                                                  bigru_scan_pallas,
                                                  bilstm_scan_pallas,
                                                  gru_scan_pallas,
                                                  lstm_scan_pallas)
from deepspeech_tpu.ops.rnn import rnn_scan as jax_rnn_scan
from deepspeech_tpu.train import StepConfig as JaxStepConfig
from deepspeech_tpu.train import TrainState as JaxTrainState
from deepspeech_tpu.train import build_optimizer as jax_build_optimizer
from deepspeech_tpu.train import make_train_step as jax_make_train_step
from deepspeech_tpu_torch.convert import jax_to_torch, torch_to_jax
from deepspeech_tpu_torch.models import build_model
from deepspeech_tpu_torch.ops.cuda import gru as gru_k
from deepspeech_tpu_torch.ops.cuda import lstm as lstm_k
from deepspeech_tpu_torch.ops.cuda.recurrence import (MMA_KC, MMA_TJ,
                                                      h_copy_shape,
                                                      pack_w_hh,
                                                      unpack_w_hh)
from deepspeech_tpu_torch.ops.cuda.route import fused_route
from deepspeech_tpu_torch.ops.rnn import rnn_scan
from deepspeech_tpu_torch.train import optim
from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                             make_train_step)
from test_torch_train_step import _batches, _flat, _port_batch

torch.set_num_threads(2)

T, B, F, H = 13, 3, 24, 32  # T not a multiple of 8; one row at full length
GATES = {"gru": 3, "lstm": 4}
KERNELS = {"gru": (gru_k, gru_k.GRUScanLayer, bigru_scan_pallas,
                   gru_scan_pallas, _gru_fwd),
           "lstm": (lstm_k, lstm_k.LSTMScanLayer, bilstm_scan_pallas,
                    lstm_scan_pallas, _lstm_fwd)}
NAMES = ("xp", "b_ih", "w_hh", "b_hh")


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", [800, 1024, 1600, 2048])
def test_fused_route_matches_jax(cell, hidden):
    """Every grid point: layer 0 (F 1312) and the layers above (F = H),
    the batch across the wide models' boundaries, both directions, both
    operand types."""
    seen = set()
    for f_in in (1312, hidden):
        for batch in (1, 20, 48, 56, 64, 72):
            for ndir in (1, 2):
                for dt, nbytes in ((torch.bfloat16, 2), (torch.float32, 4)):
                    want = fused_layer_fits(f_in, hidden, GATES[cell],
                                            batch + (-batch) % 8, ndir,
                                            nbytes)
                    got = fused_route(f_in, hidden, GATES[cell], batch, ndir,
                                      dt)
                    assert got == want, (f_in, batch, ndir, dt)
                    seen.add(got)
    if hidden == 1600:
        assert seen == {True, False}


@pytest.mark.parametrize("cell,f_in,fused,wide", [
    ("gru", 1312, 64, 72), ("gru", 1600, 48, 56), ("lstm", 1312, 16, 20),
    ("lstm", 1600, 8, 20)])
def test_wide_model_boundaries(cell, f_in, fused, wide):
    """6 x Bi{GRU,LSTM}-1600 in bf16: the last fused batch and the first
    wide one, by layer input width."""
    assert fused_route(f_in, 1600, GATES[cell], fused, 2, torch.bfloat16)
    assert not fused_route(f_in, 1600, GATES[cell], wide, 2, torch.bfloat16)


def test_route_reads_the_environment(monkeypatch):
    assert fused_route(1312, 800, 3, 20, 2, torch.bfloat16)
    monkeypatch.setenv("DEEPSPEECH_TPU_NO_FUSED", "1")
    assert not fused_route(1312, 800, 3, 20, 2, torch.bfloat16)
    monkeypatch.delenv("DEEPSPEECH_TPU_NO_FUSED")
    # the chunk override (16 time steps of streams, not 8) moves a
    # BiLSTM-1024 at batch 32 off the fused route, in both packages
    assert fused_route(1312, 1024, 4, 32, 2, torch.bfloat16)
    monkeypatch.setenv("DEEPSPEECH_TPU_GRU_CHUNK", "16")
    monkeypatch.setattr(rnn_kernel, "_CHUNK_ENV", "16")
    for batch in (8, 16, 24, 32, 40, 48, 56, 64):
        assert (fused_route(1312, 1024, 4, batch, 2, torch.bfloat16)
                == fused_layer_fits(1312, 1024, 4, batch, 2, 2)
                == (batch <= 24)), batch


def _mk(seed, d, gates):
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((d, T, B, gates * H)).astype(np.float32)
    lens = np.array([T, 9, 4], np.int32)
    b_ih = (rng.standard_normal((d, gates * H)) * 0.1).astype(np.float32)
    w_hh = (rng.standard_normal((d, H, gates * H)) * 0.2).astype(np.float32)
    b_hh = (rng.standard_normal((d, gates * H)) * 0.1).astype(np.float32)
    return xp, lens, b_ih, w_hh, b_hh


def _valid(lens):
    return np.arange(T)[:, None] < lens[None, :]


def _masked_objective(outs, lens, lib):
    """sum over directions of (h^2 cos h) with h zeroed at padded steps
    (the JAX forward direction's values there are the caller's to mask)."""
    m = lib.asarray(_valid(lens)[:, :, None].astype(np.float32))
    return sum((o * m * o * m * lib.cos(o * m)).sum() for o in outs)


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_plain_scan_matches_pallas(cell, bidir):
    mod, function, bi_fn, uni_fn, _ = KERNELS[cell]
    d = 2 if bidir else 1
    xp, lens, b_ih, w_hh, b_hh = _mk(21, d, GATES[cell])
    params = [torch.from_numpy(a).requires_grad_(True)
              for a in (xp, b_ih, w_hh, b_hh)]
    out = function.apply(*params, torch.from_numpy(lens))
    assert out.shape == (d, T, B, H)
    _masked_objective(list(out), lens, torch).backward()
    got = [p.grad.numpy() for p in params]

    def f(xp, b_ih, w_hh, b_hh):
        if bidir:
            lens_col = jnp.asarray(lens, jnp.float32)[:, None]
            outs = bi_fn(xp[0], xp[1], b_ih, w_hh, b_hh, lens_col, True)
        else:
            outs = [uni_fn(xp[0], b_ih, w_hh, b_hh, True)]
        return _masked_objective(outs, lens, jnp), outs

    (_, outs), want = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                         has_aux=True)(
        *(jnp.asarray(a) for a in (xp, b_ih, w_hh, b_hh)))
    m = _valid(lens)[:, :, None]
    for di, ref in enumerate(outs):
        np.testing.assert_allclose(out[di].detach().numpy(),
                                   np.asarray(ref) * m, rtol=1e-5, atol=1e-5)
    assert not out.detach().numpy()[:, ~m[:, :, 0]].any()
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scan_residuals_match_jax_kernel(cell):
    """The training residuals (GRU: g, hn; LSTM: c, g) at valid steps."""
    mod, _, _, _, fwd = KERNELS[cell]
    xp, lens, b_ih, w_hh, b_hh = _mk(22, 2, GATES[cell])
    got = mod.plain_scan(*(torch.from_numpy(a) for a in
                           (xp, b_ih, w_hh, b_hh, lens)), residuals=True)
    lens_col = jnp.asarray(lens, jnp.float32)[:, None]
    outs, t = fwd(jnp.asarray(xp[0]), jnp.asarray(xp[1]), jnp.asarray(b_ih),
                  jnp.asarray(w_hh), jnp.asarray(b_hh), lens_col, True, True)
    # GRU: h_f, h_b, g_f, g_b, hn_f, hn_b; LSTM: h_f, c_f, h_b, c_b, g_f, g_b
    if cell == "gru":
        refs = [outs[2:4], outs[4:6]]
    else:
        refs = [outs[1:4:2], outs[4:6]]
    valid = _valid(lens)
    for a, ref in zip(got[1:], refs):
        for di in range(2):
            np.testing.assert_allclose(a[di].numpy()[valid],
                                       np.asarray(ref[di])[:t][valid],
                                       rtol=1e-6, atol=1e-6)
            assert not a[di].numpy()[~valid].any()


def _layer_args(seed, d, gates, f_in=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, f_in)).astype(np.float32)
    lens = np.array([T, 9, 4], np.int32)
    w_ih = (rng.standard_normal((d, f_in, gates * H)) * 0.2).astype(
        np.float32)
    b_ih = (rng.standard_normal((d, gates * H)) * 0.1).astype(np.float32)
    w_hh = (rng.standard_normal((d, H, gates * H)) * 0.2).astype(np.float32)
    b_hh = (rng.standard_normal((d, gates * H)) * 0.1).astype(np.float32)
    return x, lens, w_ih, b_ih, w_hh, b_hh


def _spy(monkeypatch, mod):
    """Count the plain twins' calls: plain (the fused layer) and
    plain_scan (the recurrence on a projection, which plain calls too)."""
    calls = {"plain": 0, "plain_scan": 0}
    for name in calls:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_rnn_scan_no_fused_matches_jax(cell, bidir, monkeypatch):
    """Both packages on the wide route (``DEEPSPEECH_TPU_NO_FUSED``): the
    port through the K4 / K6 twin, JAX through the interpret kernels."""
    monkeypatch.setenv("DEEPSPEECH_TPU_NO_FUSED", "1")
    calls = _spy(monkeypatch, KERNELS[cell][0])
    args = _layer_args(23, 2 if bidir else 1, GATES[cell])
    params = [torch.from_numpy(a).requires_grad_(True)
              for a in (args[0], *args[2:])]
    out = rnn_scan(params[0], torch.from_numpy(args[1]), *params[1:],
                   cell=cell, bidirectional=bidir)
    (out * out * torch.cos(out)).sum().backward()
    assert calls == {"plain": 0, "plain_scan": 1}

    lens_j = jnp.asarray(args[1])

    def f(ps):
        o = jax_rnn_scan(ps[0], lens_j, *ps[1:], cell=cell,
                         bidirectional=bidir, compute_dtype=jnp.float32,
                         impl="pallas_interpret")
        return (o * o * jnp.cos(o)).sum(), o

    (_, ref), grads = jax.value_and_grad(f, has_aux=True)(
        [jnp.asarray(a) for a in (args[0], *args[2:])])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    for name, p, g in zip(("x", "w_ih", "b_ih", "w_hh", "b_hh"), params,
                          grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_rnn_scan_bf16_wide_route_matches_rounded_projection(cell,
                                                             monkeypatch):
    """The bf16 wide route against a JAX reference built from the TPU
    route's steps: ``einsum(...).astype(bfloat16)`` fed to the interpret
    kernel, which then rounds W_hh and h_prev to bf16 as the port does. (No
    CPU route of the JAX package rounds the projection: its interpret path
    keeps an f32 stream and an unrounded W_hh.) Outputs at 2e-3 and grads
    at 2e-2 x max(1, max|grad|): both sides round the same operands, but a
    value on a bf16 rounding boundary may round the other way after a 1e-7
    difference in f32 summation order (tests/test_torch_lstm.py)."""
    monkeypatch.setenv("DEEPSPEECH_TPU_NO_FUSED", "1")
    _, _, bi_fn, _, _ = KERNELS[cell]
    x, lens, w_ih, b_ih, w_hh, b_hh = _layer_args(24, 2, GATES[cell])
    params = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, w_ih, b_ih, w_hh, b_hh)]
    out = rnn_scan(params[0], torch.from_numpy(lens), *params[1:], cell=cell,
                   compute_dtype=torch.bfloat16)
    (out * out * torch.cos(out)).sum().backward()
    mask = jnp.asarray(_valid(lens)[:, :, None].astype(np.float32))
    lens_col = jnp.asarray(lens, jnp.float32)[:, None]

    def f(ps):
        xb, wb = ps[0].astype(jnp.bfloat16), ps[1].astype(jnp.bfloat16)
        xp = [jnp.einsum("tbf,fg->tbg", xb, wb[di],
                         preferred_element_type=jnp.float32
                         ).astype(jnp.bfloat16) for di in range(2)]
        h_f, h_b = bi_fn(xp[0], xp[1], ps[2], ps[3], ps[4], lens_col, True)
        o = (h_f + h_b) * mask
        return (o * o * jnp.cos(o)).sum(), o

    (_, ref), grads = jax.value_and_grad(f, has_aux=True)(
        [jnp.asarray(a) for a in (x, w_ih, b_ih, w_hh, b_hh)])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=2e-3, atol=2e-3)
    for name, p, g in zip(("x", "w_ih", "b_ih", "w_hh", "b_hh"), params,
                          grads):
        g = np.asarray(g, np.float32)
        scale = max(1.0, np.abs(g).max())
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=2e-2 * scale, err_msg=name)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_wide_layer_takes_the_scan_route(cell, monkeypatch):
    """A BiGRU-1600 layer at batch 72 (a BiLSTM-1600 at batch 20) leaves
    the fused route in bf16 without the environment variable, and its
    output equals the plain twin's on the bf16-rounded projection."""
    calls = _spy(monkeypatch, KERNELS[cell][0])
    batch = 72 if cell == "gru" else 20
    rng = np.random.default_rng(25)
    g, h, t = GATES[cell], 1600, 2
    x = torch.from_numpy(rng.standard_normal((t, batch, 1312)).astype(
        np.float32))
    lens = torch.full((batch,), t)
    s = 1.0 / np.sqrt(h)
    w = [torch.from_numpy(rng.uniform(-s, s, shape).astype(np.float32))
         for shape in ((2, 1312, g * h), (2, g * h), (2, h, g * h),
                       (2, g * h))]
    with torch.no_grad():
        out = rnn_scan(x, lens, *w, cell=cell, compute_dtype=torch.bfloat16)
    assert calls == {"plain": 0, "plain_scan": 1}
    xp = torch.einsum("tbf,dfg->dtbg", x.bfloat16().float(),
                      w[0].bfloat16().float()).bfloat16()
    ref = KERNELS[cell][0].plain_scan(xp, w[1], w[2].bfloat16(), w[3], lens)
    torch.testing.assert_close(out, ref[0] + ref[1], rtol=0, atol=1e-6)


NUM_CLASSES, HIDDEN, LAYERS = 29, 32, 2
LR = 3e-4


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_wide_route_train_step_matches_jax(cell, monkeypatch):
    """One SGD-Nesterov step of a 2-layer H-32 DS2 in f32 with every layer
    on the wide route, in both packages, from the JAX init; the JAX model's
    layers run the interpret kernels (a fresh jitted step, built after the
    environment is set). Tolerances and reasons of
    tests/test_torch_train_step.py; the weights at lr 3e-4 as
    tests/test_torch_lstm_train.py."""
    monkeypatch.setenv("DEEPSPEECH_TPU_NO_FUSED", "1")
    monkeypatch.setattr(jax_ds2, "rnn_scan", functools.partial(
        jax_rnn_scan, impl="pallas_interpret"))
    calls = _spy(monkeypatch, KERNELS[cell][0])
    model, _ = jax_build_model(cell, NUM_CLASSES, HIDDEN, LAYERS,
                               compute_dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 161, 51)),
                           jnp.asarray([51]), False)
    tx = jax_build_optimizer("sgd", lr=LR, momentum=0.9, max_norm=100.0)
    state = JaxTrainState.create(variables, tx)
    step = jax_make_train_step(model, tx, JaxStepConfig(
        audio_conf=JaxAudioConf()), donate=False)

    port, _ = build_model(cell, NUM_CLASSES, HIDDEN, LAYERS, device="cpu")
    port.load_state_dict(jax_to_torch(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"])))
    opt = optim.build_optimizer("sgd", lr=LR, momentum=0.9, max_norm=100.0)
    pstep = make_train_step(port, opt, StepConfig())

    batch = _batches()[0]
    key = jax.random.PRNGKey(100)
    state, jm = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                     key)
    jitter = np.asarray(jax.random.uniform(jax.random.split(key, 3)[0],
                                           (B,), minval=-0.5, maxval=0.5))
    pm = pstep(TrainState.create(port, opt), _port_batch(batch),
               jitter=torch.tensor(jitter))
    assert calls == {"plain": 0, "plain_scan": LAYERS}
    assert not bool(jm["step_skipped"]) and not bool(pm["step_skipped"])
    for name in ("loss", "per_sample"):
        np.testing.assert_allclose(pm[name].numpy(), np.asarray(jm[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(pm["grad_norm"].numpy(),
                               np.asarray(jm["grad_norm"]), rtol=1e-3)
    params, _ = torch_to_jax(port.state_dict())
    got, want = dict(_flat(params)), dict(_flat(state.params))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=3e-5, err_msg=name)


# The bf16 recurrence kernels' packing and tiling (csrc/rnn_mma.cuh), held
# on the CPU: B 13 (not a multiple of 8), H 200 (a ragged last block of 32
# units and a ragged last K chunk of 64).
TB, TH, TT = 13, 200, 3


@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_pack_w_hh_round_trip(cell, ndir):
    g = GATES[cell]
    w = torch.from_numpy(np.random.default_rng(31).standard_normal(
        (ndir, TH, g * TH)).astype(np.float32)).bfloat16()
    packed = pack_w_hh(w, g)
    nj, nk = -(-TH // MMA_TJ), -(-TH // MMA_KC)
    assert packed.shape == (ndir, nj, nk, g * MMA_TJ, MMA_KC)
    assert torch.equal(unpack_w_hh(packed, g, TH), w)
    # the zero padding past H, in both the unit and the K direction
    assert int((packed != 0).sum()) == int((w != 0).sum())


def _tile_product(packed, hb, d, gates, hidden, b):
    """h_prev @ W_hh of direction d as the kernel's blocks compute it: block
    jb takes the gate rows g*TJ + jj of units jb*TJ + jj, sums the K chunks
    of the packed tile against the bf16 h copy (B8, Hk) in f32."""
    nj, nk = packed.shape[1:3]
    out = torch.zeros((b, gates * hidden))
    for jb in range(nj):
        acc = torch.zeros((gates * MMA_TJ, hb.shape[1]))
        for kc in range(nk):
            cols = slice(kc * MMA_KC, (kc + 1) * MMA_KC)
            acc += packed[d, jb, kc].float() @ hb[d, :, cols].float().t()
        units = jb * MMA_TJ + torch.arange(MMA_TJ)
        keep = units < hidden
        for g in range(gates):
            rows = acc[g * MMA_TJ:(g + 1) * MMA_TJ][keep, :b]
            out[:, g * hidden + units[keep]] = rows.t()
    return out


@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_packed_tiles_step_matches_plain_scan(cell, ndir):
    """One bf16 step (s = 1) computed from the packed tiles, in the
    kernel's gate-row order and K chunks, on h_prev rounded into the
    (2, D, B8, Hk) copy, held to plain_scan's step at 1e-5 (f32 sums in
    another order): the hidden product against plain_scan's own, then h
    (and c) of the step, for direction 0 at t = 1 and direction 1 at
    t = T - 2."""
    g = GATES[cell]
    mod = KERNELS[cell][0]
    rng = np.random.default_rng(32)
    s = 1.0 / np.sqrt(TH)

    def u(*shape, lo=-s, hi=s):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32))

    xp = u(ndir, TT, TB, g * TH, lo=-1, hi=1).bfloat16()
    w_hh, b_ih, b_hh = u(ndir, TH, g * TH).bfloat16(), u(ndir, g * TH), \
        u(ndir, g * TH)
    lens = torch.full((TB,), TT)
    out, r1, _ = mod.plain_scan(xp, b_ih, w_hh, b_hh, lens, residuals=True)
    packed = pack_w_hh(w_hh, g)
    shape = h_copy_shape(ndir, TB, TH)
    assert shape == (2, ndir, 16, 256)
    hb = torch.zeros(shape[1:], dtype=torch.bfloat16)
    t_prev, t_now = [0, TT - 1][:ndir], [1, TT - 2][:ndir]
    for d in range(ndir):
        hb[d, :TB, :TH] = out[d, t_prev[d]].bfloat16()
    for d in range(ndir):
        h_prev = out[d, t_prev[d]]
        hg = _tile_product(packed, hb, d, g, TH, TB)
        want = h_prev.bfloat16().float() @ w_hh[d].float()
        torch.testing.assert_close(hg, want, rtol=0, atol=1e-5)
        hg = hg + b_hh[d]
        x = xp[d, t_now[d]].float() + b_ih[d]
        gx = [x[:, i * TH:(i + 1) * TH] for i in range(g)]
        gh = [hg[:, i * TH:(i + 1) * TH] for i in range(g)]
        if cell == "gru":
            r = torch.sigmoid(gx[0] + gh[0])
            z = torch.sigmoid(gx[1] + gh[1])
            n = torch.tanh(gx[2] + r * gh[2])
            h = (1 - z) * n + z * h_prev
        else:
            c_prev = r1[d, t_prev[d]]
            i_, f_ = torch.sigmoid(gx[0] + gh[0]), torch.sigmoid(gx[1] + gh[1])
            c = f_ * c_prev + i_ * torch.tanh(gx[2] + gh[2])
            h = torch.sigmoid(gx[3] + gh[3]) * torch.tanh(c)
            torch.testing.assert_close(c, r1[d, t_now[d]], rtol=0, atol=1e-5)
        torch.testing.assert_close(h, out[d, t_now[d]], rtol=0, atol=1e-5)
