"""PyTorch port: the design of the bf16 backward kernels K5 and K7
(``csrc/rnn_mma_bwd.cuh``), held on the CPU.

The CUDA code runs only on the card (tests/test_torch_cuda.py); here its
layouts and arithmetic are held in PyTorch: W_hh packed into the blocks'
tiles and back (``pack_w_hh_bwd``), one step's product from the packed
tiles and the padded operand copy in the kernel's K-chunk order, and a
model of the whole walk (the operand's double buffer, zeroed rows past
each length, the per-(unit, row) state carried from step to step, the bias
sums reduced at the end) against ``plain_bwd`` and, as the layer
Function's backward, against the JAX package's ``_gru_bwd``/``_lstm_bwd``
through ``rnn_scan(..., impl="pallas_interpret")``; then the rules that
count the blocks and choose the variant.

Tolerances: the product from the tiles 1e-5 (f32 sums of bf16-exact
operands in another order); the walk against ``plain_bwd`` 1e-5 in f32 and,
in bf16, the kernels' ``GRU_BWD_TOL`` 2e-2 x max(1, max|ref|) (a sum in
another order may round an operand to the neighbouring bf16 value, which
moves the carried dh); against JAX the layer grads' 2e-4 of
tests/test_torch_gru_train.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeech_tpu.ops.rnn import rnn_scan as jax_rnn_scan
from deepspeech_tpu_torch.ops.cuda import gru as gru_k
from deepspeech_tpu_torch.ops.cuda import lstm as lstm_k
from deepspeech_tpu_torch.ops.cuda.recurrence import (BWD_CHUNK, BWD_CL,
                                                      BWD_KC, BWD_TM,
                                                      bwd_blocks,
                                                      bwd_variant,
                                                      op_copy_shape,
                                                      pack_w_hh_bwd,
                                                      unpack_w_hh_bwd)
from deepspeech_tpu_torch.ops.rnn import rnn_scan

torch.set_num_threads(2)

GATES = {"gru": 3, "lstm": 4}
MODS = {"gru": gru_k, "lstm": lstm_k}
# the walk's shape: T 7, B 5 (not a multiple of 8), H 40 (a ragged block
# of units and a ragged last K chunk), ragged lengths with a length-1 row
T, B, F, H = 7, 5, 24, 40
LENS = np.array([7, 5, 1, 6, 3], np.int32)
NAMES = ("x", "w_ih", "b_ih", "w_hh", "b_hh")


@pytest.mark.parametrize("hidden", [40, 200, 800])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_pack_w_hh_bwd_round_trip(cell, ndir, hidden):
    g = GATES[cell]
    w = torch.from_numpy(np.random.default_rng(41).standard_normal(
        (ndir, hidden, g * hidden)).astype(np.float32)).bfloat16()
    packed = pack_w_hh_bwd(w)
    nj, nk = -(-hidden // BWD_TM), -(-g * hidden // BWD_KC)
    assert packed.shape == (ndir, nj, nk, BWD_TM, BWD_KC)
    assert torch.equal(unpack_w_hh_bwd(packed, g, hidden), w)
    # the zero padding past H and past G*H
    assert int((packed != 0).sum()) == int((w != 0).sum())
    # tile (d, jw, kc), row jj, column kk
    d, jw, kc, jj, kk = ndir - 1, nj - 1, nk - 1, 3, 5
    assert packed[d, jw, kc, jj, kk] == w[d, jw * BWD_TM + jj,
                                          kc * BWD_KC + kk]


def _product(packed, opd, hidden, b):
    """op @ W_hh^T of one direction as the kernel's clusters compute it:
    block kh of the cluster of tile group jw sums its share of the K chunks
    of the packed tile against the bf16 operand copy (B8, Gk) in f32, and
    the blocks' partial sums are added -> (b, H)."""
    nj, nk, tm = packed.shape[:3]
    share = -(-nk // BWD_CL)
    out = torch.zeros((b, nj * tm))
    for jw in range(nj):
        acc = torch.zeros((tm, opd.shape[0]))
        for kh in range(BWD_CL):
            part = torch.zeros_like(acc)
            for kc in range(kh * share, min(nk, (kh + 1) * share)):
                cols = slice(kc * BWD_KC, (kc + 1) * BWD_KC)
                part += packed[jw, kc].float() @ opd[:, cols].float().t()
            acc += part
        out[:, jw * tm:(jw + 1) * tm] = acc[:, :b].t()
    return out[:, :hidden]


def _inputs(cell, ndir, dt, seed=43, t=T, b=B, hidden=H, lens=LENS):
    """The forward's residuals and an output grad, from the plain forward
    -> (dout, g, hn or None, h or c, w_hh, lengths)."""
    mod, g = MODS[cell], GATES[cell]
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(hidden)

    def u(*shape, lo=-s, hi=s):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32))

    x = u(t, b, F, lo=0, hi=1).to(dt)
    w_ih, w_hh = u(ndir, F, g * hidden).to(dt), u(ndir, hidden,
                                                  g * hidden).to(dt)
    b_ih, b_hh = u(ndir, g * hidden), u(ndir, g * hidden)
    lengths = torch.from_numpy(lens.astype(np.int64))
    out, r1, r2 = mod.plain(x, w_ih, b_ih, w_hh, b_hh, lengths,
                            residuals=True)
    dout = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32))
    if cell == "gru":  # r1, r2 = g, hn
        return dout, r1, r2, out, w_hh, lengths
    return dout, r2, None, r1, w_hh, lengths  # r1, r2 = c, g


def _pointwise(cell, gv, dh_tot, x1, x2, dc):
    """The step's f32 pointwise part -> (gate grads, operand, the dh term
    carried into the next product, the next dc)."""
    h = gv.shape[-1] // GATES[cell]
    part = [gv[..., i * h:(i + 1) * h] for i in range(GATES[cell])]
    if cell == "gru":
        r, z, n = part
        dn = dh_tot * (1 - z) * (1 - n * n)
        dz = dh_tot * (x2 - n) * z * (1 - z)
        dr = dn * x1 * r * (1 - r)
        return (torch.cat([dr, dz, dn], -1), torch.cat([dr, dz, dn * r], -1),
                dh_tot * z, dc)
    i, f, gg, o = part
    tc = torch.tanh(x1)
    dc_tot = dc + dh_tot * o * (1 - tc * tc)
    dgv = torch.cat([dc_tot * gg * i * (1 - i), dc_tot * x2 * f * (1 - f),
                     dc_tot * i * (1 - gg * gg), dh_tot * tc * o * (1 - o)],
                    -1)
    return dgv, dgv, torch.zeros_like(dh_tot), dc_tot * f


def _walk(cell, dout, g, hn, hc, w_hh, lengths):
    """The bf16 backward's walk in PyTorch, step by step as the kernel runs
    it: step s's product reads operand copy (s + 1) & 1 (written by step
    s - 1) through the packed tiles, its pointwise part writes copy s & 1,
    zero in every row past its length; dh = state0 + product, with state0
    the z term of a valid step (GRU), 0 (LSTM) or the carried dh; the bias
    sums per row from the unrounded values, summed over B at the end.
    -> plain_bwd's results."""
    gates = GATES[cell]
    ndir, t, b, hidden = hc.shape
    dt = g.dtype
    packed = pack_w_hh_bwd(w_hh)
    shape = op_copy_shape(ndir, b, hidden, gates)
    op = torch.zeros(shape, dtype=dt)
    state = torch.zeros((6, ndir, b, hidden))
    dg = torch.zeros((ndir, t, b, gates * hidden), dtype=dt)
    dnh = torch.zeros((ndir, t, b, hidden), dtype=dt)
    for s in range(t):
        for d in range(ndir):
            tt = t - 1 - s if d == 0 else s
            valid = (tt < lengths)[:, None]
            dh = state[0, d].clone()
            if s > 0:
                dh += _product(packed[d], op[(s + 1) & 1, d], hidden, b)
            # the neighbour in the walk's past: h (c) at t - 1 / t + 1
            has_prev = (torch.full((b,), tt > 0) if d == 0
                        else tt + 1 < lengths)[:, None]
            prev = hc[d, min(max(tt + (-1 if d == 0 else 1), 0), t - 1)]
            x2 = torch.where(has_prev, prev, 0.0)
            x1 = hn[d, tt].float() if cell == "gru" else hc[d, tt]
            gp, opv, carry, dc = _pointwise(
                cell, g[d, tt].float(), dout[d, tt] + dh, x1, x2,
                state[1, d])
            dg[d, tt] = torch.where(valid, gp, 0.0).to(dt)
            if cell == "gru":
                dnh[d, tt] = torch.where(valid, opv[:, 2 * hidden:],
                                         0.0).to(dt)
            op[s & 1, d, :b, :gates * hidden] = torch.where(valid, opv,
                                                            0.0).to(dt)
            state[0, d] = torch.where(valid, carry, dh)
            state[1, d] = torch.where(valid, dc, state[1, d])
            sums = torch.where(valid, gp, 0.0)
            for k in range(gates):
                state[2 + k, d] += sums[:, k * hidden:(k + 1) * hidden]
            if cell == "gru":
                state[5, d] += torch.where(valid, opv[:, 2 * hidden:], 0.0)
    rows = state[2:].sum(2)  # (4, D, H)
    if cell == "gru":
        return (dg, dnh, torch.cat([rows[0], rows[1], rows[2]], -1),
                torch.cat([rows[0], rows[1], rows[3]], -1))
    return dg, torch.cat(list(rows), -1)


def _plain(cell, dout, g, hn, hc, w_hh, lengths):
    if cell == "gru":
        return gru_k.plain_bwd(dout, g, hn, hc, w_hh, lengths)
    return lstm_k.plain_bwd(dout, g, hc, w_hh, lengths)


@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_packed_tiles_bwd_step_matches_plain_bwd(cell, ndir):
    """Step s = 1 from the packed tiles and the padded operand copy: the
    product of step 0's operand (read back from plain_bwd's rounded dg,
    and dnh for the GRU) against op @ W_hh^T at 1e-5, then dh and the
    pointwise part of step 1 against plain_bwd's dg there."""
    gates = GATES[cell]
    dout, g, hn, hc, w_hh, lengths = _inputs(cell, ndir, torch.bfloat16,
                                             seed=44, b=13, hidden=200,
                                             lens=np.array([7] * 12 + [1]))
    ref = _plain(cell, dout, g, hn, hc, w_hh, lengths)
    dg = ref[0]
    ndir, t, b, hidden = hc.shape
    packed = pack_w_hh_bwd(w_hh)
    shape = op_copy_shape(ndir, b, hidden, gates)
    assert shape[2:] == (16, -(-gates * 200 // 128) * 128)
    for d in range(ndir):
        t0, t1 = (t - 1, t - 2) if d == 0 else (0, 1)
        op0 = (torch.cat([dg[d, t0, :, :2 * hidden], ref[1][d, t0]], -1)
               if cell == "gru" else dg[d, t0])
        opd = torch.zeros(shape[2:], dtype=torch.bfloat16)
        opd[:b, :gates * hidden] = op0
        rec = _product(packed[d], opd, hidden, b)
        torch.testing.assert_close(
            rec, op0.float() @ w_hh[d].float().t(), rtol=0, atol=1e-5)
        # step 0's pointwise part from nothing carried, then step 1's
        x2 = (hc[d, t0 - 1] if d == 0 else
              torch.where((t0 + 1 < lengths)[:, None], hc[d, t0 + 1], 0.0))
        x1 = hn[d, t0].float() if cell == "gru" else hc[d, t0]
        _, _, carry, dc = _pointwise(cell, g[d, t0].float(), dout[d, t0],
                                     x1, x2, torch.zeros(b, hidden))
        valid = (t0 < lengths)[:, None]
        dh = torch.where(valid, carry, 0.0) + rec
        dc = torch.where(valid, dc, 0.0)
        x2 = (hc[d, t1 - 1] if d == 0 else
              torch.where((t1 + 1 < lengths)[:, None], hc[d, t1 + 1], 0.0))
        x1 = hn[d, t1].float() if cell == "gru" else hc[d, t1]
        gp, _, _, _ = _pointwise(cell, g[d, t1].float(), dout[d, t1] + dh,
                                 x1, x2, dc)
        gp = torch.where((t1 < lengths)[:, None], gp, 0.0)
        scale = max(1.0, dg[d, t1].float().abs().max().item())
        torch.testing.assert_close(gp.bfloat16().float(), dg[d, t1].float(),
                                   rtol=0, atol=2e-2 * scale)


# (T, B, H, lengths): the walk's shape, and a ragged block of units, a
# batch beyond one 8-row tile and a K split over 3 and 2 chunks (GRU) or 4
# and 3 (LSTM)
WALKS = [(T, B, H, LENS), (5, 13, 200, np.array([5] * 8 + [4, 3, 2, 1, 1]))]


@pytest.mark.parametrize("walk", [0, 1])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_walk_model_matches_plain_bwd(cell, ndir, dt, walk):
    t, b, hidden, lens = WALKS[walk]
    args = _inputs(cell, ndir, dt, t=t, b=b, hidden=hidden, lens=lens)
    got = _walk(cell, *args)
    want = _plain(cell, *args)
    tol = 1e-5 if dt == torch.float32 else 2e-2
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        scale = max(1.0, w.float().abs().max().item())
        err = (a.float() - w.float()).abs().max().item()
        assert err <= tol * scale, (err, scale)
    pad = torch.arange(t)[:, None] >= args[-1][None, :]
    assert not got[0][:, pad].any()


def _objective(out):
    return (out * out * torch.cos(out)).sum()


@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_walk_model_as_layer_backward_matches_jax(cell, ndir, monkeypatch):
    """The walk as the layer Function's backward (GRULayer / LSTMLayer, f32
    operands) against the grads of the JAX package's rnn_scan through its
    Pallas kernels in interpret mode (``_gru_bwd``/``_lstm_bwd``)."""
    g = GATES[cell]
    rng = np.random.default_rng(45)
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    ws = [(rng.standard_normal(s) * sc).astype(np.float32) for s, sc in
          (((ndir, F, g * H), 0.2), ((ndir, g * H), 0.1),
           ((ndir, H, g * H), 0.2), ((ndir, g * H), 0.1))]
    calls = []

    def walk(*args):
        calls.append(1)
        if cell == "gru":
            return _walk(cell, *args)
        dout, gv, c, w_hh, lengths = args
        return _walk(cell, dout, gv, None, c, w_hh, lengths)

    monkeypatch.setattr(MODS[cell], f"{cell}_bwd", walk)
    params = [torch.from_numpy(a).requires_grad_(True) for a in (x, *ws)]
    out = rnn_scan(params[0], torch.from_numpy(LENS), *params[1:],
                   cell=cell, bidirectional=ndir == 2)
    _objective(out).backward()
    assert calls == [1]
    got = [p.grad.numpy() for p in params]

    def f(ps):
        o = jax_rnn_scan(ps[0], jnp.asarray(LENS), *ps[1:], cell=cell,
                         bidirectional=ndir == 2, compute_dtype=jnp.float32,
                         impl="pallas_interpret")
        return (o * o * jnp.cos(o)).sum(), o

    (_, want_out), want = jax.value_and_grad(f, has_aux=True)(
        [jnp.asarray(a) for a in (x, *ws)])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5)
    for name, a, w in zip(NAMES, got, want):
        np.testing.assert_allclose(a, np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("ndir,hidden,blocks", [(1, 40, 2), (2, 64, 4),
                                                (2, 800, 52),
                                                (2, 1600, 100)])
def test_bwd_blocks(ndir, hidden, blocks):
    """Clusters of 2 blocks for every 64 units of each direction."""
    assert bwd_blocks(ndir, hidden) == blocks


@pytest.mark.parametrize("b,blocks,resident,want", [
    (20, 100, 132, 2), (64, 50, 132, 2), (13, 14, 264, 2),
    (65, 50, 132, 1), (130, 50, 132, 1),   # beyond one chunk
    (20, 134, 132, 1),                     # the grid is not resident
])
def test_bwd_variant_rule(b, blocks, resident, want):
    """"auto" picks the persistent variant only where the batch fits one
    chunk of BWD_CHUNK rows and the grid is resident; "step" and
    "persistent" are taken as asked; anything else raises."""
    assert -(-b // 8) * 8 <= BWD_CHUNK or want == 1
    assert bwd_variant("auto", b, blocks, resident) == want
    assert bwd_variant("step", b, blocks, resident) == 1
    assert bwd_variant("persistent", b, blocks, resident) == 2
    with pytest.raises(ValueError, match="variant"):
        bwd_variant("fast", b, blocks, resident)
