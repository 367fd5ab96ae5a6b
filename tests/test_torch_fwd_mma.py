"""PyTorch port: the design of the bf16 fused forwards K2 and K3
(``csrc/proj_mma.cuh``, the projection GEMM; ``csrc/rnn_mma.cuh``, the
recurrence on its f32 stream, W-resident persistent variant), held on the
CPU.

The CUDA code runs only on the card (tests/test_torch_cuda.py); here its
layouts and arithmetic are held in PyTorch: the GEMM's output tiles and
K-chunk order; each block's W_hh slice as the resident kernel gathers it
from ``pack_w_hh``'s tiles, and the slices back into W_hh; one step's
product from the resident slices and the h_prev copy in the warps' k16
order, with the K-split sums added in their order; a model of the whole
walk (the f32 stream, the h copies' double buffer, state carried past each
length) against ``plain`` and, through ``rnn_scan`` and the layer Function,
against the JAX package's ``bigru_layer_pallas``/``bilstm_layer_pallas`` in
interpret mode; then the shared-memory budget and the rule that picks the
variant.

Tolerances: the GEMM against ``plain``'s f32 einsum, the product from the
slices and one step against ``plain_scan`` 1e-5 (f32 sums of bf16-exact
operands in another order); the walk against ``plain`` 1e-5 in f32 and
5e-3 in bf16 (``GRU_TOL``/``LSTM_TOL``: a state on a bf16 rounding boundary
may round the other way; the LSTM's c relative to its largest value);
against JAX the fused forward's 1e-5 and the layer grads' 2e-4 of
tests/test_torch_gru_train.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeech_tpu.ops.rnn import rnn_scan as jax_rnn_scan
from deepspeech_tpu_torch.ops import fp32_matmul
from deepspeech_tpu_torch.ops.cuda import gru as gru_k
from deepspeech_tpu_torch.ops.cuda import lstm as lstm_k
from deepspeech_tpu_torch.ops.cuda.recurrence import (FWD_CHUNK, MMA_KC,
                                                      MMA_TJ, PROJ_BK,
                                                      PROJ_BM, PROJ_BN,
                                                      RES_CL, RES_TJ,
                                                      SMEM_MAX,
                                                      fwd_blocks,
                                                      fwd_variant,
                                                      h_copy_shape,
                                                      pack_w_hh, res_shape,
                                                      res_smem, walk_index)
from deepspeech_tpu_torch.ops.rnn import rnn_scan

torch.set_num_threads(2)

GATES = {"gru": 3, "lstm": 4}
MODS = {"gru": gru_k, "lstm": lstm_k}
# the walk's shape: T 7, B 5 (not a multiple of 8), F 24, H 40 (a ragged
# block of units and a ragged last k16 step), ragged lengths with a
# length-1 row
T, B, F, H = 7, 5, 24, 40
LENS = np.array([7, 5, 1, 6, 3], np.int32)
NAMES = ("x", "w_ih", "b_ih", "w_hh", "b_hh")


def _gemm(x, w):
    """x (T, B, F) @ w (D, F, N) as the kernel computes it: output tiles
    of PROJ_BM x PROJ_BN, each the f32 sum over K chunks of PROJ_BK in
    order of bf16 (or f32) operands, zero past the edges -> (D, T, B, N)."""
    t, b, k = x.shape
    ndir, _, n = w.shape
    a = x.reshape(t * b, k).float()
    m = t * b
    out = torch.zeros((ndir, m, n))
    for d in range(ndir):
        for m0 in range(0, m, PROJ_BM):
            for n0 in range(0, n, PROJ_BN):
                acc = torch.zeros((PROJ_BM, PROJ_BN))
                for k0 in range(0, k, PROJ_BK):
                    at = torch.zeros((PROJ_BM, PROJ_BK))
                    wt = torch.zeros((PROJ_BK, PROJ_BN))
                    blk = a[m0:m0 + PROJ_BM, k0:k0 + PROJ_BK]
                    at[:blk.shape[0], :blk.shape[1]] = blk
                    blk = w[d, k0:k0 + PROJ_BK, n0:n0 + PROJ_BN].float()
                    wt[:blk.shape[0], :blk.shape[1]] = blk
                    with fp32_matmul():
                        acc += at @ wt
                rows, cols = min(PROJ_BM, m - m0), min(PROJ_BN, n - n0)
                out[d, m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    return out.reshape(ndir, t, b, n)


# (T, B, F, N): ragged M, N and K (2 x 2 tiles, 2 K chunks); F not a
# multiple of 8 and N of 8; the default layer 0's F and a GRU's N at H 100
GEMMS = [(20, 15, 50, 150), (7, 5, 24, 120), (9, 3, 1312, 300)]


@pytest.mark.parametrize("t,b,f,n", GEMMS)
def test_gemm_tiles_match_plain(t, b, f, n):
    rng = np.random.default_rng(f + n)
    x = torch.from_numpy(rng.uniform(0, 1, (t, b, f)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.uniform(-0.1, 0.1, (2, f, n)).astype(
        np.float32)).bfloat16()
    with fp32_matmul():
        want = torch.einsum("tbf,dfg->dtbg", x.float(), w.float())
    torch.testing.assert_close(_gemm(x, w), want, rtol=0, atol=1e-5)
    torch.testing.assert_close(gru_k.projection(x, w), want, rtol=0,
                               atol=0)


def _slice(w_pk, d, jb, gates, hidden):
    """Block jb's resident W_hh slice (G * RES_TJ, KW) as the kernel loads it
    from pack_w_hh's tiles: row g * 16 + jj, column k from tile (d, jb // 2,
    k // KC), row g * TJ + (jb & 1) * 16 + jj, column k % KC."""
    kw = -(-hidden // 16) * 16
    tiles = w_pk[d, jb // 2]  # (NK, G * TJ, KC)
    rows = tiles.permute(1, 0, 2).reshape(gates * MMA_TJ, -1)
    pick = [g * MMA_TJ + (jb & 1) * RES_TJ + jj for g in range(gates)
            for jj in range(RES_TJ)]
    return rows[pick, :kw]


def _unslice(slices, gates, hidden):
    """The slices of every block of one direction -> (H, G*H): the inverse
    of the gather."""
    w = torch.zeros((hidden, gates, len(slices) * RES_TJ),
                    dtype=slices[0].dtype)
    for jb, s in enumerate(slices):
        w[:, :, jb * RES_TJ:(jb + 1) * RES_TJ] = s[:, :hidden].reshape(
            gates, RES_TJ, hidden).permute(2, 0, 1)
    return w[:, :, :hidden].reshape(hidden, gates * hidden)


@pytest.mark.parametrize("hidden", [40, 200, 800])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_resident_slices_round_trip(cell, ndir, hidden):
    g = GATES[cell]
    w = torch.from_numpy(np.random.default_rng(51).standard_normal(
        (ndir, hidden, g * hidden)).astype(np.float32)).bfloat16()
    w_pk = pack_w_hh(w, g)
    nj = -(-hidden // RES_TJ)
    assert fwd_blocks(ndir, hidden)[1] == ndir * -(-nj // RES_CL) * RES_CL
    kw = -(-hidden // 16) * 16
    for d in range(ndir):
        slices = [_slice(w_pk, d, jb, g, hidden) for jb in range(nj)]
        assert all(s.shape == (g * RES_TJ, kw) for s in slices)
        assert torch.equal(_unslice(slices, g, hidden), w[d])
        # zero past H, in units and in K
        assert int(sum((s != 0).sum() for s in slices)) == int(
            (w[d] != 0).sum())
        jb, gg, jj, k = nj - 1, g - 1, (hidden - 1) % RES_TJ, hidden - 1
        assert slices[jb][gg * RES_TJ + jj, k] == w[d, k, gg * hidden
                                                    + jb * RES_TJ + jj]


def _product(slices, hb, hidden, b):
    """h_prev @ W_hh of one direction as the resident blocks compute it:
    the warps of K slice ks sum their k16 steps (ks, ks + KS, ...) of the
    slice against the (B8, Hk) h copy in f32 into slot ks, and the slots
    are added in order -> (b, G*H)."""
    gates = slices[0].shape[0] // RES_TJ
    _, _, ks_n = res_shape(b)
    nk16 = slices[0].shape[1] // 16
    out = torch.zeros((b, gates, len(slices) * RES_TJ))
    for jb, s in enumerate(slices):
        parts = []
        for ks in range(ks_n):
            part = torch.zeros((s.shape[0], hb.shape[0]))
            for kk in range(ks, nk16, ks_n):
                cols = slice(kk * 16, (kk + 1) * 16)
                with fp32_matmul():
                    part += s[:, cols].float() @ hb[:, cols].float().t()
            parts.append(part)
        total = torch.zeros_like(parts[0])
        for part in parts:
            total += part
        out[:, :, jb * RES_TJ:(jb + 1) * RES_TJ] = total[:, :b].t().reshape(
            b, gates, RES_TJ)
    return out[:, :, :hidden].reshape(b, gates * hidden)


def _update(cell, xs, hg, h, c):
    """The epilogue's f32 gate update -> (h, c, gates, extra)."""
    hid = h.shape[-1]
    gx = [xs[:, i * hid:(i + 1) * hid] for i in range(GATES[cell])]
    gh = [hg[:, i * hid:(i + 1) * hid] for i in range(GATES[cell])]
    if cell == "gru":
        r = torch.sigmoid(gx[0] + gh[0])
        z = torch.sigmoid(gx[1] + gh[1])
        n = torch.tanh(gx[2] + r * gh[2])
        return (1 - z) * n + z * h, c, torch.cat([r, z, n], -1), gh[2]
    i, f = torch.sigmoid(gx[0] + gh[0]), torch.sigmoid(gx[1] + gh[1])
    gg, o = torch.tanh(gx[2] + gh[2]), torch.sigmoid(gx[3] + gh[3])
    c = f * c + i * gg
    return o * torch.tanh(c), c, torch.cat([i, f, gg, o], -1), c


def _walk(cell, x, w_ih, b_ih, w_hh, b_hh, lengths, residuals=False):
    """The bf16 fused forward in PyTorch, as the kernels run it: the f32
    stream from the GEMM's tiles; step s's product from the resident slices
    on h copy s & 1 (the operand type), its epilogue writing copy (s + 1) &
    1 for every row, h carried past each row's length and zeros written
    there; direction 1 at t = len - 1 - s. -> plain's results."""
    gates = GATES[cell]
    dt = w_hh.dtype
    t, b, _ = x.shape
    ndir, hidden = w_hh.shape[:2]
    lengths = lengths.clamp(max=t)
    xp = _gemm(x, w_ih) + b_ih.float()[:, None, None, :]
    w_pk = pack_w_hh(w_hh, gates)
    nj = -(-hidden // RES_TJ)
    slices = [[_slice(w_pk, d, jb, gates, hidden) for jb in range(nj)]
              for d in range(ndir)]
    hb = torch.zeros(h_copy_shape(ndir, b, hidden), dtype=dt)
    h = torch.zeros((ndir, b, hidden))
    c = torch.zeros_like(h)
    out = torch.zeros((ndir, t, b, hidden))
    g_out = torch.zeros((ndir, t, b, gates * hidden))
    x_out = torch.zeros_like(out)  # GRU: hn; LSTM: c
    idx = walk_index(lengths, t)
    rows = torch.arange(b)
    for s in range(t):
        valid = (s < lengths)[:, None]
        for d in range(ndir):
            tt = torch.full((b,), s) if d == 0 else idx[s]
            hg = _product(slices[d], hb[s & 1, d], hidden, b) + b_hh[d]
            h_new, c_new, gv, extra = _update(cell, xp[d, tt, rows], hg,
                                              h[d], c[d])
            h[d] = torch.where(valid, h_new, h[d])
            c[d] = torch.where(valid, c_new, c[d])
            hb[(s + 1) & 1, d, :b, :hidden] = h[d].to(dt)
            out[d, tt, rows] = torch.where(valid, h_new, 0.0)
            g_out[d, tt, rows] = torch.where(valid, gv, 0.0)
            x_out[d, tt, rows] = torch.where(valid, extra, 0.0)
    if not residuals:
        return out
    if cell == "gru":
        return out, g_out.to(dt), x_out.to(dt)
    return out, x_out, g_out.to(dt)


def _inputs(cell, ndir, dt, seed, t=T, b=B, f=F, hidden=H, lens=LENS):
    g = GATES[cell]
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(hidden)

    def u(*shape, lo=-s, hi=s):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32))

    return (u(t, b, f, lo=0, hi=1).to(dt), u(ndir, f, g * hidden).to(dt),
            u(ndir, g * hidden), u(ndir, hidden, g * hidden).to(dt),
            u(ndir, g * hidden), torch.from_numpy(lens.astype(np.int64)))


@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_resident_step_matches_plain_scan(cell, ndir):
    """Step s = 1 from the resident slices and the padded h copy: the
    product of step 0's h (read back from plain_scan) against
    h_prev @ W_hh at 1e-5, then h (and c) of step 1 against plain_scan's
    at 1e-5, at B 13 (two n tiles) and H 200 (a ragged block of units)."""
    g = GATES[cell]
    mod = MODS[cell]
    b, hidden, t = 13, 200, 3
    x, w_ih, b_ih, w_hh, b_hh, lens = _inputs(
        cell, ndir, torch.bfloat16, 52, t=t, b=b, f=F, hidden=hidden,
        lens=np.full(b, t))
    with fp32_matmul():
        xp = torch.einsum("tbf,dfg->dtbg", x.float(), w_ih.float())
    out, r1, _ = mod.plain_scan(xp, b_ih, w_hh, b_hh, lens, residuals=True)
    w_pk = pack_w_hh(w_hh, g)
    nj = -(-hidden // RES_TJ)
    shape = h_copy_shape(ndir, b, hidden)
    assert shape[2:] == (16, -(-hidden // MMA_KC) * MMA_KC)
    for d in range(ndir):
        t_prev, t_now = (0, 1) if d == 0 else (t - 1, t - 2)
        hb = torch.zeros(shape[2:], dtype=torch.bfloat16)
        hb[:b, :hidden] = out[d, t_prev].bfloat16()
        slices = [_slice(w_pk, d, jb, g, hidden) for jb in range(nj)]
        hg = _product(slices, hb, hidden, b)
        with fp32_matmul():
            want = out[d, t_prev].bfloat16().float() @ w_hh[d].float()
        torch.testing.assert_close(hg, want, rtol=0, atol=1e-5)
        c_prev = r1[d, t_prev] if cell == "lstm" else None
        h_new, c_new, _, _ = _update(cell, xp[d, t_now] + b_ih[d],
                                     hg + b_hh[d], out[d, t_prev], c_prev)
        torch.testing.assert_close(h_new, out[d, t_now], rtol=0, atol=1e-5)
        if cell == "lstm":
            torch.testing.assert_close(c_new, r1[d, t_now], rtol=0,
                                       atol=1e-5)


# (T, B, F, H, lengths): the walk's shape (a chunk of 16 rows: 8 warps
# along K), B 37 (a chunk of 64 rows: 4 along K, 2 along the batch), B 20
# (a chunk of 32 rows) at H 96
WALKS = [(T, B, F, H, LENS),
         (4, 37, 16, 64, np.array([4] * 30 + [3, 2, 2, 1, 1, 4, 3])),
         (5, 20, 40, 96, np.array([5] * 17 + [3, 2, 1]))]


@pytest.mark.parametrize("walk", [0, 1, 2])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_walk_model_matches_plain(cell, ndir, dt, walk):
    t, b, f, hidden, lens = WALKS[walk]
    args = _inputs(cell, ndir, dt, 53 + walk, t=t, b=b, f=f, hidden=hidden,
                   lens=lens)
    got = _walk(cell, *args, residuals=True)
    want = MODS[cell].plain(*args, residuals=True)
    tol = 1e-5 if dt == torch.float32 else 5e-3
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == w.dtype and a.shape == w.shape
        # the LSTM's c relative to its largest value
        scale = (max(1.0, w.abs().max().item())
                 if cell == "lstm" and i == 1 else 1.0)
        err = (a.float() - w.float()).abs().max().item()
        assert err <= tol * scale, (i, err, scale)
    pad = torch.arange(t)[:, None] >= args[-1][None, :]
    for a in got:
        assert not a[:, pad].any()


def _objective(out):
    return (out * out * torch.cos(out)).sum()


@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_walk_model_as_layer_matches_jax(cell, ndir, monkeypatch):
    """The walk as the fused layer (f32 operands) inside the port's
    rnn_scan, inference and through the layer Function's training forward
    (its residuals feeding the backward), against the JAX package's
    rnn_scan through its fused Pallas kernels in interpret mode
    (``bigru_layer_pallas``/``bilstm_layer_pallas``): outputs at 1e-5,
    grads at 2e-4."""
    g = GATES[cell]
    rng = np.random.default_rng(54)
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    ws = [(rng.standard_normal(s) * sc).astype(np.float32) for s, sc in
          (((ndir, F, g * H), 0.2), ((ndir, g * H), 0.1),
           ((ndir, H, g * H), 0.2), ((ndir, g * H), 0.1))]
    calls = []

    def walk(*args, residuals=False):
        calls.append(residuals)
        return _walk(cell, *args, residuals=residuals)

    monkeypatch.setattr(MODS[cell], f"{cell}_layer", walk)
    lens = torch.from_numpy(LENS)
    with torch.no_grad():
        out = rnn_scan(torch.from_numpy(x), lens,
                       *map(torch.from_numpy, ws), cell=cell,
                       bidirectional=ndir == 2)
    params = [torch.from_numpy(a).requires_grad_(True) for a in (x, *ws)]
    out_g = rnn_scan(params[0], lens, *params[1:], cell=cell,
                     bidirectional=ndir == 2)
    _objective(out_g).backward()
    assert calls == [False, True]
    got = [p.grad.numpy() for p in params]

    def f(ps):
        o = jax_rnn_scan(ps[0], jnp.asarray(LENS), *ps[1:], cell=cell,
                         bidirectional=ndir == 2, compute_dtype=jnp.float32,
                         impl="pallas_interpret")
        return (o * o * jnp.cos(o)).sum(), o

    (_, want_out), want = jax.value_and_grad(f, has_aux=True)(
        [jnp.asarray(a) for a in (x, *ws)])
    for o in (out, out_g.detach()):
        np.testing.assert_allclose(o.numpy(), np.asarray(want_out),
                                   rtol=1e-5, atol=1e-5)
    for name, a, w in zip(NAMES, got, want):
        np.testing.assert_allclose(a, np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("gates,b,hidden,want", [
    (3, 20, 800, 130832), (4, 20, 800, 173072), (3, 64, 800, 181008),
    (4, 64, 800, 206864), (3, 16, 1600, 205840)])
def test_resident_smem_budget(gates, b, hidden, want):
    """The resident block's shared memory at H 800 fits the 232,448 bytes a
    block may have at every batch of one chunk; the GRU at H 1600 fits
    only up to 16 rows (and its 200-block grid is not resident)."""
    assert res_smem(gates, b, hidden) == want <= SMEM_MAX


@pytest.mark.parametrize("gates,b", [(3, 17), (3, 64), (4, 20)])
def test_resident_smem_refuses_h1600(gates, b):
    assert res_smem(gates, b, 1600) > SMEM_MAX


# H100 SXM: 132 SMs, one block of either persistent kernel on each
CAPS = (132, 132)


@pytest.mark.parametrize("gates,b,hidden,ndir,caps,want", [
    (3, 20, 800, 2, CAPS, 3), (4, 20, 800, 2, CAPS, 3),  # the default
    (3, 64, 800, 2, CAPS, 3), (4, 1, 800, 1, CAPS, 3),
    (3, 64, 1600, 2, CAPS, 2),     # the wide GRU's layer 0
    (3, 16, 1600, 2, CAPS, 2),     # the slices fit, the grid does not
    (3, 16, 1600, 1, CAPS, 3),
    (3, 65, 800, 2, CAPS, 1), (4, 130, 800, 2, CAPS, 1),  # beyond a chunk
    (3, 20, 800, 2, (132, 99), 2),  # a resident grid that is not resident
    (3, 20, 3200, 2, CAPS, 1),     # neither persistent grid is resident
])
def test_fwd_variant_rule(gates, b, hidden, ndir, caps, want):
    """"auto": resident where the slices fit a block and the grid is
    resident, else streamed persistent where its grid is, one launch a
    step above one chunk of FWD_CHUNK rows; the named variants as asked;
    anything else raises."""
    assert -(-b // 8) * 8 <= FWD_CHUNK or want == 1
    assert fwd_variant("auto", gates, b, hidden, ndir, *caps) == want
    for name, mode in (("step", 1), ("persistent", 2), ("resident", 3)):
        assert fwd_variant(name, gates, b, hidden, ndir, *caps) == mode
    with pytest.raises(ValueError, match="variant"):
        fwd_variant("fast", gates, b, hidden, ndir, *caps)


@pytest.mark.parametrize("ndir,hidden,blocks", [(2, 800, (50, 104)),
                                                (1, 40, (2, 4)),
                                                (2, 1600, (100, 200))])
def test_fwd_blocks(ndir, hidden, blocks):
    """The resident grid pads each direction's ceil(H / 16) blocks to
    whole clusters of RES_CL."""
    assert fwd_blocks(ndir, hidden) == blocks
