"""PyTorch port: the design of K8 (ctc_alpha) and K9 (ctc_beta), held on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py), but their
arithmetic and their index walks have models here:

- K9's per-frame class reduction in the kernel's order: the valid label
  states sorted by class, stably, by the kernel's chunked placement (32
  states at a time, a rank within the chunk's same-class states on top of
  a running cursor); the blank states' gammas by 32 lane-strided partial
  sums and a butterfly; then each class's contiguous segment in state
  order. Held to ``scatter_add_`` and to the JAX package's one-hot einsum
  (``_ctc_bwd``'s) at 1e-6.
- ``plain_alpha`` / ``plain_beta``, the wrappers' twins, which now take the
  log-probs and the extended labels and return the loss and the logit
  gradient: held to the JAX Pallas kernels in interpret mode
  (``_run_alpha``, ``_run_beta``, ``_ctc_fwd``, ``_ctc_bwd``) and to the
  emission-based composition the port used before (the gather outside,
  the recursions, the closed form with ``scatter_add_``) at 1e-5.
- The port's ``ctc_loss`` and its gradient against the JAX package's XLA
  scan on the edge rows: S > 1024, a NaN row, a row of one frame, no
  labels, an impossible alignment; at tests/test_torch_ctc.py's tolerances
  (1e-4 loss, rtol 1e-3 / atol 1e-4 gradient), but for the gradient at
  S > 1024 (atol 5e-3): there the loss is ~2,800 nats, and the closed form
  that the Pallas kernels and the port share, exp(alpha + beta - emit +
  loss), cancels f32 sums of that size carried over 1,100 frames. Against
  a float64 evaluation the Pallas path's gradient is off by 2.8e-3 on that
  case, the port's by 2.6e-3, XLA's autodiff by 1.5e-4. A row whose loss
  is not finite has a gradient of exactly 0 (XLA's autodiff gives NaN on a
  NaN row, so that row is held to 0 only).
- The staging ring's walk (``ring_plan``'s chunk, the global route's
  ``global_plan`` chunk, the kernels' chunk and slot arithmetic): every
  frame a kernel reads is staged, landed and not yet overwritten, for T
  below one chunk, T not a multiple of it, and long T, forward (K8) and
  reversed with K9's two-frame lag.
- The route rule (``ctc.route``): the ring wherever ``ring_plan`` fits one
  block, the global route above (K9 from S 4,448 at C 30, K8 from
  27,137); ``ring_plan`` still raises past its limit. And the port's
  ``ctc_loss`` at S 4,501 (B 1, T 2,300, L 2,250) against the XLA scan at
  tests/test_torch_ctc.py's tolerances, on logits peaked along one
  alignment (a loss of ~61 nats: on random logits the closed form's f32
  cancellation, as at S 1041 above, would set the gradient's error).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeech_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from deepspeech_tpu.ops.pallas import ctc_kernel as jax_k
from deepspeech_tpu_torch.ops import ctc as port_ctc
from deepspeech_tpu_torch.ops.cuda import build
from deepspeech_tpu_torch.ops.cuda import ctc as ctc_k

torch.set_num_threads(2)

F32 = np.float32


# ---- K9's class reduction ----

def sort_labels(ext: np.ndarray, nl: int) -> np.ndarray:
    """The kernel's placement: label state 2k + 1 (k < nl) goes to its
    class's cursor plus its rank among the same-class states of its chunk
    of 32; -> the states in sorted order."""
    cls = ext[1:2 * nl:2]
    c = int(ext.max()) + 1
    count = np.bincount(cls, minlength=c)
    cursor = np.concatenate([[0], np.cumsum(count)[:-1]])
    order = np.empty(nl, np.int64)
    for k0 in range(0, nl, 32):
        chunk = cls[k0:k0 + 32]
        for lane, cl in enumerate(chunk):
            order[cursor[cl] + np.sum(chunk[:lane] == cl)] = 2 * (k0 + lane) + 1
        for cl in np.unique(chunk):
            cursor[cl] += np.sum(chunk == cl)
    return order


def reduce_frame(gamma: np.ndarray, ext: np.ndarray, tl: int,
                 c: int) -> np.ndarray:
    """One frame's class occupancy (C,) f32 from the states' gammas (S,)
    in K9's order."""
    s = len(ext)
    nl = max(min(tl, (s - 1) // 2), 0)
    nb = nl + 1
    row = np.concatenate([gamma[0:2 * nl + 1:2],
                          gamma[sort_labels(ext, nl)]]).astype(F32)
    part = np.zeros(32, F32)
    for lane in range(32):
        for k in range(lane, nb, 32):
            part[lane] = F32(part[lane] + row[k])
    for d in (16, 8, 4, 2, 1):
        part = (part + part[np.arange(32) ^ d]).astype(F32)
    assert (part == part[0]).all()  # the butterfly leaves every lane equal
    lab = ext[sort_labels(ext, nl)]
    out = np.zeros(c, F32)
    blank = ext[0]
    for cl in range(c):
        o = part[0] if cl == blank else F32(0)
        for k in np.flatnonzero(lab == cl):
            o = F32(o + row[nb + k])
        out[cl] = o
    return out


def _labels(kind, rng, lmax, c):
    if kind == "same":
        return np.full(lmax, 3)
    if kind == "repeats":  # runs of equal labels: skips disallowed there
        return np.repeat(rng.integers(1, c, (lmax + 2) // 3), 3)[:lmax]
    return rng.integers(1, c, lmax)


@pytest.mark.parametrize("kind,tl", [("random", 40), ("repeats", 40),
                                     ("same", 40), ("random", 0),
                                     ("random", 17), ("repeats", 70)])
def test_class_reduction_matches_scatter_and_einsum(kind, tl):
    rng = np.random.default_rng(len(kind) * 100 + tl)
    c, lmax, t = 30, 70, 5
    ext = np.zeros(2 * lmax + 1, np.int64)
    ext[1::2] = _labels(kind, rng, lmax, c)
    s = len(ext)
    # gammas in [0, 1], zero on states past 2 tl (as alpha + beta leave
    # them), some zero inside (gamma under e^-80)
    gamma = rng.uniform(0, 1, (t, s)).astype(F32)
    gamma[:, 2 * tl + 1:] = 0
    gamma[rng.uniform(size=(t, s)) < 0.3] = 0
    got = np.stack([reduce_frame(gamma[i], ext, tl, c) for i in range(t)])
    ext_t = torch.from_numpy(ext)[None]
    want = ctc_k.occupancy(torch.from_numpy(gamma)[None], ext_t, c)[0]
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6)
    onehot = np.eye(c, dtype=F32)[ext][None]
    einsum = jnp.einsum("tbs,bsc->btc", jnp.asarray(gamma)[:, None],
                        jnp.asarray(onehot),
                        precision="highest")[0]
    np.testing.assert_allclose(got, np.asarray(einsum), rtol=1e-6,
                               atol=1e-6)


def test_sort_labels_is_stable_by_class():
    rng = np.random.default_rng(3)
    ext = np.zeros(2 * 200 + 1, np.int64)
    ext[1::2] = rng.integers(1, 6, 200)  # few classes: long runs per chunk
    order = sort_labels(ext, 150)
    want = 2 * np.argsort(ext[1:300:2], kind="stable") + 1
    np.testing.assert_array_equal(order, want)


def test_kernel_source_has_no_atomics_or_fast_math():
    """K9 sums by class without atomics, global or shared; the header says
    no fast intrinsic is used, and none is."""
    src = open(os.path.join(build.CSRC, "ctc.cu")).read()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for word in ("atomic", "__expf", "__logf", "ex2.approx", "lg2.approx"):
        assert word not in code, word


# ---- the plain twins against the Pallas kernels and the old composition

def _case(seed, b=4, t=15, c=9, lmax=5):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, c)).astype(F32)
    ll = rng.integers(lmax * 2 + 2, t + 1, b).astype(np.int32)
    ll[0] = t
    targets = rng.integers(1, c, (b, lmax)).astype(np.int32)
    tl = rng.integers(0, lmax + 1, b).astype(np.int32)
    tl[1] = lmax
    ll[2], tl[2] = 2, lmax  # impossible
    tl[3] = 0
    return logits, ll, targets, tl


def _old_composition(logits, ll, targets, tl, g):
    """The port before the redesign: the gather and tables outside the
    kernels, the recursions on the emissions, scatter_add_ outside."""
    lg = torch.from_numpy(logits)
    b, t, c = lg.shape
    s = 2 * targets.shape[1] + 1
    log_probs = torch.log_softmax(lg, -1)
    ext = torch.zeros((b, s), dtype=torch.int64)
    ext[:, 1::2] = torch.from_numpy(targets).long()
    prev2 = torch.cat([ext.new_zeros((b, 2)), ext[:, :-2]], 1)
    lane = torch.arange(s)[None]
    skip = torch.where((lane % 2 == 1) & (ext != prev2), 0.0, -1e30)
    tlt = torch.from_numpy(tl).long()[:, None]
    valid = torch.where(lane < 2 * tlt + 1, 0.0, -1e30)
    end = torch.where((lane == 2 * tlt) | ((lane == 2 * tlt - 1) & (tlt > 0)),
                      0.0, -1e30)
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(b, t, s))
    lens = torch.from_numpy(ll).long()
    alphas = ctc_k.alpha_recursion(emit, skip, valid, lens)
    last = alphas[torch.arange(b), (lens - 1).clamp(min=0)]
    loss = ctc_k.loss_from_alpha(last, torch.from_numpy(tl))
    betas = ctc_k.beta_recursion(emit, skip, valid, end, lens)
    ok = torch.isfinite(loss)[:, None, None]
    log_gamma = alphas + betas - emit + loss[:, None, None]
    gamma = torch.where(ok & (log_gamma > -80.0),
                        torch.exp(log_gamma.clamp(max=0.0)), 0.0)
    occ = torch.zeros_like(log_probs).scatter_add_(
        2, ext[:, None, :].expand(b, t, s), gamma)
    frame_ok = (torch.arange(t)[None, :] < lens[:, None])[..., None]
    d = torch.where(frame_ok & ok, torch.exp(log_probs) - occ, 0.0)
    d = torch.where(ok, d * torch.from_numpy(g)[:, None, None], 0.0)
    return alphas, loss, betas, d


def _port_plain(logits, ll, targets, tl, g):
    log_probs, ext = port_ctc._prep(torch.from_numpy(logits),
                                    torch.from_numpy(targets), 0)
    tlt, llt = torch.from_numpy(tl), torch.from_numpy(ll)
    alphas, loss = ctc_k.plain_alpha(log_probs, ext, tlt, llt)
    d, betas = ctc_k.plain_beta(log_probs, ext, tlt, llt, alphas, loss,
                                torch.from_numpy(g), with_betas=True)
    return tuple(x.numpy() for x in (alphas, loss, betas, d))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("seed", [0])
def test_plain_twins_match_pallas_interpret(seed):
    logits, ll, targets, tl = _case(seed)
    g = np.random.default_rng(seed + 10).uniform(0.5, 1.5, 4).astype(F32)
    alphas, loss, betas, d = _port_plain(logits, ll, targets, tl, g)
    args = (jnp.asarray(logits), jnp.asarray(ll), jnp.asarray(targets),
            jnp.asarray(tl))
    _, _, skip, valid, emit, end = jax_k._prep(*args, 0)
    want_a = jax_k._run_alpha(emit, skip, valid, args[1], True)
    want_b = jax_k._run_beta(emit, skip, valid, end, args[1], True)
    _close(alphas, np.moveaxis(np.asarray(want_a), 0, 1))
    _close(betas, np.moveaxis(np.asarray(want_b), 0, 1))
    want_loss, res = jax_k._ctc_fwd(*args, 0, True)
    _close(loss, want_loss)
    (want_d, *_) = jax_k._ctc_bwd(0, True, res, jnp.asarray(g))
    _close(d, want_d)
    assert not np.isfinite(loss[2]) and (d[2] == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_twins_match_old_composition(seed):
    logits, ll, targets, tl = _case(seed)
    g = np.random.default_rng(seed + 20).uniform(0.5, 1.5, 4).astype(F32)
    for got, want in zip(_port_plain(logits, ll, targets, tl, g),
                         _old_composition(logits, ll, targets, tl, g)):
        _close(got, want)


def test_plain_beta_zero_rows_ignore_nonfinite_g():
    """A row whose loss is not finite gets dlogits 0 even where g is inf or
    NaN; a finite row past its length gets 0 * g."""
    logits, ll, targets, tl = _case(4)
    g = np.array([1.0, np.nan, np.inf, 2.0], F32)
    _, loss, _, d = _port_plain(logits, ll, targets, tl, g)
    assert not np.isfinite(loss[2]) and (d[2] == 0).all()
    assert np.isnan(d[1]).all()  # finite loss: NaN g spreads, as before
    assert (d[3, ll[3]:] == 0).all() and np.isfinite(d[3]).all()


# ---- the loss against the XLA scan on the edge rows ----

def _edge_case(name):
    rng = np.random.default_rng(len(name))
    if name == "s_over_1024":
        b, t, c, lmax = 2, 1100, 30, 520
        logits = rng.standard_normal((b, t, c)).astype(F32)
        return (logits, np.array([1100, 1000], np.int32),
                rng.integers(1, c, (b, lmax)).astype(np.int32),
                np.array([520, 500], np.int32))
    b, t, c, lmax = 4, 19, 7, 5
    logits = rng.standard_normal((b, t, c)).astype(F32)
    ll = np.full(b, t, np.int32)
    targets = rng.integers(1, c, (b, lmax)).astype(np.int32)
    tl = np.array([lmax, 3, 2, 4], np.int32)
    if name == "nan_row":
        logits[1, 7, 2] = np.nan
    elif name == "length_1":
        ll[1], tl[1] = 1, 1
        ll[2], tl[2] = 1, 0
    elif name == "no_labels":
        tl[:] = [0, 3, 0, 1]
    elif name == "impossible":
        ll[0], tl[0] = 4, lmax
    return logits, ll, targets, tl


@pytest.mark.parametrize("name", ["s_over_1024", "nan_row", "length_1",
                                  "no_labels", "impossible"])
def test_loss_and_grad_match_xla_on_edge_rows(name):
    args = _edge_case(name)
    lg = torch.from_numpy(args[0]).requires_grad_(True)
    per = port_ctc.ctc_loss(lg, *(torch.from_numpy(a) for a in args[1:]))
    torch.where(torch.isfinite(per), per, 0.0).sum().backward()
    import jax

    def f(x):
        p = jax_ctc_loss(x, *(jnp.asarray(a) for a in args[1:]), impl="xla")
        return jnp.where(jnp.isfinite(p), p, 0.0).sum(), p

    (_, want), want_g = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(args[0]))
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    bad = ~np.isfinite(per.detach().numpy())
    assert (lg.grad.numpy()[bad] == 0).all()
    want_g = np.asarray(want_g)
    rows = np.isfinite(want_g).all(axis=(1, 2))
    assert rows[~bad].all()
    np.testing.assert_allclose(
        lg.grad.numpy()[rows], want_g[rows], rtol=1e-3,
        atol=5e-3 if name == "s_over_1024" else 1e-4)
    if name in ("nan_row", "impossible"):
        assert bad.any()


# ---- the staging ring ----

def ring_walk(n: int, chunk: int, reverse: bool, lag: int) -> None:
    """Replay a kernel's staging walk over a row of n valid frames: the
    prologue stages chunks 0..AHEAD-1, chunk j's first frame stages chunk
    j + AHEAD into stage (j + AHEAD) % RING, and the last frame of chunk j
    waits for chunk j + 1 (at most AHEAD - 1 copies in flight). Frame f of
    chunk j sits in stage j % RING at slot f - base(j). At each step the
    chain reads its frame and, ``lag`` steps behind, the lagged readers
    read theirs (K9: the alpha row of the frame before, the log-probs of
    the frame two before). Every read must find the right frame landed."""
    ring, ahead = ctc_k.RING, ctc_k.RING - 2
    stage = [None] * ring      # (chunk, landed)
    issued = []

    def base(j):
        return n - (j + 1) * chunk if reverse else j * chunk

    def issue(j):  # a chunk past the row's frames copies nothing
        if max(base(j), 0) < min(base(j) + chunk, n):
            stage[j % ring] = (j, False)
        issued.append(j)

    def wait(pending):  # all but the newest `pending` chunks landed
        for j in issued[:len(issued) - pending]:
            if stage[j % ring] and stage[j % ring][0] == j:
                stage[j % ring] = (j, True)

    def read(r):  # the frame at walk position r
        f = n - 1 - r if reverse else r
        j = r // chunk
        got = stage[j % ring]
        assert got == (j, True), (r, got)
        slot = f - base(j)
        assert 0 <= slot < chunk and max(base(j), 0) <= f < base(j) + chunk

    for j in range(ahead):
        issue(j)
    wait(ahead - 1)
    q = 0
    for r in range(n + lag):
        if r < n:
            if q == 0:
                issue(r // chunk + ahead)
            read(r)
        for back in range(1, lag + 1):
            if 0 <= r - back < n:
                read(r - back)
        if r < n:
            q += 1
            if q == chunk:
                q = 0
                wait(ahead - 1)


@pytest.mark.parametrize("n", [1, 5, 12, 13, 24, 37, 376, 1500])
@pytest.mark.parametrize("s,c", [(301, 30), (1041, 30), (11, 7)])
def test_staging_ring_walk(n, s, c):
    for beta in (False, True):
        chunk, smem = ctc_k.ring_plan(s, c, beta)
        assert ctc_k.MIN_CHUNK <= chunk <= ctc_k.MAX_CHUNK
        assert smem <= ctc_k.SMEM_MAX
        ring_walk(n, chunk, reverse=beta, lag=2 if beta else 0)
        ring_walk(n, ctc_k.MIN_CHUNK, reverse=beta, lag=2 if beta else 0)
        ring_walk(n, ctc_k.global_plan(c)[0], reverse=beta,
                  lag=2 if beta else 0)


def test_ring_plan_shapes():
    # the train shape: K8 stages 32 frames of 30 log-probs, K9 fewer of
    # the wider log-prob and alpha rows
    assert ctc_k.ring_plan(301, 30, False) == (32, 4 * (2 * 301 + 4 * 32 * 30))
    chunk, smem = ctc_k.ring_plan(301, 30, True)
    assert chunk == 65536 // (4 * 4 * 331)
    assert smem == 4 * (4 * 301 + 2 * 30 + 1 + 301 + chunk * 4 * 331)
    with pytest.raises(ValueError, match="shared memory"):
        ctc_k.ring_plan(6000, 30, True)
    assert ctc_k.ring_plan(6000, 30, False)[0] == ctc_k.MAX_CHUNK
    # the route: the ring up to its limit, the global route above it
    for s, c, beta in ((301, 30, True), (4447, 30, True), (6000, 30, True),
                       (27136, 30, False), (27137, 30, False),
                       (100_001, 30, False), (9001, 30, True)):
        fits = ctc_k._ring_smem(s, c, beta)[1] <= ctc_k.SMEM_MAX
        assert ctc_k.route(s, c, beta) == ("ring" if fits else "global")
        if not fits:
            with pytest.raises(ValueError, match="shared memory"):
                ctc_k.ring_plan(s, c, beta)
    assert ctc_k.route(4447, 30, True) == "ring"
    assert ctc_k.route(4448, 30, True) == "global"
    assert ctc_k.route(27136, 30, False) == "ring"
    assert ctc_k.route(27137, 30, False) == "global"
    # the global route holds only the log-prob ring, for any S
    assert ctc_k.global_plan(30) == (32, 4 * 4 * 32 * 30)
    with pytest.raises(ValueError, match="shared memory"):
        ctc_k.global_plan(8000)


def test_long_labels_match_xla():
    rng = np.random.default_rng(0)
    lmax, t, c = 2250, 2300, 30
    targets = np.empty(lmax, np.int32)
    prev = 0
    for i in range(lmax):  # no repeats: one frame a label suffices
        prev = targets[i] = (prev + rng.integers(1, c - 1)) % (c - 1) + 1
    logits = rng.standard_normal((1, t, c)).astype(F32)
    logits[0, np.arange(lmax), targets] += 8.0
    logits[0, lmax:, 0] += 8.0
    args = (np.array([t], np.int32), targets[None],
            np.array([lmax], np.int32))
    assert ctc_k.route(2 * lmax + 1, c, True) == "global"
    lg = torch.from_numpy(logits).requires_grad_(True)
    per = port_ctc.ctc_loss(lg, *(torch.from_numpy(a) for a in args))
    per.sum().backward()
    import jax

    def f(x):
        p = jax_ctc_loss(x, *(jnp.asarray(a) for a in args), impl="xla")
        return p.sum(), p

    (_, want), want_g = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(logits))
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_g),
                               rtol=1e-3, atol=1e-4)
