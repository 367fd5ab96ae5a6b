"""PyTorch port: the designs of K1 (stft_mag) and K10 (topk), held on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py), but each
design's host half is Python and its device half is arithmetic a numpy
model can follow step by step:

- K1's FFT route: ``fft_plan`` (the radix sequence), ``fft_twiddles`` (the
  f32 table the wrapper uploads, rounded once from float64) and the route
  rule on n_fft. A numpy Stockham FFT driven by that plan and that table,
  with the kernel's index arithmetic, its f32 butterfly constants and its
  even/odd real-input split, is held to the wrapper's ``plain`` and to the
  JAX package (the Pallas kernel in interpret mode where hop divides n_fft,
  the matmul lowering at n_fft 400 / hop 160, which the Pallas kernel
  refuses) at rtol = atol = 1e-4, the tolerance of tests/test_pallas_stft.py.
- K10's selection route: a numpy model of the 64-bit radix select (8 bits
  a pass, the suffix scan, the early stop, the index's high two bytes
  skipped), the compaction and the rank
  pass, held bit for bit (values as int32 bits, and indices) to ``plain``,
  to a lexsort oracle and, for k <= 128, to the JAX Pallas kernel in
  interpret mode; and the route rule on k and the block shape on n.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeech_tpu.ops.pallas.stft_kernel import stft_magnitude_pallas
from deepspeech_tpu.ops.pallas.topk_kernel import topk_total_order as jax_topk
from deepspeech_tpu.ops.stft import stft_magnitude as jax_stft
from deepspeech_tpu_torch.audio.features import make_window
from deepspeech_tpu_torch.ops.cuda import build, stft, topk

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


# ---- K1: the FFT route ----

def butterfly(a: np.ndarray) -> np.ndarray:
    """The R-point DFT along axis 0 with the kernel's f32 constants."""
    q = np.arange(len(a))
    d = np.exp(-2j * np.pi * np.outer(q, q) / len(a)).astype(np.complex64)
    return np.einsum("qr,r...->q...", d, a).astype(np.complex64)


def reg_dft(a: np.ndarray, r1: int, r2: int, itw: np.ndarray) -> np.ndarray:
    """``RegDft<R1, R2>``: R2 DFTs of R1 points (point s2 + R2 r1), the
    internal twiddles itw[(s2-1)(r1-1) + q1-1], R1 DFTs of R2 points; output
    q1 + R1 q2."""
    t = np.empty_like(a)
    for s2 in range(r2):
        c = butterfly(a[s2::r2])
        for q1 in range(r1):
            w = itw[(s2 - 1) * (r1 - 1) + q1 - 1] if s2 and q1 else 1
            t[q1 * r2 + s2] = c[q1] * np.complex64(w)
    out = np.empty_like(a)
    for q1 in range(r1):
        out[q1::r1] = butterfly(t[q1 * r2:(q1 + 1) * r2])
    return out


def stockham(z: np.ndarray, plan, tw: np.ndarray) -> tuple[np.ndarray, int]:
    """(F, M) complex64 -> its FFT along M, stage by stage as
    ``stft_fft_kernel``: butterfly j of radix R = R1 R2 reads points
    j + r M/R, twiddles them by tw[off + k (R-1) + r - 1] (k = j mod ns),
    takes their DFT as ``reg_dft``, writes points (j-k) R + k + q ns.
    Returns the spectra and the offset of the post-twiddles in ``tw``."""
    m = z.shape[1]
    src, ns, off = z.astype(np.complex64), 1, 0
    for r1, r2 in plan:
        r = r1 * r2
        mr = m // r
        j = np.arange(mr)
        k = j % ns
        a = np.stack([src[:, j + q * mr] for q in range(r)])
        w = tw[off + k[:, None] * (r - 1) + np.arange(r - 1)[None, :]]
        a[1:] = a[1:] * w.T[:, None, :]
        off += ns * (r - 1)
        b = reg_dft(a, r1, r2, tw[off:off + (r1 - 1) * (r2 - 1)])
        off += (r1 - 1) * (r2 - 1)
        dst = np.empty_like(src)
        for q in range(r):
            dst[:, (j - k) * r + k + q * ns] = b[q]
        src, ns = dst, ns * r
    return src, off


def fft_model(y: np.ndarray, n_fft: int, hop: int,
              window: np.ndarray) -> np.ndarray:
    """|STFT| (B, S) -> (B, n_fft/2 + 1, T) through the FFT route's model."""
    plan, tw = stft.fft_plan(n_fft), stft.fft_twiddles(n_fft)
    pad = n_fft // 2
    yp = np.pad(y, ((0, 0), (pad, pad)), mode="reflect")
    t = (yp.shape[1] - n_fft) // hop + 1
    frames = np.stack([yp[:, i * hop:i * hop + n_fft] for i in range(t)], 1)
    x = (frames * window.astype(np.float32)).astype(np.float32)
    b, m = y.shape[0], n_fft // 2
    z = (x[..., 0::2] + 1j * x[..., 1::2]).astype(np.complex64)
    spec, off = stockham(z.reshape(b * t, m), plan, tw)
    k = np.arange(m + 1)
    zk, zm = spec[:, k % m], spec[:, (m - k) % m]
    e = 0.5 * (zk + np.conj(zm))
    o = (zk - np.conj(zm)) / np.complex64(2j)
    mag = np.abs(e + tw[off + k] * o).astype(np.float32)
    return mag.reshape(b, t, m + 1).transpose(0, 2, 1)


@pytest.mark.parametrize("n_fft,plan", [
    (160, ((4, 4), (5, 1))), (200, ((4, 1), (5, 1), (5, 1))),
    (320, ((4, 4), (2, 5))), (400, ((4, 2), (5, 1), (5, 1))),
    (480, ((4, 4), (3, 5))), (512, ((4, 4), (4, 4))), (4, ((2, 1),)),
    (8, ((4, 1),)), (12, ((2, 3),)), (1920, ((4, 4), (4, 3), (5, 1))),
    (448, None), (2046, None), (2040, None), (162, None), (14, None)])
def test_fft_plan_and_route(n_fft, plan):
    """Base radices 4, then 2, then 3, then 5, whose product is n_fft / 2,
    paired in order into the stages' in-register radices where their
    product is at most 16; any other factor
    (448 = 2^6 7, 2040 / 2 = 4 3 5 17), or an n_fft not a multiple of 4,
    takes the DFT route."""
    assert stft.fft_plan(n_fft) == plan
    assert stft.route(n_fft) == ("dft" if plan is None else "fft")
    if plan is not None:
        assert np.prod(plan) == n_fft // 2
        assert max(r1 * r2 for r1, r2 in plan) <= stft.MAX_STAGE_RADIX
        code = stft.plan_code(plan)
        assert [((code >> (6 * s)) & 7, (code >> (6 * s + 3)) & 7)
                for s in range(len(plan) + 1)] == [*plan, (0, 0)]


def test_every_plan_has_its_stages_in_the_kernel():
    """Each (R1, R2) stage that a plan of any n_fft the wrapper takes can
    hold is instantiated in ``stft_fft_kernel``'s dispatch."""
    src = open(os.path.join(build.CSRC, "stft_mag.cu")).read()
    kernel = {(int(a), int(b))
              for a, b in re.findall(r"DS_STAGE\((\d), (\d)\)", src)}
    plans = [stft.fft_plan(n) for n in range(4, 2 * stft.MAX_BINS, 4)]
    used = {stage for plan in plans if plan for stage in plan}
    assert used and used <= kernel


@pytest.mark.parametrize("n_fft", [160, 320, 400, 480])
def test_fft_twiddles_are_f64_rounded_once(n_fft):
    tw = stft.fft_twiddles(n_fft)
    plan, m = stft.fft_plan(n_fft), n_fft // 2
    assert tw.dtype == np.complex64
    sizes, ns = [], 1
    for r1, r2 in plan:
        sizes.append(ns * (r1 * r2 - 1) + (r1 - 1) * (r2 - 1))
        ns *= r1 * r2
    assert len(tw) == sum(sizes) + m + 1
    post = tw[sum(sizes):]
    ref = np.exp(-2j * np.pi * np.arange(m + 1, dtype=np.float64) / n_fft)
    assert np.array_equal(post, ref.astype(np.complex64))
    assert post[0] == 1 and post[-1].real == -1
    r1, r2 = plan[0]
    assert np.all(tw[:r1 * r2 - 1] == 1)  # the first stage's k = 0
    internal = tw[r1 * r2 - 1:sizes[0]]  # exp(-2 pi i s2 q1 / (r1 r2))
    s2, q1 = np.meshgrid(np.arange(1, r2), np.arange(1, r1), indexing="ij")
    assert np.array_equal(internal, np.exp(
        -2j * np.pi * (s2 * q1).ravel() / (r1 * r2)).astype(np.complex64))


@pytest.mark.parametrize("n_fft,hop,ft", [
    (320, 160, 16), (160, 80, 32), (400, 160, 16), (480, 160, 8),
    (512, 128, 8), (1920, 480, 2), (320, 1600, 4)])
def test_fft_frames_per_block(n_fft, hop, ft):
    """32 frames a block, halved while a frame buffer or the staged samples
    would pass FFT_BUF_BYTES."""

    def fits(f):
        return max(f * (n_fft // 2) * 8,
                   ((f - 1) * hop + n_fft) * 4) <= stft.FFT_BUF_BYTES

    assert stft.fft_frames_per_block(n_fft, hop) == ft
    assert fits(ft) and (ft == 32 or not fits(2 * ft))


def _waves(seed, b, s):
    rng = np.random.default_rng(seed)
    t = np.arange(s) / 16000
    y = (0.5 * np.sin(2 * np.pi * rng.uniform(100, 900, (b, 1)) * t)
         + 0.1 * rng.standard_normal((b, s)))
    return (y / np.abs(y).max(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,s", [(160, 80, 4000), (320, 160, 7403),
                                         (400, 160, 5000), (320, 160, 170)])
def test_fft_model_matches_plain_and_jax(n_fft, hop, s):
    """The FFT route's model against the wrapper's plain DFT and the JAX
    package; (320, 160, 170) is one short utterance whose every frame
    reads a reflected edge."""
    y = _waves(n_fft + s, 3, s)
    win = make_window("hamming", n_fft)
    got = fft_model(y, n_fft, hop, win)
    plain = stft.plain(torch.from_numpy(y), n_fft, hop, win).numpy()
    assert got.shape == plain.shape
    np.testing.assert_allclose(got, plain, **TOL)
    if n_fft % hop == 0:
        ref = stft_magnitude_pallas(jnp.asarray(y), n_fft, hop, win,
                                    interpret=True)
    else:
        ref = jax_stft(jnp.asarray(y), n_fft, hop, win, method="matmul")
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


# ---- K10: the selection route ----

def composite_keys(x: np.ndarray) -> np.ndarray:
    """(ordered float bits << 32) | ~index, as ``topk.cu:composite``."""
    u = x.view(np.uint32).astype(np.uint64)
    ordered = np.where(u >> 31 == 1, u ^ 0xFFFFFFFF, u | 0x80000000)
    idx = np.arange(len(x), dtype=np.uint64)
    return (ordered << 32) | (~idx & 0xFFFFFFFF)


def select_model(x: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray, int]:
    """One row through ``topk_select``'s arithmetic: the radix select (a
    256-bin histogram of the live keys' digit, the scan from the top digit
    down, the stop once the keys left are the ones needed), the compaction
    and the rank pass. Returns (values, indices, passes)."""
    assert len(x) <= 1 << 16
    key = composite_keys(x)
    prefix, mask, need, passes = 0, 0, k, 0
    for shift in (56, 48, 40, 32, 8, 0):
        if shift == 8:  # ~index >> 16 is 0xffff for every index < 65,536
            prefix |= 0xFFFF0000
            mask |= 0xFFFF0000
        passes += 1
        live = key[(key & np.uint64(mask)) == np.uint64(prefix)]
        hist = np.bincount(((live >> np.uint64(shift)) & np.uint64(0xFF))
                           .astype(np.int64), minlength=256)
        above = 0
        for digit in range(255, -1, -1):
            if above + hist[digit] >= need:
                break
            above += hist[digit]
        need -= above
        prefix |= digit << shift
        mask |= 0xFF << shift
        if hist[digit] == need:
            break
    cand = key[(key & np.uint64(mask)) >= np.uint64(prefix)]
    assert len(cand) == k
    rank = (cand[None, :] > cand[:, None]).sum(1)
    out = np.empty(k, np.uint64)
    out[rank] = cand
    ordered = (out >> np.uint64(32)).astype(np.uint32)
    bits = np.where(ordered >> 31 == 1, ordered ^ 0x80000000,
                    ordered ^ 0xFFFFFFFF).astype(np.uint32)
    idx = (~out & np.uint64(0xFFFFFFFF)).astype(np.uint32).astype(np.int32)
    return bits.view(np.float32), idx, passes


def ref_topk(x: np.ndarray, k: int):
    u = x.view(np.int32).astype(np.int64)
    key = u ^ (0x7FFFFFFF & (u >> 31))
    order = np.lexsort((np.arange(len(x)), -key))
    return x[order[:k]], order[:k].astype(np.int32)


def stress_row(rng, n: int) -> np.ndarray:
    """Ties, signed zeros, infinities and NaNs of both signs with payloads,
    as the rows of tests/test_torch_topk.py and tests/test_torch_cuda.py."""
    x = rng.standard_normal(n).astype(np.float32)
    nans = np.array([0x7FC00011, 0xFFC00022], np.uint32).view(np.float32)
    specials = np.concatenate(
        [np.array([0.0, -0.0, np.inf, -np.inf, 1.5], np.float32), nans])
    pick = rng.integers(0, n, n // 3)
    x[pick] = rng.choice(specials, len(pick))
    return x


def flood_row(rng, n: int = 3968, finite: int = 31) -> np.ndarray:
    """A width-128 beam's early step: one live beam's candidates finite,
    the rest -inf."""
    x = np.full(n, -np.inf, np.float32)
    x[rng.choice(n, finite, replace=False)] = (
        rng.standard_normal(finite) * 8 - 40).astype(np.float32)
    return x


def assert_same(got, ref):
    (gv, gi), (rv, ri) = got, ref
    assert np.array_equal(np.asarray(gv).view(np.int32),
                          np.asarray(rv).view(np.int32))
    assert np.array_equal(np.asarray(gi), np.asarray(ri))


ROWS = {
    "normal": lambda rng, n: rng.standard_normal(n).astype(np.float32),
    "stress": stress_row,
    "ties": lambda rng, n: np.full(n, 0.25, np.float32),
    "beam": lambda rng, n: np.where(rng.random(n) < 0.33, -np.inf,
                                    rng.standard_normal(n) * 8 - 40
                                    ).astype(np.float32),
}


@pytest.mark.parametrize("kind", sorted(ROWS))
@pytest.mark.parametrize("n,k", [(310, 1), (310, 10), (3968, 128),
                                 (3968, 256), (300, 300), (1000, 256)])
def test_select_model_matches_plain_and_jax(kind, n, k):
    x = ROWS[kind](np.random.default_rng(n * 7 + k), n)
    v, i, _ = select_model(x, k)
    pv, pi = topk.plain(torch.from_numpy(x[None].copy()), k)
    assert_same((v, i), (pv.numpy()[0], pi.numpy()[0]))
    assert_same((v, i), ref_topk(x, k))
    if k <= 128:
        jv, ji = jax_topk(jnp.asarray(x), k, interpret=True, force=True)
        assert_same((v, i), (np.asarray(jv), np.asarray(ji)))


@pytest.mark.parametrize("k", [1, 10, 97, 128, 256])
def test_select_model_on_the_inf_flood(k):
    """31 finite of 3,968, the rest -inf: past the 31 the threshold is -inf
    and the lowest indices among ~3,900 ties are taken, which reads the
    index's low two bytes (6 passes); within the 31 the value word
    decides."""
    x = flood_row(np.random.default_rng(k))
    v, i, passes = select_model(x, k)
    assert_same((v, i), ref_topk(x, k))
    pv, pi = topk.plain(torch.from_numpy(x[None].copy()), k)
    assert_same((v, i), (pv.numpy()[0], pi.numpy()[0]))
    if k <= 128:
        jv, ji = jax_topk(jnp.asarray(x), k, interpret=True, force=True)
        assert_same((v, i), (np.asarray(jv), np.asarray(ji)))
    assert passes == 6 if k > 31 else passes <= 4


def test_select_model_stops_within_the_value_word():
    """Distinct values: the k-th value is unique, so at most 4 passes."""
    rng = np.random.default_rng(3)
    x = rng.permutation(np.arange(3968, dtype=np.float32) - 2000.5)
    for k in (1, 10, 128, 256):
        assert select_model(x, k)[2] <= 4
    assert select_model(x, 3968)[2] == 1  # k = n: the whole row at once


@pytest.mark.parametrize("k,how", [(1, "select"), (128, "select"),
                                   (256, "select"), (257, "bitonic"),
                                   (3968, "bitonic")])
def test_topk_route(k, how):
    assert topk.route(k) == how


@pytest.mark.parametrize("n,shape", [
    (1, (32, 1)), (7, (32, 1)), (310, (320, 1)), (1024, (1024, 1)),
    (1025, (544, 2)), (3968, (992, 4)), (8193, (544, 16)),
    (16384, (1024, 16))])
def test_select_shape(n, shape):
    """The fewest keys a thread that keep 1,024 threads a block at most."""
    threads, kpt = topk.select_shape(n)
    assert (threads, kpt) == shape
    assert threads % 32 == 0 and threads <= 1024 and threads * kpt >= n
    assert kpt <= topk.SELECT_MAX_KPT
