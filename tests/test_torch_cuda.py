"""PyTorch port: the CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and nvcc; elsewhere they skip. They cover the
edge shapes chip_smoke.py does not: 8 kHz framing, ``center=False``, one
direction, one row, hidden sizes that do not fill a block, a batch of 70
rows (the step kernels' shared memory does not grow with B), CTC rows with
no labels or an impossible alignment, and odd T. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: the STFT as tests/test_pallas_stft.py (1e-4); the GRU layer
and its residuals 1e-4 in f32 (sums in another order) and 5e-3 in bf16 (a
state on a bf16 rounding boundary may round the other way); the GRU
backward's dg, dnh 1e-4 in f32 and 2e-2 relative to the largest in bf16
(a one-ulp flip of a bf16 operand moves the carried dh), its bias grads
1e-3 relative in f32 and 2e-2 in bf16 (sums over T x B in other orders);
CTC alphas, the debug betas, loss and dlogits 1e-4 (at S > 1024, T 1,500,
one row, 64 rows and with a NaN row too, on both routes; at S 4,501 and
9,001 on the global route and at S 4,401 on the ring); small-model logits
2e-2. The LSTM kernels (K3, K7) hold the GRU's tolerances, the cell
stream c relative to its largest value, since |c| is not bounded by 1.
The bf16 backwards (K5, K7 on tensor cores) are held in each variant at
the widths of both models, and beyond one batch chunk.
The top-k (K10) and the device beam search through it are exact: bit for
bit against the plain top-k, on rows of ties, signed zeros, infinities and
NaNs of both signs. The device masks and the noise mix on the card equal
the same functions on the CPU from the same draws. Multi-GPU training:
K2's and K5's D=1 training variants (what each rank of ``--mesh-model
2`` runs) at the default model's and config 4's widths, at the GRU
tolerances; a data-2 step of two gloo ranks sharing cuda:0 (this file run
as a script, ``--dp-rank``) against the single-process step, each kernel
launch of both held to its plain version and the conv front's clamps
compared. CUDA graphs (``--steps-per-dispatch``): every bf16 variant of
K2-K7 (the W-resident and K5/K7 cluster launches, the cooperative
persistent launches, one launch a step), the f32 layers, K8/K9 on both
routes, K1 and K10, each captured after an eager warm-up and replayed on
new inputs bit-equal to eager calls; a pageable copy under capture raises;
``StepGraphs`` replays draw what eager steps draw and count their
launches, and a capture that fails raises; a cache of one graph evicts
and captures again; the k-step multi-step of a small GRU and LSTM model,
f32 and bf16, against as many eager steps, and with the LR set between
groups and the device noise bank read in place, bit-equal to them. The
conv front's kernels (bf16 operands, f32 sums) against f64 products of
the same operands at both convs' shapes and the train cells' batches: the
forward to f32 reassociation, dgrad and wgrad within the bf16 rounding
they get (dy as hi + lo); equal bits on two runs and under a CUDA graph;
the bf16 front against its CPU twin; the f32 front on cuDNN with TF32
off.
"""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("sr", [16000, 8000])
def test_stft_kernel_matches_plain(dev, sr, center):
    from deepspeech_tpu_torch.audio.features import AudioConf, make_window
    from deepspeech_tpu_torch.ops.cuda import stft

    conf = AudioConf(sample_rate=sr)
    rng = np.random.default_rng(sr)
    y = torch.from_numpy(rng.standard_normal((3, int(0.37 * sr))).astype(
        np.float32)).to(dev)
    win = make_window("hamming", conf.n_fft)
    before = stft.launches
    got = stft.stft_mag(y, conf.n_fft, conf.hop, win, center=center)
    assert stft.launches == before + 1
    ref = stft.plain(y, conf.n_fft, conf.hop, win, center=center)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


# n_fft 160-512 take the FFT route, 448 = 2^6 7 the DFT route; (320, 160,
# 170) is one short utterance whose every frame reads a reflected edge
@pytest.mark.parametrize("n_fft,hop,b,s", [
    (160, 80, 3, 5921), (320, 160, 3, 5921), (400, 160, 3, 5921),
    (512, 128, 2, 4000), (448, 112, 2, 4000), (320, 160, 1, 170)])
def test_stft_routes_match_plain(dev, n_fft, hop, b, s):
    """Each route against its plain version on the card and against a
    float64 numpy FFT of the same frames."""
    from deepspeech_tpu_torch.audio.features import make_window
    from deepspeech_tpu_torch.ops.cuda import stft

    rng = np.random.default_rng(n_fft + s)
    y = rng.uniform(-1, 1, (b, s)).astype(np.float32)
    win = make_window("hamming", n_fft)
    y_dev = torch.from_numpy(y).to(dev)
    before = stft.launches
    got = stft.stft_mag(y_dev, n_fft, hop, win)
    torch.cuda.synchronize()
    assert stft.launches == before + 1
    assert stft.route(n_fft) == ("dft" if n_fft == 448 else "fft")
    ref = stft.plain(y_dev, n_fft, hop, win)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    pad = n_fft // 2
    yp = np.pad(y.astype(np.float64), ((0, 0), (pad, pad)), mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(yp, n_fft, 1)[:, ::hop]
    f64 = np.abs(np.fft.rfft(frames * win, axis=-1)).transpose(0, 2, 1)
    np.testing.assert_allclose(got.cpu().numpy(), f64, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("t,b,f,h", [(7, 1, 40, 32), (29, 3, 96, 50),
                                     (64, 20, 1312, 800), (9, 70, 64, 800)])
def test_gru_kernel_matches_plain(dev, dtype, tol, ndir, t, b, f, h):
    from deepspeech_tpu_torch.ops.cuda import gru

    rng = np.random.default_rng(t + b)
    s = 1.0 / np.sqrt(h)

    def u(*shape, lo=-s, hi=s):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32)).to(dev)

    x, w_ih, w_hh = u(t, b, f, lo=0, hi=1), u(ndir, f, 3 * h), \
        u(ndir, h, 3 * h)
    b_ih, b_hh = u(ndir, 3 * h), u(ndir, 3 * h)
    lens = torch.from_numpy(np.linspace(t, max(1, t // 3), b).astype(
        np.int64)).to(dev)
    args = (x.to(dtype), w_ih.to(dtype), b_ih, w_hh.to(dtype), b_hh, lens)
    before = gru.launches
    got = gru.gru_layer(*args)
    assert gru.launches == before + 1
    ref = gru.plain(*args)
    torch.testing.assert_close(got, ref, rtol=0, atol=tol)
    pad = torch.arange(t, device=dev)[:, None] >= lens[None, :]
    assert not got[:, pad].any()


@pytest.mark.parametrize("bidirectional", [True, False])
def test_small_model_forward_kernel_matches_plain(dev, bidirectional):
    from deepspeech_tpu_torch.audio.features import AudioConf, featurize_batch
    from deepspeech_tpu_torch.models import build_model

    model, _ = build_model("gru", 30, 64, 3, bidirectional=bidirectional,
                           compute_dtype="bfloat16", device=dev)
    model.eval()
    rng = np.random.default_rng(1)
    audio = torch.from_numpy(rng.uniform(-1, 1, (2, 16000)).astype(
        np.float32))
    audio[1, 9000:] = 0
    lens = torch.tensor([16000, 9000])
    with torch.inference_mode():
        spect, frames = featurize_batch(audio.to(dev), lens.to(dev),
                                        AudioConf())
        got = model(spect, frames)
        model.cpu()
        ref = model(*featurize_batch(audio, lens, AudioConf()))
    torch.testing.assert_close(got[2].cpu(), ref[2])
    scale = max(1.0, ref[0].abs().max().item())
    for i, n in enumerate(ref[2].tolist()):
        torch.testing.assert_close(got[0][i, :n].cpu(), ref[0][i, :n],
                                   rtol=0, atol=2e-2 * scale)


def _gru_case(dev, dtype, ndir, t, b, f, h, seed):
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(h)

    def u(*shape, lo=-s, hi=s):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32)).to(dev)

    x, w_ih, w_hh = u(t, b, f, lo=0, hi=1), u(ndir, f, 3 * h), \
        u(ndir, h, 3 * h)
    b_ih, b_hh = u(ndir, 3 * h), u(ndir, 3 * h)
    lens = torch.from_numpy(np.linspace(t, max(1, t // 3), b).astype(
        np.int64)).to(dev)
    return (x.to(dtype), w_ih.to(dtype), b_ih, w_hh.to(dtype), b_hh, lens)


GRU_SHAPES = [(7, 1, 40, 32), (29, 3, 96, 50), (33, 70, 64, 800),
              (64, 20, 1312, 800)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("t,b,f,h", GRU_SHAPES)
def test_gru_residual_kernel_matches_plain(dev, dtype, tol, ndir, t, b, f,
                                           h):
    from deepspeech_tpu_torch.ops.cuda import gru

    args = _gru_case(dev, dtype, ndir, t, b, f, h, t + b + 1)
    before = (gru.launches, gru.res_launches)
    out, g, hn = gru.gru_layer(*args, residuals=True)
    assert (gru.launches, gru.res_launches) == (before[0] + 1, before[1] + 1)
    ref = gru.plain(*args, residuals=True)
    assert g.dtype == hn.dtype == dtype
    for got, want in zip((out, g, hn), ref):
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("t,b,f,h", GRU_SHAPES)
def test_gru_bwd_kernel_matches_plain(dev, dtype, ndir, t, b, f, h):
    from deepspeech_tpu_torch.ops.cuda import gru

    x, w_ih, b_ih, w_hh, b_hh, lens = _gru_case(dev, dtype, ndir, t, b, f, h,
                                                t + b + 2)
    out, g, hn = gru.plain(x, w_ih, b_ih, w_hh, b_hh, lens, residuals=True)
    rng = np.random.default_rng(t)
    dout = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32)).to(dev)
    before = gru.bwd_launches
    got = gru.gru_bwd(dout, g, hn, out, w_hh, lens)
    assert gru.bwd_launches == before + 1
    want = gru.plain_bwd(dout, g, hn, out, w_hh, lens)
    f32 = dtype == torch.float32
    for name, a, w in zip(("dg", "dnh", "dbi", "dbh"), got, want):
        scale = max(1.0, w.abs().max().item())
        tol = (1e-4 if name in ("dg", "dnh") else 1e-3) if f32 else 2e-2
        err = (a.float() - w.float()).abs().max().item()
        assert err <= tol * scale, (name, err, scale)
    pad = torch.arange(t, device=dev)[:, None] >= lens[None, :]
    assert not got[0][:, pad].any() and not got[1][:, pad].any()


def _hold_ctc(dev, logits, ll, targets, tl, how=None):
    """K8 and K9, one launch each (on the route ``how``, by default the
    rule's), against plain_alpha / plain_beta on the same inputs: alphas,
    loss, the debug betas and dlogits, non-finite entries in the same
    places. -> the kernels' loss and dlogits."""
    from deepspeech_tpu_torch.ops import ctc as ctc_loss_mod
    from deepspeech_tpu_torch.ops.cuda import ctc

    lp, ext = ctc_loss_mod._prep(logits, targets, 0)
    g = torch.linspace(0.5, 1.5, len(ll), device=dev)
    before = (ctc.alpha_launches, ctc.beta_launches)
    alphas, loss = ctc._alpha(lp, ext, tl, ll, how)
    dl, betas = ctc._beta(lp, ext, tl, ll, alphas, loss, g, True, how)
    assert (ctc.alpha_launches, ctc.beta_launches) == (before[0] + 1,
                                                       before[1] + 1)
    ref_a, ref_l = ctc.plain_alpha(lp, ext, tl, ll)
    ref_d, ref_b = ctc.plain_beta(lp, ext, tl, ll, ref_a, ref_l, g,
                                  with_betas=True)
    for got, ref in ((alphas, ref_a), (loss, ref_l), (betas, ref_b),
                     (dl, ref_d)):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4,
                                   equal_nan=True)
    bad = ~torch.isfinite(loss)
    assert not dl[bad].any()
    return loss, dl


@pytest.mark.parametrize("t", [1, 17, 101])
def test_ctc_kernels_match_plain(dev, t):
    from deepspeech_tpu_torch.ops import ctc as ctc_loss_mod

    rng = np.random.default_rng(t)
    b, c, lmax = 6, 30, max(2, t // 3)
    logits = torch.from_numpy(rng.standard_normal((b, t, c)).astype(
        np.float32)).to(dev)
    ll = torch.from_numpy(rng.integers(1, t + 1, b)).to(dev)
    ll[0] = t
    targets = torch.from_numpy(rng.integers(1, c, (b, lmax))).to(dev)
    tl = torch.from_numpy(rng.integers(0, lmax + 1, b)).to(dev)
    tl[1] = 0               # no labels
    tl[2], ll[2] = lmax, 1  # impossible: two or more labels in one frame
    _hold_ctc(dev, logits, ll, targets, tl)

    lg = logits.clone().requires_grad_(True)
    per = ctc_loss_mod.ctc_loss(lg, ll, targets, tl)
    torch.where(torch.isfinite(per), per, 0.0).sum().backward()
    lg_cpu = logits.cpu().requires_grad_(True)
    per_cpu = ctc_loss_mod.ctc_loss(lg_cpu, ll.cpu(), targets.cpu(), tl.cpu())
    torch.where(torch.isfinite(per_cpu), per_cpu, 0.0).sum().backward()
    assert not torch.isfinite(per[2]) and torch.isfinite(per[1])
    assert torch.equal(lg.grad[2], torch.zeros_like(lg.grad[2]))
    torch.testing.assert_close(per.cpu(), per_cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lg.grad.cpu(), lg_cpu.grad, rtol=1e-4,
                               atol=1e-4)


# (B, T, L): S > 1024 (several states a thread), T 1,500 (many staging
# chunks), T not a multiple of K8's or K9's chunk, one row, 64 rows; and a
# row with a NaN logit
@pytest.mark.parametrize("how", ["ring", "global"])
@pytest.mark.parametrize("b,t,lmax,nan", [(2, 1100, 520, False),
                                          (3, 1500, 200, False),
                                          (4, 77, 20, False),
                                          (1, 61, 15, False),
                                          (64, 90, 25, False),
                                          (5, 50, 12, True)])
def test_ctc_kernels_edge_shapes(dev, b, t, lmax, nan, how):
    rng = np.random.default_rng(b * t)
    c = 30
    logits = torch.from_numpy(rng.standard_normal((b, t, c)).astype(
        np.float32)).to(dev)
    ll = torch.from_numpy(rng.integers(max(1, 2 * lmax + 2), t + 1,
                                       b)).to(dev).clamp(max=t)
    ll[0] = t
    targets = torch.from_numpy(rng.integers(1, c, (b, lmax))).to(dev)
    tl = torch.from_numpy(rng.integers(0, lmax + 1, b)).to(dev)
    tl[0] = lmax
    if nan:
        logits[1, t // 2, 4] = float("nan")
    loss, dl = _hold_ctc(dev, logits, ll, targets, tl, how)
    assert torch.isfinite(loss[0])
    if nan:
        assert torch.isnan(loss[1]) and not dl[1].any()


# Long label sequences: L 2,250 (S 4,501) and 4,500 (S 9,001), past the
# ring route of K9; K8 held on its global route there too. And S 4,401,
# where the rule still takes the ring for both.
@pytest.mark.parametrize("lmax,how", [(2250, None), (2250, "global"),
                                      (4500, None), (2200, None)])
def test_ctc_long_labels(dev, lmax, how):
    from deepspeech_tpu_torch.ops import ctc as ctc_loss_mod
    from deepspeech_tpu_torch.ops.cuda import ctc

    s, c = 2 * lmax + 1, 30
    assert ctc.route(s, c, True) == ("ring" if s <= 4401 else "global")
    t = lmax + lmax // 10 + 40  # room for the repeats' blanks
    rng = np.random.default_rng(lmax)
    logits = torch.from_numpy(rng.standard_normal((2, t, c)).astype(
        np.float32)).to(dev)
    ll = torch.tensor([t, t - 13], device=dev)
    targets = torch.from_numpy(rng.integers(1, c, (2, lmax))).to(dev)
    tl = torch.tensor([lmax, lmax - 7], device=dev)
    loss, dl = _hold_ctc(dev, logits, ll, targets, tl, how)
    assert torch.isfinite(loss).all()
    lg = logits.clone().requires_grad_(True)
    per = ctc_loss_mod.ctc_loss(lg, ll, targets, tl)
    per.sum().backward()
    torch.testing.assert_close(per, loss, rtol=0, atol=0)
    torch.testing.assert_close(lg.grad, dl / torch.linspace(
        0.5, 1.5, 2, device=dev)[:, None, None], rtol=1e-4, atol=1e-4)


def _lstm_case(dev, dtype, ndir, t, b, f, h, seed):
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(h)

    def u(*shape, lo=-s, hi=s):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32)).to(dev)

    x, w_ih, w_hh = u(t, b, f, lo=0, hi=1), u(ndir, f, 4 * h), \
        u(ndir, h, 4 * h)
    b_ih, b_hh = u(ndir, 4 * h), u(ndir, 4 * h)
    lens = torch.from_numpy(np.linspace(t, max(1, t // 3), b).astype(
        np.int64)).to(dev)
    return (x.to(dtype), w_ih.to(dtype), b_ih, w_hh.to(dtype), b_hh, lens)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("t,b,f,h", GRU_SHAPES)
def test_lstm_kernel_matches_plain(dev, dtype, tol, ndir, t, b, f, h):
    """K3, both variants, with the LSTM's tolerances: as the GRU's (|h| and
    the gates <= 1; |c| grows, so c is held relative to its largest)."""
    from deepspeech_tpu_torch.ops.cuda import lstm

    args = _lstm_case(dev, dtype, ndir, t, b, f, h, t + b + 3)
    before = (lstm.launches, lstm.res_launches)
    got = lstm.lstm_layer(*args)
    out, c, g = lstm.lstm_layer(*args, residuals=True)
    assert (lstm.launches, lstm.res_launches) == (before[0] + 2,
                                                  before[1] + 1)
    ref, ref_c, ref_g = lstm.plain(*args, residuals=True)
    assert c.dtype == torch.float32 and g.dtype == dtype
    for a, w in ((got, ref), (out, ref), (g, ref_g)):
        torch.testing.assert_close(a.float(), w.float(), rtol=0, atol=tol)
    scale = max(1.0, ref_c.abs().max().item())
    torch.testing.assert_close(c, ref_c, rtol=0, atol=tol * scale)
    pad = torch.arange(t, device=dev)[:, None] >= args[-1][None, :]
    for a in (got, c, g):
        assert not a[:, pad].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("t,b,f,h", GRU_SHAPES)
def test_lstm_bwd_kernel_matches_plain(dev, dtype, ndir, t, b, f, h):
    """K7 against plain_bwd, with the GRU backward's tolerances."""
    from deepspeech_tpu_torch.ops.cuda import lstm

    x, w_ih, b_ih, w_hh, b_hh, lens = _lstm_case(dev, dtype, ndir, t, b, f,
                                                 h, t + b + 4)
    out, c, g = lstm.plain(x, w_ih, b_ih, w_hh, b_hh, lens, residuals=True)
    rng = np.random.default_rng(t)
    dout = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32)).to(dev)
    before = lstm.bwd_launches
    got = lstm.lstm_bwd(dout, g, c, w_hh, lens)
    assert lstm.bwd_launches == before + 1
    want = lstm.plain_bwd(dout, g, c, w_hh, lens)
    f32 = dtype == torch.float32
    for name, a, w in zip(("dg", "db"), got, want):
        scale = max(1.0, w.abs().max().item())
        tol = (1e-4 if name == "dg" else 1e-3) if f32 else 2e-2
        err = (a.float() - w.float()).abs().max().item()
        assert err <= tol * scale, (name, err, scale)
    pad = torch.arange(t, device=dev)[:, None] >= lens[None, :]
    assert not got[0][:, pad].any()


# The bf16 K5 and K7 (csrc/rnn_mma_bwd.cuh) at (T, B, H): a ragged block of
# units and K chunk (B 13, H 200), the default width (B 20, H 800), the wide
# models' (B 64, H 1600), and a batch beyond one chunk (B 130), which the
# step variant loops over and the persistent variant refuses
BWD_SHAPES = [(9, 13, 200), (7, 20, 800), (5, 64, 1600), (5, 130, 1600)]


@pytest.mark.parametrize("variant", ["step", "persistent"])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("t,b,h", BWD_SHAPES)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_bf16_bwd_variants_match_plain(dev, cell, t, b, h, ndir, variant):
    """K5 and K7 in bf16, each variant, against plain_bwd with
    GRU_BWD_TOL (2e-2 x max(1, max|ref|)), ragged lengths with a length-1
    row; one launch counted a call; zeros past every length."""
    from deepspeech_tpu_torch.ops.cuda import gru, lstm

    mod = gru if cell == "gru" else lstm
    case = _gru_case if cell == "gru" else _lstm_case
    x, w_ih, b_ih, w_hh, b_hh, lens = case(dev, torch.bfloat16, ndir, t, b,
                                           64, h, t + b + 6)
    lens[-1] = 1
    out, r1, r2 = mod.plain(x, w_ih, b_ih, w_hh, b_hh, lens, residuals=True)
    dout = torch.from_numpy(np.random.default_rng(b).standard_normal(
        out.shape).astype(np.float32)).to(dev)
    args = ((dout, r1, r2, out, w_hh, lens) if cell == "gru"
            else (dout, r2, r1, w_hh, lens))
    bwd = gru.gru_bwd if cell == "gru" else lstm.lstm_bwd
    if variant == "persistent" and b > 64:
        with pytest.raises(RuntimeError, match="bwd kernel"):
            bwd(*args, variant=variant)
        return
    before = mod.bwd_launches
    got = bwd(*args, variant=variant)
    assert mod.bwd_launches == before + 1
    want = mod.plain_bwd(*args)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        scale = max(1.0, w.float().abs().max().item())
        err = (a.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * scale, (err, scale)
    pad = torch.arange(t, device=dev)[:, None] >= lens[None, :]
    assert not got[0][:, pad].any()
    if cell == "gru":
        assert not got[1][:, pad].any()


@pytest.mark.parametrize("cell", ["lstm", "rnn"])
def test_small_lstm_and_rnn_models_match_plain(dev, cell):
    """A 3 x BiLSTM-64 (K3) or vanilla-RNN DS2 in bf16 on the card against
    the same model on the CPU, at the small GRU model's tolerance."""
    from deepspeech_tpu_torch.audio.features import AudioConf, featurize_batch
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.ops.cuda import lstm

    model, _ = build_model(cell, 30, 64, 3, compute_dtype="bfloat16",
                           device=dev)
    model.eval()
    rng = np.random.default_rng(2)
    audio = torch.from_numpy(rng.uniform(-1, 1, (2, 16000)).astype(
        np.float32))
    audio[1, 9000:] = 0
    lens = torch.tensor([16000, 9000])
    before = lstm.launches
    with torch.inference_mode():
        spect, frames = featurize_batch(audio.to(dev), lens.to(dev),
                                        AudioConf())
        got = model(spect, frames)
        assert lstm.launches == before + (3 if cell == "lstm" else 0)
        model.cpu()
        ref = model(*featurize_batch(audio, lens, AudioConf()))
    torch.testing.assert_close(got[2].cpu(), ref[2])
    scale = max(1.0, ref[0].abs().max().item())
    for i, n in enumerate(ref[2].tolist()):
        torch.testing.assert_close(got[0][i, :n].cpu(), ref[0][i, :n],
                                   rtol=0, atol=2e-2 * scale)


def _topk_rows(rng, r, n):
    """Rows with exact ties, signed zeros, infinities and NaNs of both
    signs (payloads set), beside plain normal rows."""
    x = rng.standard_normal((r, n)).astype(np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, 1.5], np.float32)
    nans = np.array([0x7FC00011, 0xFFC00022], np.uint32).view(np.float32)
    for row in range(1, r, 2):
        pick = rng.integers(0, n, n // 3)
        x[row, pick] = rng.choice(np.concatenate([specials, nans]),
                                  len(pick))
    if r > 2:
        x[2] = np.float32(-0.0)  # a row of one value
    return x


@pytest.mark.parametrize("r,n,k", [(20, 310, 10), (20, 3968, 128),
                                   (1, 2, 1), (3, 5, 5), (7, 1000, 1000),
                                   (2, 16384, 300)])
def test_topk_kernel_matches_plain(dev, r, n, k):
    """K10 bit for bit (values as int32 bits, and indices) against its
    plain version, one launch per call."""
    from deepspeech_tpu_torch.ops.cuda import topk

    x = torch.from_numpy(_topk_rows(np.random.default_rng(n + k), r, n))
    before = topk.launches
    v, i = topk.topk_total_order(x.to(dev), k)
    torch.cuda.synchronize()
    assert topk.launches == before + 1
    rv, ri = topk.plain(x, k)
    assert torch.equal(v.cpu().view(torch.int32), rv.view(torch.int32))
    assert torch.equal(i.cpu(), ri)


def _flood_rows(rng, r, n, finite=31):
    """The width-128 beam's early steps: ~31 finite candidates a row, the
    rest -inf."""
    x = np.full((r, n), -np.inf, np.float32)
    for row in range(r):
        x[row, rng.choice(n, finite, replace=False)] = (
            rng.standard_normal(finite) * 8 - 40)
    return x


# the selection route up to k 256 (the -inf flood, k = n, 16 keys a
# thread), the bitonic route from 257
@pytest.mark.parametrize("r,n,k,flood", [
    (20, 3968, 128, True), (20, 3968, 256, True), (20, 3968, 257, True),
    (20, 3968, 256, False), (20, 3968, 257, False), (5, 300, 300, False),
    (4, 256, 256, False), (3, 16384, 256, False), (2, 8193, 100, False)])
def test_topk_routes_match_plain(dev, r, n, k, flood):
    from deepspeech_tpu_torch.ops.cuda import topk

    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(_flood_rows(rng, r, n) if flood
                         else _topk_rows(rng, r, n))
    before = topk.launches
    v, i = topk.topk_total_order(x.to(dev), k)
    torch.cuda.synchronize()
    assert topk.launches == before + 1
    assert topk.route(k) == ("select" if k <= 256 else "bitonic")
    rv, ri = topk.plain(x, k)
    assert torch.equal(v.cpu().view(torch.int32), rv.view(torch.int32))
    assert torch.equal(i.cpu(), ri)


def test_topk_kernel_refuses_oversize_rows(dev):
    """Each route refuses rows longer than it holds: the selection 16,384
    keys in registers, the bitonic sort 16,384 padded keys in shared
    memory."""
    from deepspeech_tpu_torch.ops.cuda import topk

    with pytest.raises(ValueError, match="registers"):
        topk.topk_total_order(torch.zeros(1, 16385, device=dev), 4)
    with pytest.raises(ValueError, match="shared memory"):
        topk.topk_total_order(torch.zeros(1, 16385, device=dev), 300)


@pytest.mark.parametrize("lm", [False, True])
def test_device_beam_through_k10_matches_plain(dev, lm, tmp_path):
    """The device beam search on the card through K10 equals the same
    search with the plain top-k swapped in, bit for bit, with one K10
    launch a time step."""
    from deepspeech_tpu_torch.decoders import beam_device, lm_device
    from deepspeech_tpu_torch.ops.cuda import topk

    labels = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 "
    rng = np.random.default_rng(4)
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((3, 57, 30)).astype(np.float32) * 3), -1).to(dev)
    lengths = torch.tensor([57, 40, 9], device=dev)
    kw = dict(beam_width=12, top_paths=3)
    if lm:
        arpa = tmp_path / "lm.arpa"
        arpa.write_text("\\data\\\nngram 1=4\nngram 2=1\n\n\\1-grams:\n"
                        "-0.5\t<s>\t-0.1\n-0.6\tHI\t-0.2\n-0.7\tME\t0\n"
                        "-2.0\t<unk>\t0\n\n\\2-grams:\n-0.2\tHI ME\n\n"
                        "\\end\\\n")
        kw.update(lm=lm_device.load_device_lm(str(arpa), labels, dev),
                  space=labels.index(" "), alpha=1.2, beta=0.5)
    before = topk.launches
    got = beam_device.ctc_beam_search_device(lp, lengths, **kw)
    assert topk.launches == before + 57
    kernel = topk.topk_total_order
    topk.topk_total_order = topk.plain
    try:
        ref = beam_device.ctc_beam_search_device(lp, lengths, **kw)
    finally:
        topk.topk_total_order = kernel
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# (5, 13, 200): a ragged last block of units and K chunk; (9, 130, 1600):
# a batch above one chunk of 64 rows, which the bf16 kernel loops over
SCAN_SHAPES = [(7, 1, 32), (29, 3, 50), (33, 70, 800), (17, 64, 1600),
               (5, 13, 200), (9, 130, 1600)]


def _scan_case(dev, dtype, ndir, t, b, h, gates, seed):
    """xp rounded to the operand type, as the wide route's projection."""
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(h)

    def u(*shape, lo=-s, hi=s):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32)).to(dev)

    xp = u(ndir, t, b, gates * h, lo=-1, hi=1)
    w_hh, b_ih, b_hh = u(ndir, h, gates * h), u(ndir, gates * h), \
        u(ndir, gates * h)
    lens = torch.from_numpy(np.linspace(t, max(1, t // 3), b).astype(
        np.int64)).to(dev)
    return xp.to(dtype), b_ih, w_hh.to(dtype), b_hh, lens


@pytest.mark.parametrize("variant", ["step", "persistent", "auto"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("t,b,h", SCAN_SHAPES)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scan_kernel_matches_plain(dev, cell, dtype, tol, ndir, t, b, h,
                                   variant):
    """K4 and K6, inference and training, in each variant (the LSTM's f32
    has one), against plain_scan with the tolerances of K2 and K3 (the
    LSTM's c relative to its largest value). A persistent launch of a batch
    above one chunk raises: it never falls back. K4's f32 persistent
    variant counts one launch a call, and "auto" takes it from 9 to 64 rows
    at H 1600 (recurrence.scan_f32_variant)."""
    from deepspeech_tpu_torch.ops.cuda import gru, lstm

    mod = gru if cell == "gru" else lstm
    scan = gru.gru_scan if cell == "gru" else lstm.lstm_scan
    args = _scan_case(dev, dtype, ndir, t, b, h, 3 if cell == "gru" else 4,
                      t + b + 5)
    f32_gru = dtype == torch.float32 and cell == "gru"
    if (variant == "persistent" and b > 64
            and (dtype == torch.bfloat16 or f32_gru)):
        with pytest.raises(RuntimeError, match="scan kernel"):
            scan(*args, variant=variant)
        return
    before = (mod.scan_launches, mod.scan_res_launches, mod.launches,
              gru.scan_f32_persistent_launches)
    got = scan(*args, variant=variant)
    res = scan(*args, residuals=True, variant=variant)
    persistent = f32_gru and (variant == "persistent"
                              or (variant == "auto" and 8 < b <= 64
                                  and h >= 1200))
    assert (mod.scan_launches, mod.scan_res_launches, mod.launches,
            gru.scan_f32_persistent_launches) == (
        before[0] + 2, before[1] + 1, before[2], before[3] + 2 * persistent)
    ref = mod.plain_scan(*args, residuals=True)
    torch.testing.assert_close(got, ref[0], rtol=0, atol=tol)
    for name, a, w in zip(("h", "r1", "r2"), res, ref):
        assert a.dtype == w.dtype, name
        scale = (max(1.0, w.abs().max().item())
                 if a.dtype == torch.float32 and name == "r1" else 1.0)
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                   atol=tol * scale)
    pad = torch.arange(t, device=dev)[:, None] >= args[-1][None, :]
    for a in (got, *res):
        assert not a[:, pad].any()


@pytest.mark.parametrize("variant", ["persistent", "auto"])
@pytest.mark.parametrize("ndir", [1, 2])
def test_scan_f32_persistent_at_the_eval_shape(dev, ndir, variant):
    """K4's f32 persistent variant at the eval cell's layer shape (B 64,
    H 1600, T 406; ragged lengths from a length-1 row to a full one),
    inference and with residuals, against plain_scan at 1e-4, one launch
    a call; zero past each row's length."""
    from deepspeech_tpu_torch.ops.cuda import gru

    t, b, h = 406, 64, 1600
    xp, b_ih, w_hh, b_hh, _ = _scan_case(dev, torch.float32, ndir, t, b, h,
                                         3, 61)
    lens = torch.from_numpy(np.linspace(t, 1, b).astype(np.int64)).to(dev)
    assert int(lens.min()) == 1 and int(lens.max()) == t
    args = (xp, b_ih, w_hh, b_hh, lens)
    before = gru.scan_f32_persistent_launches
    got = gru.gru_scan(*args, variant=variant)
    res = gru.gru_scan(*args, residuals=True, variant=variant)
    assert gru.scan_f32_persistent_launches == before + 2
    ref = gru.plain_scan(*args, residuals=True)
    torch.testing.assert_close(got, ref[0], rtol=0, atol=1e-4)
    for name, a, w in zip(("h", "g", "hn"), res, ref):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-4, msg=name)
    pad = torch.arange(t, device=dev)[:, None] >= lens[None, :]
    for a in (got, *res):
        assert not a[:, pad].any()


@pytest.mark.parametrize("variant", ["step", "persistent"])
def test_scan_f32_without_steps(dev, variant):
    """K4 in f32 at T 0, each variant: empty outputs, and the card still
    sound after the call (the persistent kernel's copy of its resident
    W_hh chunks is waited for only inside the step loop, so T 0 launches
    nothing)."""
    from deepspeech_tpu_torch.ops.cuda import gru

    xp, b_ih, w_hh, b_hh, _ = _scan_case(dev, torch.float32, 2, 0, 16, 96,
                                         3, 7)
    lens = torch.zeros(16, dtype=torch.int64, device=dev)
    out, g, hn = gru.gru_scan(xp, b_ih, w_hh, b_hh, lens, residuals=True,
                              variant=variant)
    torch.cuda.synchronize()
    assert (out.shape, g.shape, hn.shape) == (
        (2, 0, 16, 96), (2, 0, 16, 288), (2, 0, 16, 96))


@pytest.mark.parametrize("t,b,h", [(41, 20, 96), (5, 13, 200),
                                   (9, 130, 1600)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scan_layer_grads_match_plain(dev, cell, dtype, t, b, h):
    """GRUScanLayer / LSTMScanLayer (K4 or K6 forward, K5 or K7 backward)
    against the same Function on the plain twins: the grads of xp, b_ih,
    W_hh and b_hh at the backward kernels' tolerances x max(1, max|ref|)."""
    from deepspeech_tpu_torch.ops.cuda import gru, lstm

    mod = gru if cell == "gru" else lstm
    fn = gru.GRUScanLayer if cell == "gru" else lstm.LSTMScanLayer
    names = ("gru_scan", "gru_bwd") if cell == "gru" else ("lstm_scan",
                                                           "lstm_bwd")
    xp, b_ih, w_hh, b_hh, lens = _scan_case(dev, dtype, 2, t, b, h,
                                            3 if cell == "gru" else 4, 7)
    dout = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, t, b, h)).astype(np.float32)).to(dev)

    def grads():
        ins = [a.clone().requires_grad_(True)
               for a in (xp, b_ih, w_hh.float(), b_hh)]
        out = fn.apply(*ins, lens)
        return torch.autograd.grad(out, ins, dout)

    got = grads()
    saved = [getattr(mod, n) for n in names]
    setattr(mod, names[0], mod.plain_scan)
    setattr(mod, names[1], mod.plain_bwd)
    try:
        want = grads()
    finally:
        for n, f in zip(names, saved):
            setattr(mod, n, f)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, w in zip(("xp", "b_ih", "w_hh", "b_hh"), got, want):
        assert a.dtype == w.dtype, name
        scale = max(1.0, w.float().abs().max().item())
        err = (a.float() - w.float()).abs().max().item()
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_wide_route_on_the_card(dev, cell, monkeypatch):
    """rnn_scan on the wide route (DEEPSPEECH_TPU_NO_FUSED) launches K4 or
    K6 and no fused kernel, and matches the same layer on the CPU."""
    from deepspeech_tpu_torch.ops.cuda import gru, lstm
    from deepspeech_tpu_torch.ops.rnn import rnn_scan

    monkeypatch.setenv("DEEPSPEECH_TPU_NO_FUSED", "1")
    mod = gru if cell == "gru" else lstm
    g = 3 if cell == "gru" else 4
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((23, 5, 40)).astype(np.float32))
    lens = torch.tensor([23, 20, 11, 5, 1])
    w = [torch.from_numpy(rng.uniform(-0.2, 0.2, s).astype(np.float32))
         for s in ((2, 40, g * 64), (2, g * 64), (2, 64, g * 64),
                   (2, g * 64))]
    before = (mod.scan_launches, mod.launches)
    got = rnn_scan(x.to(dev), lens.to(dev), *(a.to(dev) for a in w),
                   cell=cell, compute_dtype=torch.bfloat16)
    assert (mod.scan_launches, mod.launches) == (before[0] + 1, before[1])
    ref = rnn_scan(x, lens, *w, cell=cell, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-2)


# K2 and K3 in bf16 (csrc/proj_mma.cuh, csrc/rnn_mma.cuh), each variant, at
# (T, B, F, H): a ragged H and F (the projection's element-wise edge, F not
# a multiple of 8), B not a multiple of 8 with H 50 (3H and 4H not
# multiples of 8 either), a batch above one chunk (70 rows: the persistent
# variants refuse it) and H 1600 at B 64 (the resident slices do not fit a
# block's shared memory: that variant refuses it)
FWD_SHAPES = [(7, 5, 50, 40), (9, 13, 96, 50), (5, 70, 64, 800),
              (4, 64, 1312, 1600)]


@pytest.mark.parametrize("variant", ["step", "persistent", "resident"])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("t,b,f,h", FWD_SHAPES)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_bf16_fwd_variants_match_plain(dev, cell, t, b, f, h, ndir,
                                       variant):
    """K2 and K3 in bf16, inference and training, each variant, against
    plain with the fused forwards' tolerance 5e-3 (the LSTM's c relative
    to its largest value), ragged lengths with a length-1 row; one launch
    counted a call; zeros past every length. A variant the shape does not
    allow raises: it never falls back."""
    from deepspeech_tpu_torch.ops.cuda import gru, lstm

    mod = gru if cell == "gru" else lstm
    case = _gru_case if cell == "gru" else _lstm_case
    layer = gru.gru_layer if cell == "gru" else lstm.lstm_layer
    args = case(dev, torch.bfloat16, ndir, t, b, f, h, t + b + 9)
    args[-1][-1] = 1
    if (variant != "step" and b > 64) or (variant == "resident"
                                          and h == 1600):
        with pytest.raises(RuntimeError, match="fwd kernel"):
            layer(*args, variant=variant)
        return
    before = (mod.launches, mod.res_launches)
    got = layer(*args, variant=variant)
    res = layer(*args, residuals=True, variant=variant)
    assert (mod.launches, mod.res_launches) == (before[0] + 2, before[1] + 1)
    ref = mod.plain(*args, residuals=True)
    torch.testing.assert_close(got, ref[0], rtol=0, atol=5e-3)
    for name, a, w in zip(("h", "r1", "r2"), res, ref):
        assert a.dtype == w.dtype, name
        scale = (max(1.0, w.abs().max().item())
                 if a.dtype == torch.float32 and name == "r1" else 1.0)
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                   atol=5e-3 * scale)
    pad = torch.arange(t, device=dev)[:, None] >= args[-1][None, :]
    for a in (got, *res):
        assert not a[:, pad].any()


@pytest.mark.parametrize("cell,b,h,want", [
    ("gru", 20, 800, 3), ("lstm", 20, 800, 3), ("gru", 64, 800, 3),
    ("lstm", 64, 800, 3), ("gru", 64, 1600, 2), ("lstm", 70, 800, 1)])
def test_fwd_rule_on_the_card(dev, cell, b, h, want):
    """The rule on this card's capacities: the resident variant at H 800
    up to one chunk, the streamed one for the wide GRU's layer 0, one
    launch a step above 64 rows."""
    from deepspeech_tpu_torch.ops.cuda import gru, lstm
    from deepspeech_tpu_torch.ops.cuda.recurrence import (fwd_capacity,
                                                          fwd_variant)

    mod = gru if cell == "gru" else lstm
    caps = fwd_capacity(mod._fwd_kernel(), f"{cell}_fwd_capacity", b, h, dev)
    assert fwd_variant("auto", 3 if cell == "gru" else 4, b, h, 2,
                       *caps) == want


# (T, B, F, N): ragged M, N and K, the default layer 0 and its GRU's N, and
# an x whose base is 2 bytes off 16-byte alignment
PROJ_SHAPES = [(7, 5, 50, 150), (9, 13, 96, 200), (64, 20, 1312, 2400)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("t,b,f,n", PROJ_SHAPES)
def test_projection_kernel_matches_plain(dev, t, b, f, n, offset):
    """K2's and K3's bf16 projection GEMM against the f32 einsum of the
    same bf16 operands (exact products, sums in another order: rtol 1e-5,
    atol 1e-4)."""
    from deepspeech_tpu_torch.ops.cuda import gru

    rng = np.random.default_rng(f + n)
    buf = torch.from_numpy(rng.uniform(0, 1, t * b * f + offset).astype(
        np.float32)).to(dev).bfloat16()
    x = buf[offset:].view(t, b, f)
    w = torch.from_numpy(rng.uniform(-0.05, 0.05, (2, f, n)).astype(
        np.float32)).to(dev).bfloat16()
    before = gru.proj_launches
    got = gru.projection(x, w)
    assert gru.proj_launches == before + 1
    torch.testing.assert_close(got, gru.projection(x.cpu(), w.cpu()).to(dev),
                               rtol=1e-5, atol=1e-4)


def test_device_masks_and_noise_mix_match_cpu(dev):
    """SpecAugment, the 8 kHz band zero and the two-pass noise mix on the
    card from fixed draws (made on the CPU) equal the same functions on
    the CPU: the masks exactly, the mix to 1e-6."""
    from deepspeech_tpu_torch.augment import noise_device, spectrogram

    gen = torch.Generator().manual_seed(0)
    b, t, s = 20, 376, 120_000
    mag = torch.rand(b, 161, t, generator=gen) + 0.1
    lens = torch.randint(t // 3, t + 1, (b,), generator=gen)
    spec = spectrogram.draw_spec_augment(b, 161, t, gen)
    band = spectrogram.draw_band_zero(b, gen)
    want = spectrogram.apply_band_zero_8khz(
        spectrogram.apply_spec_augment(mag, lens, spec, 0.7), band, 0.4)
    got = spectrogram.apply_band_zero_8khz(
        spectrogram.apply_spec_augment(
            mag.to(dev), lens.to(dev),
            {k: v.to(dev) for k, v in spec.items()}, 0.7),
        band.to(dev), 0.4)
    assert torch.equal(got.cpu(), want)

    audio = torch.randn(b, s, generator=gen) * 0.3
    alens = torch.randint(s // 2, s - 160, (b,), generator=gen)
    bank = torch.randn(3, 2 * s, generator=gen) * 0.2
    blens = torch.tensor([2 * s, s, 1000])
    draws = noise_device.draw_noise(b, s, 3, gen)
    want = noise_device.apply_noise(audio, alens, draws, bank, blens, 0.6,
                                    0.2, reflect_pad=160)
    got = noise_device.apply_noise(
        audio.to(dev), alens.to(dev), {k: v.to(dev) for k, v in draws.items()},
        bank.to(dev), blens.to(dev), 0.6, 0.2, reflect_pad=160)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)


# ---- the serving path and the CNN zoo on the card ----

SERVE_LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 "


def _serve_audio(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * (300 + 40 * seed) * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _uni_ds2(device, cell="gru"):
    from deepspeech_tpu_torch.models import build_model

    torch.manual_seed(0)
    model, _ = build_model(cell, len(SERVE_LABELS), 64, 2,
                           bidirectional=False, device="cpu")
    return model.eval(), model.to(device).eval()


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_streamed_chunks_match_cpu(dev, cell):
    """The stream on the card (K1 a chunk) against the same stream on the
    CPU port: logits to 1e-3 (f32 sums in other orders through two layers
    and the lookahead)."""
    import copy

    from deepspeech_tpu_torch.ops.cuda import stft
    from deepspeech_tpu_torch.serve import StreamingTranscriber
    from deepspeech_tpu_torch.text.labels import Labels

    cpu_model, _ = _uni_ds2("cpu", cell)
    card_model = copy.deepcopy(cpu_model).to(dev)
    y = _serve_audio(1.7, 1)
    out = []
    for model in (cpu_model, card_model):
        st = StreamingTranscriber(model, Labels(SERVE_LABELS),
                                  chunk_frames=40)
        before = stft.launches
        st.feed(y)
        st.finish()
        out.append((st.collected_logits(), stft.launches - before))
    (ref, cpu_launches), (got, launches) = out
    assert cpu_launches == 0 and launches >= 1
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


def test_pool_tick_counts_k1_and_k10(dev):
    """A beam pool's tick on the card launches K1 once and K10 once a beam
    step (an emitted output), for any number of busy slots."""
    from deepspeech_tpu_torch.ops.cuda import stft, topk
    from deepspeech_tpu_torch.serve import StreamPool
    from deepspeech_tpu_torch.text.labels import Labels

    _, model = _uni_ds2(dev)
    pool = StreamPool(model, Labels(SERVE_LABELS), chunk_frames=40, slots=3,
                      decoder="beam", beam_width=8)
    s = pool.open()
    pool.write(s, _serve_audio(1.0, 2))
    pool.close(s)
    ticks = 0
    while pool.busy():
        k1, k10 = stft.launches, topk.launches
        pool.tick()
        ticks += 1
        assert stft.launches - k1 == 1
        assert topk.launches - k10 == 40 // 2
    assert ticks >= 2 and pool.done(s) and isinstance(pool.beam_text(s), str)


@pytest.mark.parametrize("variant", ["cnn", "cnn_residual"])
def test_cnn_train_step_matches_plain(dev, variant):
    """A small CNN's train step on the card: K1, K8 and K9 once each, the
    loss and every gradient against the same step through the plain
    versions (f32: 1e-4 relative, gradients 1e-3 of their largest)."""
    import contextlib

    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.ops.cuda import ctc, stft
    from deepspeech_tpu_torch.train.optim import build_optimizer
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_train_step)

    torch.manual_seed(1)
    model, _ = build_model(variant, len(SERVE_LABELS), 48, 2, cnn_width=32,
                           device=dev)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(3)
    lens = np.array([16000, 12800, 9600])
    audio = np.zeros((3, 16000), np.float32)
    for i, n in enumerate(lens):
        audio[i, :n] = _serve_audio(n / 16000, i)
    targets = rng.integers(1, len(SERVE_LABELS), (3, 12)).astype(np.int32)
    batch = {"audio": torch.from_numpy(audio).to(dev),
             "audio_lengths": torch.from_numpy(lens).to(dev),
             "targets": torch.from_numpy(targets).to(dev),
             "target_lengths": torch.tensor([12, 9, 6], device=dev)}
    jitter = torch.zeros(3, device=dev)

    @contextlib.contextmanager
    def plain():
        saved = (stft.stft_mag, ctc.ctc_alpha, ctc.ctc_beta)
        stft.stft_mag = lambda y, n, h, w, center=True: stft.plain(
            y, n, h, w, center=center)
        ctc.ctc_alpha, ctc.ctc_beta = ctc.plain_alpha, ctc.plain_beta
        try:
            yield
        finally:
            stft.stft_mag, ctc.ctc_alpha, ctc.ctc_beta = saved

    runs = []
    for ctx in (contextlib.nullcontext(), plain()):
        model.load_state_dict(init)
        opt = build_optimizer("sgd", lr=1e-3)
        step = make_train_step(model, opt, StepConfig())
        before = (stft.launches, ctc.alpha_launches, ctc.beta_launches)
        with ctx:
            m = step(TrainState.create(model, opt), batch, jitter=jitter,
                     return_grads=True)
        after = (stft.launches, ctc.alpha_launches, ctc.beta_launches)
        runs.append((m, [a - b for a, b in zip(after, before)]))
    (m, launches), (ref, plain_launches) = runs
    assert launches == [1, 1, 1] and plain_launches == [0, 0, 0]
    torch.testing.assert_close(m["loss"], ref["loss"], rtol=1e-4, atol=0)
    for g, r in zip(m["grads"], ref["grads"]):
        scale = max(1e-6, r.abs().max().item())
        assert (g - r).abs().max().item() <= 1e-3 * scale


# ---- the data path: the test CLI with a KenLM trie on the card ----

def test_test_cli_kenlm_trie_beam_matches_cpu(dev, tmp_path):
    """``test --decoder beam --lm-path <KenLM trie>`` on the card: K1 once
    and K2 once a layer; the posteriors it dumps agree with the same CLI
    on the CPU port at 1e-4 (f32 sums in other orders), and its
    transcripts equal the CPU port's Python search (where ``auto`` sends a
    binary LM) run on those posteriors. The LM fixtures come from
    chip_smoke.py's writers: this suite runs with ``--noconftest`` where
    JAX may be absent, so the JAX tests' writers cannot be imported."""
    import contextlib
    import io
    import pickle

    from chip_smoke import write_kenlm_binary, write_synthetic_arpa
    from deepspeech_tpu_torch.audio.features import AudioConf
    from deepspeech_tpu_torch.audio.io import save_wav
    from deepspeech_tpu_torch.cli.test import main as test_main
    from deepspeech_tpu_torch.decoders import BeamCTCDecoder
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.ops.cuda import gru, stft
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    torch.manual_seed(0)
    model, meta = build_model("gru", len(SERVE_LABELS), 64, 2, device="cpu")
    path = str(tmp_path / "m.ckpt")
    ckpt.save(path, ckpt.package_from_model(model, meta, SERVE_LABELS,
                                            AudioConf().to_dict()))
    arpa, trie = str(tmp_path / "lm.arpa"), str(tmp_path / "lm.binary")
    write_synthetic_arpa(arpa, np.random.default_rng(1), n_words=200)
    write_kenlm_binary(trie, arpa, "trie")
    rows = []
    for i in range(3):
        wav, txt = str(tmp_path / f"u{i}.wav"), str(tmp_path / f"u{i}.txt")
        save_wav(wav, _serve_audio(1.0 + 0.3 * i, i), 16000)
        with open(txt, "w") as f:
            f.write("AB CD")
        rows.append(f"{wav},{txt}")
    manifest = tmp_path / "m.csv"
    manifest.write_text("\n".join(rows) + "\n")

    dumps = {}
    for device in ("cuda", "cpu"):
        before = (stft.launches, gru.launches)
        with contextlib.redirect_stdout(io.StringIO()):
            assert test_main([
                "--model-path", path, "--test-manifest", str(manifest),
                "--device", device, "--batch-size", "3", "--num-workers",
                "0", "--decoder", "beam", "--lm-path", trie,
                "--beam-width", "8", "--output-path",
                str(tmp_path / f"{device}.pkl")]) == 0
        launches = (stft.launches - before[0], gru.launches - before[1])
        assert launches == ((1, 2) if device == "cuda" else (0, 0))
        with open(tmp_path / f"{device}.pkl", "rb") as f:
            files = pickle.load(f)
        dumps[device] = {}
        for name in files:
            with open(name, "rb") as f:
                d = pickle.load(f)
            dumps[device][d["filename"]] = d
    decoder = BeamCTCDecoder(SERVE_LABELS, lm_path=trie, beam_width=8,
                             num_processes=1)
    assert decoder.backend == "python"
    for name, card in dumps["cuda"].items():
        cpu = dumps["cpu"][name]
        assert card["len"] == cpu["len"]
        np.testing.assert_allclose(card["probs"], cpu["probs"], rtol=1e-4,
                                   atol=1e-4)
        want, _ = decoder.decode(card["probs"][None].astype(np.float64),
                                 [card["len"]])
        assert card["transcript"] == want[0][0]


# -- multi-GPU training (parallel/) on the card --------------------------------

# the shapes of the training variants tensor parallelism runs at D=1: the
# default model's (F 1312 then 800, H 800, B 20) and config 4's (F 1600,
# H 1600, B 64), over a short T
TP_SHAPES = [(24, 20, 1312, 800), (24, 20, 800, 800), (12, 64, 1600, 1600)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("t,b,f,h", TP_SHAPES)
def test_tp_d1_training_variants_match_plain(dev, dtype, tol, t, b, f, h):
    """K2 with residuals and K5 at D=1, as each rank of --mesh-model 2
    runs them, against plain (the GRU tolerances above)."""
    from deepspeech_tpu_torch.ops.cuda import gru

    args = _gru_case(dev, dtype, 1, t, b, f, h, t + b + f)
    before = (gru.res_launches, gru.bwd_launches)
    res = gru.gru_layer(*args, residuals=True)
    ref = gru.plain(*args, residuals=True)
    for got, want in zip(res, ref):
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=tol)
    out, g, hn = ref
    dout = torch.from_numpy(np.random.default_rng(h).standard_normal(
        out.shape).astype(np.float32)).to(dev)
    w_hh, lens = args[3], args[5]
    got = gru.gru_bwd(dout, g, hn, out, w_hh, lens)
    assert (gru.res_launches, gru.bwd_launches) == (before[0] + 1,
                                                    before[1] + 1)
    want = gru.plain_bwd(dout, g, hn, out, w_hh, lens)
    f32 = dtype == torch.float32
    for name, a, w in zip(("dg", "dnh", "dbi", "dbh"), got, want):
        scale = max(1.0, w.abs().max().item())
        btol = (1e-4 if name in ("dg", "dnh") else 1e-3) if f32 else 2e-2
        err = (a.float() - w.float()).abs().max().item()
        assert err <= btol * scale, (name, err, scale)


# -- CUDA graphs of the train step (--steps-per-dispatch) ---------------------


def _replays_match_eager(fn, inputs: tuple, fresh: list) -> None:
    """``fn`` eager on ``inputs`` (the warm-up: the build, the function
    attributes, the per-shape caches), then captured on static copies and
    replayed on each of ``fresh`` copied in: every replay's outputs equal
    an eager call's on the same inputs bit for bit."""
    fn(*inputs)
    static = [x.clone() for x in inputs]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*static)
    outs = out if isinstance(out, tuple) else (out,)
    for new in fresh:
        for s, n in zip(static, new):
            s.copy_(n)
        graph.replay()
        want = fn(*new)
        want = want if isinstance(want, tuple) else (want,)
        assert len(want) == len(outs)
        for a, w in zip(outs, want):
            torch.testing.assert_close(a, w, rtol=0, atol=0, equal_nan=True)


_FWD_CAPTURE = [(v, torch.bfloat16) for v in ("resident", "persistent",
                                              "step")] + [("auto",
                                                           torch.float32)]


@pytest.mark.parametrize("residuals", [False, True])
@pytest.mark.parametrize("variant,dtype", _FWD_CAPTURE)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_fused_forward_variants_capture(dev, cell, variant, dtype,
                                        residuals):
    """K2 and K3, each bf16 recurrence variant (the W-resident cluster
    launch through cudaLaunchKernelEx, the cooperative streamed one, one
    launch a step) and f32, at the default model's widths (B 20, F 1312,
    H 800; T 16), inference and training, captured and replayed."""
    import functools

    from deepspeech_tpu_torch.ops.cuda import gru, lstm

    case = _gru_case if cell == "gru" else _lstm_case
    layer = gru.gru_layer if cell == "gru" else lstm.lstm_layer
    args = case(dev, dtype, 2, 16, 20, 1312, 800, 31)
    fresh = [case(dev, dtype, 2, 16, 20, 1312, 800, 32 + i)
             for i in range(2)]
    _replays_match_eager(functools.partial(layer, residuals=residuals,
                                           variant=variant), args, fresh)


@pytest.mark.parametrize("variant,dtype", [
    ("persistent", torch.bfloat16), ("step", torch.bfloat16),
    ("auto", torch.float32), ("step", torch.float32)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scan_variants_capture(dev, cell, variant, dtype):
    """K4 and K6 at config 4's width (B 64, H 1600; T 9): the cooperative
    persistent launches (bf16, and K4's f32 by the rule), one launch a step
    in both types, with residuals, captured and replayed."""
    import functools

    from deepspeech_tpu_torch.ops.cuda import gru, lstm

    gates = 3 if cell == "gru" else 4
    scan = gru.gru_scan if cell == "gru" else lstm.lstm_scan
    args = _scan_case(dev, dtype, 2, 9, 64, 1600, gates, 41)
    fresh = [_scan_case(dev, dtype, 2, 9, 64, 1600, gates, 42 + i)
             for i in range(2)]
    _replays_match_eager(functools.partial(scan, residuals=True,
                                           variant=variant), args, fresh)


@pytest.mark.parametrize("variant,dtype", [
    ("persistent", torch.bfloat16), ("step", torch.bfloat16),
    ("auto", torch.float32)])
@pytest.mark.parametrize("t,b,h", [(9, 20, 800), (5, 64, 1600)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_bwd_variants_capture(dev, cell, t, b, h, variant, dtype):
    """K5 and K7 (the bf16 cluster launches through cudaLaunchKernelEx,
    persistent and one a step; f32) at both models' widths, captured and
    replayed."""
    import functools

    from deepspeech_tpu_torch.ops.cuda import gru, lstm

    mod = gru if cell == "gru" else lstm
    case = _gru_case if cell == "gru" else _lstm_case

    def inputs(seed):
        x, w_ih, b_ih, w_hh, b_hh, lens = case(dev, dtype, 2, t, b, 64, h,
                                               seed)
        out, r1, r2 = mod.plain(x, w_ih, b_ih, w_hh, b_hh, lens,
                                residuals=True)
        dout = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            out.shape).astype(np.float32)).to(dev)
        return ((dout, r1, r2, out, w_hh, lens) if cell == "gru"
                else (dout, r2, r1, w_hh, lens))

    bwd = gru.gru_bwd if cell == "gru" else lstm.lstm_bwd
    _replays_match_eager(functools.partial(bwd, variant=variant),
                         inputs(51), [inputs(52), inputs(53)])


@pytest.mark.parametrize("how,lmax", [("ring", 40), ("global", 40),
                                      ("global", 2250)])
def test_ctc_routes_capture(dev, how, lmax):
    """K8 and K9 on each route (the global route's per-row workspace, K9's
    too), captured and replayed."""
    from deepspeech_tpu_torch.ops import ctc as ctc_loss_mod
    from deepspeech_tpu_torch.ops.cuda import ctc

    b, t = 3, max(60, lmax + lmax // 10 + 40)

    def inputs(seed):
        rng = np.random.default_rng(seed)
        logits = torch.from_numpy(rng.standard_normal((b, t, 29)).astype(
            np.float32)).to(dev)
        targets = torch.from_numpy(rng.integers(1, 29, (b, lmax)).astype(
            np.int32)).to(dev)
        lp, ext = ctc_loss_mod._prep(logits, targets, 0)
        tl = torch.tensor([lmax, lmax // 2, 0], device=dev)
        ll = torch.tensor([t, t - 7, 5], device=dev)
        g = torch.linspace(0.5, 1.5, b, device=dev)
        return lp, ext, tl, ll, g

    def both(lp, ext, tl, ll, g):
        alphas, loss = ctc._alpha(lp, ext, tl, ll, how)
        return alphas, loss, ctc._beta(lp, ext, tl, ll, alphas, loss, g,
                                       False, how)

    _replays_match_eager(both, inputs(61), [inputs(62), inputs(63)])


def test_stft_and_topk_capture(dev):
    """K1 (the FFT route's device constants made by the warm-up) and K10,
    captured and replayed."""
    from deepspeech_tpu_torch.audio.features import make_window
    from deepspeech_tpu_torch.ops.cuda import stft, topk

    win = make_window("hamming", 320)

    def wave(seed):
        return (torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (4, 16000)).astype(np.float32)).to(dev),)

    _replays_match_eager(lambda y: stft.stft_mag(y, 320, 160, win), wave(71),
                         [wave(72), wave(73)])

    def rows(seed):
        return (torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (20, 310)).astype(np.float32)).to(dev),)

    _replays_match_eager(lambda x: topk.topk_total_order(x, 10), rows(81),
                         [rows(82), rows(83)])


def _fake_step(state, batch, generator=None):
    """A stand-in train step: K1 on the batch, a draw from the generator,
    the state's step moved in place."""
    from deepspeech_tpu_torch.audio.features import make_window
    from deepspeech_tpu_torch.ops.cuda import stft

    mag = stft.stft_mag(batch["audio"], 320, 160, make_window("hamming", 320))
    state.step += 1
    return {"mag": mag.sum((1, 2)),
            "draw": torch.rand(batch["audio"].shape[0], generator=generator,
                               device=batch["audio"].device)}


def test_step_graphs_draws_and_counts(dev):
    """StepGraphs on a stand-in step: the first batch eager, the second
    captured, then replays; the replays' draws equal an eager run's from
    a generator of the same seed, the generator's state after them too;
    K1's counter counts every replay once (none for the capture); one
    graph a shape (a second shape warms up eagerly, then is captured)."""
    import types

    from deepspeech_tpu_torch.ops.cuda import stft
    from deepspeech_tpu_torch.train.graph import StepGraphs

    batches = [{"audio": torch.from_numpy(np.random.default_rng(i)
                                          .standard_normal((3, n)).astype(
                                              np.float32)).to(dev)}
               for i, n in enumerate((4000, 4000, 4000, 4000, 6000, 6000,
                                      6000, 4000))]
    state = types.SimpleNamespace(step=torch.zeros((), dtype=torch.int64,
                                                   device=dev))
    gen = torch.Generator(device=dev).manual_seed(5)
    graphs = StepGraphs(_fake_step, state, gen)
    before = stft.launches
    got = [graphs(b) for b in batches]
    assert stft.launches == before + len(batches)
    assert graphs.stats()["graphs"] == 2
    assert graphs.eager_steps == 2 and graphs.replays == 6
    assert int(state.step) == len(batches)

    ref_state = types.SimpleNamespace(step=torch.zeros((), dtype=torch.int64,
                                                       device=dev))
    ref_gen = torch.Generator(device=dev).manual_seed(5)
    want = [_fake_step(ref_state, b, ref_gen) for b in batches]
    for g, w in zip(got, want):
        assert torch.equal(g["draw"], w["draw"])
        torch.testing.assert_close(g["mag"], w["mag"], rtol=0, atol=0)
    assert torch.equal(gen.get_state(), ref_gen.get_state())


def _spd_batches(k: int):
    """k batches of 4 rows of one shape (1 s audio bucket, 0.3-0.5 s of
    noisy tones), the int16 wire, on the CPU."""
    from deepspeech_tpu_torch.data import BucketSpec, collate_batch

    rng = np.random.default_rng(9)
    out = []
    for j in range(k):
        samples = []
        for i in range(4):
            n = 16000 * (3 + (i + j) % 3) // 10
            y = (0.5 * np.sin(2 * np.pi * (150 + 70 * i) * np.arange(n)
                              / 16000) + 0.1 * rng.standard_normal(n))
            samples.append({"audio": y.astype(np.float32), "path": "",
                            "target": rng.integers(1, 29, 4 + i).astype(
                                np.int32)})
        batch = collate_batch(samples, 4, BucketSpec(wire_dtype="int16"))
        batch.pop("paths")
        out.append(batch)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_multi_step_replays_match_eager_steps(dev, cell, dtype):
    """``make_multi_train_step`` at k 4 on the card (one eager step, a
    capture, three replays) against four eager ``train_step`` calls from
    the same init and generator seed, 2 x Bi<cell>-64 with the device
    masks on: every parameter, BatchNorm buffer and optimizer tensor, the
    losses and grad norms at 1e-5 relative (cuDNN deterministic in both
    runs; the gaps are printed), the step counter and the generator's
    state equal; the launch counters move alike in both runs."""
    from deepspeech_tpu_torch.audio.features import AudioConf
    from deepspeech_tpu_torch.data import stack_microbatches
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.ops.cuda import read_counters
    from deepspeech_tpu_torch.train.optim import build_optimizer
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_multi_train_step,
                                                 make_train_step)

    cfg = StepConfig(audio_conf=AudioConf(aug_prob_spect=0.5,
                                          aug_prob_8khz=0.3))
    host = _spd_batches(4)
    torch.manual_seed(3)
    init, _ = build_model(cell, 29, 64, 2, compute_dtype=dtype,
                          device="cuda")
    init = {k: v.clone() for k, v in init.state_dict().items()}
    runs = []
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for graphed in (False, True):
            model, _ = build_model(cell, 29, 64, 2, compute_dtype=dtype,
                                   device="cuda")
            model.load_state_dict(init)
            opt = build_optimizer("sgd", lr=3e-3, momentum=0.9,
                                  max_norm=100.0)
            state = TrainState.create(model, opt)
            gen = torch.Generator(device="cuda").manual_seed(11)
            before = read_counters()
            if graphed:
                stacked, live = stack_microbatches(host, 4)
                multi = make_multi_train_step(model, opt, cfg)
                m = multi(state, {k: torch.from_numpy(v).cuda()
                                  for k, v in stacked.items()}, gen, live)
                stats = multi.graphs.stats()
                assert stats["graphs"] == 1 and stats["eager_steps"] == 1
                assert stats["replays"] == 3
            else:
                step = make_train_step(model, opt, cfg)
                ms = [step(state, {k: torch.from_numpy(v).cuda()
                                   for k, v in b.items()}, generator=gen)
                      for b in host]
                m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
            torch.cuda.synchronize()
            after = read_counters()
            runs.append((model, state, gen, m,
                         {c: after[c] - before[c] for c in after}))
    finally:
        torch.backends.cudnn.deterministic = saved
    (ma, sa, ga, mta, ca), (mb, sb, gb, mtb, cb) = runs
    assert ca == cb and ca[("stft", "launches")] == 4
    assert torch.equal(sa.step, sb.step) and int(sb.step) == 4
    assert torch.equal(ga.get_state(), gb.get_state())
    gaps = {}
    for key in ("loss", "grad_norm", "per_sample"):
        gaps[key] = ((mtb[key] - mta[key]).abs().max()
                     / mta[key].abs().max()).item()
    for (name, a), (_, b) in zip(ma.state_dict().items(),
                                 mb.state_dict().items()):
        gaps[name] = ((b - a).abs().max() / a.abs().max().clamp(
            min=1e-30)).item()
    for i, (a, b) in enumerate(zip(sa.opt_state["trace"],
                                   sb.opt_state["trace"])):
        gaps[f"trace {i}"] = ((b - a).abs().max() / a.abs().max().clamp(
            min=1e-30)).item()
    print(f"{cell} {dtype}: replays against eager steps, largest relative "
          f"gap {max(gaps.values()):.2e} ({max(gaps, key=gaps.get)})")
    assert max(gaps.values()) <= 1e-5, gaps
    assert not mtb["step_skipped"].any()


def test_multi_step_follows_set_lr_and_the_noise_bank(dev):
    """``make_multi_train_step`` at k 2 over three groups of one shape
    with ``set_lr`` between the groups (the checkpoint anneal: the replays
    of the graph captured at the first LR read the new one) and the device
    noise mix reading a noise bank passed as ``shared``, against six eager
    ``train_step`` calls with the same LRs set at the same places, 2 x
    BiGRU-64 f32, cuDNN deterministic in both runs: the losses, every
    parameter, BatchNorm buffer and momentum trace, the step and the
    generator's state equal (torch.equal)."""
    from deepspeech_tpu_torch.data import stack_microbatches
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.train.optim import build_optimizer, set_lr
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_multi_train_step,
                                                 make_train_step)

    cfg = StepConfig(device_noise_prob=0.7, device_noise_limit=0.3)
    host = _spd_batches(6)
    rng = np.random.default_rng(12)
    width = 2 * host[0]["audio"].shape[1]
    shared = {"noise_bank": torch.from_numpy(
        (0.3 * rng.standard_normal((3, width))).astype(np.float32)).to(dev),
        "noise_bank_lengths": torch.tensor([width, width // 2, width // 3],
                                           dtype=torch.int32, device=dev)}
    lrs = (3e-3, 1.5e-3, 1e-3)
    torch.manual_seed(4)
    init, _ = build_model("gru", 29, 64, 2, compute_dtype="float32",
                          device="cuda")
    init = {k: v.clone() for k, v in init.state_dict().items()}
    runs = []
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for graphed in (False, True):
            model, _ = build_model("gru", 29, 64, 2, compute_dtype="float32",
                                   device="cuda")
            model.load_state_dict(init)
            opt = build_optimizer("sgd", lr=lrs[0], momentum=0.9,
                                  max_norm=100.0)
            state = TrainState.create(model, opt)
            gen = torch.Generator(device="cuda").manual_seed(21)
            multi = make_multi_train_step(model, opt, cfg)
            step = make_train_step(model, opt, cfg)
            losses = []
            for g, lr in enumerate(lrs):
                set_lr(state.opt_state, lr)
                group = host[2 * g:2 * g + 2]
                if graphed:
                    stacked, live = stack_microbatches(group, 2)
                    m = multi(state, {k: torch.from_numpy(v).cuda()
                                      for k, v in stacked.items()}, gen, live,
                              shared)
                    losses += list(m["loss"])
                else:
                    for b in group:
                        m = step(state, {**{k: torch.from_numpy(v).cuda()
                                            for k, v in b.items()},
                                         **shared}, generator=gen)
                        losses.append(m["loss"])
            if graphed:
                stats = multi.graphs.stats()
                assert (stats["graphs"], stats["eager_steps"],
                        stats["replays"]) == (1, 1, 5)
            torch.cuda.synchronize()
            runs.append((model, state, gen, torch.stack(losses)))
    finally:
        torch.backends.cudnn.deterministic = saved
    (ma, sa, ga, la), (mb, sb, gb, lb) = runs
    assert torch.equal(la, lb), (la, lb)
    for (name, a), (_, b) in zip(ma.state_dict().items(),
                                 mb.state_dict().items()):
        assert torch.equal(a, b), name
    for a, b in zip(sa.opt_state["trace"], sb.opt_state["trace"]):
        assert torch.equal(a, b)
    assert torch.equal(sa.step, sb.step) and int(sb.step) == 6
    assert sb.opt_state["lr_host"] == lrs[-1]
    assert torch.equal(ga.get_state(), gb.get_state())


def test_step_graphs_evict_the_least_recent(dev):
    """A cache of one graph over two alternating shapes: each shape warms
    up eagerly once, then every change of shape evicts the other graph and
    captures anew; the draws equal an eager run's and K1's counter counts
    every step once."""
    import types

    from deepspeech_tpu_torch.ops.cuda import stft
    from deepspeech_tpu_torch.train.graph import StepGraphs

    batches = [{"audio": torch.from_numpy(np.random.default_rng(i)
                                          .standard_normal((3, n)).astype(
                                              np.float32)).to(dev)}
               for i, n in enumerate((4000, 4000, 6000, 6000, 4000, 6000,
                                      6000))]
    state = types.SimpleNamespace(step=torch.zeros((), dtype=torch.int64,
                                                   device=dev))
    gen = torch.Generator(device=dev).manual_seed(6)
    graphs = StepGraphs(_fake_step, state, gen)
    graphs.max_graphs = 1
    before = stft.launches
    got = [graphs(b) for b in batches]
    assert stft.launches == before + len(batches)
    stats = graphs.stats()
    assert (stats["graphs"], stats["evictions"], len(stats["capture_s"]),
            stats["eager_steps"], stats["replays"]) == (1, 3, 4, 2, 5)
    ref_state = types.SimpleNamespace(step=torch.zeros((), dtype=torch.int64,
                                                       device=dev))
    ref_gen = torch.Generator(device=dev).manual_seed(6)
    for g, b in zip(got, batches):
        w = _fake_step(ref_state, b, ref_gen)
        assert torch.equal(g["draw"], w["draw"])
        torch.testing.assert_close(g["mag"], w["mag"], rtol=0, atol=0)
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    assert int(state.step) == len(batches)


def _dp_batch():
    """8 rows whose halves differ in length and content, on the int16
    wire."""
    from deepspeech_tpu_torch.data import BucketSpec, collate_batch

    rng = np.random.default_rng(5)
    samples = []
    for i in range(8):
        n = 8000 if i < 4 else 4000
        y = rng.standard_normal(n) * (0.1 if i < 4 else 0.02)
        if i >= 4:
            y += 0.5 * np.sin(2 * np.pi * (200 + 90 * i) * np.arange(n)
                              / 16000)
        samples.append({"audio": y.astype(np.float32), "path": "",
                        "target": rng.integers(1, 29, 6 if i < 4 else 3)
                        .astype(np.int32)})
    batch = collate_batch(samples, 8, BucketSpec(audio_step=1600,
                                                 wire_dtype="int16"))
    batch.pop("paths")
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# each wrapper of the train step -> (module, its plain version, the f32
# tolerance x max(1, max|plain|)): the kernels' own f32 tolerances above
_HELD = {"stft_mag": ("stft", "plain", 1e-4),
         "gru_layer": ("gru", "plain", 1e-4),
         "gru_bwd": ("gru", "plain_bwd", 1e-3),
         "ctc_alpha": ("ctc", "plain_alpha", 1e-4),
         "ctc_beta": ("ctc", "plain_beta", 1e-4)}


@contextlib.contextmanager
def _held_and_clamped(errs: dict, pre: list, clamps: list | None = None):
    """Inside, each K1, K2, K5, K8 and K9 launch also runs its plain version
    on the same inputs, and ``errs`` keeps each wrapper's largest gap over
    max(1, max|plain|) (finite entries, -1e30 fills aside); every input of
    the conv front's Hardtanh(0, 20) is kept in ``pre``. With ``clamps``
    (a (below 0, above 20) pair of masks for each Hardtanh call, in order)
    the Hardtanh clamps where those masks say, not where its input does:
    the same value and gradient wherever the two agree."""
    import importlib

    from deepspeech_tpu_torch.models import ds2

    swaps = [(ds2, "hardtanh_0_20", ds2.hardtanh_0_20)]

    def clamp(x):
        pre.append(x.detach().cpu())
        if clamps is None:
            return swaps[0][2](x)
        lo, hi = (m.to(x.device) for m in clamps[len(pre) - 1])
        return torch.where(lo | hi, torch.where(hi, 20.0, 0.0).to(x.dtype),
                           x)

    def held(name, kernel, plain):
        def call(*args, **kw):
            got = kernel(*args, **kw)
            want = plain(*args, **kw)
            pairs = (zip(got, want) if isinstance(got, tuple)
                     else ((got, want),))
            for g, w in pairs:
                ok = torch.isfinite(w) & (w.abs() < 1e29)
                if not ok.any():
                    continue
                err = (g.float() - w.float())[ok].abs().max().item()
                scale = max(1.0, w.float()[ok].abs().max().item())
                errs[name] = max(errs.get(name, 0.0), err / scale)
            return got
        return call

    ds2.hardtanh_0_20 = clamp
    for name, (mod, plain, _) in _HELD.items():
        mod = importlib.import_module(f"deepspeech_tpu_torch.ops.cuda.{mod}")
        swaps.append((mod, name, getattr(mod, name)))
        setattr(mod, name, held(name, getattr(mod, name),
                                getattr(mod, plain)))
    try:
        yield
    finally:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)


def _dp_steps(model, mesh, batch, steps=2, clamps=None):
    """``steps`` f32 train steps (SGD lr 0.3, clip 1) -> [(loss, grad norm,
    {name: parameter}, the conv front's Hardtanh inputs, {wrapper: its
    launches' largest gap to plain})] after each, the launches held
    (``_held_and_clamped``) in the first step; ``clamps``: each step's
    clamp masks to replay."""
    from deepspeech_tpu_torch.parallel import shard_state
    from deepspeech_tpu_torch.train.optim import build_optimizer
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_train_step)

    opt = build_optimizer("sgd", lr=0.3, momentum=0.9, max_norm=1.0)
    state = TrainState.create(model, opt)
    if mesh is not None:
        state = shard_state(state, mesh)
    step = make_train_step(model, opt, StepConfig(), mesh)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for _ in range(steps):
        errs, pre = {}, []
        with _held_and_clamped(errs, pre,
                               None if clamps is None else clamps[len(out)]):
            m = step(state, batch, generator=gen)
        out.append((m["loss"].item(), m["grad_norm"].item(),
                    {k: p.detach().to("cpu", copy=True)
                     for k, p in model.named_parameters()}, pre,
                    errs if not out else {}))
    return out


def _dp_rank(rank: int, d: str) -> None:
    """One of two gloo ranks on cuda:0: data 2 over the saved model and
    batch, once replaying the one process's clamps on its rows and once
    on its own; its steps saved to ``<d>/rank<rank>.pt``."""
    import datetime

    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", init_method="file://" + os.path.join(d, "rdv"), rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=60))
    try:
        saved = torch.load(os.path.join(d, "inputs.pt"))
        mesh = make_mesh(data=2, device="cuda:0")
        batch = mesh.data_rows({k: v.cuda() for k, v in
                                saved["batch"].items()})
        rows = slice(mesh.data_index * 4, mesh.data_index * 4 + 4)
        runs = {}
        for how in ("replayed", "own"):
            clamps = None if how == "own" else [
                [(lo[rows], hi[rows]) for lo, hi in step]
                for step in saved["clamps"]]
            model, _ = build_model("gru", 29, 32, 2, device="cuda")
            model.load_state_dict(saved["init"])
            runs[how] = _dp_steps(model, mesh, batch, clamps=clamps)
        torch.save(runs, os.path.join(d, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def test_two_gloo_ranks_on_the_card_match_one_process(dev, tmp_path):
    """Two data-2 steps over gloo on two ranks sharing cuda:0 (every tensor
    on the card) against the single-process steps on the whole batch, f32
    with the kernels, run one after the other. Every K1, K2, K5, K8 and K9
    launch of the first step, at B 8 in the one process and B 4 on each
    rank, is held to its plain version on its inputs (``_HELD``). Each
    step: the loss at 1e-4 relative, the grad norm at 1e-4, each
    parameter's change from its init at 1e-3 of the largest change (the
    two halves' sums and the BN moments' sums run in other orders). An
    input of the conv front's Hardtanh(0, 20) within round-off of 0 can
    clamp in one run only, and one such flip moves the second conv's
    gradient by a few percent of its largest. So the ranks run twice: once
    replaying the one process's clamps on their rows, held at those bounds
    at every step; once on their own clamps, held at them up to the first
    step where a clamp flips (the flips and gaps are printed)."""
    from deepspeech_tpu_torch.models import build_model

    torch.manual_seed(0)
    model, _ = build_model("gru", 29, 32, 2, device="cuda")
    init = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}
    batch = _dp_batch()
    want = _dp_steps(model, None, {k: v.cuda() for k, v in batch.items()})
    clamps = [[(x < 0, x > 20) for x in step[3]] for step in want]
    torch.save({"init": init, "batch": batch, "clamps": clamps},
               tmp_path / "inputs.pt")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
         str(tmp_path)], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    readings = {"one process, B 8": want[0][4]}
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for how in ("replayed", "own"):
        # the inputs whose own clamp differs from the one process's, each
        # step, over both ranks (a flip on one moves both through the
        # gradient all-reduce)
        flips = [sum(int((((x > 0) != (w > 0)) | ((x < 20) != (w < 20)))
                         .sum()) for r in range(2)
                     for x, w in zip(ranks[r][how][k][3],
                                     (w[4 * r:4 * r + 4] for w in want[k][3])))
                 for k in range(len(want))]
        for r in range(2):
            got = ranks[r][how]
            readings[f"rank {r}, B 4, {how} clamps"] = got[0][4]
            for k, ((loss, norm, params, _, _), (wl, wn, wp, _, _)) in \
                    enumerate(zip(got, want)):
                worst = max((p - wp[n]).abs().max().item()
                            / (wp[n] - init[n]).abs().max().item()
                            for n, p in params.items())
                print(f"rank {r}, {how} clamps, step {k + 1}: loss rel "
                      f"{abs(loss - wl) / abs(wl):.2e}, grad norm rel "
                      f"{abs(norm - wn) / wn:.2e}, worst parameter "
                      f"{worst:.2e} of its change; own clamps differing "
                      f"on both ranks {flips[k]}")
                if how == "own" and any(flips[:k + 1]):
                    continue
                assert abs(loss - wl) <= 1e-4 * abs(wl), (r, how, k, loss)
                assert abs(norm - wn) <= 1e-4 * wn, (r, how, k, norm, wn)
                assert worst <= 1e-3, (r, how, k, worst)
    for where, errs in readings.items():
        print(f"{where}, each launch against plain: {errs}")
        assert sorted(errs) == sorted(_HELD), (where, errs)
        for name, err in errs.items():
            assert err <= _HELD[name][2], (where, name, err)


# ---- the conv front's tensor-core kernels (csrc/conv_mma.cu) -------------

# (B, T_in): T' 29 (odd), 30 (even), 637 (odd, the train cells' mean bin),
# 638 (even) at the train cells' batches
CONV_SHAPES = [(1, 57), (1, 60), (20, 1273), (64, 1276)]


def _conv_operands(dev, c, b, t_in, seed):
    """x (conv0: f32; conv1: bf16), w (f32, bf16 values), bias, dy for
    conv ``c``, drawn on the card, with a masked tail in the last row."""
    from deepspeech_tpu_torch.ops.cuda import conv

    g = conv.GEOMETRIES[c]
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = conv.out_frames(0, t_in)
    if c == 0:
        x = torch.randn((b, 1, 161, t_in), generator=gen, device=dev)
    else:
        x = torch.randn((b, 32, 81, t), generator=gen,
                        device=dev).to(torch.bfloat16)
    x[-1, ..., x.shape[-1] * 3 // 4:] = 0
    w = (torch.randn((32, g.cin, *g.kernel), generator=gen, device=dev)
         * 0.05).to(torch.bfloat16)
    bias = torch.randn((32,), generator=gen, device=dev)
    dy = torch.randn((b, 32, (g.rows - 1) // 2 + 1, t), generator=gen,
                     device=dev)
    dy[-1, ..., t * 3 // 4:] = 0
    return x, w, bias, dy


def _conv_held(got, ref, terms, rel):
    """|got - ref| <= rel |ref| + 2^-14 (sum of the products' magnitudes)
    elementwise -> the largest ratio of the error to that bound."""
    err = (got.double() - ref).abs()
    return float((err / (rel * ref.abs() + 2.0 ** -14 * terms
                         + 1e-300)).max())


@pytest.mark.parametrize("b,t_in", CONV_SHAPES)
def test_conv_kernels_match_f64(dev, b, t_in):
    """Each product against the f64 product of the same bf16-valued
    operands: the forward (f32 result, bias in its epilogue) to f32
    reassociation, 2^-16 of the products' magnitudes; dgrad (conv1) and
    wgrad (both) within one bf16 ulp and 2^-14 of the products' magnitudes,
    the rounding they get today (dy enters as hi + lo)."""
    import torch.nn.functional as F

    from deepspeech_tpu_torch.ops.cuda import conv

    for c in (0, 1):
        g = conv.GEOMETRIES[c]
        x, w, bias, dy = _conv_operands(dev, c, b, t_in, seed=b + t_in + c)
        xd = x.to(torch.bfloat16).double()
        wd, dyd = w.double(), dy.double()
        before = (conv.fprop_launches, conv.dgrad_launches,
                  conv.wgrad_launches, conv.reduce_launches)
        out = conv.fprop(x, w, bias, c)
        ref = F.conv2d(xd, wd, bias.double(), g.stride, g.padding)
        terms = F.conv2d(xd.abs(), wd.abs(), bias.double().abs(), g.stride,
                         g.padding)
        err = float(((out.double() - ref).abs() / (2.0 ** -16 * terms
                                                   + 1e-300)).max())
        assert out.dtype == torch.float32 and err <= 1, ("fprop", c, err)
        dw = conv.wgrad(dy, x, c)
        ref = torch.nn.grad.conv2d_weight(xd, w.shape, dyd, g.stride,
                                          g.padding)
        terms = torch.nn.grad.conv2d_weight(xd.abs(), w.shape, dyd.abs(),
                                            g.stride, g.padding)
        assert torch.equal(dw, dw.to(torch.bfloat16).float())
        err = _conv_held(dw, ref, terms, 2.0 ** -7)
        assert err <= 1, ("wgrad", c, err)
        if c == 1:
            dx = conv.dgrad(dy, w, 1, x.shape)
            ref = torch.nn.grad.conv2d_input(x.shape, wd, dyd, g.stride,
                                             g.padding)
            terms = torch.nn.grad.conv2d_input(x.shape, wd.abs(), dyd.abs(),
                                               g.stride, g.padding)
            assert dx.dtype == torch.bfloat16
            err = _conv_held(dx, ref, terms, 2.0 ** -7)
            assert err <= 1, ("dgrad", err)
        after = (conv.fprop_launches, conv.dgrad_launches,
                 conv.wgrad_launches, conv.reduce_launches)
        assert [a - z for a, z in zip(after, before)] == [1, c, 1, 1]


def test_conv_gradients_take_dy_low_term(dev):
    """dgrad and both wgrads read dy as hi + lo: with dy = 1 + k 2^-10 (k
    1-3: hi 1, lo k 2^-10) and small integer weights and inputs every
    product and sum is exact in f32, so each gradient is the bf16 rounding
    of the exact hi + lo product, bit for bit; a kernel that read hi alone
    would give the hi-only product, which differs in a tenth of the
    elements or more."""
    from deepspeech_tpu_torch.ops.cuda import conv

    gen = torch.Generator(device=dev).manual_seed(7)
    t_in = 128
    t = conv.out_frames(0, t_in)

    def ints(shape, low, high):
        return torch.randint(low, high, shape, generator=gen,
                             device=dev).float()

    for c in (0, 1):
        g = conv.GEOMETRIES[c]
        x = ints((1, g.cin, g.rows, t_in if c == 0 else t), 0, 3)
        x = x if c == 0 else x.to(torch.bfloat16)
        w = ints((32, g.cin, *g.kernel), -1, 3).to(torch.bfloat16)
        dy = 1 + ints((1, 32, (g.rows - 1) // 2 + 1, t), 1, 4) * 2.0 ** -10
        hi, lo = conv.split_hi_lo(dy)
        assert bool((hi == 1).all()) and bool((lo != 0).all())
        terms = {"hi + lo": hi.double() + lo.double(), "hi": hi.double()}
        xd, wd = x.double(), w.double()
        got = {"wgrad": conv.wgrad(dy, x, c)}
        want = {k: {"wgrad": torch.nn.grad.conv2d_weight(
            xd, w.shape, d, g.stride, g.padding).to(torch.bfloat16).float()}
            for k, d in terms.items()}
        if c == 1:
            got["dgrad"] = conv.dgrad(dy, w, 1, x.shape)
            for k, d in terms.items():
                want[k]["dgrad"] = torch.nn.grad.conv2d_input(
                    x.shape, wd, d, g.stride, g.padding).to(torch.bfloat16)
        for name, out in got.items():
            assert torch.equal(out, want["hi + lo"][name]), (name, c)
            moved = (want["hi"][name] != want["hi + lo"][name]).double()
            assert float(moved.mean()) >= 0.1, (name, c, float(moved.mean()))


def _conv_products(conv, x0, x1, w0, w1, b0, b1, dy0, dy1):
    return (conv.fprop(x0, w0, b0, 0), conv.fprop(x1, w1, b1, 1),
            conv.dgrad(dy1, w1, 1, x1.shape), conv.wgrad(dy0, x0, 0),
            conv.wgrad(dy1, x1, 1))


def test_conv_kernels_deterministic_and_captured(dev):
    """Two runs of every product give equal bits; a CUDA graph of them,
    replayed on new inputs, equals eager calls on those inputs bit for
    bit."""
    from deepspeech_tpu_torch.ops.cuda import conv

    def operands(seed):
        x0, w0, b0, dy0 = _conv_operands(dev, 0, 20, 801, seed)
        x1, w1, b1, dy1 = _conv_operands(dev, 1, 20, 801, seed + 1)
        return x0, x1, w0, w1, b0, b1, dy0, dy1

    first = operands(1)
    one, two = (_conv_products(conv, *first) for _ in range(2))
    assert all(torch.equal(p, q) for p, q in zip(one, two))
    static = [t.clone() for t in first]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _conv_products(conv, *static)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = _conv_products(conv, *static)
    for seed in (5, 9):
        new = operands(seed)
        for s, n in zip(static, new):
            s.copy_(n)
        graph.replay()
        eager = _conv_products(conv, *new)
        assert all(torch.equal(p, q) for p, q in zip(outs, eager))


def test_bf16_conv_front_on_the_card_matches_cpu(dev, monkeypatch):
    """The bf16 ``ConvFrontend`` on the card (the kernels) against its CPU
    twin (f32 convs of the rounded operands), train mode: the output within
    one bf16 ulp (and 2^-6: a conv0 value rounded the other way moves
    conv1's sums a little); the counters read 2 forwards, 1 dgrad and 2
    wgrads; and each product the front launched, recorded with its inputs,
    against its plain twin on the CPU on those inputs (the forward to
    2^-16, the gradients within one bf16 ulp and 2^-14, of the products'
    magnitudes). The parameters' gradients are not compared whole: a
    pre-activation that the two sides' f32 sums put on either side of a
    Hardtanh bound (0 or 20) takes its term in or out of the sums below it
    (as chip_smoke.py's CNN phase finds for ReLU)."""
    import torch.nn.functional as F

    from deepspeech_tpu_torch.models.ds2 import ConvFrontend, conv_out_lengths
    from deepspeech_tpu_torch.ops.cuda import conv

    calls = []
    for name in ("fprop", "dgrad", "wgrad"):
        def recorder(*args, _fn=getattr(conv, name), _name=name):
            calls.append((_name, [a.clone() if torch.is_tensor(a) else a
                                  for a in args]))
            out = _fn(*args)
            calls[-1] += (out.clone(),)
            return out
        monkeypatch.setattr(conv, name, recorder)
    torch.manual_seed(0)
    cpu = ConvFrontend(compute_dtype=torch.bfloat16)
    card = ConvFrontend(compute_dtype=torch.bfloat16).to(dev)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 161, 301)).astype(
        np.float32))
    lengths = torch.tensor([301, 280, 200, 97])
    for i, n in enumerate(lengths.tolist()):
        x[i, :, n:] = 0
    weight = torch.from_numpy(rng.standard_normal((4, 32, 41, 151)).astype(
        np.float32))
    outs = []
    for model, where in ((cpu, "cpu"), (card, dev)):
        calls.clear()
        before = (conv.fprop_launches, conv.dgrad_launches,
                  conv.wgrad_launches)
        out = model(x.to(where), conv_out_lengths(lengths).to(where))
        (out.float() * weight.to(where)).sum().backward()
        after = (conv.fprop_launches, conv.dgrad_launches,
                 conv.wgrad_launches)
        assert [a - z for a, z in zip(after, before)] == (
            [2, 1, 2] if where is dev else [0, 0, 0])
        outs.append(out.float().cpu())
    got, ref = outs[1], outs[0]
    assert bool(((got - ref).abs() <= 2.0 ** -7 * ref.abs() + 2.0 ** -6)
                .all())
    assert sorted(c[0] for c in calls) == ["dgrad", "fprop", "fprop",
                                           "wgrad", "wgrad"]
    for name, args, out in calls:
        args = [a.cpu() if torch.is_tensor(a) else a for a in args]
        want = getattr(conv, f"plain_{name}")(*args)
        c = args[2] if name != "fprop" else args[3]
        g = conv.GEOMETRIES[c]
        if name == "fprop":
            xd, wd = args[0].to(torch.bfloat16).double(), args[1].double()
            terms = F.conv2d(xd.abs(), wd.abs(), args[2].double().abs(),
                             g.stride, g.padding)
            rel = 0.0
        elif name == "dgrad":
            terms = torch.nn.grad.conv2d_input(
                args[3], args[1].double().abs(), args[0].double().abs(),
                g.stride, g.padding)
            rel = 2.0 ** -7
        else:
            terms = torch.nn.grad.conv2d_weight(
                args[1].to(torch.bfloat16).double().abs(),
                (32, g.cin, *g.kernel), args[0].double().abs(), g.stride,
                g.padding)
            rel = 2.0 ** -7
        err = (out.cpu().double() - want.double()).abs()
        bound = rel * want.double().abs() + (
            2.0 ** -16 if name == "fprop" else 2.0 ** -14) * terms
        assert bool((err <= bound).all()), (name, c, float(err.max()))


def test_f32_conv_front_on_the_card_keeps_cudnn_tf32_off(dev, monkeypatch):
    """An f32 ``ConvFrontend`` on the card calls ``F.conv2d`` (cuDNN) with
    TF32 off, twice, and no conv kernel."""
    import types

    import torch.nn.functional as F

    from deepspeech_tpu_torch.models import ds2
    from deepspeech_tpu_torch.ops.cuda import conv

    flags = []

    def conv2d(*a, **k):
        flags.append(torch.backends.cudnn.allow_tf32)
        return F.conv2d(*a, **k)

    monkeypatch.setattr(ds2, "F", types.SimpleNamespace(conv2d=conv2d))
    front = ds2.ConvFrontend().to(dev)
    x = torch.randn((2, 161, 120), device=dev)
    before = conv.fprop_launches
    front(x, ds2.conv_out_lengths(torch.tensor([120, 90], device=dev)))
    assert flags == [False, False] and conv.fprop_launches == before


# the failed captures last: a capture that fails leaves its stream behind


def test_pageable_copy_under_capture_raises(dev):
    """A host-to-device copy of pageable memory inside a capture (a
    ``torch.tensor`` of a list) raises; it does not pass silently."""
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError):
        with torch.cuda.graph(graph):
            torch.tensor([1.0, 2.0], device=dev)


def test_step_graphs_capture_failure_raises(dev):
    """A step that reads a value back to the host cannot be captured: the
    capture raises (after the eager warm-up ran), and no eager step stands
    in for it; the launch counters are left as they were."""
    import types

    from deepspeech_tpu_torch.ops.cuda import stft
    from deepspeech_tpu_torch.train.graph import StepGraphs

    def syncing_step(state, batch, generator=None):
        out = _fake_step(state, batch, generator)
        out["host"] = torch.full((), out["mag"].sum().item(), device=dev)
        return out

    state = types.SimpleNamespace(step=torch.zeros((), dtype=torch.int64,
                                                   device=dev))
    graphs = StepGraphs(syncing_step, state, None)
    batch = {"audio": torch.ones((2, 4000), device=dev)}
    graphs(batch)
    before = (stft.launches, int(state.step))
    with pytest.raises(RuntimeError):
        graphs(batch)
    assert (stft.launches, int(state.step)) == before
    assert graphs.replays == 0


if __name__ == "__main__" and sys.argv[1:2] == ["--dp-rank"]:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _dp_rank(int(sys.argv[2]), sys.argv[3])
