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
the same functions on the CPU from the same draws.
"""

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


@pytest.mark.parametrize("variant", ["step", "persistent"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("t,b,h", SCAN_SHAPES)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scan_kernel_matches_plain(dev, cell, dtype, tol, ndir, t, b, h,
                                   variant):
    """K4 and K6, inference and training, one launch a step and persistent
    (bf16; f32 has one variant), against plain_scan with the tolerances of
    K2 and K3 (the LSTM's c relative to its largest value). A persistent
    launch of a batch above one chunk raises: it never falls back."""
    from deepspeech_tpu_torch.ops.cuda import gru, lstm

    mod = gru if cell == "gru" else lstm
    scan = gru.gru_scan if cell == "gru" else lstm.lstm_scan
    args = _scan_case(dev, dtype, ndir, t, b, h, 3 if cell == "gru" else 4,
                      t + b + 5)
    if dtype == torch.bfloat16 and variant == "persistent" and b > 64:
        with pytest.raises(RuntimeError, match="scan kernel"):
            scan(*args, variant=variant)
        return
    before = (mod.scan_launches, mod.scan_res_launches, mod.launches)
    got = scan(*args, variant=variant)
    res = scan(*args, residuals=True, variant=variant)
    assert (mod.scan_launches, mod.scan_res_launches, mod.launches) == (
        before[0] + 2, before[1] + 1, before[2])
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
