"""The conv front's tensor-core route (``ops/cuda/conv.py``) on the CPU.

The kernels (``csrc/conv_mma.cu``) run only on the card
(``tests/test_torch_cuda.py``); here: dy's hi/lo split, the route rule and
which entry point the front calls, the autograd Function's plain twins
against ``F.conv2d`` and its gradients at both convs' shapes, and PyTorch
models of the kernels' index arithmetic (the packed weight layouts, the
output rows' input rows and parities, the weight gradient's partial layout
and its transposing reduction, the frame copies of conv1's wgrad) against
the convolutions they compute.
"""

import types

import pytest
import torch
import torch.nn.functional as F

from deepspeech_tpu_torch.models import ds2
from deepspeech_tpu_torch.ops.cuda import conv

BF16 = torch.bfloat16
TINY = 2.0 ** -134  # half the spacing of bf16's subnormals


def _rounded(t):
    return t.to(BF16).float()


def test_split_hi_lo_keeps_16_bits():
    """hi is bf16(dy) bit for bit; hi + lo is dy to 2^-16 relative where lo
    is normal, to 2^-134 absolute near f32's smallest normal; zeros stay
    zero, large values below bf16's largest finite stay finite, NaN stays
    NaN."""
    g = torch.Generator().manual_seed(0)
    normal = torch.randn(4096, generator=g) * torch.exp2(
        torch.randint(-60, 60, (4096,), generator=g).float())
    tiny = torch.tensor([1.17549435e-38, -1.17549435e-38, 1.5e-38, 2.9e-38,
                         1.0e-36, 5.9e-39])
    big = torch.tensor([1e38, -1e38, 3e38, -3e38, 3.3e38])
    zeros = torch.tensor([0.0, -0.0])
    dy = torch.cat([normal, tiny, big, zeros, torch.tensor([float("nan")])])
    hi, lo = conv.split_hi_lo(dy)
    assert hi.dtype == lo.dtype == BF16
    assert torch.equal(hi.view(torch.int16), dy.to(BF16).view(torch.int16))
    joined = hi.double() + lo.double()
    err = (joined - dy.double()).abs()
    fin = torch.isfinite(dy)
    bound = torch.maximum(2.0 ** -16 * dy.double().abs(),
                          torch.full_like(err, TINY))
    assert bool((err[fin] <= bound[fin]).all())
    assert bool(torch.isfinite(joined[fin]).all())
    assert bool((err[:4096] <= 2.0 ** -16 * dy[:4096].double().abs()).all())
    assert bool((joined[-3:-1] == 0).all())
    assert bool(hi[-1].isnan()) and bool(lo[-1].isnan())
    # the f32 sum of the two terms is exact: the twins join them so
    assert torch.equal((hi.float() + lo.float())[fin].double(), joined[fin])


def test_route_follows_compute_dtype_and_device():
    assert conv.on_kernels(torch.device("cuda"), BF16)
    assert conv.on_kernels(torch.device("cuda", 0), BF16)
    assert not conv.on_kernels(torch.device("cuda"), None)
    assert not conv.on_kernels(torch.device("cpu"), BF16)
    assert not conv.on_kernels(torch.device("cpu"), None)


def _front_inputs(seed=0, b=3, t=45):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 161, t, generator=g)
    lengths = torch.tensor([t, t - 7, t - 20][:b])
    x[1, :, t - 7:] = 0
    x[2, :, t - 20:] = 0
    return x, ds2.conv_out_lengths(lengths)


@pytest.mark.parametrize("cd,card", [(None, False), (None, True),
                                     (BF16, False), (BF16, True)])
def test_front_calls_the_routed_entry_point(monkeypatch, cd, card):
    """The front calls ``conv.conv2d_bf16`` (the kernels' Function) where
    ``on_kernels`` says so, else ``F.conv2d``; ``card`` makes
    ``on_kernels`` answer as it does for CUDA tensors, so the Function
    runs its plain twins here, and its forward equals the f32 route's bit
    for bit."""
    calls = []
    real = conv.conv2d_bf16

    def kernel_entry(*a):
        calls.append("kernel")
        return real(*a)

    def f32_entry(*a, **k):
        calls.append("f32")
        return F.conv2d(*a, **k)

    monkeypatch.setattr(conv, "conv2d_bf16", kernel_entry)
    monkeypatch.setattr(ds2, "F", types.SimpleNamespace(conv2d=f32_entry))
    if card:
        monkeypatch.setattr(conv, "on_kernels",
                            lambda device, dtype: dtype == BF16)
    torch.manual_seed(0)
    front = ds2.ConvFrontend(compute_dtype=cd)
    x, out_lengths = _front_inputs()
    got = front(x, out_lengths)
    want = "kernel" if card and cd == BF16 else "f32"
    assert calls == [want, want]
    if want == "kernel":
        monkeypatch.setattr(conv, "on_kernels", lambda device, dtype: False)
        calls.clear()
        assert torch.equal(got, front(x, out_lengths))
        assert calls == ["f32", "f32"]


def _operands(c, t_in, seed):
    """x, w, bias and a dy for conv ``c`` at T_in frames, with a masked
    tail in the second row of x and of dy."""
    g = conv.GEOMETRIES[c]
    gen = torch.Generator().manual_seed(seed)
    t = conv.out_frames(0, t_in)
    x = (torch.randn(2, 1, 161, t_in, generator=gen) if c == 0
         else torch.randn(2, 32, 81, t, generator=gen).to(BF16))
    x[1, ..., x.shape[-1] - 5:] = 0
    w = torch.randn(32, g.cin, *g.kernel, generator=gen) * 0.05
    bias = torch.randn(32, generator=gen)
    rows = (g.rows + 2 * g.padding[0] - g.kernel[0]) // g.stride[0] + 1
    dy = torch.randn(2, 32, rows, t, generator=gen)
    dy[1, ..., t - 3:] = 0
    return x, w, bias, dy


def _near(a, b, terms):
    """|a - b| within one bf16 ulp of b (2^-7 relative at most) plus 2^-14
    of ``terms``, the sum of the products' magnitudes: dy's hi + lo (2^-16
    of each product) and f32 sums in another order, under cancellation."""
    return bool(((a.double() - b.double()).abs()
                 <= 2.0 ** -7 * b.double().abs() + 2.0 ** -14 * terms).all())


@pytest.mark.parametrize("t_in", [57, 60])   # T' 29 (odd) and 30 (even)
@pytest.mark.parametrize("c", [0, 1])
def test_function_plain_twins_match_conv2d(c, t_in):
    """``ConvBF16`` on CPU tensors (its plain twins) against ``F.conv2d`` on
    the rounded operands with autograd, today's f32 route: the forward bit
    for bit, dw and dx within one bf16 ulp and 2^-14 of the sum of the
    products' magnitudes (dy's hi + lo against dy), the bias gradient to f32
    sums; conv0 makes no input gradient."""
    g = conv.GEOMETRIES[c]
    x, w, bias, dy = _operands(c, t_in, seed=10 + c)
    xa = x.clone().requires_grad_(c == 1)
    wa, ba = w.clone().requires_grad_(), bias.clone().requires_grad_()
    got = conv.ConvBF16.apply(xa, wa, ba, c)
    got.backward(dy)
    xr = x.clone().requires_grad_(c == 1)
    wr, br = w.clone().requires_grad_(), bias.clone().requires_grad_()
    ref = F.conv2d(_rounded(xr), _rounded(wr), br, g.stride, g.padding)
    ref.backward(dy)
    assert got.dtype == torch.float32 and torch.equal(got, ref)
    xm, wm, dym = (_rounded(x).double().abs(), _rounded(w).double().abs(),
                   dy.double().abs())
    assert _near(wa.grad, wr.grad, torch.nn.grad.conv2d_weight(
        xm, w.shape, dym, g.stride, g.padding))
    assert torch.equal(wa.grad, _rounded(wa.grad))
    torch.testing.assert_close(ba.grad, br.grad, rtol=0,
                               atol=2.0 ** -20 * float(dym.sum()))
    if c == 1:
        assert xa.grad.dtype == BF16 and _near(
            xa.grad, xr.grad, torch.nn.grad.conv2d_input(
                x.shape, wm, dym, g.stride, g.padding))
        assert bool((xa.grad[1, ..., -5:] != 0).any())  # read from dy
    else:
        assert xa.grad is None


def test_function_skips_conv0_dgrad(monkeypatch):
    """conv0's input gradient is never asked for: the spectrogram needs
    none, and on the card it has no kernel."""
    def refuse(*a, **k):
        raise AssertionError("dgrad called for conv0")

    monkeypatch.setattr(conv, "dgrad", refuse)
    x, w, bias, dy = _operands(0, 40, seed=3)
    w.requires_grad_()
    conv.ConvBF16.apply(x, w, bias, 0).backward(dy[..., :20])
    assert w.grad is not None


def test_dgrad_refuses_conv0_on_every_device():
    """The twin and the kernel take the same inputs: conv0's input gradient
    raises on the CPU as on the card."""
    x, w, _, dy = _operands(0, 40, seed=4)
    with pytest.raises(ValueError):
        conv.dgrad(dy[..., :20], w, 0, x.shape)


def test_geometry_refuses_other_convs():
    assert conv.geometry(torch.empty(32, 1, 41, 11), (2, 2), (20, 5)) == 0
    assert conv.geometry(torch.empty(32, 32, 21, 11), (2, 1), (10, 5)) == 1
    with pytest.raises(ValueError):
        conv.geometry(torch.empty(32, 32, 21, 11), (2, 2), (10, 5))
    with pytest.raises(ValueError):
        conv.geometry(torch.empty(64, 32, 21, 11), (2, 1), (10, 5))


# ---- models of the kernels' index arithmetic -----------------------------

def _model_fprop0(x, wp, bias):
    """fprop0's walk: xs[kh][2 t + kw] of the bf16 rows 2 fo - 20 + kh,
    frames 2 t - 5 + kw, against the packed (32, 41 * 16) weights."""
    xb = _rounded(x)[:, 0]
    b, _, t_in = xb.shape
    t = conv.out_frames(0, t_in)
    xp = F.pad(xb, (5, 5 + 16, 20, 20))
    w = wp.float().view(32, 41, 16)
    out = torch.zeros(b, 32, 81, t)
    for kh in range(41):
        rows = xp[:, kh:kh + 2 * 81:2]
        for kw in range(16):
            out += torch.einsum("bft,n->bnft", rows[..., kw:kw + 2 * t:2],
                                w[:, kh, kw])
    return out + bias[None, :, None, None]


def _model_rowconv(inp, wp, rout, dgrad):
    """rowconv's walk: output row r reads input rows base(r) + j for the
    j that lie inside, stage (j, half), tap kw at frame t + kw - 5,
    weights wp[par(r)][j][half][kw][n][c]."""
    b, _, rin, t = inp.shape
    ip = F.pad(inp.float(), (5, 5))
    w = wp.float()
    out = torch.zeros(b, 32, rout, t)
    for r in range(rout):
        if dgrad:
            base, nj, par = (r - 9) >> 1, 11 - (r & 1), r & 1
        else:
            base, nj, par = 2 * r - 10, 21, 0
        for j in range(max(0, -base), min(nj, rin - base)):
            for half in range(2):
                for kw in range(11):
                    a = ip[:, 16 * half:16 * half + 16, base + j, kw:kw + t]
                    out[:, :, r] += torch.einsum("bct,nc->bnt", a,
                                                 w[par, j, half, kw])
    return out


@pytest.mark.parametrize("t_in", [57, 60])
def test_fprop_layouts_compute_the_convs(t_in):
    x0, w0, b0, _ = _operands(0, t_in, seed=20)
    want0 = F.conv2d(_rounded(x0), _rounded(w0), b0, (2, 2), (20, 5))
    got0 = _model_fprop0(x0, conv.pack_fprop(w0, 0), b0)
    torch.testing.assert_close(got0, want0, rtol=1e-4, atol=1e-4)
    x1, w1, b1, _ = _operands(1, t_in, seed=21)
    wp = conv.pack_fprop(w1, 1)
    assert wp.shape == (1, 21, 2, 11, 32, 16) and wp.dtype == BF16
    want1 = F.conv2d(x1.float(), _rounded(w1), b1, (2, 1), (10, 5))
    got1 = _model_rowconv(x1, wp, 41, False) + b1[None, :, None, None]
    torch.testing.assert_close(got1, want1, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t_in", [57, 60])
def test_dgrad_layout_computes_the_input_gradient(t_in):
    """pack_dgrad's parities and flipped taps over consecutive dy rows give
    conv1's input gradient."""
    x, w, _, dy = _operands(1, t_in, seed=30)
    wp = conv.pack_dgrad(w)
    assert wp.shape == (2, 11, 2, 11, 32, 16)
    assert not bool(wp[1, 10].float().any())
    want = torch.nn.grad.conv2d_input(x.shape, _rounded(w), dy, (2, 1),
                                      (10, 5))
    got = _model_rowconv(dy, wp, 81, True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_wgrad1_partials_and_reduction_layout():
    """wgrad1's rows fo of each kernel row (those whose input row lies
    inside h), its partials (co, kh, kw, c) and the reduction's transpose
    to (co, c, kh, kw)."""
    for kh in range(21):
        lo, hi = max(0, (11 - kh) >> 1), min(41, (90 - kh) // 2 + 1)
        assert list(range(lo, hi)) == [fo for fo in range(41)
                                       if 0 <= 2 * fo + kh - 10 < 81]
        assert hi - lo >= 36  # wgrad_splits' smallest row count
    x, w, _, dy = _operands(1, 60, seed=40)
    t = dy.shape[-1]
    xp = F.pad(x.float(), (5, 5, 10, 10))
    part = torch.zeros(32, 21, 11, 32)
    for kh in range(21):
        for kw in range(11):
            a = xp[:, :, kh:kh + 2 * 41:2, kw:kw + t]
            part[:, kh, kw] = torch.einsum("bofs,bcfs->oc", dy, a)
    flat = part.reshape(-1)
    i = torch.arange(flat.numel())
    c, kw = i % 32, (i // 32) % 11
    kh, co = (i // (32 * 11)) % 21, i // (32 * 11 * 21)
    dw = torch.empty_like(flat)
    dw[((co * 32 + c) * 21 + kh) * 11 + kw] = flat
    want = torch.nn.grad.conv2d_weight(x.float(), (32, 32, 21, 11), dy,
                                       (2, 1), (10, 5))
    torch.testing.assert_close(dw.view(32, 32, 21, 11), want, rtol=1e-4,
                               atol=1e-4)


def test_wgrad1_frame_copies_give_aligned_tap_pairs():
    """x0 holds frames f0 - 6 + u, x1 frames f0 - 5 + u: for every even
    frame offset tl of a pair and tap kw, the kernel's word (tl + kw +
    (kw & 1)) / 2 of x0 (odd kw) or x1 (even kw) starts at frame f0 + tl +
    kw - 5, within the 74 frames staged."""
    for tl in range(0, 64, 2):
        for kw in range(11):
            word = (tl + kw + (kw & 1)) >> 1
            start = (-6 if kw & 1 else -5) + 2 * word
            assert start == tl + kw - 5
            assert 2 * word + 1 < 74


def test_wgrad_splits():
    assert conv.wgrad_splits(1, 64, 637, 132) == 51
    assert conv.wgrad_splits(0, 64, 637, 132) == 264
    assert conv.wgrad_splits(1, 1, 1, 132) == 36
    assert conv.wgrad_splits(0, 1, 1, 132) == 81
