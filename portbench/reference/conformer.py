"""A plain PyTorch Conformer-CTC: the yardstick that decides ``correct``
for a Conformer configuration.

The model of arXiv:2005.08100 (Fig. 1, Table 1), with a linear CTC head in
place of its RNN-T decoder, written from the paper and these equations
alone with library calls only:

* featurize: the int16 wire scaled back, ``torch.stft`` (centred, reflect
  padding, symmetric Hann window of ``window_size``) power, an 80-band mel
  filterbank on the Slaney scale with Slaney's area norm (``mel_matrix``,
  built band by band in float64), log(x + 2**-24), each band less its
  mean and over its standard deviation (n - 1) + 1e-5 over the row's
  valid frames, zero past them;
* subsampling: two 3x3 stride-2 convs with ReLU, no padding, each output
  zeroed past the row's frames ((T - 3) // 2 + 1 each time; at least 1
  after the second), then a linear layer over the channel-major features,
  times sqrt(d);
* each block: x + FFN/2, + MHSA, + Conv, + FFN/2, then LayerNorm; FFN =
  LayerNorm, linear to ``ff``, Swish, linear back; MHSA = LayerNorm,
  q, k, v projections, the scores (q + u) . k + (q + v) . p_(i-j) over
  sqrt(dk), with p the sinusoid of the distance i - j through a bias-free
  projection (looked up by an index matrix, ``rel_scores``), keys past the
  row's length (at least its first) masked, softmax, the output
  projection; Conv = LayerNorm, pointwise to 2d, GLU, padded frames
  zeroed, a depthwise conv (k // 2 zeros before, k - 1 - k // 2 after),
  BatchNorm over the channels, Swish, pointwise back;
* the head: a linear layer, log-softmax, ``F.ctc_loss`` (float64) with
  the blank at 0 (``ds2.mean_loss``);
* a train step: the mean loss over the real rows, the gradients, clip by
  global norm, Adam (bias-corrected, eps outside the square root).

BatchNorm in train mode takes its moments over every position, padding
included, as the program's does; running statistics are not updated. No
dropout (the configurations run at 0). On the card each block is
recomputed in the backward (``torch.utils.checkpoint``), so the f32
reference at the timed sizes fits beside nothing else; the products are
the same.

``operand`` rounds the operands of every product (the inputs and weights
of each linear layer and conv, q + u, q + v, k, p, the probabilities and
v) straight through, as ``reference/ds2.py`` does: "bfloat16" is what a
bf16 configuration states, "float8_e4m3fn" the control one step below.

Departures from the paper, as the configuration's ``assumed`` lists them:
the CTC head, the front's window and normalization, the subsampling's
form, the even kernel's padding, the position encoding's form (ESPnet's
``RelPositionMultiHeadedAttention``). Nothing here imports the program
under test.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.ds2 import (BN_DRAWS, BN_EPS, mask_of, mean_loss,
                                     precision, rounded)

LN_EPS = 1e-5
LOG_GUARD = 2.0 ** -24
STD_EPS = 1e-5
LN_DRAWS = {"weight": (0.5, 1.5), "bias": (-0.5, 0.5)}


def param_specs(cfg: dict) -> list:
    """[(name, shape, low, high)]: every parameter and BatchNorm buffer,
    each drawn from U(low, high): PyTorch's default bound for a linear
    layer's or conv's weight and bias (1/sqrt(fan in)), Xavier's for the
    per-head biases, ``LN_DRAWS`` and ``ds2.BN_DRAWS`` for the norms."""
    d, h, ff, k = cfg["d_model"], cfg["heads"], cfg["ff"], cfg["conv_kernel"]
    dk = d // h
    out = []

    def uniform(name, shape, fan):
        b = 1.0 / math.sqrt(fan)
        out.append((name, shape, -b, b))

    def lin(name, n_in, n_out, bias=True):
        uniform(f"{name}.weight", (n_out, n_in), n_in)
        if bias:
            uniform(f"{name}.bias", (n_out,), n_in)

    def norm(name, draws, n):
        out.extend((f"{name}.{key}", (n,), lo, hi)
                   for key, (lo, hi) in draws.items())

    uniform("subsample.conv0.weight", (d, 1, 3, 3), 9)
    uniform("subsample.conv0.bias", (d,), 9)
    uniform("subsample.conv1.weight", (d, d, 3, 3), 9 * d)
    uniform("subsample.conv1.bias", (d,), 9 * d)
    lin("subsample.out", d * sub_bands(cfg["n_mels"]), d)
    xavier = math.sqrt(6.0 / (h + dk))
    for i in range(cfg["layers"]):
        b = f"blocks.{i}"
        for f in ("ffn1", "ffn2"):
            norm(f"{b}.{f}.norm", LN_DRAWS, d)
            lin(f"{b}.{f}.linear1", d, ff)
            lin(f"{b}.{f}.linear2", ff, d)
        norm(f"{b}.mhsa.norm", LN_DRAWS, d)
        for p in ("q", "k", "v", "out"):
            lin(f"{b}.mhsa.linear_{p}", d, d)
        lin(f"{b}.mhsa.linear_pos", d, d, bias=False)
        out.append((f"{b}.mhsa.pos_bias_u", (h, dk), -xavier, xavier))
        out.append((f"{b}.mhsa.pos_bias_v", (h, dk), -xavier, xavier))
        norm(f"{b}.conv_module.norm", LN_DRAWS, d)
        lin(f"{b}.conv_module.pointwise1", d, 2 * d)
        uniform(f"{b}.conv_module.depthwise.weight", (d, 1, k), k)
        uniform(f"{b}.conv_module.depthwise.bias", (d,), k)
        norm(f"{b}.conv_module.bn", BN_DRAWS, d)
        lin(f"{b}.conv_module.pointwise2", d, d)
        norm(f"{b}.norm", LN_DRAWS, d)
    lin("head", d, cfg["num_classes"])
    return out


def sub_bands(n_mels: int) -> int:
    """Mel bands left after the two 3x3 stride-2 convs."""
    return ((n_mels - 3) // 2 + 1 - 3) // 2 + 1


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The configuration's weights from ``seed``: one uniform draw of every
    element on ``device``, cut into the tensors and moved to each one's
    range. The same seed gives the same weights."""
    specs = param_specs(cfg)
    n = sum(math.prod(shape) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.empty(n, device=device).uniform_(0.0, 1.0, generator=gen)
    out, at = {}, 0
    for name, shape, lo, hi in specs:
        k = math.prod(shape)
        out[name] = flat[at:at + k].view(shape) * (hi - lo) + lo
        at += k
    return out


def is_param(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


# -- the front ---------------------------------------------------------------

def mel_matrix(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) float64: band m is the triangle from mel
    point m to m + 2 (points even on Slaney's scale from 0 to sr / 2),
    peak 1 at point m + 1, times 2 / (its width in Hz)."""
    def to_mel(f):
        return f / (200.0 / 3) if f < 1000.0 else (
            15.0 + math.log(f / 1000.0) * 27.0 / math.log(6.4))

    def to_hz(m):
        return m * 200.0 / 3 if m < 15.0 else (
            1000.0 * math.exp((m - 15.0) * math.log(6.4) / 27.0))

    top = to_mel(sr / 2.0)
    points = [to_hz(top * i / (n_mels + 1)) for i in range(n_mels + 2)]
    bins = [sr / 2.0 * j / (n_fft // 2) for j in range(n_fft // 2 + 1)]
    out = np.zeros((n_mels, len(bins)))
    for m in range(n_mels):
        lo, mid, hi = points[m:m + 3]
        for j, f in enumerate(bins):
            rise, fall = (f - lo) / (mid - lo), (hi - f) / (hi - mid)
            out[m, j] = max(0.0, min(rise, fall)) * 2.0 / (hi - lo)
    return out


def featurize(audio: torch.Tensor, scale: torch.Tensor | None,
              lengths: torch.Tensor, cfg: dict):
    """Wire rows -> (normalized log-mel (B, n_mels, T) f32, frames (B,))."""
    sr = cfg["sample_rate"]
    n_fft = int(sr * (cfg["window_size"] + 1e-8))
    hop = int(sr * (cfg["window_stride"] + 1e-8))
    x = audio.float()
    if scale is not None:
        x = x * scale.float()[:, None]
    window = torch.from_numpy(scipy.signal.get_window(
        cfg["window"], n_fft, fftbins=False)).to(x.device, torch.float32)
    power = torch.stft(x, n_fft, hop_length=hop, win_length=n_fft,
                       window=window, center=True, pad_mode="reflect",
                       return_complex=True).abs() ** 2
    fb = torch.from_numpy(mel_matrix(sr, n_fft, cfg["n_mels"])).to(
        x.device, torch.float32)
    spect = torch.log(torch.einsum("mf,bft->bmt", fb, power) + LOG_GUARD)
    frames = 1 + lengths.to(x.device) // hop
    mask = mask_of(frames, spect.shape[-1])[:, None]
    n = mask.sum(-1, keepdim=True)
    mean = (spect * mask).sum(-1, keepdim=True) / n.clamp(min=1.0)
    std = torch.sqrt((((spect - mean) * mask) ** 2).sum(-1, keepdim=True)
                     / (n - 1).clamp(min=1.0))
    return (spect - mean) / (std + STD_EPS) * mask, frames


# -- the model ---------------------------------------------------------------

def conv_lengths(n: torch.Tensor) -> torch.Tensor:
    return (n - 3) // 2 + 1


def dense(x, w, name, op):
    """x @ W^T (+ b), both operands rounded to ``op``."""
    y = rounded(x, op) @ rounded(w[f"{name}.weight"], op).t()
    b = w.get(f"{name}.bias")
    return y if b is None else y + b


def layer_norm(x, w, name):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"],
                        w[f"{name}.bias"], LN_EPS)


def swish(x):
    return x * torch.sigmoid(x)


def sinusoids(t: int, d: int, device) -> torch.Tensor:
    """(2T - 1, d): row r the distance T - 1 - r, columns sin and cos of it
    over 10000^(2m/d), interleaved."""
    dist = torch.arange(t - 1, -t, -1, device=device, dtype=torch.float64)
    freq = 10000.0 ** (-torch.arange(0, d, 2, device=device,
                                     dtype=torch.float64) / d)
    out = torch.zeros(2 * t - 1, d, device=device, dtype=torch.float64)
    out[:, 0::2] = torch.sin(dist[:, None] * freq)
    out[:, 1::2] = torch.cos(dist[:, None] * freq)
    return out.float()


def rel_scores(qv: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(B, H, T, dk) queries, (H, 2T - 1, dk) position keys -> (B, H, T, T)
    with [i, j] = qv_i . p_r, r the row of distance i - j (T - 1 - i + j),
    through an index matrix."""
    t = qv.shape[2]
    i = torch.arange(t, device=qv.device)
    rows = (t - 1 - i[:, None] + i[None, :])  # (T, T)
    table = torch.einsum("bhid,hrd->bhir", qv, p)  # (B, H, T, 2T - 1)
    return table.gather(-1, rows[None, None].expand(*table.shape[:2], t, t))


def mhsa(x, pos, lengths, w, b, heads, op):
    bsz, t, d = x.shape
    dk = d // heads
    h = layer_norm(x, w, f"{b}.norm")

    def split(y):
        return y.reshape(bsz, t, heads, dk).permute(0, 2, 1, 3)

    q = split(dense(h, w, f"{b}.linear_q", op))
    k = split(dense(h, w, f"{b}.linear_k", op))
    v = split(dense(h, w, f"{b}.linear_v", op))
    p = dense(pos, w, f"{b}.linear_pos", op).reshape(2 * t - 1, heads,
                                                     dk).permute(1, 0, 2)
    qu = q + w[f"{b}.pos_bias_u"][None, :, None, :]
    qv = q + w[f"{b}.pos_bias_v"][None, :, None, :]
    scores = (rounded(qu, op) @ rounded(k, op).transpose(-1, -2)
              + rel_scores(rounded(qv, op), rounded(p, op))) / math.sqrt(dk)
    keys = mask_of(lengths.clamp(min=1), t) > 0
    scores = scores.masked_fill(~keys[:, None, None, :], float("-inf"))
    out = rounded(torch.softmax(scores, -1), op) @ rounded(v, op)
    out = out.permute(0, 2, 1, 3).reshape(bsz, t, d)
    return dense(out, w, f"{b}.linear_out", op)


def conv_module(x, lengths, w, b, kernel, op):
    h = F.glu(dense(layer_norm(x, w, f"{b}.norm"), w, f"{b}.pointwise1", op),
              -1)
    h = (h * mask_of(lengths, h.shape[1])[..., None]).transpose(1, 2)
    h = F.pad(h, (kernel // 2, kernel - 1 - kernel // 2))
    h = F.conv1d(rounded(h, op), rounded(w[f"{b}.depthwise.weight"], op),
                 w[f"{b}.depthwise.bias"], groups=h.shape[1])
    mean = h.mean((0, 2), keepdim=True)
    var = ((h - mean) ** 2).mean((0, 2), keepdim=True)
    h = ((h - mean) * torch.rsqrt(var + BN_EPS)
         * w[f"{b}.bn.weight"][:, None] + w[f"{b}.bn.bias"][:, None])
    return dense(swish(h).transpose(1, 2), w, f"{b}.pointwise2", op)


def feed_forward(x, w, b, op):
    h = swish(dense(layer_norm(x, w, f"{b}.norm"), w, f"{b}.linear1", op))
    return dense(h, w, f"{b}.linear2", op)


def block(x, pos, lengths, w, i, cfg, op):
    b = f"blocks.{i}"
    x = x + 0.5 * feed_forward(x, w, f"{b}.ffn1", op)
    x = x + mhsa(x, pos, lengths, w, f"{b}.mhsa", cfg["heads"], op)
    x = x + conv_module(x, lengths, w, f"{b}.conv_module",
                        cfg["conv_kernel"], op)
    x = x + 0.5 * feed_forward(x, w, f"{b}.ffn2", op)
    return layer_norm(x, w, f"{b}.norm")


def subsample(spect, frames, w, cfg, op):
    """(B, n_mels, T) features, (B,) frames -> ((B, T', d), (B,) T')."""
    t1 = conv_lengths(frames).clamp(min=0)
    t2 = conv_lengths(t1).clamp(min=1)
    h = spect.transpose(1, 2)[:, None]
    for j, n in ((0, t1), (1, t2)):
        h = F.conv2d(rounded(h, op), rounded(w[f"subsample.conv{j}.weight"],
                                             op),
                     w[f"subsample.conv{j}.bias"], 2)
        h = F.relu(h) * mask_of(n, h.shape[2])[:, None, :, None]
    bsz, c, t, f = h.shape
    x = dense(h.permute(0, 2, 1, 3).reshape(bsz, t, c * f), w,
              "subsample.out", op) * math.sqrt(cfg["d_model"])
    return x, t2


def forward(w: dict, batch: dict, cfg: dict, operand: str | None = None,
            recompute: bool = False):
    """-> (logits (B, T', C), output lengths (B,)); the BatchNorms take the
    batch's moments (train mode)."""
    spect, frames = featurize(batch["audio"], batch.get("audio_scale"),
                              batch["audio_lengths"], cfg)
    x, t2 = subsample(spect, frames, w, cfg, operand)
    pos = sinusoids(x.shape[1], cfg["d_model"], x.device)
    for i in range(cfg["layers"]):
        if recompute:
            x = checkpoint(block, x, pos, t2, w, i, cfg, operand,
                           use_reentrant=False)
        else:
            x = block(x, pos, t2, w, i, cfg, operand)
    return dense(x, w, "head", operand), t2


def train_steps(w0: dict, batches: list, jitters: list, cfg: dict,
                operand: str | None = None, half_batch: bool = False):
    """len(batches) train steps of Adam from the weights ``w0`` -> dict of
    readings as ``ds2.train_steps`` gives them: ``loss`` (per step),
    ``grad`` (each parameter's first gradient as the optimizer takes it,
    clipped: its norm), ``change`` (each parameter's change after the last
    step: its norm). ``jitters`` are not read (the log-mel front takes
    none); ``half_batch`` leaves the second half of each batch's rows out
    of the loss."""
    opt = cfg["optimizer"]
    lr, b1, b2, eps = opt["lr"], opt["beta1"], opt["beta2"], opt["eps"]
    names = [n for n in w0 if is_param(n)]
    p = {n: w0[n].detach().clone() for n in names}
    buffers = {n: v for n, v in w0.items() if not is_param(n)}
    mu = {n: torch.zeros_like(v) for n, v in p.items()}
    nu = {n: torch.zeros_like(v) for n, v in p.items()}
    recompute = next(iter(w0.values())).device.type == "cuda"
    losses, first = [], None
    for step, batch in enumerate(batches, 1):
        leaves = {n: v.detach().requires_grad_(True) for n, v in p.items()}
        with precision(operand):
            logits, out_lengths = forward({**leaves, **buffers}, batch, cfg,
                                          operand, recompute)
            rows = None
            if half_batch:
                b = logits.shape[0]
                rows = torch.arange(b, device=logits.device) < b // 2
            loss = mean_loss(logits, out_lengths, batch, rows)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
            clip = (float(opt["max_norm"] / norm)
                    if float(norm) >= opt["max_norm"] else 1.0)
            for n, g in zip(names, grads):
                g = g * clip
                mu[n] = b1 * mu[n] + (1 - b1) * g
                nu[n] = b2 * nu[n] + (1 - b2) * g * g
                m_hat = mu[n] / (1 - b1 ** step)
                v_hat = nu[n] / (1 - b2 ** step)
                p[n] = p[n] - lr * m_hat / (torch.sqrt(v_hat) + eps)
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: float((mu[n] / (1 - b1)).double().norm())
                     for n in names}
    change = {n: float((p[n] - w0[n]).double().norm()) for n in names}
    return {"loss": losses, "grad": first, "change": change}
