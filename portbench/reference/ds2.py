"""A plain PyTorch DeepSpeech2: the yardstick that decides ``correct``.

The model of arXiv:1512.02595 as the vadimkantorov/deepspeech.pytorch
training script defines it (``train.py`` defaults), written from that
description alone with library calls only:

* featurize: the int16 wire scaled back, ``torch.stft`` (centred, reflect
  padding, symmetric Hamming window) magnitude, the first 161 bins,
  ``log1p(x * 2**20)`` less the mean over each row's valid frames, zero
  past them, plus the row's max-frame jitter on the valid frames;
* two masked convs (41x11 s2x2 and 21x11 s2x1, 32 channels), each with
  BatchNorm over the channels and Hardtanh(0, 20), re-zeroed past each
  row's valid frames after each op;
* N bidirectional GRU layers, the directions summed, BatchNorm over the
  features before every layer but the first: in the train steps
  ``torch.nn.GRU`` over packed sequences (cuDNN on the card, TF32 off);
  in the eval forward a step loop of plain products in float64
  (``gru_scan``), the exact side of an f32 program's comparison;
* BatchNorm then a bias-free linear head, log-softmax, ``F.ctc_loss``
  (float64) with the blank at 0;
* a train step: the mean loss over the real rows, the gradients, clip by
  global norm, SGD with Nesterov momentum.

BatchNorm in train mode takes the moments over every position, padding
included, as the JAX package's model does (its statistics see the zeroed
padding). The running statistics are not updated: no compared number
reads them.

``operand`` rounds the operands of every convolution and of both products
of each recurrent layer to a lower precision (the input, W_ih and W_hh;
not the recurrent state inside cuDNN), straight through: the backward
pass sees the rounded forward and passes its gradient unrounded.
``"bfloat16"`` is what a bf16 configuration states; ``"float8_e4m3fn"``
(scaled per tensor by its largest magnitude) and ``"tf32"`` (also turning
TF32 on for cuBLAS and cuDNN) are the controls one step below the
configurations' precisions.

Weights are a dict of tensors under the names and layouts of
``param_specs``; nothing here imports the program under test.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

N_BINS = 161
CONVS = (  # (out channels, kernel (freq, time), stride, padding)
    (32, (41, 11), (2, 2), (20, 5)),
    (32, (21, 11), (2, 1), (10, 5)),
)
BN_EPS = 1e-5
F8_MAX = 448.0  # the largest finite float8_e4m3fn


def conv_features(n_bins: int = N_BINS) -> int:
    """Features a frame after the conv front: channels x frequency rows."""
    f = n_bins
    for _, (kf, _), (sf, _), (pf, _) in CONVS:
        f = (f + 2 * pf - kf) // sf + 1
    return CONVS[-1][0] * f


# a BatchNorm's draws, at magnitudes a trained model's hold: (low, high)
BN_DRAWS = {"weight": (0.5, 1.5), "bias": (-0.5, 0.5),
            "running_mean": (-0.5, 0.5), "running_var": (0.5, 2.0)}


def param_specs(cfg: dict) -> list:
    """[(name, shape, low, high)]: every parameter and BatchNorm buffer of
    the configuration's model, each drawn from U(low, high): PyTorch's
    default for the module's weights and biases (U(-1/sqrt(fan),
    1/sqrt(fan))), ``BN_DRAWS`` for a BatchNorm's."""
    h, layers = cfg["hidden_size"], cfg["hidden_layers"]
    d = 2 if cfg["bidirectional"] else 1
    c = cfg["num_classes"]
    out = []

    def bn(prefix, n):
        out.extend((f"{prefix}.{k}", (n,), lo, hi)
                   for k, (lo, hi) in BN_DRAWS.items())

    def uniform(name, shape, bound):
        out.append((name, shape, -bound, bound))

    cin = 1
    for i, (cout, (kf, kt), _, _) in enumerate(CONVS):
        bound = 1.0 / math.sqrt(cin * kf * kt)
        uniform(f"conv.conv{i}.weight", (cout, cin, kf, kt), bound)
        uniform(f"conv.conv{i}.bias", (cout,), bound)
        bn(f"conv.bn{i}", cout)
        cin = cout
    f_in = conv_features()
    for i in range(layers):
        if i > 0:
            bn(f"rnns.{i}.bn", f_in)
        bound = 1.0 / math.sqrt(h)
        uniform(f"rnns.{i}.w_ih", (d, f_in, 3 * h), bound)
        uniform(f"rnns.{i}.b_ih", (d, 3 * h), bound)
        uniform(f"rnns.{i}.w_hh", (d, h, 3 * h), bound)
        uniform(f"rnns.{i}.b_hh", (d, 3 * h), bound)
        f_in = h
    bn("fc_bn", h)
    uniform("fc.weight", (c, h), 1.0 / math.sqrt(h))
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The configuration's weights from ``seed``: one uniform draw of every
    element on ``device`` (a seeded ``torch.Generator`` there), cut into
    the tensors and moved to each one's range. The same seed gives the
    same weights."""
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


# -- precision ---------------------------------------------------------------

def quantize(x: torch.Tensor, operand: str | None) -> torch.Tensor:
    """``x`` (f32) rounded to ``operand`` and back to f32."""
    if operand is None:
        return x
    if operand == "bfloat16":
        return x.to(torch.bfloat16).float()
    if operand == "tf32":  # round to nearest even on 10 mantissa bits
        i = x.contiguous().view(torch.int32)
        i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
        return i.view(torch.float32)
    if operand == "float8_e4m3fn":
        scale = x.abs().amax().clamp(min=1e-30) / F8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown operand precision {operand!r}")


def rounded(x: torch.Tensor, operand: str | None) -> torch.Tensor:
    """Straight-through rounding: the forward sees ``quantize(x)``, the
    backward passes the gradient unchanged."""
    if operand is None:
        return x
    return x + (quantize(x.detach(), operand) - x.detach())


@contextlib.contextmanager
def precision(operand: str | None):
    """Full f32 products (TF32 off) for the reference; TF32 on for the
    "tf32" control."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = operand == "tf32"
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


# -- the model ---------------------------------------------------------------

def mask_of(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B,) lengths -> (B, T) f32 {0, 1}."""
    return (torch.arange(t, device=lengths.device)[None, :]
            < lengths[:, None]).float()


def featurize(audio: torch.Tensor, scale: torch.Tensor | None,
              lengths: torch.Tensor, cfg: dict,
              jitter: torch.Tensor | None = None,
              dtype: torch.dtype = torch.float32):
    """Wire rows -> (normalized log spectrogram (B, 161, T) in ``dtype``,
    frames (B,))."""
    sr = cfg["sample_rate"]
    n_fft = int(sr * (cfg["window_size"] + 1e-8))
    hop = int(sr * (cfg["window_stride"] + 1e-8))
    x = audio.to(dtype)
    if scale is not None:
        x = x * scale.to(dtype)[:, None]
    window = torch.from_numpy(scipy.signal.get_window(
        cfg["window"], n_fft, fftbins=False)).to(x.device, dtype)
    mag = torch.stft(x, n_fft, hop_length=hop, win_length=n_fft,
                     window=window, center=True, pad_mode="reflect",
                     return_complex=True).abs()[:, :N_BINS]
    frames = 1 + lengths.to(x.device) // hop
    mask = mask_of(frames, mag.shape[-1])
    spect = torch.log1p(mag * 1048576.0)
    frame_mean = spect.mean(1)
    mean = (frame_mean * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)
    spect = (spect - mean[:, None, None]) * mask[:, None]
    if jitter is not None:
        spect = spect + jitter.to(dtype)[:, None, None] * mask[:, None]
    return spect, frames


def batch_norm(x: torch.Tensor, w: dict, prefix: str, axis: int,
               train: bool) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[axis] = -1
    if train:
        axes = [i for i in range(x.ndim) if i != axis % x.ndim]
        mean = x.mean(axes)
        var = ((x - mean.view(shape)) ** 2).mean(axes)
    else:
        mean, var = w[f"{prefix}.running_mean"], w[f"{prefix}.running_var"]
    return ((x - mean.view(shape)) * torch.rsqrt(var + BN_EPS).view(shape)
            * w[f"{prefix}.weight"].view(shape) + w[f"{prefix}.bias"]
            .view(shape))


def conv_front(spect: torch.Tensor, out_lengths: torch.Tensor, w: dict,
               train: bool, operand: str | None) -> torch.Tensor:
    """(B, 161, T) -> (T', B, 1312)."""
    h = spect[:, None]
    for i, (_, _, stride, pad) in enumerate(CONVS):
        h = F.conv2d(rounded(h, operand),
                     rounded(w[f"conv.conv{i}.weight"], operand),
                     w[f"conv.conv{i}.bias"], stride, pad)
        m = mask_of(out_lengths, h.shape[-1])[:, None, None, :]
        h = h * m
        h = batch_norm(h, w, f"conv.bn{i}", 1, train) * m
        h = h.clamp(0.0, 20.0) * m
    b, c, f, t = h.shape
    return h.reshape(b, c * f, t).permute(2, 0, 1)


def gru_layer(x: torch.Tensor, lengths: torch.Tensor, w: dict, i: int,
              hidden: int, bidirectional: bool,
              operand: str | None) -> torch.Tensor:
    """One (bi)directional GRU layer over (T, B, F) -> (T, B, H), the
    directions summed, zero past each row's length. The weights' layout
    is (D, F, 3H) / (D, H, 3H) with the gates in r, z, n order, the
    transpose of ``torch.nn.GRU``'s per direction."""
    t = x.shape[0]
    gru = torch.nn.GRU(x.shape[-1], hidden, bidirectional=bidirectional,
                       device="meta")
    params = {}
    for d, suffix in enumerate(("", "_reverse")[:2 if bidirectional else 1]):
        params[f"weight_ih_l0{suffix}"] = rounded(w[f"rnns.{i}.w_ih"][d],
                                                  operand).t()
        params[f"weight_hh_l0{suffix}"] = rounded(w[f"rnns.{i}.w_hh"][d],
                                                  operand).t()
        params[f"bias_ih_l0{suffix}"] = w[f"rnns.{i}.b_ih"][d]
        params[f"bias_hh_l0{suffix}"] = w[f"rnns.{i}.b_hh"][d]
    params = {k: v.contiguous() for k, v in params.items()}
    packed = pack_padded_sequence(rounded(x, operand), lengths.cpu(),
                                  enforce_sorted=False)
    y, _ = torch.func.functional_call(gru, params, (packed,))
    y, _ = pad_packed_sequence(y, total_length=t)
    return y[..., :hidden] + y[..., hidden:] if bidirectional else y


def gru_scan(x: torch.Tensor, lengths: torch.Tensor, w: dict, i: int,
             hidden: int, bidirectional: bool,
             operand: str | None) -> torch.Tensor:
    """``gru_layer`` as a loop over the steps of plain products in the
    tensors' own type (float64 for the exact reference): r, z, n = the
    gates of x @ W_ih + b_ih and h @ W_hh + b_hh, n = tanh(x_n + r * h_n),
    h = (1 - z) * n + z * h, held past each row's length; direction 1
    walks each row's valid steps backward."""
    t, b, _ = x.shape
    h3 = 3 * hidden
    w_ih = rounded(w[f"rnns.{i}.w_ih"], operand)
    w_hh = rounded(w[f"rnns.{i}.w_hh"], operand)
    xp = (torch.einsum("tbf,dfg->dtbg", rounded(x, operand), w_ih)
          + w[f"rnns.{i}.b_ih"][:, None, None, :])
    steps = torch.arange(t, device=x.device)[:, None]
    lens = lengths.to(x.device)[None, :]
    valid = steps < lens  # (T, B)
    # direction 1's walk, its own inverse: len - 1 - s inside each row
    back = torch.where(valid, lens - 1 - steps, steps)[..., None]
    if bidirectional:
        xp = torch.stack([xp[0], xp[1].gather(0, back.expand(-1, -1, h3))])
    h = x.new_zeros(xp.shape[0], b, hidden)
    b_hh = w[f"rnns.{i}.b_hh"][:, None, :]
    outs = []
    for s in range(t):
        hp = torch.baddbmm(b_hh, h, w_hh)
        xs = xp[:, s]
        r = torch.sigmoid(xs[..., :hidden] + hp[..., :hidden])
        z = torch.sigmoid(xs[..., hidden:2 * hidden]
                          + hp[..., hidden:2 * hidden])
        n = torch.tanh(xs[..., 2 * hidden:] + r * hp[..., 2 * hidden:])
        new = (1 - z) * n + z * h
        keep = valid[s][None, :, None]
        h = torch.where(keep, new, h)
        outs.append(torch.where(keep, new, 0.0))
    out = torch.stack(outs, 1)  # (D, T, B, H)
    if not bidirectional:
        return out[0]
    return out[0] + out[1].gather(0, back.expand(-1, -1, hidden))


def forward(w: dict, batch: dict, cfg: dict, train: bool,
            jitter: torch.Tensor | None = None, operand: str | None = None,
            layer=gru_layer, dtype: torch.dtype = torch.float32):
    """-> (logits (B, T', C) in ``dtype``, output lengths (B,)).
    ``batch``: audio, optional audio_scale, audio_lengths (tensors on one
    device); ``layer``: ``gru_layer`` (cuDNN) or ``gru_scan``."""
    spect, frames = featurize(batch["audio"], batch.get("audio_scale"),
                              batch["audio_lengths"], cfg, jitter, dtype)
    out_lengths = (frames - 1) // 2 + 1
    x = conv_front(spect, out_lengths, w, train, operand)
    for i in range(cfg["hidden_layers"]):
        if i > 0:
            x = batch_norm(x, w, f"rnns.{i}.bn", -1, train)
        x = layer(x, out_lengths, w, i, cfg["hidden_size"],
                  cfg["bidirectional"], operand)
    x = batch_norm(x, w, "fc_bn", -1, train)
    logits = x @ w["fc.weight"].t()
    return logits.transpose(0, 1), out_lengths


def mean_loss(logits, out_lengths, batch, rows=None):
    """(sum of the finite per-row CTC losses over the real rows) / (their
    count), in float64; ``rows`` (B,) bool, when given, keeps only those
    rows (a fault that leaves part of the batch out)."""
    log_probs = F.log_softmax(logits.double(), -1).transpose(0, 1)
    per = F.ctc_loss(log_probs, batch["targets"].long(), out_lengths.long(),
                     batch["target_lengths"].long(), blank=0,
                     reduction="none", zero_infinity=False)
    valid = batch["valid"] > 0
    if rows is not None:
        valid = valid & rows
    keep = valid & torch.isfinite(per)
    return torch.where(keep, per, 0.0).sum() / valid.sum().clamp(min=1)


def train_steps(w0: dict, batches: list, jitters: list, cfg: dict,
                operand: str | None = None, half_batch: bool = False):
    """len(batches) train steps from the weights ``w0`` -> dict of
    readings: ``loss`` (per step), ``grad`` (each parameter's first
    gradient as the optimizer takes it, clipped, by name: its norm),
    ``change`` (each parameter's change after the last step: its norm).
    ``half_batch`` plants a fault: each loss is the mean over the first
    half of the rows alone."""
    opt = cfg["optimizer"]
    lr, m, max_norm = opt["lr"], opt["momentum"], opt["max_norm"]
    names = [n for n in w0 if is_param(n)]
    p = {n: w0[n].detach().clone() for n in names}
    buffers = {n: v for n, v in w0.items() if not is_param(n)}
    trace = {n: torch.zeros_like(v) for n, v in p.items()}
    losses, first = [], None
    for batch, jitter in zip(batches, jitters):
        leaves = {n: v.detach().requires_grad_(True) for n, v in p.items()}
        with precision(operand):
            logits, out_lengths = forward({**leaves, **buffers}, batch, cfg,
                                          True, jitter, operand)
            rows = None
            if half_batch:
                b = logits.shape[0]
                rows = torch.arange(b, device=logits.device) < b // 2
            loss = mean_loss(logits, out_lengths, batch, rows)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
            clip = float(max_norm / norm) if float(norm) >= max_norm else 1.0
            for n, g in zip(names, grads):
                g = g * clip
                trace[n] = g + m * trace[n]
                p[n] = p[n] - lr * (g + m * trace[n])
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: float(trace[n].double().norm()) for n in names}
    change = {n: float((p[n] - w0[n]).double().norm()) for n in names}
    return {"loss": losses, "grad": first, "change": change}


def posteriors(w: dict, batch: dict, cfg: dict, operand: str | None = None):
    """Eval-mode forward through ``gru_scan`` -> (log-probs (B, T', C),
    output lengths). With no ``operand`` every product is float64, so the
    reference's own rounding lies far below an f32 program's; with one,
    float32 rounded to it (the "tf32" control: TF32 on besides)."""
    dtype = torch.float64 if operand is None else torch.float32
    w = {k: v.to(dtype) for k, v in w.items()}
    with torch.no_grad(), precision(operand):
        logits, out_lengths = forward(w, batch, cfg, False, None, operand,
                                      gru_scan, dtype)
        return F.log_softmax(logits, -1), out_lengths
