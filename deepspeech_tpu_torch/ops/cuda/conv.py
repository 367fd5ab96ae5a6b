"""Wrapper of the conv front's tensor-core products (``csrc/conv_mma.cu``).

The two convolutions of ``models/ds2.py:ConvFrontend`` in a bf16
configuration: the forward of both, the input gradient of the second
(the spectrogram needs none) and the weight gradient of both, as implicit
GEMMs with bf16 operands and f32 sums. They replace no TPU kernel: the
JAX package's conv front is banded einsums (``deepspeech_tpu/ops/
banded_conv.py``, bf16 operands, ``preferred_element_type=float32``). For
CPU tensors ``ConvBF16`` runs the plain twins beside it (``plain_fprop``,
``plain_dgrad``, ``plain_wgrad``); for CUDA tensors it launches the kernels
or raises.

Numbers: the forward's operands are bf16 values, so its products are
exact and it is the f32 conv of the rounded operands up to the order of
its f32 sums. The gradients read dy as ``split_hi_lo(dy)``, two bf16 terms
that keep 16 significant bits, and round dx and dw to bf16 as the backward
of the model's rounding (``x.to(bf16).float()``) does. The bias gradient
is dy's f32 sum. The weight gradient's partial sums go to scratch from
``torch.empty`` (``wgrad_splits`` of them, a function of the shapes and
the card) and a second launch adds them in order: the same bits on every
run, captured or not.

``on_kernels`` picks this path where the compute type is bf16 and the
tensors are on the card; everywhere else the model keeps ``F.conv2d`` in f32 of
the rounded operands (cuDNN with TF32 off on the card).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from deepspeech_tpu_torch.ops.cuda import build

# kernel launches since the caller last reset them
fprop_launches = 0   # forward, either conv
dgrad_launches = 0   # conv1's input gradient
wgrad_launches = 0   # the weight gradients' partial sums, either conv
reduce_launches = 0  # their second pass


class Geometry(NamedTuple):
    cin: int
    rows: int          # input rows (frequency bins)
    kernel: tuple
    stride: tuple
    padding: tuple


# conv0 and conv1 of ConvFrontend, the only shapes the kernels take
GEOMETRIES = (Geometry(1, 161, (41, 11), (2, 2), (20, 5)),
              Geometry(32, 81, (21, 11), (2, 1), (10, 5)))
CHANNELS = 32
WGRAD_FRAMES = 64      # frames of one wgrad item (the kernels' TK)
WGRAD_BLOCKS = {0: 2, 1: 8}  # wgrad blocks aimed at per SM

_P = ctypes.c_void_p
_I = ctypes.c_int


def on_kernels(device: torch.device, compute_dtype) -> bool:
    """Whether a conv runs on these kernels: bf16 on a CUDA device (else
    ``F.conv2d`` in f32)."""
    return compute_dtype == torch.bfloat16 and device.type == "cuda"


def geometry(weight: torch.Tensor, stride, padding) -> int:
    """Which of ``GEOMETRIES`` a conv is (0 or 1); raises on any other."""
    for i, g in enumerate(GEOMETRIES):
        if (tuple(weight.shape) == (CHANNELS, g.cin, *g.kernel)
                and tuple(stride) == g.stride
                and tuple(padding) == g.padding):
            return i
    raise ValueError(f"conv kernels: no kernel for weight "
                     f"{tuple(weight.shape)}, stride {tuple(stride)}, "
                     f"padding {tuple(padding)}")


def out_frames(conv: int, t_in: int) -> int:
    return (t_in - 1) // GEOMETRIES[conv].stride[1] + 1


def split_hi_lo(dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo) bf16 with hi = bf16(dy), lo = bf16(dy - hi): hi + lo
    holds dy to 2^-16 relative where lo is a normal bf16 number (to 2^-134
    absolute below that), as the kernels split it."""
    hi = dy.to(torch.bfloat16)
    return hi, (dy - hi.float()).to(torch.bfloat16)


def _joined(dy: torch.Tensor) -> torch.Tensor:
    hi, lo = split_hi_lo(dy.float())
    return hi.float() + lo.float()  # exact in f32


def plain_fprop(x, w, bias, conv: int) -> torch.Tensor:
    """The forward: f32 conv of bf16(x) with the bf16 weights, plus bias."""
    g = GEOMETRIES[conv]
    return F.conv2d(x.to(torch.bfloat16).float(), w.float(), bias.float(),
                    g.stride, g.padding)


def plain_dgrad(dy, w, conv: int, x_shape) -> torch.Tensor:
    """The input gradient from dy's hi + lo, rounded to bf16."""
    g = GEOMETRIES[conv]
    return torch.nn.grad.conv2d_input(
        tuple(x_shape), w.float(), _joined(dy), g.stride,
        g.padding).to(torch.bfloat16)


def plain_wgrad(dy, x, conv: int) -> torch.Tensor:
    """The weight gradient from bf16(x) and dy's hi + lo, bf16-rounded,
    in f32."""
    g = GEOMETRIES[conv]
    return torch.nn.grad.conv2d_weight(
        x.to(torch.bfloat16).float(), (CHANNELS, g.cin, *g.kernel),
        _joined(dy), g.stride, g.padding).to(torch.bfloat16).float()


def pack_fprop(w: torch.Tensor, conv: int) -> torch.Tensor:
    """The forward's weight layout, bf16: conv0 (32, 41 * 16), row kh's 11
    taps padded to 16 with zeros; conv1 (1, 21, 2, 11, 32, 16): [kh][half
    of the input channels][kw][out channel][input channel % 16]."""
    w = w.to(torch.bfloat16)
    if conv == 0:
        return F.pad(w.reshape(CHANNELS, 41, 11), (0, 5)).reshape(
            CHANNELS, 41 * 16).contiguous()
    return w.reshape(CHANNELS, 2, 16, 21, 11).permute(
        3, 1, 4, 0, 2).contiguous()[None]


def pack_dgrad(w: torch.Tensor) -> torch.Tensor:
    """conv1's input-gradient layout, bf16 (2, 11, 2, 11, 32, 16):
    [parity p of the output row][tap j][half of dy's channels][kw'][input
    channel][dy channel % 16] = w[co][ci][20 - p - 2 j][10 - kw'], zero
    at p 1, j 10. An output row r reads dy rows floor((r - 9) / 2) + j."""
    wf = w.to(torch.bfloat16).flip(2, 3)  # kernel rows 20 - i, taps kw'
    even = wf[:, :, 0::2]
    odd = F.pad(wf[:, :, 1::2], (0, 0, 0, 1))
    wd = torch.stack((even, odd))  # (p, co, ci, j, kw')
    return wd.reshape(2, 2, 16, CHANNELS, 11, 11).permute(
        0, 4, 1, 5, 3, 2).contiguous()


def wgrad_splits(conv: int, b: int, t: int, sms: int) -> int:
    """The weight gradient's partial sums: about WGRAD_BLOCKS[conv] blocks
    an SM (conv1's grid holds 21 kernel rows of them), at most one an
    item of the smallest row's (b, row, 64-frame chunk) items."""
    chunks = -(-t // WGRAD_FRAMES)
    if conv == 0:
        return max(1, min(b * 81 * chunks, WGRAD_BLOCKS[0] * sms))
    return max(1, min(b * 36 * chunks,
                      math.ceil(WGRAD_BLOCKS[1] * sms / 21)))


@functools.cache
def _kernel():
    lib = build.load("conv_mma")
    lib.conv0_fprop_bf16.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    lib.conv1_fprop_bf16.argtypes = [_P] * 4 + [_I] * 2 + [_P]
    lib.conv1_dgrad_bf16.argtypes = [_P] * 3 + [_I] * 2 + [_P]
    lib.conv0_wgrad_bf16.argtypes = [_P] * 3 + [_I] * 4 + [_P]
    lib.conv1_wgrad_bf16.argtypes = [_P] * 3 + [_I] * 3 + [_P]
    lib.conv_wgrad_reduce.argtypes = [_P, _P, _I, _I, _P]
    for f in ("conv0_fprop_bf16", "conv1_fprop_bf16", "conv1_dgrad_bf16",
              "conv0_wgrad_bf16", "conv1_wgrad_bf16", "conv_wgrad_reduce"):
        getattr(lib, f).restype = _I
    return lib


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_input(x: torch.Tensor, conv: int) -> None:
    g = GEOMETRIES[conv]
    if x.ndim != 4 or x.shape[1] != g.cin or x.shape[2] != g.rows:
        raise ValueError(f"conv{conv} kernels take (B, {g.cin}, {g.rows}, "
                         f"T), got {tuple(x.shape)}")
    want = torch.float32 if conv == 0 else torch.bfloat16
    if x.dtype != want:
        raise TypeError(f"conv{conv} kernels take a {want} input, got "
                        f"{x.dtype}")


def _launch_args(t: torch.Tensor):
    return (torch.cuda.current_stream(t.device).cuda_stream,
            torch.cuda.device(t.device))


def fprop(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
          conv: int) -> torch.Tensor:
    """The forward of conv ``conv`` -> (B, 32, rows out, T) f32. x: conv0
    (B, 1, 161, T_in) f32 (rounded to bf16 here), conv1 (B, 32, 81, T)
    bf16; w (32, cin, kh, kw) bf16 values; bias (32,) f32."""
    _check_input(x, conv)
    if x.device.type == "cpu":
        return plain_fprop(x, w, bias, conv)
    if x.device.type != "cuda":
        raise ValueError(f"conv kernels: unsupported device {x.device}")
    b, _, rows, t_in = x.shape
    t = out_frames(conv, t_in)
    out = torch.empty((b, CHANNELS, (rows - 1) // 2 + 1, t),
                      dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    x, wp = x.contiguous(), pack_fprop(w, conv)
    bias = bias.float().contiguous()
    lib = _kernel()
    stream, ctx = _launch_args(x)
    with ctx:
        if conv == 0:
            code = lib.conv0_fprop_bf16(x.data_ptr(), wp.data_ptr(),
                                        bias.data_ptr(), out.data_ptr(), b,
                                        t_in, t, stream)
        else:
            code = lib.conv1_fprop_bf16(x.data_ptr(), wp.data_ptr(),
                                        bias.data_ptr(), out.data_ptr(), b,
                                        t, stream)
    build.check(lib, code, f"conv{conv} forward kernel")
    global fprop_launches
    fprop_launches += 1
    return out


def dgrad(dy: torch.Tensor, w: torch.Tensor, conv: int,
          x_shape) -> torch.Tensor:
    """The input gradient of conv1 -> (B, 32, 81, T) bf16 from dy (B, 32,
    41, T) f32 and w (32, 32, 21, 11) bf16 values; conv0's raises (the
    spectrogram needs none)."""
    if conv != 1:
        raise ValueError("conv kernels: conv0's input gradient has no "
                         "kernel (the spectrogram needs none)")
    if dy.device.type == "cpu":
        return plain_dgrad(dy, w, conv, x_shape)
    if dy.device.type != "cuda":
        raise ValueError(f"conv kernels: unsupported device {dy.device}")
    b, _, _, t = dy.shape
    dx = torch.empty(tuple(x_shape), dtype=torch.bfloat16, device=dy.device)
    if dx.numel() == 0:
        return dx
    dy, wp = dy.float().contiguous(), pack_dgrad(w)
    lib = _kernel()
    stream, ctx = _launch_args(dy)
    with ctx:
        code = lib.conv1_dgrad_bf16(dy.data_ptr(), wp.data_ptr(),
                                    dx.data_ptr(), b, t, stream)
    build.check(lib, code, "conv1 input-gradient kernel")
    global dgrad_launches
    dgrad_launches += 1
    return dx


def wgrad(dy: torch.Tensor, x: torch.Tensor, conv: int) -> torch.Tensor:
    """The weight gradient of conv ``conv`` -> (32, cin, kh, kw) f32 of
    bf16 values, from dy (B, 32, rows out, T) f32 and the forward's x."""
    _check_input(x, conv)
    if dy.device.type == "cpu":
        return plain_wgrad(dy, x, conv)
    if dy.device.type != "cuda":
        raise ValueError(f"conv kernels: unsupported device {dy.device}")
    g = GEOMETRIES[conv]
    b, _, _, t = dy.shape
    dw = torch.empty((CHANNELS, g.cin, *g.kernel), dtype=torch.float32,
                     device=dy.device)
    if dy.numel() == 0:
        return dw.zero_()
    s = wgrad_splits(conv, b, t, _sms(dy.device.index or 0))
    part = torch.empty(s * dw.numel(), dtype=torch.float32, device=dy.device)
    dy, x = dy.float().contiguous(), x.contiguous()
    lib = _kernel()
    stream, ctx = _launch_args(dy)
    with ctx:
        if conv == 0:
            code = lib.conv0_wgrad_bf16(dy.data_ptr(), x.data_ptr(),
                                        part.data_ptr(), b, x.shape[-1], t,
                                        s, stream)
        else:
            code = lib.conv1_wgrad_bf16(dy.data_ptr(), x.data_ptr(),
                                        part.data_ptr(), b, t, s, stream)
        build.check(lib, code, f"conv{conv} weight-gradient kernel")
        code = lib.conv_wgrad_reduce(part.data_ptr(), dw.data_ptr(), conv, s,
                                     stream)
    build.check(lib, code, f"conv{conv} weight-gradient reduction")
    global wgrad_launches, reduce_launches
    wgrad_launches += 1
    reduce_launches += 1
    return dw


class ConvBF16(torch.autograd.Function):
    """One conv of the front in a bf16 configuration: the forward, dgrad
    and wgrad kernels (the plain twins on the CPU), the bias gradient as
    dy's f32 sum. x: conv0's f32 spectrogram (rounded here) or conv1's
    bf16 activations; weight and bias the module's f32 parameters."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv):
        wb = weight.to(torch.bfloat16)
        ctx.save_for_backward(x, wb)
        ctx.conv = conv
        return fprop(x, wb, bias, conv)

    @staticmethod
    def backward(ctx, dy):
        x, wb = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dy = dy.float().contiguous()
        dx = (dgrad(dy, wb, ctx.conv, x.shape).to(x.dtype) if need_x
              else None)
        dw = wgrad(dy, x, ctx.conv) if need_w else None
        db = dy.sum((0, 2, 3)) if need_b else None
        return dx, dw, db, None


def conv2d_bf16(x, weight, bias, stride, padding) -> torch.Tensor:
    """``F.conv2d`` of ``ConvFrontend``'s convs in a bf16 configuration,
    on the tensor-core kernels (f32 result)."""
    conv = geometry(weight, stride, padding)
    x = x.float() if conv == 0 else x.to(torch.bfloat16)
    return ConvBF16.apply(x, weight, bias, conv)
