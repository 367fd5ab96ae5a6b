"""Wrapper of the GRU layer-forward kernel (``csrc/gru_fwd.cu``).

Replaces ``deepspeech_tpu/ops/pallas/rnn_fused.py`` (``_gru_fused_fwd_kernel``
via ``bigru_layer_pallas`` / ``gru_layer_pallas``) in its inference variant,
input projection included. For CPU tensors the wrapper runs ``plain``, the
plain PyTorch loop beside it; for CUDA tensors it launches the kernel or
raises.

Semantics of both: time-major (T, B, F) layout, torch gate order r, z, n,
f32 state and f32 gates. With bf16 operands every product accumulates in
f32, the input projection stays f32, and the hidden dot rounds h_prev to
bf16. The backward direction reads each sequence reversed within its valid
length (pack_padded_sequence semantics); outputs at padded steps are zero.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepspeech_tpu_torch.ops import fp32_matmul
from deepspeech_tpu_torch.ops.cuda import build

launches = 0  # wrapper calls that launched the kernel (one per layer)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = {torch.float32: "gru_fwd_f32", torch.bfloat16: "gru_fwd_bf16"}


@functools.cache
def _kernel():
    lib = build.load("gru_fwd")
    for name in _ENTRY.values():
        getattr(lib, name).argtypes = [_P] * 9 + [_I] * 5 + [_P]
        getattr(lib, name).restype = _I
    return lib


def walk_index(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(T, B) time index of step s for each row of the backward direction:
    ``len - 1 - s`` inside the valid prefix, ``s`` past it. It is its own
    inverse, so it maps the walk back to time order as well."""
    s = torch.arange(t, device=lengths.device)[:, None]
    lens = lengths.to(s.dtype)[None, :]
    return torch.where(s < lens, lens - 1 - s, s)


def plain(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
          w_hh: torch.Tensor, b_hh: torch.Tensor,
          lengths: torch.Tensor) -> torch.Tensor:
    """GRU layer, one or two directions -> (D, T, B, H) f32, zero at steps
    past each row's length.

    x: (T, B, F); w_ih: (D, F, 3H); w_hh: (D, H, 3H), all in the operand
    type (float32 or bfloat16); b_ih, b_hh: (D, 3H); lengths: (B,).
    Direction 1, when present, runs backward in time."""
    ndir, hidden = w_hh.shape[0], w_hh.shape[1]
    t, b = x.shape[0], x.shape[1]
    lengths = lengths.to(x.device).clamp(max=t)
    with fp32_matmul():
        xp = torch.einsum("tbf,dfg->dtbg", x.float(), w_ih.float())
    xp = xp + b_ih.float()[:, None, None, :]
    idx = walk_index(lengths, t)
    if ndir == 2:
        gather = idx[:, :, None].expand(t, b, 3 * hidden)
        xp = torch.stack([xp[0], torch.gather(xp[1], 0, gather)])
    valid = (torch.arange(t, device=x.device)[:, None]
             < lengths[None, :])[None, :, :, None]  # (1, T, B, 1)
    w32 = w_hh.float()
    bh = b_hh.float()[:, None, :]
    h = torch.zeros((ndir, b, hidden), dtype=torch.float32, device=x.device)
    outs = []
    for s in range(t):
        with fp32_matmul():
            hp = torch.bmm(h.to(w_hh.dtype).float(), w32) + bh
        xs = xp[:, s]
        r = torch.sigmoid(xs[..., :hidden] + hp[..., :hidden])
        z = torch.sigmoid(xs[..., hidden:2 * hidden]
                          + hp[..., hidden:2 * hidden])
        n = torch.tanh(xs[..., 2 * hidden:] + r * hp[..., 2 * hidden:])
        h_new = (1.0 - z) * n + z * h
        keep = valid[:, s]
        h = torch.where(keep, h_new, h)
        outs.append(torch.where(keep, h_new, torch.zeros_like(h_new)))
    out = torch.stack(outs, dim=1)  # (D, T, B, H) in walk order
    if ndir == 2:
        gather = idx[:, :, None].expand(t, b, hidden)
        out = torch.stack([out[0], torch.gather(out[1], 0, gather)])
    return out


def gru_layer(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
              w_hh: torch.Tensor, b_hh: torch.Tensor,
              lengths: torch.Tensor) -> torch.Tensor:
    """GRU layer forward -> (D, T, B, H) f32, zero past each row's length.

    x (T, B, F), w_ih (D, F, 3H) and w_hh (D, H, 3H) share the operand type
    (float32 or bfloat16); b_ih, b_hh (D, 3H) f32; lengths (B,)."""
    if x.device.type == "cpu":
        return plain(x, w_ih, b_ih, w_hh, b_hh, lengths)
    if x.device.type != "cuda":
        raise ValueError(f"gru_layer: unsupported device {x.device}")
    dt = x.dtype
    if dt not in _ENTRY or w_ih.dtype != dt or w_hh.dtype != dt:
        raise TypeError(f"gru_layer kernel takes x, w_ih, w_hh all float32 "
                        f"or all bfloat16, got {x.dtype}, {w_ih.dtype}, "
                        f"{w_hh.dtype}")
    t, b, f_in = x.shape
    ndir, hidden, g = w_hh.shape
    if (g != 3 * hidden or w_ih.shape != (ndir, f_in, g)
            or b_ih.shape != (ndir, g) or b_hh.shape != (ndir, g)
            or lengths.shape != (b,) or ndir not in (1, 2)):
        raise ValueError("gru_layer: inconsistent shapes "
                         f"x {tuple(x.shape)} w_ih {tuple(w_ih.shape)} "
                         f"w_hh {tuple(w_hh.shape)} b_ih {tuple(b_ih.shape)} "
                         f"b_hh {tuple(b_hh.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    dev = x.device
    for name, a in (("w_ih", w_ih), ("b_ih", b_ih), ("w_hh", w_hh),
                    ("b_hh", b_hh), ("lengths", lengths)):
        if a.device != dev:
            raise ValueError(f"gru_layer: {name} on {a.device}, x on {dev}")
    lib = _kernel()
    x = x.contiguous()
    w_ih, w_hh = w_ih.contiguous(), w_hh.contiguous()
    b_ih = b_ih.float().contiguous()
    b_hh = b_hh.float().contiguous()
    lens = lengths.to(torch.int32).clamp(max=t).contiguous()
    xp = torch.empty((ndir, t, b, g), dtype=torch.float32, device=dev)
    state = torch.empty((2, ndir, b, hidden), dtype=torch.float32, device=dev)
    out = torch.empty((ndir, t, b, hidden), dtype=torch.float32, device=dev)
    fn = getattr(lib, _ENTRY[dt])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fn(x.data_ptr(), w_ih.data_ptr(), b_ih.data_ptr(),
                  w_hh.data_ptr(), b_hh.data_ptr(), lens.data_ptr(),
                  xp.data_ptr(), state.data_ptr(), out.data_ptr(),
                  t, b, f_in, hidden, ndir, stream)
    build.check(lib, code, "gru_fwd kernel")
    global launches
    launches += 1
    return out
