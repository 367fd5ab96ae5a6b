"""Wrappers of the CTC alpha and beta kernels (``csrc/ctc.cu``).

``ctc_alpha`` replaces ``deepspeech_tpu/ops/pallas/ctc_kernel.py``
(``_ctc_alpha_kernel`` via ``_run_alpha``) and ``ctc_beta`` replaces
``_ctc_beta_kernel`` (via ``_run_beta``). For CPU tensors each runs its
plain PyTorch twin (``plain_alpha``, ``plain_beta``); for CUDA tensors it
launches the kernel or raises.

Layout (batch-major, unlike the TPU kernels' time-major stream): emit
(B, T, S) f32, the per-state emission log-probs of the S = 2L + 1 states;
skip, valid, end (B, S) f32, 0 where the skip transition / state / final
state is allowed and -1e30 where not; lengths (B,) logit lengths. Both
recursions clamp at -1e30 and freeze past each row's length, in the TPU
kernels' order of operations.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepspeech_tpu_torch.ops.cuda import build

NEG_INF = -1e30

alpha_launches = 0  # ctc_alpha launches (one per loss call)
beta_launches = 0   # ctc_beta launches (one per loss backward)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _kernel():
    lib = build.load("ctc")
    lib.ctc_alpha_f32.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    lib.ctc_alpha_f32.restype = _I
    lib.ctc_beta_f32.argtypes = [_P] * 6 + [_I] * 3 + [_P]
    lib.ctc_beta_f32.restype = _I
    return lib


def logaddexp3(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """log(e^a + e^b + e^c), -1e30 where all three are at or below it."""
    m = torch.maximum(torch.maximum(a, b), c)
    dead = m <= NEG_INF
    ms = torch.where(dead, 0.0, m)
    s = torch.exp(a - ms) + torch.exp(b - ms) + torch.exp(c - ms)
    s = torch.where(dead, 1.0, s)
    return torch.where(dead, NEG_INF, ms + torch.log(s))


def _shift(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S) shifted by n states (right for n > 0), -1e30 filled."""
    pad = x.new_full((x.shape[0], abs(n)), NEG_INF)
    if n > 0:
        return torch.cat([pad, x[:, :-n]], 1)
    return torch.cat([x[:, -n:], pad], 1)


def plain_alpha(emit, skip, valid, lengths):
    """Alpha trajectory (B, T, S): alpha_t including frame t's emission."""
    b, t, s = emit.shape
    lengths = lengths.to(emit.device)
    lane = torch.arange(s, device=emit.device)
    alpha = torch.where(lane < 2, 0.0, NEG_INF)[None, :] + valid
    out = []
    for i in range(t):
        new = alpha if i == 0 else logaddexp3(
            alpha, _shift(alpha, 1), _shift(alpha, 2) + skip)
        new = torch.clamp(new + emit[:, i] + valid, min=NEG_INF)
        alpha = torch.where((i < lengths)[:, None], new, alpha)
        out.append(alpha)
    return torch.stack(out, 1)


def plain_beta(emit, skip, valid, end, lengths):
    """Beta trajectory plus emission (B, T, S), -1e30 past each length."""
    b, t, s = emit.shape
    lengths = lengths.to(emit.device)
    beta = emit.new_full((b, s), NEG_INF)
    skip2 = _shift(skip, -2)
    out = [None] * t
    for i in reversed(range(t)):
        trans = logaddexp3(beta, _shift(beta, -1), _shift(beta, -2) + skip2)
        here = torch.where((i == lengths - 1)[:, None], end, trans)
        here = torch.clamp(here + emit[:, i] + valid, min=NEG_INF)
        active = (i < lengths)[:, None]
        here = torch.where(active, here, NEG_INF)
        beta = torch.where(active, here, beta)
        out[i] = here
    return torch.stack(out, 1)


def _check(name, emit, lengths, **tables):
    if emit.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {emit.device}")
    if emit.dtype != torch.float32 or emit.ndim != 3:
        raise TypeError(f"{name} kernel takes (B, T, S) float32 emissions, "
                        f"got {emit.dtype} {tuple(emit.shape)}")
    b, _, s = emit.shape
    for key, a in tables.items():
        if a.shape != (b, s) or a.dtype != torch.float32:
            raise ValueError(f"{name}: {key} {a.dtype} {tuple(a.shape)}, "
                             f"expected float32 {(b, s)}")
        if a.device != emit.device:
            raise ValueError(f"{name}: {key} on {a.device}")
    if lengths.shape != (b,) or lengths.device != emit.device:
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)} on "
                         f"{lengths.device}")


def ctc_alpha(emit, skip, valid, lengths):
    """K8: alpha trajectory (B, T, S); arguments as ``plain_alpha``."""
    if emit.device.type == "cpu":
        return plain_alpha(emit, skip, valid, lengths)
    _check("ctc_alpha", emit, lengths, skip=skip, valid=valid)
    b, t, s = emit.shape
    emit, skip, valid = emit.contiguous(), skip.contiguous(), \
        valid.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(emit)
    lib = _kernel()
    stream = torch.cuda.current_stream(emit.device).cuda_stream
    with torch.cuda.device(emit.device):
        code = lib.ctc_alpha_f32(emit.data_ptr(), skip.data_ptr(),
                                 valid.data_ptr(), lens.data_ptr(),
                                 out.data_ptr(), b, t, s, stream)
    build.check(lib, code, "ctc_alpha kernel")
    global alpha_launches
    alpha_launches += 1
    return out


def ctc_beta(emit, skip, valid, end, lengths):
    """K9: beta + emission trajectory (B, T, S); arguments as
    ``plain_beta``."""
    if emit.device.type == "cpu":
        return plain_beta(emit, skip, valid, end, lengths)
    _check("ctc_beta", emit, lengths, skip=skip, valid=valid, end=end)
    b, t, s = emit.shape
    emit, skip, valid, end = (a.contiguous() for a in (emit, skip, valid,
                                                       end))
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(emit)
    lib = _kernel()
    stream = torch.cuda.current_stream(emit.device).cuda_stream
    with torch.cuda.device(emit.device):
        code = lib.ctc_beta_f32(emit.data_ptr(), skip.data_ptr(),
                                valid.data_ptr(), end.data_ptr(),
                                lens.data_ptr(), out.data_ptr(), b, t, s,
                                stream)
    build.check(lib, code, "ctc_beta kernel")
    global beta_launches
    beta_launches += 1
    return out
