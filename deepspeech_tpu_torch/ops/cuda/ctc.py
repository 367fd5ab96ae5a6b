"""Wrappers of the CTC alpha and beta kernels (``csrc/ctc.cu``).

``ctc_alpha`` replaces ``deepspeech_tpu/ops/pallas/ctc_kernel.py``
(``_ctc_alpha_kernel`` via ``_run_alpha``, with the loss of ``_ctc_fwd``)
and ``ctc_beta`` replaces ``_ctc_beta_kernel`` (via ``_run_beta``) together
with ``_ctc_bwd``'s closed-form gradient. For CPU tensors each runs its
plain PyTorch twin (``plain_alpha``, ``plain_beta``); for CUDA tensors it
launches the kernel or raises.

Layout (batch-major, unlike the TPU kernels' time-major stream): log_probs
(B, T, C) f32, the log-softmax of the logits; ext (B, S) int, the
blank-extended labels of the S = 2L + 1 states (ext[:, 0] is the blank);
target_lengths and lengths (B,), the label and logit lengths. The kernels
gather each state's emission log_probs[b, t, ext[b, s]] themselves, from
the row staged in shared memory, and derive the skip / valid / end state
tables (``tables``) from ext and the target lengths. Both recursions clamp
at -1e30 and freeze past each row's length, in the TPU kernels' order of
operations.

Each kernel has two routes, chosen before the launch by a fixed rule on
(S, C) (``route``): the staged ring, which holds the per-state rows in
shared memory (``ring_plan``), wherever it fits one block, and the global
route otherwise, which keeps those rows in global memory and only the
log-prob ring in shared memory (``global_plan``), so that any S is taken.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepspeech_tpu_torch.ops.cuda import build

NEG_INF = -1e30

alpha_launches = 0  # ctc_alpha launches (one per loss call)
beta_launches = 0   # ctc_beta launches (one per loss backward)

# The staging ring (csrc/ctc.cu): RING stages of `chunk` frames, the rows
# of both rings within RING_BYTES, chunks of 2 to MAX_CHUNK frames; one
# block's shared memory holds at most SMEM_MAX bytes on the H100.
RING, MAX_CHUNK, MIN_CHUNK = 4, 32, 2
RING_BYTES = 64 * 1024
SMEM_MAX = 232_448

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _kernel():
    lib = build.load("ctc")
    lib.ctc_alpha_f32.argtypes = [_P] * 6 + [_I] * 5 + [_P]
    lib.ctc_alpha_f32.restype = _I
    lib.ctc_beta_f32.argtypes = [_P] * 9 + [_I] * 5 + [_P]
    lib.ctc_beta_f32.restype = _I
    lib.ctc_alpha_global_f32.argtypes = [_P] * 7 + [_I] * 5 + [_P]
    lib.ctc_alpha_global_f32.restype = _I
    lib.ctc_beta_global_f32.argtypes = [_P] * 10 + [_I] * 5 + [_P]
    lib.ctc_beta_global_f32.restype = _I
    return lib


def _ring_smem(s: int, c: int, beta: bool) -> tuple[int, int]:
    if beta:
        per_frame, fixed = RING * (c + s), 4 * s + 2 * c + 1 + s
    else:
        per_frame, fixed = RING * c, 2 * s
    chunk = max(MIN_CHUNK, min(MAX_CHUNK, RING_BYTES // (4 * per_frame)))
    return chunk, 4 * (fixed + chunk * per_frame)


def ring_plan(s: int, c: int, beta: bool) -> tuple[int, int]:
    """(chunk frames, dynamic shared-memory bytes) of K8's ring route
    (``beta`` False: the previous and current rows and a ring of log-prob
    rows) or K9's (also two gamma rows, a ring of alpha rows and the label
    states sorted by class). Raises where even the least chunk does not
    fit one block's shared memory."""
    chunk, smem = _ring_smem(s, c, beta)
    if smem > SMEM_MAX:
        raise ValueError(
            f"ctc_{'beta' if beta else 'alpha'}: S {s}, C {c} need {smem} "
            f"bytes of shared memory, more than one block's {SMEM_MAX}")
    return chunk, smem


def global_plan(c: int) -> tuple[int, int]:
    """(chunk frames, dynamic shared-memory bytes) of either kernel's
    global route: only the ring of log-prob rows. Raises for a class count
    whose least ring does not fit one block."""
    chunk = max(MIN_CHUNK, min(MAX_CHUNK, RING_BYTES // (4 * RING * c)))
    smem = 4 * RING * chunk * c
    if smem > SMEM_MAX:
        raise ValueError(f"ctc: C {c} needs {smem} bytes of shared memory "
                         f"for its log-prob ring, more than {SMEM_MAX}")
    return chunk, smem


def route(s: int, c: int, beta: bool) -> str:
    """"ring" where ``ring_plan`` fits one block's shared memory, else
    "global"; K8 (``beta`` False) or K9 at S states and C classes."""
    return "ring" if _ring_smem(s, c, beta)[1] <= SMEM_MAX else "global"


def beta_workspace_words(s: int, c: int) -> int:
    """4-byte words of K9's global-route workspace a row (csrc/ctc.cu
    ``beta_ws_words``): two beta rows, two sorted gamma rows, the state
    words and the sorted places, then the class table."""
    return 6 * s + 2 * c + 1


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


def tables(ext: torch.Tensor, target_lengths: torch.Tensor):
    """The skip / valid / end state tables (B, S) f32, 0 where the s-2 skip
    transition / the state / the final state is allowed and -1e30 where
    not; ext[:, 0], the blank, stands before state 0."""
    b, s = ext.shape
    dev = ext.device
    prev2 = torch.cat([ext[:, :1].expand(b, 2), ext[:, :-2]], 1)
    lane = torch.arange(s, device=dev)[None, :]
    can_skip = (lane % 2 == 1) & (ext != prev2)
    skip = torch.where(can_skip, 0.0, NEG_INF)
    tl = target_lengths.to(dev)[:, None]
    valid = torch.where(lane < 2 * tl + 1, 0.0, NEG_INF)
    end = torch.where((lane == 2 * tl) | ((lane == 2 * tl - 1) & (tl > 0)),
                      0.0, NEG_INF)
    return skip, valid, end


def emissions(log_probs: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """Each state's emission log-prob (B, T, S)."""
    b, t, _ = log_probs.shape
    return torch.gather(log_probs, 2,
                        ext.long()[:, None, :].expand(b, t, ext.shape[1]))


def alpha_recursion(emit, skip, valid, lengths):
    """Alpha trajectory (B, T, S) from the emissions: alpha_t including
    frame t's emission."""
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


def beta_recursion(emit, skip, valid, end, lengths):
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


def loss_from_alpha(alpha_last, target_lengths):
    """-log(alpha_last at the two end states), +inf where both are dead."""
    tl = target_lengths.to(alpha_last.device).long()
    end_blank = alpha_last.gather(1, (2 * tl)[:, None])[:, 0]
    end_label = alpha_last.gather(1, (2 * tl - 1).clamp(min=0)[:, None])[:, 0]
    end_label = torch.where(tl > 0, end_label, NEG_INF)
    m = torch.maximum(end_blank, end_label)
    dead = m <= NEG_INF
    ms = torch.where(dead, 0.0, m)
    sm = torch.exp(end_blank - ms) + torch.exp(end_label - ms)
    sm = torch.where(dead, 1.0, sm)
    total = torch.where(dead, -torch.inf, ms + torch.log(sm))
    return -total


def plain_alpha(log_probs, ext, target_lengths, lengths):
    """(alphas (B, T, S), loss (B,)): the gather, the alpha recursion and
    the loss at each row's last frame."""
    skip, valid, _ = tables(ext, target_lengths)
    lengths = lengths.to(log_probs.device)
    alphas = alpha_recursion(emissions(log_probs, ext), skip, valid, lengths)
    idx = (lengths.long() - 1).clamp(min=0)
    alpha_last = alphas[torch.arange(alphas.shape[0],
                                     device=alphas.device), idx]
    return alphas, loss_from_alpha(alpha_last, target_lengths)


def occupancy(gamma: torch.Tensor, ext: torch.Tensor, c: int):
    """Class occupancy (B, T, C): each state's gamma summed into its
    label's class."""
    b, t, s = gamma.shape
    return gamma.new_zeros((b, t, c)).scatter_add_(
        2, ext.long()[:, None, :].expand(b, t, s), gamma)


def plain_beta(log_probs, ext, target_lengths, lengths, alphas, loss, g,
               with_betas: bool = False):
    """dlogits (B, T, C) of the loss, scaled by g (B,), by the beta
    recursion and the closed form (and, with ``with_betas``, also the beta
    + emission trajectory (B, T, S))."""
    skip, valid, end = tables(ext, target_lengths)
    lengths = lengths.to(log_probs.device)
    emit = emissions(log_probs, ext)
    betas = beta_recursion(emit, skip, valid, end, lengths)
    sample_ok = torch.isfinite(loss)[:, None, None]
    # emission is counted in both alpha and beta: remove one copy
    log_gamma = alphas + betas - emit + loss[:, None, None]
    gamma = torch.where(sample_ok & (log_gamma > -80.0),
                        torch.exp(log_gamma.clamp(max=0.0)), 0.0)
    b, t, c = log_probs.shape
    frame_ok = (torch.arange(t, device=lengths.device)[None, :]
                < lengths[:, None])[..., None]
    dlogits = torch.where(frame_ok & sample_ok,
                          torch.exp(log_probs) - occupancy(gamma, ext, c),
                          0.0)
    # rows zeroed above stay 0 even when g is not finite there
    dlogits = torch.where(sample_ok, dlogits * g[:, None, None], 0.0)
    return (dlogits, betas) if with_betas else dlogits


def _check(name, log_probs, ext, **rows):
    if log_probs.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {log_probs.device}")
    if log_probs.dtype != torch.float32 or log_probs.ndim != 3:
        raise TypeError(f"{name} kernel takes (B, T, C) float32 log-probs, "
                        f"got {log_probs.dtype} {tuple(log_probs.shape)}")
    b = log_probs.shape[0]
    if ext.ndim != 2 or ext.shape[0] != b or ext.device != log_probs.device:
        raise ValueError(f"{name}: ext {tuple(ext.shape)} on {ext.device}")
    for key, a in rows.items():
        if a.shape[0] != b or a.device != log_probs.device:
            raise ValueError(f"{name}: {key} {tuple(a.shape)} on {a.device}")


def _i32(x):
    return x.to(torch.int32).contiguous()


def _route(s: int, c: int, beta: bool, how: str | None) -> str:
    how = how or route(s, c, beta)
    if how not in ("ring", "global"):
        raise ValueError(f"ctc: unknown route {how!r}")
    return how


def ctc_alpha(log_probs, ext, target_lengths, lengths):
    """K8: (alphas (B, T, S), loss (B,)); arguments as ``plain_alpha``.
    ``route`` picks the kernel's route."""
    if log_probs.device.type == "cpu":
        return plain_alpha(log_probs, ext, target_lengths, lengths)
    return _alpha(log_probs, ext, target_lengths, lengths, None)


def _alpha(log_probs, ext, target_lengths, lengths, how: str | None):
    """K8's launch on the route ``how`` ("ring" or "global"; None:
    ``route``'s choice). The tests and chip_smoke.py name a route to hold
    each one; the model's path takes ``ctc_alpha``."""
    _check("ctc_alpha", log_probs, ext, target_lengths=target_lengths,
           lengths=lengths)
    b, t, c = log_probs.shape
    s = ext.shape[1]
    how = _route(s, c, False, how)
    chunk, _ = (ring_plan(s, c, beta=False) if how == "ring"
                else global_plan(c))
    lp = log_probs.contiguous()
    ext, tls, lens = _i32(ext), _i32(target_lengths), _i32(lengths)
    alphas = lp.new_empty((b, t, s))
    loss = lp.new_empty((b,))
    lib = _kernel()
    stream = torch.cuda.current_stream(lp.device).cuda_stream
    with torch.cuda.device(lp.device):
        if how == "ring":
            code = lib.ctc_alpha_f32(lp.data_ptr(), ext.data_ptr(),
                                     tls.data_ptr(), lens.data_ptr(),
                                     alphas.data_ptr(), loss.data_ptr(), b,
                                     t, s, c, chunk, stream)
        else:
            words = torch.empty((b, s), dtype=torch.int32, device=lp.device)
            code = lib.ctc_alpha_global_f32(
                lp.data_ptr(), ext.data_ptr(), tls.data_ptr(),
                lens.data_ptr(), alphas.data_ptr(), loss.data_ptr(),
                words.data_ptr(), b, t, s, c, chunk, stream)
    build.check(lib, code, f"ctc_alpha kernel ({how} route)")
    global alpha_launches
    alpha_launches += 1
    return alphas, loss


def ctc_beta(log_probs, ext, target_lengths, lengths, alphas, loss, g,
             with_betas: bool = False):
    """K9: dlogits (B, T, C) (and, with ``with_betas``, beta + emission);
    arguments as ``plain_beta``. ``route`` picks the kernel's route."""
    if log_probs.device.type == "cpu":
        return plain_beta(log_probs, ext, target_lengths, lengths, alphas,
                          loss, g, with_betas)
    return _beta(log_probs, ext, target_lengths, lengths, alphas, loss, g,
                 with_betas, None)


def _beta(log_probs, ext, target_lengths, lengths, alphas, loss, g,
          with_betas: bool, how: str | None):
    """K9's launch on the route ``how``, as ``_alpha``'s."""
    _check("ctc_beta", log_probs, ext, target_lengths=target_lengths,
           lengths=lengths, alphas=alphas, loss=loss, g=g)
    b, t, c = log_probs.shape
    s = ext.shape[1]
    if alphas.shape != (b, t, s) or alphas.dtype != torch.float32:
        raise ValueError(f"ctc_beta: alphas {alphas.dtype} "
                         f"{tuple(alphas.shape)}, expected float32 "
                         f"{(b, t, s)}")
    how = _route(s, c, True, how)
    chunk, _ = (ring_plan(s, c, beta=True) if how == "ring"
                else global_plan(c))
    lp, alphas = log_probs.contiguous(), alphas.contiguous()
    loss = loss.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    ext, tls, lens = _i32(ext), _i32(target_lengths), _i32(lengths)
    dlogits = torch.empty_like(lp)
    betas = lp.new_empty((b, t, s)) if with_betas else None
    lib = _kernel()
    stream = torch.cuda.current_stream(lp.device).cuda_stream
    args = (lp.data_ptr(), ext.data_ptr(), tls.data_ptr(), lens.data_ptr(),
            alphas.data_ptr(), loss.data_ptr(), g.data_ptr(),
            dlogits.data_ptr(), betas.data_ptr() if with_betas else None)
    with torch.cuda.device(lp.device):
        if how == "ring":
            code = lib.ctc_beta_f32(*args, b, t, s, c, chunk, stream)
        else:
            ws = torch.empty((b, beta_workspace_words(s, c)),
                             dtype=torch.int32, device=lp.device)
            code = lib.ctc_beta_global_f32(*args, ws.data_ptr(), b, t, s, c,
                                           chunk, stream)
    build.check(lib, code, f"ctc_beta kernel ({how} route)")
    global beta_launches
    beta_launches += 1
    return (dlogits, betas) if with_betas else dlogits

