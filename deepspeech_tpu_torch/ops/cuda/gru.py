"""Wrappers of the GRU layer kernels (``csrc/gru_fwd.cu``,
``csrc/gru_scan.cu``, ``csrc/gru_bwd.cu``) and the autograd Functions that
tie them together.

``gru_layer`` replaces ``deepspeech_tpu/ops/pallas/rnn_fused.py``
(``_gru_fused_fwd_kernel`` via ``bigru_layer_pallas`` / ``gru_layer_pallas``),
input projection included, in both variants: inference, and training
(``residuals=True``), which also returns the gate stream g = (r, z, n) and hn,
the hidden n-term before the r *, in the operand type. In bf16 (K2 on
tensor cores: ``csrc/proj_mma.cuh`` for the projection, ``csrc/rnn_mma.cuh``
for the recurrence on its f32 stream) it runs one of three variants,
``variant=`` "resident", "persistent" or "step", or by the rule
``recurrence.fwd_variant``; in f32 it keeps its SIMT kernels.
``gru_bwd`` replaces ``deepspeech_tpu/ops/pallas/rnn_kernel.py``
(``_gru_bwd_kernel`` via ``_gru_bwd``). ``gru_scan`` (K4) replaces
``rnn_kernel.py``
(``_gru_fwd_kernel`` via ``bigru_scan_pallas`` / ``gru_scan_pallas``): the
same recurrence on a projection computed outside and rounded to the
operand type, for the layers ``route.fused_route`` sends there; in f32
either one launch a step (K2's SIMT step kernel) or one persistent launch
that reads W_hh once a step for the whole batch (``variant=``, or the rule
``recurrence.scan_f32_variant``). For CPU
tensors each wrapper runs its plain PyTorch twin beside it (``plain``,
``plain_scan``, ``plain_bwd``); for CUDA tensors it launches the kernel or
raises.

In bf16 the backward ``gru_bwd`` (K5) runs its recurrent product on tensor
cores (``csrc/rnn_mma_bwd.cuh``: W_hh packed by
``recurrence.pack_w_hh_bwd``, one launch a step or one persistent launch,
``variant=``); in f32 it keeps its SIMT step kernel.

Semantics: time-major (T, B, F) layout, torch gate order r, z, n, f32 state
and f32 gates. With bf16 operands every product accumulates in f32, the
input projection stays f32, and the hidden dot rounds h_prev to bf16. The
backward direction reads each sequence reversed within its valid length
(pack_padded_sequence semantics); outputs and residuals at padded steps are
zero, and the backward ignores the output grads there.

``GRULayer`` is the layer's ``torch.autograd.Function``: the training
forward, then K5 for the recurrence's gradient and cuBLAS for the large
products dW_hh, dW_ih and dx (``rnn_kernel.py:475-486``,
``rnn_fused.py:_proj_grads``), as the JAX package leaves them to XLA.
``GRUScanLayer`` is K4's: K4 with residuals forward, K5 backward, and the
gradients of xp, b_ih, W_hh and b_hh (``_bigru_bwd_rule``,
``rnn_kernel.py:514-517``); dx and dW_ih come from autograd through the
projection outside.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepspeech_tpu_torch.ops import fp32_matmul
from deepspeech_tpu_torch.ops.cuda import build
from deepspeech_tpu_torch.ops.cuda.recurrence import (F32_LAYOUT,
                                                      bwd_blocks,
                                                      bwd_variant,
                                                      check_layer,
                                                      check_scan, dw_hh,
                                                      fwd_capacity,
                                                      fwd_mode, fwd_variant,
                                                      h_copy_shape,
                                                      h_copy_shape_f32,
                                                      h_prev_stream,
                                                      op_copy_shape,
                                                      pack_w_hh,
                                                      pack_w_hh_bwd,
                                                      pack_w_hh_f32,
                                                      proj_bwd,
                                                      resident_blocks,
                                                      same_device,
                                                      scan_f32_variant,
                                                      scan_variant,
                                                      to_time_order,
                                                      valid_mask,
                                                      walk_index)
from deepspeech_tpu_torch.utils import trace

launches = 0      # gru_fwd launches (one per layer call), both variants
res_launches = 0  # of those, the training variant's (residuals written)
proj_launches = 0  # the bf16 projection GEMM alone (``projection``)
scan_launches = 0      # gru_scan launches (K4, one per layer call)
scan_res_launches = 0  # of those, the training variant's
scan_f32_persistent_launches = 0  # of those, f32 in one persistent launch
bwd_launches = 0  # gru_bwd launches (one per layer backward)

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD = {torch.float32: "gru_fwd_f32", torch.bfloat16: "gru_fwd_bf16"}
_SCAN = {torch.float32: "gru_scan_f32", torch.bfloat16: "gru_scan_bf16"}
_BWD = {torch.float32: "gru_bwd_f32", torch.bfloat16: "gru_bwd_bf16"}


@functools.cache
def _fwd_kernel():
    lib = build.load("gru_fwd")
    lib.gru_fwd_f32.argtypes = [_P] * 11 + [_I] * 5 + [_P]
    lib.gru_fwd_bf16.argtypes = [_P] * 13 + [_I] * 6 + [_P]
    lib.gru_fwd_capacity.argtypes = [_I, _I, _P, _P]
    lib.proj_mma_bf16.argtypes = [_P] * 3 + [_I] * 4 + [_P]
    for name in (*_FWD.values(), "gru_fwd_capacity", "proj_mma_bf16"):
        getattr(lib, name).restype = _I
    return lib


@functools.cache
def _scan_kernel():
    lib = build.load("gru_scan")
    lib.gru_scan_f32.argtypes = [_P] * 9 + [_I] * 4 + [_P]
    lib.gru_scan_f32_persistent.argtypes = [_P] * 10 + [_I] * 4 + [_P]
    lib.gru_scan_f32_capacity.argtypes = [_I, _P]
    lib.gru_scan_bf16.argtypes = [_P] * 11 + [_I] * 5 + [_P]
    lib.gru_scan_f32_layout.argtypes = [_P]
    for name in (*_SCAN.values(), "gru_scan_f32_persistent",
                 "gru_scan_f32_capacity", "gru_scan_f32_layout"):
        getattr(lib, name).restype = _I
    # the packing and scratch shapes built here follow the kernel's tiling
    layout = (_I * len(F32_LAYOUT))()
    build.check(lib, lib.gru_scan_f32_layout(layout), "gru_scan_f32_layout")
    if tuple(layout) != F32_LAYOUT:
        raise RuntimeError(f"gru_scan's f32 layout {tuple(layout)} is not "
                           f"recurrence.F32_LAYOUT {F32_LAYOUT}")
    return lib


@functools.cache
def _bwd_kernel():
    lib = build.load("gru_bwd")
    lib.gru_bwd_f32.argtypes = [_P] * 11 + [_I] * 4 + [_P]
    lib.gru_bwd_bf16.argtypes = [_P] * 13 + [_I] * 5 + [_P]
    lib.gru_bwd_resident.argtypes = [_I, _P]
    for name in (*_BWD.values(), "gru_bwd_resident"):
        getattr(lib, name).restype = _I
    return lib


def plain(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
          w_hh: torch.Tensor, b_hh: torch.Tensor, lengths: torch.Tensor,
          residuals: bool = False):
    """GRU layer, one or two directions -> (D, T, B, H) f32, zero at steps
    past each row's length; with ``residuals`` also g (D, T, B, 3H) and hn
    (D, T, B, H) in x's type, zero there too.

    x: (T, B, F); w_ih: (D, F, 3H); w_hh: (D, H, 3H), all in the operand
    type (float32 or bfloat16); b_ih, b_hh: (D, 3H); lengths: (B,).
    Direction 1, when present, runs backward in time. The projection
    stays f32."""
    with fp32_matmul():
        xp = torch.einsum("tbf,dfg->dtbg", x.float(), w_ih.float())
    return plain_scan(xp, b_ih, w_hh, b_hh, lengths, residuals)


def plain_scan(xp: torch.Tensor, b_ih: torch.Tensor, w_hh: torch.Tensor,
               b_hh: torch.Tensor, lengths: torch.Tensor,
               residuals: bool = False):
    """GRU recurrence on a projection -> (D, T, B, H) f32, zero at steps
    past each row's length; with ``residuals`` also g (D, T, B, 3H) and hn
    (D, T, B, H) in w_hh's type, zero there too.

    xp: (D, T, B, 3H), x @ W_ih without bias, in time order for both
    directions; w_hh: (D, H, 3H) in the operand type; b_ih, b_hh: (D, 3H);
    lengths: (B,). xp is widened to f32 and b_ih added there."""
    ndir, t, b = xp.shape[:3]
    hidden = w_hh.shape[1]
    lengths = lengths.to(xp.device).clamp(max=t)
    xp = xp.float() + b_ih.float()[:, None, None, :]
    idx = walk_index(lengths, t)
    xp = to_time_order(xp, idx)  # the gather is its own inverse
    valid = valid_mask(lengths, t)
    w32 = w_hh.float()
    bh = b_hh.float()[:, None, :]
    h = torch.zeros((ndir, b, hidden), dtype=torch.float32, device=xp.device)
    outs, gates, hns = [], [], []
    for s in range(t):
        with fp32_matmul():
            hp = torch.bmm(h.to(w_hh.dtype).float(), w32) + bh
        xs = xp[:, s]
        r = torch.sigmoid(xs[..., :hidden] + hp[..., :hidden])
        z = torch.sigmoid(xs[..., hidden:2 * hidden]
                          + hp[..., hidden:2 * hidden])
        hn = hp[..., 2 * hidden:]
        n = torch.tanh(xs[..., 2 * hidden:] + r * hn)
        h_new = (1.0 - z) * n + z * h
        keep = valid[:, s]
        h = torch.where(keep, h_new, h)
        outs.append(torch.where(keep, h_new, 0.0))
        if residuals:
            gates.append(torch.where(keep, torch.cat([r, z, n], -1), 0.0))
            hns.append(torch.where(keep, hn, 0.0))
    out = to_time_order(torch.stack(outs, dim=1), idx)
    if not residuals:
        return out
    g = to_time_order(torch.stack(gates, dim=1), idx).to(w_hh.dtype)
    hn = to_time_order(torch.stack(hns, dim=1), idx).to(w_hh.dtype)
    return out, g, hn


def gru_layer(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
              w_hh: torch.Tensor, b_hh: torch.Tensor, lengths: torch.Tensor,
              residuals: bool = False, variant: str = "auto"):
    """K2: GRU layer forward -> (D, T, B, H) f32, zero past each row's
    length; with ``residuals`` -> (out, g, hn) for the backward.

    x (T, B, F), w_ih (D, F, 3H) and w_hh (D, H, 3H) share the operand type
    (float32 or bfloat16); b_ih, b_hh (D, 3H) f32; lengths (B,). In bf16
    the projection and the recurrence run on tensor cores, the recurrence
    from W_hh packed here (``pack_w_hh``): ``variant`` "auto" (the rule
    ``fwd_variant``), "resident", "persistent" or "step"; a variant the
    shape does not allow raises. f32 has one variant."""
    if x.device.type == "cpu":
        return plain(x, w_ih, b_ih, w_hh, b_hh, lengths, residuals)
    if x.device.type != "cuda":
        raise ValueError(f"gru_layer: unsupported device {x.device}")
    dt, dev = x.dtype, x.device
    t, b, f_in, ndir, hidden = check_layer("gru_layer", 3, tuple(_FWD), x,
                                           w_ih, b_ih, w_hh, b_hh, lengths)
    fwd_mode(variant)
    g = 3 * hidden
    lib = _fwd_kernel()
    x = x.contiguous()
    w_ih, w_hh = w_ih.contiguous(), w_hh.contiguous()
    b_ih = b_ih.float().contiguous()
    b_hh = b_hh.float().contiguous()
    lens = lengths.to(torch.int32).clamp(max=t).contiguous()
    xp = torch.empty((ndir, t, b, g), dtype=torch.float32, device=dev)
    out = torch.empty((ndir, t, b, hidden), dtype=torch.float32, device=dev)
    gates = hn = None
    if residuals:
        gates = torch.empty((ndir, t, b, g), dtype=dt, device=dev)
        hn = torch.empty((ndir, t, b, hidden), dtype=dt, device=dev)
    res = (gates.data_ptr() if residuals else None,
           hn.data_ptr() if residuals else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dt == torch.bfloat16:
        mode = fwd_variant(variant, 3, b, hidden, ndir, *fwd_capacity(
            lib, "gru_fwd_capacity", b, hidden, dev))
        w_pk = pack_w_hh(w_hh, 3)
        h = torch.empty((ndir, b, hidden), dtype=torch.float32, device=dev)
        hb = torch.empty(h_copy_shape(ndir, b, hidden), dtype=dt,
                         device=dev)
        bar = torch.empty(1, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            code = lib.gru_fwd_bf16(
                x.data_ptr(), w_ih.data_ptr(), b_ih.data_ptr(),
                w_pk.data_ptr(), b_hh.data_ptr(), lens.data_ptr(),
                xp.data_ptr(), h.data_ptr(), hb.data_ptr(), bar.data_ptr(),
                out.data_ptr(), *res, t, b, f_in, hidden, ndir, mode,
                stream)
    else:
        state = torch.empty((2, ndir, b, hidden), dtype=torch.float32,
                            device=dev)
        with torch.cuda.device(dev):
            code = lib.gru_fwd_f32(
                x.data_ptr(), w_ih.data_ptr(), b_ih.data_ptr(),
                w_hh.data_ptr(), b_hh.data_ptr(), lens.data_ptr(),
                xp.data_ptr(), state.data_ptr(), out.data_ptr(), *res, t, b,
                f_in, hidden, ndir, stream)
    build.check(lib, code, "gru_fwd kernel")
    global launches, res_launches
    launches += 1
    if not residuals:
        return out
    res_launches += 1
    return out, gates, hn


def projection(x: torch.Tensor, w_ih: torch.Tensor) -> torch.Tensor:
    """The bf16 projection GEMM of K2 and K3 alone (``csrc/proj_mma.cuh``):
    x (T, B, F) @ w_ih (D, F, N) -> (D, T, B, N) f32 with f32 sums, as the
    fused forwards compute it before their recurrence; its plain twin is
    ``plain``'s einsum. For timing it beside cuBLAS and for the card
    tests; the layers launch it inside ``gru_layer``/``lstm_layer``."""
    if x.device.type == "cpu":
        with fp32_matmul():
            return torch.einsum("tbf,dfn->dtbn", x.float(), w_ih.float())
    if x.dtype != torch.bfloat16 or w_ih.dtype != torch.bfloat16:
        raise TypeError(f"projection kernel takes bfloat16 x and w_ih, got "
                        f"{x.dtype}, {w_ih.dtype}")
    t, b, f_in = x.shape
    ndir, n = w_ih.shape[0], w_ih.shape[2]
    if w_ih.shape[1] != f_in:
        raise ValueError(f"projection: x {tuple(x.shape)} against w_ih "
                         f"{tuple(w_ih.shape)}")
    same_device("projection", x.device, w_ih=w_ih)
    lib = _fwd_kernel()
    x, w_ih = x.contiguous(), w_ih.contiguous()
    out = torch.empty((ndir, t, b, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.proj_mma_bf16(
            x.data_ptr(), w_ih.data_ptr(), out.data_ptr(), t * b, n, f_in,
            ndir, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, code, "projection kernel")
    global proj_launches
    proj_launches += 1
    return out


def gru_scan(xp: torch.Tensor, b_ih: torch.Tensor, w_hh: torch.Tensor,
             b_hh: torch.Tensor, lengths: torch.Tensor,
             residuals: bool = False, variant: str = "auto"):
    """K4: GRU recurrence on a projection -> (D, T, B, H) f32, zero past
    each row's length; with ``residuals`` -> (out, g, hn) for K5.

    xp (D, T, B, 3H) and w_hh (D, H, 3H) share the operand type (float32
    or bfloat16); b_ih, b_hh (D, 3H) f32; lengths (B,). ``variant`` "auto",
    "step" (one launch a step) or "persistent" (one launch a call; above 64
    rows, or where its grid is not resident at once, it raises). In bf16
    the kernel runs on tensor cores from W_hh packed here (``pack_w_hh``),
    "auto" the kernel's rule. In f32 every product is an f32 FMA; the
    persistent variant reads W_hh packed here (``pack_w_hh_f32``) once a
    step for the whole batch, "auto" the rule ``scan_f32_variant``."""
    if xp.device.type == "cpu":
        return plain_scan(xp, b_ih, w_hh, b_hh, lengths, residuals)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_scan: unsupported device {xp.device}")
    dt, dev = xp.dtype, xp.device
    ndir, t, b, hidden = check_scan("gru_scan", 3, tuple(_SCAN), xp, b_ih,
                                    w_hh, b_hh, lengths)
    mode = scan_variant(variant)
    lib = _scan_kernel()
    xp, w_hh = xp.contiguous(), w_hh.contiguous()
    b_ih = b_ih.float().contiguous()
    b_hh = b_hh.float().contiguous()
    lens = lengths.to(torch.int32).clamp(max=t).contiguous()
    out = torch.empty((ndir, t, b, hidden), dtype=torch.float32, device=dev)
    gates = hn = None
    if residuals:
        gates = torch.empty((ndir, t, b, 3 * hidden), dtype=dt, device=dev)
        hn = torch.empty((ndir, t, b, hidden), dtype=dt, device=dev)
    res = (gates.data_ptr() if residuals else None,
           hn.data_ptr() if residuals else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dt == torch.bfloat16:
        w_pk = pack_w_hh(w_hh, 3)
        h = torch.empty((ndir, b, hidden), dtype=torch.float32, device=dev)
        hb = torch.empty(h_copy_shape(ndir, b, hidden), dtype=dt,
                         device=dev)
        bar = torch.empty(1, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            code = lib.gru_scan_bf16(
                xp.data_ptr(), b_ih.data_ptr(), w_pk.data_ptr(),
                b_hh.data_ptr(), lens.data_ptr(), h.data_ptr(),
                hb.data_ptr(), bar.data_ptr(), out.data_ptr(), *res, t, b,
                hidden, ndir, mode, stream)
    else:
        mode = scan_f32_variant(variant, b, hidden, ndir, resident_blocks(
            lib, "gru_scan_f32_capacity", hidden, dev)
            if variant == "auto" else 0)
        if mode == 2:
            w_pk = pack_w_hh_f32(w_hh)
            ht = torch.empty(h_copy_shape_f32(ndir, b, hidden),
                             dtype=torch.float32, device=dev)
            bar = torch.empty(1, dtype=torch.int32, device=dev)
            with torch.cuda.device(dev):
                code = lib.gru_scan_f32_persistent(
                    xp.data_ptr(), b_ih.data_ptr(), w_pk.data_ptr(),
                    b_hh.data_ptr(), lens.data_ptr(), ht.data_ptr(),
                    bar.data_ptr(), out.data_ptr(), *res, t, b, hidden,
                    ndir, stream)
        else:
            state = torch.empty((2, ndir, b, hidden), dtype=torch.float32,
                                device=dev)
            with torch.cuda.device(dev):
                code = lib.gru_scan_f32(
                    xp.data_ptr(), b_ih.data_ptr(), w_hh.data_ptr(),
                    b_hh.data_ptr(), lens.data_ptr(), state.data_ptr(),
                    out.data_ptr(), *res, t, b, hidden, ndir, stream)
    build.check(lib, code, "gru_scan kernel")
    global scan_launches, scan_res_launches, scan_f32_persistent_launches
    scan_launches += 1
    if dt == torch.float32 and mode == 2:
        scan_f32_persistent_launches += 1
    if not residuals:
        return out
    scan_res_launches += 1
    return out, gates, hn


def plain_bwd(dout: torch.Tensor, g: torch.Tensor, hn: torch.Tensor,
              h: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor):
    """Backward through time of the GRU recurrence -> (dg (D, T, B, 3H) and
    dnh (D, T, B, H) in g's type, dbi and dbh (D, 3H) f32).

    dout, h (D, T, B, H) f32: the grads and values of the layer outputs;
    g, hn: the forward's residuals; w_hh (D, H, 3H) in g's type. Direction
    0 walks t = T-1 .. 0, direction 1 t = 0 .. T-1; steps past a row's
    length give dg = 0 and keep the carried dh."""
    ndir, t, b, hidden = h.shape
    dt = g.dtype
    dev = h.device
    lengths = lengths.to(dev)
    hp_all = h_prev_stream(h, lengths)
    wt = w_hh.float().transpose(1, 2)  # (D, 3H, H)
    dirs = torch.arange(ndir, device=dev)
    dg = torch.zeros((ndir, t, b, 3 * hidden), dtype=dt, device=dev)
    dnh = torch.zeros((ndir, t, b, hidden), dtype=dt, device=dev)
    acc_i = torch.zeros((ndir, b, 3 * hidden), device=dev)
    acc_h = torch.zeros_like(acc_i)
    dh = torch.zeros((ndir, b, hidden), device=dev)
    for s in range(t):
        ts = torch.tensor([t - 1 - s, s][:ndir], device=dev)
        valid = (ts[:, None] < lengths[None, :])[:, :, None]  # (D, B, 1)
        dh_tot = dout[dirs, ts] + dh
        gv = g[dirs, ts].float()
        r, z, n = gv[..., :hidden], gv[..., hidden:2 * hidden], \
            gv[..., 2 * hidden:]
        hnv = hn[dirs, ts].float()
        hp = hp_all[dirs, ts]
        dn = dh_tot * (1.0 - z) * (1.0 - n * n)
        dz = dh_tot * (hp - n) * z * (1.0 - z)
        dr = dn * hnv * r * (1.0 - r)
        dnhv = dn * r
        dgv = torch.where(valid, torch.cat([dr, dz, dn], -1), 0.0)
        dhp = torch.where(valid, torch.cat([dr, dz, dnhv], -1), 0.0)
        dg[dirs, ts] = dgv.to(dt)
        dnh[dirs, ts] = dhp[..., 2 * hidden:].to(dt)
        acc_i += dgv
        acc_h += dhp
        with fp32_matmul():
            rec = torch.bmm(dhp.to(dt).float(), wt)
        dh = torch.where(valid, dh_tot * z + rec, dh)
    return dg, dnh, acc_i.sum(1), acc_h.sum(1)


def gru_bwd(dout: torch.Tensor, g: torch.Tensor, hn: torch.Tensor,
            h: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor,
            variant: str = "auto"):
    """K5: the GRU recurrence's backward; arguments and results as
    ``plain_bwd``. In bf16 the kernel runs on tensor cores from W_hh packed
    here (``pack_w_hh_bwd``), one launch a step or one persistent launch:
    ``variant`` "auto" (the rule ``bwd_variant``), "step" or "persistent";
    f32 has one variant."""
    if h.device.type == "cpu":
        return plain_bwd(dout, g, hn, h, w_hh, lengths)
    if h.device.type != "cuda":
        raise ValueError(f"gru_bwd: unsupported device {h.device}")
    dt = g.dtype
    if dt not in _BWD or hn.dtype != dt or w_hh.dtype != dt:
        raise TypeError(f"gru_bwd kernel takes g, hn, w_hh all float32 or "
                        f"all bfloat16, got {g.dtype}, {hn.dtype}, "
                        f"{w_hh.dtype}")
    if dout.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError("gru_bwd kernel takes dout and h in float32")
    ndir, t, b, hidden = h.shape
    gh = 3 * hidden
    if (dout.shape != h.shape or g.shape != (ndir, t, b, gh)
            or hn.shape != h.shape or w_hh.shape != (ndir, hidden, gh)
            or lengths.shape != (b,) or ndir not in (1, 2)):
        raise ValueError("gru_bwd: inconsistent shapes "
                         f"dout {tuple(dout.shape)} g {tuple(g.shape)} hn "
                         f"{tuple(hn.shape)} h {tuple(h.shape)} w_hh "
                         f"{tuple(w_hh.shape)} lengths {tuple(lengths.shape)}")
    dev = h.device
    same_device("gru_bwd", dev, dout=dout, g=g, hn=hn, w_hh=w_hh,
                 lengths=lengths)
    scan_variant(variant)
    lib = _bwd_kernel()
    dout, g, hn, h = (a.contiguous() for a in (dout, g, hn, h))
    lens = lengths.to(torch.int32).clamp(max=t).contiguous()
    dg = torch.empty((ndir, t, b, gh), dtype=dt, device=dev)
    dnh = torch.empty((ndir, t, b, hidden), dtype=dt, device=dev)
    dbi = torch.empty((ndir, gh), dtype=torch.float32, device=dev)
    dbh = torch.empty_like(dbi)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dt == torch.bfloat16:
        mode = bwd_variant(variant, b, bwd_blocks(ndir, hidden),
                           resident_blocks(lib, "gru_bwd_resident", b, dev))
        w_pk = pack_w_hh_bwd(w_hh)
        op = torch.empty(op_copy_shape(ndir, b, hidden, 3), dtype=dt,
                         device=dev)
        bar = torch.empty(1, dtype=torch.int32, device=dev)
        state = torch.empty((6, ndir, b, hidden), dtype=torch.float32,
                            device=dev)
        with torch.cuda.device(dev):
            code = lib.gru_bwd_bf16(
                dout.data_ptr(), g.data_ptr(), hn.data_ptr(), h.data_ptr(),
                w_pk.data_ptr(), lens.data_ptr(), dg.data_ptr(),
                dnh.data_ptr(), op.data_ptr(), bar.data_ptr(),
                state.data_ptr(), dbi.data_ptr(), dbh.data_ptr(), t, b,
                hidden, ndir, mode, stream)
    else:
        wt = w_hh.transpose(1, 2).contiguous()
        scratch = torch.empty(2 * ndir * b * gh + 2 * ndir * b * hidden,
                              dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            code = lib.gru_bwd_f32(
                dout.data_ptr(), g.data_ptr(), hn.data_ptr(), h.data_ptr(),
                wt.data_ptr(), lens.data_ptr(), dg.data_ptr(),
                dnh.data_ptr(), scratch.data_ptr(), dbi.data_ptr(),
                dbh.data_ptr(), t, b, hidden, ndir, stream)
    build.check(lib, code, "gru_bwd kernel")
    global bwd_launches
    bwd_launches += 1
    return dg, dnh, dbi, dbh


class GRULayer(torch.autograd.Function):
    """Differentiable GRU layer: K2 with residuals forward, K5 backward.

    forward(x, w_ih, b_ih, w_hh, b_hh, lengths) -> (D, T, B, H) f32. x and
    w_ih are in the operand type; w_hh, b_ih and b_hh in f32 (the kernel
    takes w_hh rounded to the operand type, and its gradient stays f32, as
    the JAX package's does). dx and dW_ih come back in the operand type."""

    @staticmethod
    def forward(ctx, x, w_ih, b_ih, w_hh, b_hh, lengths):
        w_op = w_hh.to(x.dtype)
        out, g, hn = gru_layer(x, w_ih, b_ih, w_op, b_hh, lengths,
                               residuals=True)
        ctx.save_for_backward(x, w_ih, w_op, out, g, hn, lengths)
        return out

    @staticmethod
    def backward(ctx, dout):
        with trace.span("rnn.bwd"):
            x, w_ih, w_op, out, g, hn, lengths = ctx.saved_tensors
            dg, dnh, dbi, dbh = gru_bwd(dout.float().contiguous(), g, hn, out,
                                        w_op, lengths)
            dx, dw_ih = proj_bwd(x, w_ih, dg)
            return dx, dw_ih, dbi, _dw_hh(out, dg, dnh, lengths), dbh, None


def _dw_hh(out: torch.Tensor, dg: torch.Tensor, dnh: torch.Tensor,
           lengths: torch.Tensor) -> torch.Tensor:
    """dW_hh (D, H, 3H) f32: h_prev against [dr, dz, dnh], built a direction
    at a time."""
    hidden = out.shape[-1]
    ops = (torch.cat([dg[d][..., :2 * hidden], dnh[d]], -1)
           for d in range(out.shape[0]))
    return dw_hh(out, lengths, ops, dg.dtype)


class GRUScanLayer(torch.autograd.Function):
    """Differentiable GRU recurrence on a projection: K4 with residuals
    forward, K5 backward.

    forward(xp, b_ih, w_hh, b_hh, lengths) -> (D, T, B, H) f32. xp is in
    the operand type; w_hh, b_ih and b_hh in f32 (the kernel takes w_hh
    rounded to the operand type). The backward returns dxp = dg in the
    operand type, db_ih, dW_hh (f32) and db_hh, as ``_bigru_bwd_rule``."""

    @staticmethod
    def forward(ctx, xp, b_ih, w_hh, b_hh, lengths):
        w_op = w_hh.to(xp.dtype)
        out, g, hn = gru_scan(xp, b_ih, w_op, b_hh, lengths, residuals=True)
        ctx.save_for_backward(w_op, out, g, hn, lengths)
        return out

    @staticmethod
    def backward(ctx, dout):
        with trace.span("rnn.bwd"):
            w_op, out, g, hn, lengths = ctx.saved_tensors
            dg, dnh, dbi, dbh = gru_bwd(dout.float().contiguous(), g, hn, out,
                                        w_op, lengths)
            return dg, dbi, _dw_hh(out, dg, dnh, lengths), dbh, None
