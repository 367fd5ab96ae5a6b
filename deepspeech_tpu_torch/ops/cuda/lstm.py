"""Wrappers of the LSTM layer kernels (``csrc/lstm_fwd.cu``,
``csrc/lstm_scan.cu``, ``csrc/lstm_bwd.cu``) and the autograd Functions
that tie them together.

``lstm_layer`` replaces ``deepspeech_tpu/ops/pallas/rnn_fused.py``
(``_lstm_fused_fwd_kernel`` via ``bilstm_layer_pallas`` /
``lstm_layer_pallas``), input projection included, in both variants:
inference, which writes only h, and training (``residuals=True``), which
also returns the cell stream c in f32 and the activated gates (i, f, g, o)
in the operand type. In bf16 (K3 on tensor cores: ``csrc/proj_mma.cuh``
for the projection, ``csrc/rnn_mma.cuh`` for the recurrence on its f32
stream) it runs one of three variants, ``variant=`` "resident",
"persistent" or "step", or by the rule ``recurrence.fwd_variant``; in f32
it keeps its SIMT kernels. ``lstm_bwd`` replaces
``deepspeech_tpu/ops/pallas/rnn_kernel.py`` (``_lstm_bwd_kernel`` via
``_lstm_bwd``). ``lstm_scan`` (K6) replaces ``rnn_kernel.py``
(``_lstm_fwd_kernel`` via ``bilstm_scan_pallas`` / ``lstm_scan_pallas``):
the same recurrence on a projection computed outside and rounded to the
operand type, for the layers ``route.fused_route`` sends there; its
inference variant writes h only, where the TPU kernel also writes c. For
CPU tensors each wrapper runs its plain PyTorch twin beside it (``plain``,
``plain_scan``, ``plain_bwd``); for CUDA tensors it launches the kernel or
raises.

In bf16 the backward ``lstm_bwd`` (K7) runs its recurrent product on tensor
cores (``csrc/rnn_mma_bwd.cuh``: W_hh packed by
``recurrence.pack_w_hh_bwd``, one launch a step or one persistent launch,
``variant=``); in f32 it keeps its SIMT step kernel.

Semantics: time-major (T, B, F) layout, torch gate order i, f, g, o, f32
state (h and c) and f32 gates. With bf16 operands every product
accumulates in f32, the input projection stays f32 with both biases added
in f32, and the hidden dot rounds h_prev to bf16. The backward direction
reads each sequence reversed within its valid length (pack_padded_sequence
semantics, the walk index ``t = len - 1 - s`` of ``recurrence.walk_index``,
not the TPU kernels' freeze gate); outputs and residuals at padded steps
are zero, and the backward ignores the output grads there.

``LSTMLayer`` is the layer's ``torch.autograd.Function``: the training
forward, then K7 for the recurrence's gradient and cuBLAS for the large
products dW_hh, dW_ih and dx (``rnn_kernel.py:834-846``,
``rnn_fused.py:_proj_grads``), as the JAX package leaves them to XLA.
``LSTMScanLayer`` is K6's: K6 with residuals forward, K7 backward, and the
gradients of xp, b_ih, W_hh and b_hh (``_bilstm_bwd_rule``,
``rnn_kernel.py:864-867``); dx and dW_ih come from autograd through the
projection outside.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepspeech_tpu_torch.ops import fp32_matmul
from deepspeech_tpu_torch.ops.cuda import build
from deepspeech_tpu_torch.ops.cuda.recurrence import (bwd_blocks,
                                                      bwd_variant,
                                                      check_layer,
                                                      check_scan, dw_hh,
                                                      fwd_capacity,
                                                      fwd_mode, fwd_variant,
                                                      h_copy_shape,
                                                      op_copy_shape,
                                                      pack_w_hh,
                                                      pack_w_hh_bwd,
                                                      proj_bwd,
                                                      resident_blocks,
                                                      same_device,
                                                      scan_variant,
                                                      to_time_order,
                                                      valid_mask,
                                                      walk_index)
from deepspeech_tpu_torch.utils import trace

launches = 0      # lstm_fwd launches (one per layer call), both variants
res_launches = 0  # of those, the training variant's (residuals written)
scan_launches = 0      # lstm_scan launches (K6, one per layer call)
scan_res_launches = 0  # of those, the training variant's
bwd_launches = 0  # lstm_bwd launches (one per layer backward)

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD = {torch.float32: "lstm_fwd_f32", torch.bfloat16: "lstm_fwd_bf16"}
_SCAN = {torch.float32: "lstm_scan_f32", torch.bfloat16: "lstm_scan_bf16"}
_BWD = {torch.float32: "lstm_bwd_f32", torch.bfloat16: "lstm_bwd_bf16"}


@functools.cache
def _fwd_kernel():
    lib = build.load("lstm_fwd")
    lib.lstm_fwd_f32.argtypes = [_P] * 11 + [_I] * 5 + [_P]
    lib.lstm_fwd_bf16.argtypes = [_P] * 13 + [_I] * 6 + [_P]
    lib.lstm_fwd_capacity.argtypes = [_I, _I, _P, _P]
    for name in (*_FWD.values(), "lstm_fwd_capacity"):
        getattr(lib, name).restype = _I
    return lib


@functools.cache
def _scan_kernel():
    lib = build.load("lstm_scan")
    lib.lstm_scan_f32.argtypes = [_P] * 9 + [_I] * 4 + [_P]
    lib.lstm_scan_bf16.argtypes = [_P] * 11 + [_I] * 5 + [_P]
    lib.lstm_scan_f32.restype = lib.lstm_scan_bf16.restype = _I
    return lib


@functools.cache
def _bwd_kernel():
    lib = build.load("lstm_bwd")
    lib.lstm_bwd_f32.argtypes = [_P] * 8 + [_I] * 4 + [_P]
    lib.lstm_bwd_bf16.argtypes = [_P] * 10 + [_I] * 5 + [_P]
    lib.lstm_bwd_resident.argtypes = [_I, _P]
    for name in (*_BWD.values(), "lstm_bwd_resident"):
        getattr(lib, name).restype = _I
    return lib


def plain(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
          w_hh: torch.Tensor, b_hh: torch.Tensor, lengths: torch.Tensor,
          residuals: bool = False):
    """LSTM layer, one or two directions -> (D, T, B, H) f32, zero at steps
    past each row's length; with ``residuals`` also c (D, T, B, H) f32 and
    the activated gates g = (i, f, g, o) (D, T, B, 4H) in x's type, zero
    there too.

    x: (T, B, F); w_ih: (D, F, 4H); w_hh: (D, H, 4H), all in the operand
    type (float32 or bfloat16); b_ih, b_hh: (D, 4H); lengths: (B,).
    Direction 1, when present, runs backward in time. The projection
    stays f32."""
    with fp32_matmul():
        xp = torch.einsum("tbf,dfg->dtbg", x.float(), w_ih.float())
    return plain_scan(xp, b_ih, w_hh, b_hh, lengths, residuals)


def plain_scan(xp: torch.Tensor, b_ih: torch.Tensor, w_hh: torch.Tensor,
               b_hh: torch.Tensor, lengths: torch.Tensor,
               residuals: bool = False):
    """LSTM recurrence on a projection -> (D, T, B, H) f32, zero at steps
    past each row's length; with ``residuals`` also c (D, T, B, H) f32 and
    the activated gates (D, T, B, 4H) in w_hh's type, zero there too.

    xp: (D, T, B, 4H), x @ W_ih without bias, in time order for both
    directions; w_hh: (D, H, 4H) in the operand type; b_ih, b_hh: (D, 4H);
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
    c = torch.zeros_like(h)
    outs, cells, gates = [], [], []
    for s in range(t):
        with fp32_matmul():
            hp = torch.bmm(h.to(w_hh.dtype).float(), w32) + bh
        pre = xp[:, s] + hp
        i = torch.sigmoid(pre[..., :hidden])
        f = torch.sigmoid(pre[..., hidden:2 * hidden])
        g = torch.tanh(pre[..., 2 * hidden:3 * hidden])
        o = torch.sigmoid(pre[..., 3 * hidden:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        keep = valid[:, s]
        h = torch.where(keep, h_new, h)
        c = torch.where(keep, c_new, c)
        outs.append(torch.where(keep, h_new, 0.0))
        if residuals:
            cells.append(torch.where(keep, c_new, 0.0))
            gates.append(torch.where(keep, torch.cat([i, f, g, o], -1), 0.0))
    out = to_time_order(torch.stack(outs, dim=1), idx)
    if not residuals:
        return out
    cs = to_time_order(torch.stack(cells, dim=1), idx)
    gs = to_time_order(torch.stack(gates, dim=1), idx).to(w_hh.dtype)
    return out, cs, gs


def lstm_layer(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
               w_hh: torch.Tensor, b_hh: torch.Tensor, lengths: torch.Tensor,
               residuals: bool = False, variant: str = "auto"):
    """K3: LSTM layer forward -> (D, T, B, H) f32, zero past each row's
    length; with ``residuals`` -> (out, c, g) for the backward.

    x (T, B, F), w_ih (D, F, 4H) and w_hh (D, H, 4H) share the operand type
    (float32 or bfloat16); b_ih, b_hh (D, 4H) f32; lengths (B,). In bf16
    the projection and the recurrence run on tensor cores, the recurrence
    from W_hh packed here (``pack_w_hh``): ``variant`` "auto" (the rule
    ``fwd_variant``), "resident", "persistent" or "step"; a variant the
    shape does not allow raises. f32 has one variant."""
    if x.device.type == "cpu":
        return plain(x, w_ih, b_ih, w_hh, b_hh, lengths, residuals)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_layer: unsupported device {x.device}")
    dt, dev = x.dtype, x.device
    t, b, f_in, ndir, hidden = check_layer("lstm_layer", 4, tuple(_FWD), x,
                                           w_ih, b_ih, w_hh, b_hh, lengths)
    fwd_mode(variant)
    g = 4 * hidden
    lib = _fwd_kernel()
    x = x.contiguous()
    w_ih, w_hh = w_ih.contiguous(), w_hh.contiguous()
    b_ih = b_ih.float().contiguous()
    b_hh = b_hh.float().contiguous()
    lens = lengths.to(torch.int32).clamp(max=t).contiguous()
    xp = torch.empty((ndir, t, b, g), dtype=torch.float32, device=dev)
    out = torch.empty((ndir, t, b, hidden), dtype=torch.float32, device=dev)
    cells = gates = None
    if residuals:
        cells = torch.empty((ndir, t, b, hidden), dtype=torch.float32,
                            device=dev)
        gates = torch.empty((ndir, t, b, g), dtype=dt, device=dev)
    res = (cells.data_ptr() if residuals else None,
           gates.data_ptr() if residuals else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dt == torch.bfloat16:
        mode = fwd_variant(variant, 4, b, hidden, ndir, *fwd_capacity(
            lib, "lstm_fwd_capacity", b, hidden, dev))
        w_pk = pack_w_hh(w_hh, 4)
        hc = torch.empty((2, ndir, b, hidden), dtype=torch.float32,
                         device=dev)
        hb = torch.empty(h_copy_shape(ndir, b, hidden), dtype=dt,
                         device=dev)
        bar = torch.empty(1, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            code = lib.lstm_fwd_bf16(
                x.data_ptr(), w_ih.data_ptr(), b_ih.data_ptr(),
                w_pk.data_ptr(), b_hh.data_ptr(), lens.data_ptr(),
                xp.data_ptr(), hc.data_ptr(), hb.data_ptr(), bar.data_ptr(),
                out.data_ptr(), *res, t, b, f_in, hidden, ndir, mode,
                stream)
    else:
        # h ping-pongs between [0] and [1]; [2] holds c
        state = torch.empty((3, ndir, b, hidden), dtype=torch.float32,
                            device=dev)
        with torch.cuda.device(dev):
            code = lib.lstm_fwd_f32(
                x.data_ptr(), w_ih.data_ptr(), b_ih.data_ptr(),
                w_hh.data_ptr(), b_hh.data_ptr(), lens.data_ptr(),
                xp.data_ptr(), state.data_ptr(), out.data_ptr(), *res, t, b,
                f_in, hidden, ndir, stream)
    build.check(lib, code, "lstm_fwd kernel")
    global launches, res_launches
    launches += 1
    if not residuals:
        return out
    res_launches += 1
    return out, cells, gates


def lstm_scan(xp: torch.Tensor, b_ih: torch.Tensor, w_hh: torch.Tensor,
              b_hh: torch.Tensor, lengths: torch.Tensor,
              residuals: bool = False, variant: str = "auto"):
    """K6: LSTM recurrence on a projection -> (D, T, B, H) f32, zero past
    each row's length; with ``residuals`` -> (out, c, g) for K7.

    xp (D, T, B, 4H) and w_hh (D, H, 4H) share the operand type (float32
    or bfloat16); b_ih, b_hh (D, 4H) f32; lengths (B,). In bf16 the kernel
    runs on tensor cores from W_hh packed here (``pack_w_hh``), one launch
    a step or one persistent launch: ``variant`` "auto" (the kernel's
    rule), "step" or "persistent"; f32 has one variant."""
    if xp.device.type == "cpu":
        return plain_scan(xp, b_ih, w_hh, b_hh, lengths, residuals)
    if xp.device.type != "cuda":
        raise ValueError(f"lstm_scan: unsupported device {xp.device}")
    dt, dev = xp.dtype, xp.device
    ndir, t, b, hidden = check_scan("lstm_scan", 4, tuple(_SCAN), xp, b_ih,
                                    w_hh, b_hh, lengths)
    mode = scan_variant(variant)
    lib = _scan_kernel()
    xp, w_hh = xp.contiguous(), w_hh.contiguous()
    b_ih = b_ih.float().contiguous()
    b_hh = b_hh.float().contiguous()
    lens = lengths.to(torch.int32).clamp(max=t).contiguous()
    out = torch.empty((ndir, t, b, hidden), dtype=torch.float32, device=dev)
    cells = gates = None
    if residuals:
        cells = torch.empty((ndir, t, b, hidden), dtype=torch.float32,
                            device=dev)
        gates = torch.empty((ndir, t, b, 4 * hidden), dtype=dt, device=dev)
    res = (cells.data_ptr() if residuals else None,
           gates.data_ptr() if residuals else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dt == torch.bfloat16:
        w_pk = pack_w_hh(w_hh, 4)
        hc = torch.empty((2, ndir, b, hidden), dtype=torch.float32,
                         device=dev)  # h, then c
        hb = torch.empty(h_copy_shape(ndir, b, hidden), dtype=dt,
                         device=dev)
        bar = torch.empty(1, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            code = lib.lstm_scan_bf16(
                xp.data_ptr(), b_ih.data_ptr(), w_pk.data_ptr(),
                b_hh.data_ptr(), lens.data_ptr(), hc.data_ptr(),
                hb.data_ptr(), bar.data_ptr(), out.data_ptr(), *res, t, b,
                hidden, ndir, mode, stream)
    else:
        # h ping-pongs between [0] and [1]; [2] holds c
        state = torch.empty((3, ndir, b, hidden), dtype=torch.float32,
                            device=dev)
        with torch.cuda.device(dev):
            code = lib.lstm_scan_f32(
                xp.data_ptr(), b_ih.data_ptr(), w_hh.data_ptr(),
                b_hh.data_ptr(), lens.data_ptr(), state.data_ptr(),
                out.data_ptr(), *res, t, b, hidden, ndir, stream)
    build.check(lib, code, "lstm_scan kernel")
    global scan_launches, scan_res_launches
    scan_launches += 1
    if not residuals:
        return out
    scan_res_launches += 1
    return out, cells, gates


def plain_bwd(dout: torch.Tensor, g: torch.Tensor, c: torch.Tensor,
              w_hh: torch.Tensor, lengths: torch.Tensor):
    """Backward through time of the LSTM recurrence -> (dg (D, T, B, 4H),
    the pre-activation gate grads in g's type, and db (D, 4H) f32, their
    unrounded sum over (t, b), the grad of both biases).

    dout, c (D, T, B, H) f32: the grads of the layer outputs and the
    forward's cell stream; g (D, T, B, 4H): its activated gates; w_hh
    (D, H, 4H) in g's type. Direction 0 walks t = T-1 .. 0 with c_prev =
    c[t-1] (0 at t = 0), direction 1 t = 0 .. T-1 with c_prev = c[t+1] (0
    at t = len - 1); steps past a row's length give dg = 0 and keep the
    carried dh and dc."""
    ndir, t, b, hidden = c.shape
    dt = g.dtype
    dev = c.device
    lengths = lengths.to(dev)
    wt = w_hh.float().transpose(1, 2)  # (D, 4H, H)
    dirs = torch.arange(ndir, device=dev)
    zero = torch.zeros((ndir, b, hidden), device=dev)
    dg = torch.zeros((ndir, t, b, 4 * hidden), dtype=dt, device=dev)
    acc = torch.zeros((ndir, b, 4 * hidden), device=dev)
    dh, dc = zero, zero
    for s in range(t):
        ts = torch.tensor([t - 1 - s, s][:ndir], device=dev)
        valid = (ts[:, None] < lengths[None, :])[:, :, None]  # (D, B, 1)
        # c_prev: c[t-1] walking down, c[t+1] inside the length walking up
        prev = ts + torch.tensor([-1, 1][:ndir], device=dev)
        has_prev = ((prev[:, None] >= 0)
                    & (prev[:, None] < lengths[None, :]))[:, :, None]
        c_prev = torch.where(has_prev, c[dirs, prev.clamp(0, t - 1)], 0.0)
        dh_tot = dout[dirs, ts] + dh
        gv = g[dirs, ts].float()
        i, f = gv[..., :hidden], gv[..., hidden:2 * hidden]
        gg, o = gv[..., 2 * hidden:3 * hidden], gv[..., 3 * hidden:]
        tc = torch.tanh(c[dirs, ts])
        do = dh_tot * tc * o * (1.0 - o)
        dc_tot = dc + dh_tot * o * (1.0 - tc * tc)
        di = dc_tot * gg * i * (1.0 - i)
        df = dc_tot * c_prev * f * (1.0 - f)
        dgg = dc_tot * i * (1.0 - gg * gg)
        dgv = torch.where(valid, torch.cat([di, df, dgg, do], -1), 0.0)
        dg[dirs, ts] = dgv.to(dt)
        acc += dgv
        with fp32_matmul():
            rec = torch.bmm(dgv.to(dt).float(), wt)
        dh = torch.where(valid, rec, dh)
        dc = torch.where(valid, dc_tot * f, dc)
    return dg, acc.sum(1)


def lstm_bwd(dout: torch.Tensor, g: torch.Tensor, c: torch.Tensor,
             w_hh: torch.Tensor, lengths: torch.Tensor,
             variant: str = "auto"):
    """K7: the LSTM recurrence's backward; arguments and results as
    ``plain_bwd``. In bf16 the kernel runs on tensor cores from W_hh packed
    here (``pack_w_hh_bwd``), one launch a step or one persistent launch:
    ``variant`` "auto" (the rule ``bwd_variant``), "step" or "persistent";
    f32 has one variant."""
    if c.device.type == "cpu":
        return plain_bwd(dout, g, c, w_hh, lengths)
    if c.device.type != "cuda":
        raise ValueError(f"lstm_bwd: unsupported device {c.device}")
    dt = g.dtype
    if dt not in _BWD or w_hh.dtype != dt:
        raise TypeError(f"lstm_bwd kernel takes g and w_hh both float32 or "
                        f"both bfloat16, got {g.dtype}, {w_hh.dtype}")
    if dout.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError("lstm_bwd kernel takes dout and c in float32")
    ndir, t, b, hidden = c.shape
    gh = 4 * hidden
    if (dout.shape != c.shape or g.shape != (ndir, t, b, gh)
            or w_hh.shape != (ndir, hidden, gh) or lengths.shape != (b,)
            or ndir not in (1, 2)):
        raise ValueError("lstm_bwd: inconsistent shapes "
                         f"dout {tuple(dout.shape)} g {tuple(g.shape)} c "
                         f"{tuple(c.shape)} w_hh {tuple(w_hh.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    dev = c.device
    same_device("lstm_bwd", dev, dout=dout, g=g, w_hh=w_hh, lengths=lengths)
    scan_variant(variant)
    lib = _bwd_kernel()
    dout, g, c = (a.contiguous() for a in (dout, g, c))
    lens = lengths.to(torch.int32).clamp(max=t).contiguous()
    dg = torch.empty((ndir, t, b, gh), dtype=dt, device=dev)
    db = torch.empty((ndir, gh), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dt == torch.bfloat16:
        mode = bwd_variant(variant, b, bwd_blocks(ndir, hidden),
                           resident_blocks(lib, "lstm_bwd_resident", b, dev))
        w_pk = pack_w_hh_bwd(w_hh)
        op = torch.empty(op_copy_shape(ndir, b, hidden, 4), dtype=dt,
                         device=dev)
        bar = torch.empty(1, dtype=torch.int32, device=dev)
        state = torch.empty((6, ndir, b, hidden), dtype=torch.float32,
                            device=dev)
        with torch.cuda.device(dev):
            code = lib.lstm_bwd_bf16(
                dout.data_ptr(), g.data_ptr(), c.data_ptr(), w_pk.data_ptr(),
                lens.data_ptr(), dg.data_ptr(), op.data_ptr(),
                bar.data_ptr(), state.data_ptr(), db.data_ptr(), t, b,
                hidden, ndir, mode, stream)
    else:
        wt = w_hh.transpose(1, 2).contiguous()
        scratch = torch.empty(ndir * b * gh + 2 * ndir * b * hidden,
                              dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            code = lib.lstm_bwd_f32(
                dout.data_ptr(), g.data_ptr(), c.data_ptr(), wt.data_ptr(),
                lens.data_ptr(), dg.data_ptr(), scratch.data_ptr(),
                db.data_ptr(), t, b, hidden, ndir, stream)
    build.check(lib, code, "lstm_bwd kernel")
    global bwd_launches
    bwd_launches += 1
    return dg, db


class LSTMLayer(torch.autograd.Function):
    """Differentiable LSTM layer: K3 with residuals forward, K7 backward.

    forward(x, w_ih, b_ih, w_hh, b_hh, lengths) -> (D, T, B, H) f32. x and
    w_ih are in the operand type; w_hh, b_ih and b_hh in f32 (the kernel
    takes w_hh rounded to the operand type, and its gradient stays f32, as
    the JAX package's does). dx and dW_ih come back in the operand type;
    db_ih and db_hh are the same sum (the LSTM has no GRU-style r term)."""

    @staticmethod
    def forward(ctx, x, w_ih, b_ih, w_hh, b_hh, lengths):
        w_op = w_hh.to(x.dtype)
        out, c, g = lstm_layer(x, w_ih, b_ih, w_op, b_hh, lengths,
                               residuals=True)
        ctx.save_for_backward(x, w_ih, w_op, out, c, g, lengths)
        return out

    @staticmethod
    def backward(ctx, dout):
        with trace.span("rnn.bwd"):
            x, w_ih, w_op, out, c, g, lengths = ctx.saved_tensors
            dg, db = lstm_bwd(dout.float().contiguous(), g, c, w_op, lengths)
            dx, dw_ih = proj_bwd(x, w_ih, dg)
            # two tensors: autograd may keep each as a .grad and add into it
            return (dx, dw_ih, db, dw_hh(out, lengths, dg, dg.dtype),
                    db.clone(), None)


class LSTMScanLayer(torch.autograd.Function):
    """Differentiable LSTM recurrence on a projection: K6 with residuals
    forward, K7 backward.

    forward(xp, b_ih, w_hh, b_hh, lengths) -> (D, T, B, H) f32. xp is in
    the operand type; w_hh, b_ih and b_hh in f32 (the kernel takes w_hh
    rounded to the operand type). The backward returns dxp = dg in the
    operand type, db_ih, dW_hh (f32) and db_hh, as ``_bilstm_bwd_rule``."""

    @staticmethod
    def forward(ctx, xp, b_ih, w_hh, b_hh, lengths):
        w_op = w_hh.to(xp.dtype)
        out, c, g = lstm_scan(xp, b_ih, w_op, b_hh, lengths, residuals=True)
        ctx.save_for_backward(w_op, out, c, g, lengths)
        return out

    @staticmethod
    def backward(ctx, dout):
        with trace.span("rnn.bwd"):
            w_op, out, c, g, lengths = ctx.saved_tensors
            dg, db = lstm_bwd(dout.float().contiguous(), g, c, w_op, lengths)
            return dg, db, dw_hh(out, lengths, dg, dg.dtype), db.clone(), None
