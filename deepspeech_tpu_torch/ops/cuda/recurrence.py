"""Helpers shared by the recurrent-layer wrappers (``gru.py``, ``lstm.py``):
the backward direction's time walk, the h_prev stream and the cuBLAS
products of the layer backwards (f32 sums: ``ops/products.py:mm_f32``),
argument checks, the W_hh packings, scratch shapes and rules of the bf16
recurrence kernels (K2, K3, K4, K6: ``csrc/rnn_mma.cuh``, with K2's and
K3's projection GEMM in ``csrc/proj_mma.cuh``; K5, K7:
``csrc/rnn_mma_bwd.cuh``), and those of K4's f32 persistent variant
(``csrc/gru_scan.cu``: ``f32_scan``)."""

from __future__ import annotations

import ctypes

import torch

from deepspeech_tpu_torch.ops import fp32_matmul
from deepspeech_tpu_torch.ops.cuda import build
from deepspeech_tpu_torch.ops.products import mm_f32


def walk_index(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(T, B) time index of step s for each row of the backward direction:
    ``len - 1 - s`` inside the valid prefix, ``s`` past it. It is its own
    inverse, so it maps the walk back to time order as well."""
    s = torch.arange(t, device=lengths.device)[:, None]
    lens = lengths.to(s.dtype)[None, :]
    return torch.where(s < lens, lens - 1 - s, s)


def to_time_order(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(D, T, B, N) in walk order -> time order (direction 1 regathered)."""
    if a.shape[0] == 1:
        return a
    gather = idx[:, :, None].expand(-1, -1, a.shape[-1])
    return torch.stack([a[0], torch.gather(a[1], 0, gather)])


def valid_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(1, T, B, 1) bool: step t lies inside row b's length."""
    return (torch.arange(t, device=lengths.device)[:, None]
            < lengths[None, :])[None, :, :, None]


def h_prev_stream(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(D, T, B, H) layer outputs -> h_prev of each step in time order:
    h[t-1] for direction 0 (0 at t = 0), h[t+1] for direction 1 (0 where
    t + 1 is past the row's length)."""
    zero = torch.zeros_like(h[:1, :1])
    prev = [torch.cat([zero[0], h[0, :-1]])]
    if h.shape[0] == 2:
        t = h.shape[1]
        nxt = torch.cat([h[1, 1:], zero[0]])
        keep = (torch.arange(t, device=h.device)[:, None] + 1
                < lengths.to(h.device)[None, :])[:, :, None]
        prev.append(torch.where(keep, nxt, 0.0))
    return torch.stack(prev)


def proj_bwd(x: torch.Tensor, w_ih: torch.Tensor,
             dg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused layers' projection backward: x (T, B, F) and w_ih
    (D, F, G*H) as the forward took them, dg (D, T, B, G*H) the gate
    grads -> dx (T, B, F) in x's type, the directions' dg @ W_ih^T summed in
    f32, and dW_ih = x^T dg (D, F, G*H) in w_ih's type, on cuBLAS."""
    ndir, t, b, gh = dg.shape
    x2 = x.reshape(t * b, -1)
    dx = 0.0
    dw_ih = []
    with fp32_matmul():
        for d in range(ndir):
            dg2 = dg[d].reshape(t * b, gh)
            dx = dx + mm_f32(dg2, w_ih[d].t())
            dw_ih.append(mm_f32(x2.t(), dg2))
    return dx.reshape(x.shape).to(x.dtype), torch.stack(dw_ih).to(w_ih.dtype)


def dw_hh(out: torch.Tensor, lengths: torch.Tensor, operands,
          dtype: torch.dtype) -> torch.Tensor:
    """dW_hh (D, H, K) f32: h_prev of the layer's outputs ``out``
    (D, T, B, H), rounded to ``dtype``, against each direction's operand
    (T, B, K) in ``dtype``, which ``operands`` yields in turn (the LSTM's
    dg, the GRU's [dr, dz, dnh]), summed over every (t, b) on cuBLAS."""
    _, t, b, hidden = out.shape
    hp = h_prev_stream(out, lengths).to(dtype)
    with fp32_matmul():
        return torch.stack([
            mm_f32(hp[d].reshape(t * b, hidden).t(), op.reshape(t * b, -1))
            for d, op in enumerate(operands)])


def same_device(where: str, dev: torch.device, **tensors) -> None:
    for name, a in tensors.items():
        if a.device != dev:
            raise ValueError(f"{where}: {name} on {a.device}, expected {dev}")


def check_layer(where: str, gates: int, dtypes: tuple, x: torch.Tensor,
                w_ih: torch.Tensor, b_ih: torch.Tensor, w_hh: torch.Tensor,
                b_hh: torch.Tensor, lengths: torch.Tensor
                ) -> tuple[int, int, int, int, int]:
    """Check a layer kernel's arguments -> (T, B, F, D, H).

    x (T, B, F), w_ih (D, F, G*H) and w_hh (D, H, G*H) share one operand
    type out of ``dtypes``; b_ih, b_hh (D, G*H); lengths (B,); D is 1 or 2;
    all on x's device."""
    dt = x.dtype
    if dt not in dtypes or w_ih.dtype != dt or w_hh.dtype != dt:
        raise TypeError(f"{where} kernel takes x, w_ih, w_hh all float32 "
                        f"or all bfloat16, got {x.dtype}, {w_ih.dtype}, "
                        f"{w_hh.dtype}")
    t, b, f_in = x.shape
    ndir, hidden, g = w_hh.shape
    if (g != gates * hidden or w_ih.shape != (ndir, f_in, g)
            or b_ih.shape != (ndir, g) or b_hh.shape != (ndir, g)
            or lengths.shape != (b,) or ndir not in (1, 2)):
        raise ValueError(f"{where}: inconsistent shapes "
                         f"x {tuple(x.shape)} w_ih {tuple(w_ih.shape)} "
                         f"w_hh {tuple(w_hh.shape)} b_ih {tuple(b_ih.shape)} "
                         f"b_hh {tuple(b_hh.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    same_device(where, x.device, w_ih=w_ih, b_ih=b_ih, w_hh=w_hh, b_hh=b_hh,
                lengths=lengths)
    return t, b, f_in, ndir, hidden


def check_scan(where: str, gates: int, dtypes: tuple, xp: torch.Tensor,
               b_ih: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
               lengths: torch.Tensor) -> tuple[int, int, int, int]:
    """Check a recurrence kernel's arguments -> (D, T, B, H).

    xp (D, T, B, G*H) and w_hh (D, H, G*H) share one operand type out of
    ``dtypes``; b_ih, b_hh (D, G*H); lengths (B,); D is 1 or 2; all on
    xp's device."""
    dt = xp.dtype
    if dt not in dtypes or w_hh.dtype != dt:
        raise TypeError(f"{where} kernel takes xp and w_hh both float32 or "
                        f"both bfloat16, got {xp.dtype}, {w_hh.dtype}")
    ndir, t, b, g = xp.shape
    hidden = w_hh.shape[1]
    if (g != gates * hidden or w_hh.shape != (ndir, hidden, g)
            or b_ih.shape != (ndir, g) or b_hh.shape != (ndir, g)
            or lengths.shape != (b,) or ndir not in (1, 2)):
        raise ValueError(f"{where}: inconsistent shapes "
                         f"xp {tuple(xp.shape)} w_hh {tuple(w_hh.shape)} "
                         f"b_ih {tuple(b_ih.shape)} b_hh {tuple(b_hh.shape)} "
                         f"lengths {tuple(lengths.shape)}")
    same_device(where, xp.device, b_ih=b_ih, w_hh=w_hh, b_hh=b_hh,
                lengths=lengths)
    return ndir, t, b, hidden


# The bf16 recurrence kernels' tiling (csrc/rnn_mma.cuh): TJ hidden units a
# block, K chunks of KC h columns
MMA_TJ, MMA_KC = 32, 64
# "auto" is the kernels' fixed rule: persistent where the batch fits one
# chunk (<= 64 rows) and the whole grid is resident at once
SCAN_VARIANTS = {"auto": 0, "step": 1, "persistent": 2}


def pack_w_hh(w_hh: torch.Tensor, gates: int) -> torch.Tensor:
    """(D, H, G*H) -> (D, NJ, NK, G*TJ, KC), the order in which the bf16
    recurrence's blocks read W_hh: tile (d, jb, kc), row g*TJ + jj, column
    kk holds ``w_hh[d, kc*KC + kk, g*H + jb*TJ + jj]``, zero past H."""
    ndir, hidden, _ = w_hh.shape
    nj = -(-hidden // MMA_TJ)
    nk = -(-hidden // MMA_KC)
    w = w_hh.reshape(ndir, hidden, gates, hidden)
    w = torch.nn.functional.pad(w, (0, nj * MMA_TJ - hidden, 0, 0,
                                    0, nk * MMA_KC - hidden))
    w = w.reshape(ndir, nk, MMA_KC, gates, nj, MMA_TJ)
    return w.permute(0, 4, 1, 3, 5, 2).reshape(
        ndir, nj, nk, gates * MMA_TJ, MMA_KC).contiguous()


def unpack_w_hh(packed: torch.Tensor, gates: int,
                hidden: int) -> torch.Tensor:
    """The inverse of ``pack_w_hh`` -> (D, H, G*H)."""
    ndir, nj, nk = packed.shape[:3]
    w = packed.reshape(ndir, nj, nk, gates, MMA_TJ, MMA_KC)
    w = w.permute(0, 2, 5, 3, 1, 4).reshape(
        ndir, nk * MMA_KC, gates, nj * MMA_TJ)
    return w[:, :hidden, :, :hidden].reshape(ndir, hidden, gates * hidden)


def h_copy_shape(ndir: int, b: int, hidden: int) -> tuple:
    """(2, D, B8, Hk): the bf16 kernels' two copies of h_prev in the
    operand type, the batch padded to 8 rows and H to whole K chunks."""
    return (2, ndir, -(-b // 8) * 8, -(-hidden // MMA_KC) * MMA_KC)


def scan_variant(variant: str) -> int:
    if variant not in SCAN_VARIANTS:
        raise ValueError(f"variant must be one of {sorted(SCAN_VARIANTS)}, "
                         f"got {variant!r}")
    return SCAN_VARIANTS[variant]


# K4's f32 persistent variant (csrc/gru_scan.cu, f32_scan): F32_TJ units a
# block, F32_ROW floats a packed W_hh row (its 3 * F32_TJ columns padded),
# K chunks of F32_KC rows, the batch in blocks of F32_RB rows, at most
# F32_CHUNK rows (the kernel's TJ, ROW, KC, RT, NB: ``gru._scan_kernel``
# holds them to its ``gru_scan_f32_layout`` when it loads the library);
# "auto" takes it from F32_MIN_BLOCKS blocks a direction, a threshold
# interpolated between two measured grids (``scan_f32_variant``)
F32_TJ, F32_ROW, F32_KC, F32_RB, F32_CHUNK = 25, 84, 32, 8, 64
F32_LAYOUT = (F32_TJ, F32_ROW, F32_KC, F32_RB, F32_CHUNK)
F32_MIN_BLOCKS = 48


def pack_w_hh_f32(w_hh: torch.Tensor) -> torch.Tensor:
    """(D, H, G*H) -> (D, NJ, Hk, ROW), the order in which the f32
    persistent kernel's blocks read W_hh (NJ = ceil(H / TJ), Hk = H rounded
    up to KC): row k of block jb holds, at column g*TJ + u,
    ``w_hh[d, k, g*H + jb*TJ + u]``; zero past H in k and in the units, and
    in the columns from G*TJ on. A block's K chunk of KC rows is one
    contiguous run."""
    ndir, hidden, gh = w_hh.shape
    gates = gh // hidden
    nj = -(-hidden // F32_TJ)
    w = w_hh.reshape(ndir, hidden, gates, hidden)
    if nj * F32_TJ != hidden:
        w = torch.nn.functional.pad(w, (0, nj * F32_TJ - hidden))
    # one fill and one strided copy: two kernels a call on the card
    out = w_hh.new_zeros((ndir, nj, -(-hidden // F32_KC) * F32_KC,
                          F32_ROW))
    out[:, :, :hidden, :gates * F32_TJ].unflatten(-1, (gates, F32_TJ)).copy_(
        w.reshape(ndir, hidden, gates, nj, F32_TJ).permute(0, 3, 1, 2, 4))
    return out


def unpack_w_hh_f32(packed: torch.Tensor, gates: int,
                    hidden: int) -> torch.Tensor:
    """The inverse of ``pack_w_hh_f32`` -> (D, H, G*H)."""
    ndir, nj, hk = packed.shape[:3]
    w = packed[..., :gates * F32_TJ].reshape(ndir, nj, hk, gates, F32_TJ)
    w = w.permute(0, 2, 3, 1, 4).reshape(ndir, hk, gates, nj * F32_TJ)
    return w[:, :hidden, :, :hidden].reshape(ndir, hidden, gates * hidden)


def h_copy_shape_f32(ndir: int, b: int, hidden: int) -> tuple:
    """(2, D, Hk, P): the f32 persistent kernel's two copies of h_prev,
    transposed (element (k, b) of a copy at k * P + b), H rounded up to
    whole K chunks and the pitch P the batch rounded up to F32_RB, + 4."""
    return (2, ndir, -(-hidden // F32_KC) * F32_KC,
            -(-b // F32_RB) * F32_RB + 4)


def f32_blocks(ndir: int, hidden: int) -> int:
    """The f32 persistent kernel's grid: ceil(H / TJ) blocks a direction."""
    return ndir * -(-hidden // F32_TJ)


def scan_f32_variant(variant: str, b: int, hidden: int, ndir: int,
                     capacity: int) -> int:
    """K4's f32 variant, 1 (one launch a step, ``gru_step``) or 2 (one
    persistent launch): ``variant`` "step" or "persistent" as asked; "auto"
    the rule, persistent where the batch fits (<= F32_CHUNK rows) and the
    grid is resident at once (``capacity`` blocks can be), where it fills
    the card (F32_MIN_BLOCKS blocks a direction or more: H >= 1,176) and
    where the batch is more than one block of F32_RB rows; else one launch
    a step. Each persistent block walks all of H's K chunks every step, so
    its step takes about as long on a small grid as on a full one, while
    the step kernel spreads ceil(B / 8) reads of W_hh over the whole card:
    on the H100 (PERF.md) the persistent step is 2.3x faster at B 64,
    H 1600, D 2, 1.7x at B 20 and 1.2x at D 1, but 8% slower at H 800, D 2
    (64 blocks) and 4% slower at B 8. No grid between 32 and 64 blocks a
    direction was measured, and no configuration runs one: 48 is
    interpolated. The persistent step grows about as H, the step kernel's
    as H squared, so the two measured grids put their crossing near 35
    blocks a direction (H ~865), below the threshold."""
    mode = scan_variant(variant)
    if mode:
        return mode
    return 2 if (F32_RB < b <= F32_CHUNK
                 and f32_blocks(ndir, hidden) <= capacity
                 and f32_blocks(1, hidden) >= F32_MIN_BLOCKS) else 1


# The fused forwards' bf16 variants (K2, K3; csrc/rnn_mma.cuh): one launch a
# step, persistent with W_hh streamed from L2 once a step, persistent with
# each block's W_hh slice resident in shared memory. "auto" is the rule
# ``fwd_variant``.
FWD_VARIANTS = {"auto": 0, "step": 1, "persistent": 2, "resident": 3}
# The W-resident variant's units a block and blocks a cluster (sharing each
# step's h_prev load), its column groups of that load, the batch rows of
# one chunk (the persistent variants' limit), and the shared memory a block
# may have
RES_TJ, RES_CL, RES_HCH, FWD_CHUNK, SMEM_MAX = 16, 4, 2, 64, 232448
# K2's and K3's bf16 projection GEMM (csrc/proj_mma.cuh): output tiles of
# PROJ_BM x PROJ_BN, K in chunks of PROJ_BK
PROJ_BM, PROJ_BN, PROJ_BK = 128, 128, 32


def fwd_mode(variant: str) -> int:
    if variant not in FWD_VARIANTS:
        raise ValueError(f"variant must be one of {sorted(FWD_VARIANTS)}, "
                         f"got {variant!r}")
    return FWD_VARIANTS[variant]


def res_shape(b: int) -> tuple[int, int, int]:
    """The W-resident variant's warps for a batch of b rows (``ResShape`` in
    csrc/rnn_mma.cuh) -> (NT n tiles of 8 rows in the chunk, WN warps along
    the batch, KS warps along K); the 16 warps are 2 groups of gate tiles
    x KS x WN, each taking NT / WN n tiles and the k16 steps ks, ks + KS,
    ...; each output's KS partial sums meet in KS slots."""
    b8 = -(-b // 8) * 8
    nt = 2 if b8 <= 16 else 4 if b8 <= 32 else 8
    wn = 2 if nt == 8 else 1
    return nt, wn, 16 // (2 * wn)


def res_smem(gates: int, b: int, hidden: int) -> int:
    """Shared memory of one block of the W-resident variant (``ResShape``
    in csrc/rnn_mma.cuh): the G * 16 gate rows of its units and the
    h_prev staging of the batch chunk, rows of KW = 16 ceil(H / 16) columns
    at a pitch of KW + 8, the staging's bytes shared with the K-split
    sums' slots, then one mbarrier for each column group of the h_prev
    load."""
    nt, _, ks = res_shape(b)
    m, nc = gates * RES_TJ, nt * 8
    pitch = -(-hidden // 16) * 16 + 8
    red = ks * nc * (m + 4) * 4
    return m * pitch * 2 + max(nc * pitch * 2, red) + 8 * RES_HCH


def fwd_blocks(ndir: int, hidden: int) -> tuple[int, int]:
    """The grids of the fused forwards' persistent variants: (streamed, 32
    units a block; resident, RES_TJ units a block in whole clusters of
    RES_CL), over both directions."""
    nj = -(-hidden // RES_TJ)
    return ndir * -(-hidden // MMA_TJ), ndir * -(-nj // RES_CL) * RES_CL


def fwd_variant(variant: str, gates: int, b: int, hidden: int, ndir: int,
                streamed: int, resident: int) -> int:
    """K2's and K3's bf16 variant, 1 (one launch a step), 2 (persistent,
    W_hh streamed) or 3 (persistent, W_hh resident): ``variant`` "step",
    "persistent" or "resident" as asked; "auto" the fixed rule. The rule,
    for a batch that fits one chunk (<= 64 rows; else one launch a step):
    resident where its slices fit a block's shared memory and its grid is
    resident at once (``resident`` blocks can be), else persistent where
    its grid is (``streamed`` blocks can be), else one launch a step."""
    mode = fwd_mode(variant)
    if mode:
        return mode
    if -(-b // 8) * 8 > FWD_CHUNK:
        return 1
    grid_s, grid_r = fwd_blocks(ndir, hidden)
    if res_smem(gates, b, hidden) <= SMEM_MAX and grid_r <= resident:
        return 3
    return 2 if grid_s <= streamed else 1


_capacity: dict = {}


def fwd_capacity(lib: ctypes.CDLL, name: str, b: int, hidden: int,
                 dev: torch.device) -> tuple[int, int]:
    """How many blocks of a fused forward's streamed and W-resident
    persistent kernels can be resident at once on ``dev`` (the C entry
    ``name`` of ``lib``: ``<cell>_fwd_capacity``) for a batch of ``b`` rows
    and ``hidden`` units; asked once."""
    key = (name, -(-b // 8), hidden, torch.cuda.current_device()
           if dev.index is None else dev.index)
    if key not in _capacity:
        streamed, resident = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(dev):
            code = getattr(lib, name)(b, hidden, ctypes.byref(streamed),
                                      ctypes.byref(resident))
        build.check(lib, code, name)
        _capacity[key] = (streamed.value, resident.value)
    return _capacity[key]


# The bf16 backward kernels' tiling (csrc/rnn_mma_bwd.cuh): clusters of
# BWD_CL blocks split the product's K for BWD_TM = BWD_CL * 32 hidden units,
# K chunks of BWD_KC gate columns, at most BWD_CHUNK batch rows in one chunk
# (the persistent variant's limit)
BWD_CL, BWD_TM, BWD_KC, BWD_CHUNK = 2, 64, 128, 64


def pack_w_hh_bwd(w_hh: torch.Tensor) -> torch.Tensor:
    """(D, H, G*H) -> (D, NJ, NK, TM, KC), the order in which the bf16
    backward's clusters read W_hh (NJ = ceil(H / TM), NK = ceil(G*H /
    KC)): tile (d, jw, kc), row jj, column kk holds
    ``w_hh[d, jw*TM + jj, kc*KC + kk]``, zero past H and past G*H."""
    ndir, hidden, gh = w_hh.shape
    nj = -(-hidden // BWD_TM)
    nk = -(-gh // BWD_KC)
    w = torch.nn.functional.pad(w_hh, (0, nk * BWD_KC - gh,
                                       0, nj * BWD_TM - hidden))
    w = w.reshape(ndir, nj, BWD_TM, nk, BWD_KC)
    return w.permute(0, 1, 3, 2, 4).contiguous()


def unpack_w_hh_bwd(packed: torch.Tensor, gates: int,
                    hidden: int) -> torch.Tensor:
    """The inverse of ``pack_w_hh_bwd`` -> (D, H, G*H)."""
    ndir, nj, nk, tm, kc = packed.shape
    w = packed.permute(0, 1, 3, 2, 4).reshape(ndir, nj * tm, nk * kc)
    return w[:, :hidden, :gates * hidden]


def op_copy_shape(ndir: int, b: int, hidden: int, gates: int) -> tuple:
    """(2, D, B8, Gk): the bf16 backward's two copies of the product's
    operand, the batch padded to 8 rows and G*H to whole K chunks."""
    return (2, ndir, -(-b // 8) * 8, -(-gates * hidden // BWD_KC) * BWD_KC)


def bwd_blocks(ndir: int, hidden: int) -> int:
    """The bf16 backward's grid: BWD_CL blocks for every BWD_TM units of
    each direction."""
    return ndir * -(-hidden // BWD_TM) * BWD_CL


def bwd_variant(variant: str, b: int, blocks: int, resident: int) -> int:
    """The bf16 backward's variant, 1 (one launch a step) or 2
    (persistent): ``variant`` "step" or "persistent" as asked; "auto" the
    fixed rule, persistent where the batch fits one chunk and the grid of
    ``blocks`` is resident at once (``resident`` blocks can be)."""
    mode = scan_variant(variant)
    if mode:
        return mode
    return 2 if -(-b // 8) * 8 <= BWD_CHUNK and blocks <= resident else 1


_resident: dict = {}


def resident_blocks(lib: ctypes.CDLL, name: str, size: int,
                    dev: torch.device) -> int:
    """How many blocks of a persistent kernel (the C entry ``name`` of
    ``lib``: ``<cell>_bwd_resident`` for a bf16 backward at a batch of
    ``size`` rows, ``gru_scan_f32_capacity`` for K4's f32 variant at
    ``size`` units) can be resident at once on ``dev``; asked once."""
    key = (name, size, torch.cuda.current_device()
           if dev.index is None else dev.index)
    if key not in _resident:
        n = ctypes.c_int(0)
        with torch.cuda.device(dev):
            code = getattr(lib, name)(size, ctypes.byref(n))
        build.check(lib, code, name)
        _resident[key] = n.value
    return _resident[key]

