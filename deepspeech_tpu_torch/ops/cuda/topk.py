"""Wrapper of the total-order top-k kernel (``csrc/topk.cu``).

Replaces ``deepspeech_tpu/ops/pallas/topk_kernel.py`` (``_topk_kernel``,
via ``_topk_pallas`` and ``topk_total_order``), the selection step of the
device beam search. For a CPU tensor the wrapper runs ``plain``, the plain
PyTorch version beside it; for a CUDA tensor it launches the kernel or
raises. It never falls back to ``torch.topk``, which does not promise this
order among ties.

Order, as TPU ``lax.top_k``: descending by the bitwise total order of
float32 (``+0.0 > -0.0``, positive NaNs above ``+inf``, negative NaNs below
``-inf``), ties by ascending index; the values keep the input's bits.

The kernel has two routes, chosen by a fixed rule on ``k`` before the
launch (``route``): a radix select for ``k <= SELECT_MAX_K`` and a bitonic
sort of the row above it. Both count as launches of ``topk``; a failure in
either raises. Each refuses rows longer than it holds: the selection
``SELECT_MAX_N`` keys in registers (``select_shape``), the sort a padded
row in shared memory (``padded_size``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepspeech_tpu_torch.ops.cuda import build

launches = 0  # kernel launches since the caller last reset it

SMEM_BYTES = 232_448  # shared memory one block may use on Hopper
SELECT_MAX_K = 256    # the selection's candidate buffer
SELECT_MAX_KPT = 16   # keys a thread of the selection holds in registers
SELECT_MAX_N = 1024 * SELECT_MAX_KPT

_P = ctypes.c_void_p
_I = ctypes.c_int


def monotone_key(score: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 key with the float's bitwise total order
    (self-inverse on the bits; the sign bit is kept)."""
    u = score.contiguous().view(torch.int32)
    return u ^ (0x7FFFFFFF & (u >> 31))


def plain(score: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, n) f32 -> (values (R, k) f32, indices (R, k) int32): a stable
    descending sort of the monotone keys, whose ties keep ascending index."""
    _, order = torch.sort(monotone_key(score), dim=-1, descending=True,
                          stable=True)
    order = order[:, :k]
    return score.gather(1, order), order.to(torch.int32)


@functools.cache
def _kernel():
    lib = build.load("topk")
    lib.topk_bitonic_f32.argtypes = [_P, _P, _P] + [_I] * 4 + [_P]
    lib.topk_bitonic_f32.restype = _I
    lib.topk_select_f32.argtypes = [_P, _P, _P] + [_I] * 5 + [_P]
    lib.topk_select_f32.restype = _I
    return lib


def route(k: int) -> str:
    """"select" for k <= SELECT_MAX_K, else "bitonic"."""
    return "select" if k <= SELECT_MAX_K else "bitonic"


def select_shape(n: int) -> tuple[int, int]:
    """The selection's (threads, keys a thread) for rows of n: the fewest
    keys a thread, a power of two, that keep the block within 1,024
    threads; the threads rounded up to a warp."""
    kpt = 1
    while n > 1024 * kpt:
        kpt *= 2
    threads = -(-n // kpt)
    return -(-threads // 32) * 32, kpt


def padded_size(n: int) -> int:
    """The bitonic route's row length: n rounded up to a power of two, at
    least 2."""
    return max(2, 1 << (n - 1).bit_length())


def topk_total_order(score: torch.Tensor,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K10: the top ``k`` of each row of (R, n) float32 ``score`` ->
    (values (R, k) f32, indices (R, k) int32)."""
    if score.ndim != 2:
        raise ValueError(f"expected (R, n) scores, got {tuple(score.shape)}")
    r, n = score.shape
    if not 1 <= k <= n:
        raise ValueError(f"top-k needs 1 <= k <= n, got k={k}, n={n}")
    if score.dtype != torch.float32:
        raise TypeError(f"topk_total_order takes float32, got {score.dtype}")
    if score.device.type == "cpu":
        return plain(score, k)
    if score.device.type != "cuda":
        raise ValueError(f"topk_total_order: unsupported device "
                         f"{score.device}")
    how = route(k)
    npad = padded_size(n)
    if how == "select" and n > SELECT_MAX_N:
        raise ValueError(f"topk kernel: a row of {n} keys is over the "
                         f"{SELECT_MAX_N} the selection holds in registers "
                         f"({SELECT_MAX_KPT} a thread)")
    if how == "bitonic" and npad * 8 > SMEM_BYTES:
        raise ValueError(f"topk kernel: a row of {n} pads to {npad} keys, "
                         f"{npad * 8} bytes, over the {SMEM_BYTES} bytes of "
                         "shared memory a block may use")
    score = score.contiguous()
    vals = torch.empty((r, k), dtype=torch.float32, device=score.device)
    idx = torch.empty((r, k), dtype=torch.int32, device=score.device)
    if r == 0:
        return vals, idx
    lib = _kernel()
    stream = torch.cuda.current_stream(score.device).cuda_stream
    ptrs = score.data_ptr(), vals.data_ptr(), idx.data_ptr()
    with torch.cuda.device(score.device):
        if how == "select":
            code = lib.topk_select_f32(*ptrs, r, n, k, *select_shape(n),
                                       stream)
        else:
            code = lib.topk_bitonic_f32(*ptrs, r, n, npad, k, stream)
    build.check(lib, code, f"topk kernel ({how} route)")
    global launches
    launches += 1
    return vals, idx
