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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepspeech_tpu_torch.ops.cuda import build

launches = 0  # kernel launches since the caller last reset it

SMEM_BYTES = 232_448  # shared memory one block may use on Hopper

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
    lib.topk_f32.argtypes = [_P, _P, _P] + [_I] * 4 + [_P]
    lib.topk_f32.restype = _I
    return lib


def padded_size(n: int) -> int:
    """The kernel's row length: n rounded up to a power of two, at least 2."""
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
    npad = padded_size(n)
    if npad * 8 > SMEM_BYTES:
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
    with torch.cuda.device(score.device):
        code = lib.topk_f32(score.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                            r, n, npad, k, stream)
    build.check(lib, code, "topk kernel")
    global launches
    launches += 1
    return vals, idx
