"""PyTorch port: the design of K4's f32 persistent variant
(``csrc/gru_scan.cu``, ``f32_scan``), held on the CPU.

The CUDA code runs only on the card (tests/test_torch_cuda.py); here its
layouts and arithmetic are held in PyTorch: W_hh packed into the blocks'
order (``pack_w_hh_f32``) and back; h_prev's two transposed copies
(``h_copy_shape_f32``); a model of the whole walk (each block's sums from
its packed rows and the h copy, split over the 8 K-lanes and added in the
shuffles' order, the gate update with both biases in f32, the state carried
past each length, the backward direction's t = len - 1 - s) against
``plain_scan``; then the rule that picks the variant.

Tolerance: the walk against ``plain_scan`` 1e-5 (f32 sums in another
order; plain_scan's products are f32 too).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeech_tpu_torch.ops.cuda import gru as gru_k
from deepspeech_tpu_torch.ops.cuda.recurrence import (F32_CHUNK, F32_KC,
                                                      F32_MIN_BLOCKS,
                                                      F32_LAYOUT, F32_RB,
                                                      F32_ROW, F32_TJ,
                                                      f32_blocks,
                                                      h_copy_shape_f32,
                                                      pack_w_hh_f32,
                                                      scan_f32_variant,
                                                      unpack_w_hh_f32)

torch.set_num_threads(2)

# T 7, B 5 (not a multiple of 16), H 60 (a ragged last block of 25 units
# and a ragged last K chunk of 32); ragged lengths with a length-1 row and
# a full one
T, B, H = 7, 5, 60
LENS = torch.tensor([7, 5, 1, 6, 3])
KL = 8  # lanes splitting K


def _case(ndir, seed=5):
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(H)

    def u(*shape, lo=-s, hi=s):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32))

    return (u(ndir, T, B, 3 * H, lo=-1, hi=1), u(ndir, 3 * H),
            u(ndir, H, 3 * H), u(ndir, 3 * H), LENS)


@pytest.mark.parametrize("hidden", [60, 1600])
@pytest.mark.parametrize("ndir", [1, 2])
def test_pack_w_hh_f32_round_trip(ndir, hidden):
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (ndir, hidden, 3 * hidden)).astype(np.float32))
    packed = pack_w_hh_f32(w)
    nj, hk = -(-hidden // F32_TJ), -(-hidden // F32_KC) * F32_KC
    assert packed.shape == (ndir, nj, hk, F32_ROW)
    assert torch.equal(unpack_w_hh_f32(packed, 3, hidden), w)
    # zero past H in k and in the units, and in the pad columns
    assert int((packed != 0).sum()) == int((w != 0).sum())
    # row k of block jb, gate g, unit u
    d, jb, k, g, u = ndir - 1, nj - 1, hidden - 1, 2, (hidden - 1) % F32_TJ
    assert packed[d, jb, k, g * F32_TJ + u] == w[d, k, g * hidden
                                                 + jb * F32_TJ + u]


@pytest.mark.parametrize("ndir,b,hidden,shape", [
    (2, 64, 1600, (2, 2, 1600, 68)), (1, 5, 60, (2, 1, 64, 12)),
    (2, 20, 1600, (2, 2, 1600, 28)), (2, 33, 800, (2, 2, 800, 44))])
def test_h_copy_shape_f32(ndir, b, hidden, shape):
    """The pitch is the batch rounded up to 8, + 4: a multiple of 4 whose
    quarter is odd, so 8 consecutive k rows of a quarter-warp's 16-byte
    reads fall on the 8 bank groups."""
    assert h_copy_shape_f32(ndir, b, hidden) == shape
    assert shape[3] % 4 == 0 and (shape[3] // 4) % 2 == 1


def _lane_sums(w, h, nk):
    """h (Hk, P) against w (Hk, N) as a block's lanes sum them: lane kl takes
    the rows c * KC + i * KL + kl; the 8 lanes' sums meet by xor shuffles
    1, 2, 4 -> (P, N)."""
    prod = h[:, :, None] * w[:, None, :]
    v = prod.reshape(nk, F32_KC // KL, KL, *prod.shape[1:]).sum((0, 1))
    while v.shape[0] > 1:
        v = v[0::2] + v[1::2]
    return v[0]


def _walk(xp, b_ih, w_hh, b_hh, lens, residuals):
    """The persistent kernel's walk: every block's sums from its packed
    rows and the step's h copy, then its epilogue for each (row, unit)."""
    ndir, t, b, gh = xp.shape
    hidden = gh // 3
    packed = pack_w_hh_f32(w_hh)
    ht = torch.zeros(h_copy_shape_f32(ndir, b, hidden))
    nk = ht.shape[2] // F32_KC
    out = torch.zeros((ndir, t, b, hidden))
    gates = torch.zeros((ndir, t, b, gh))
    hns = torch.zeros((ndir, t, b, hidden))
    state = torch.zeros((ndir, b, hidden))
    rows = torch.arange(b)
    for s in range(t):
        hin, hout = ht[s % 2], ht[(s + 1) % 2]
        valid = s < lens
        for d in range(ndir):
            tt = torch.where(valid, lens - 1 - s, s) if d else \
                torch.full((b,), s)
            for jb in range(packed.shape[1]):
                units = jb * F32_TJ + torch.arange(F32_TJ)
                units = units[units < hidden]
                sums = _lane_sums(packed[d, jb], hin[d], nk)[:b]
                hg = [sums[:, g * F32_TJ:g * F32_TJ + len(units)]
                      + b_hh[d, g * hidden + units] for g in range(3)]
                x = [xp[d, tt, rows][:, g * hidden + units]
                     + b_ih[d, g * hidden + units] for g in range(3)]
                r = torch.sigmoid(x[0] + hg[0])
                z = torch.sigmoid(x[1] + hg[1])
                n = torch.tanh(x[2] + r * hg[2])
                hp = state[d][:, units]
                h = torch.where(valid[:, None], (1 - z) * n + z * hp, hp)
                state[d][:, units] = h
                hout[d, units, :b] = h.t()
                keep, at = valid[:, None], (d, tt[:, None], rows[:, None])
                out[(*at, units)] = torch.where(keep, h, 0.0)
                for g, v in enumerate((r, z, n)):
                    gates[(*at, g * hidden + units)] = torch.where(keep, v,
                                                                  0.0)
                hns[(*at, units)] = torch.where(keep, hg[2], 0.0)
    return (out, gates, hns) if residuals else out


@pytest.mark.parametrize("ndir", [1, 2])
def test_f32_walk_matches_plain_scan(ndir):
    """The model of the persistent kernel's walk, inference and with
    residuals, against plain_scan at 1e-5; zero past each row's length."""
    args = _case(ndir)
    got = _walk(*args, residuals=True)
    want = gru_k.plain_scan(*args, residuals=True)
    for name, a, w in zip(("h", "g", "hn"), got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5, msg=name)
    torch.testing.assert_close(_walk(*args, residuals=False), want[0],
                               rtol=0, atol=1e-5)
    pad = torch.arange(T)[:, None] >= LENS[None, :]
    assert not got[0][:, pad].any()


# H100 SXM: 132 SMs, one block of the persistent kernel on each
SMS = 132


@pytest.mark.parametrize("b,hidden,ndir,capacity,want", [
    (64, 1600, 2, SMS, 2),   # the eval cell's layers: 128 blocks
    (20, 1600, 2, SMS, 2), (9, 1600, 2, SMS, 2), (64, 1600, 1, SMS, 2),
    (64, 1200, 2, SMS, 2),   # 48 blocks a direction
    (65, 1600, 2, SMS, 1),   # past one chunk of 64 rows
    (130, 800, 2, SMS, 1),
    (64, 1700, 2, SMS, 1),   # 136 blocks: not resident at once
    (64, 1600, 2, 127, 1),   # a card with fewer blocks resident
    (64, 800, 2, SMS, 1),    # 32 blocks a direction: the card half idle
    (64, 1175, 2, SMS, 1), (20, 800, 1, SMS, 1),
    (8, 1600, 2, SMS, 1),    # one block of 8 rows
])
def test_scan_f32_variant_rule(b, hidden, ndir, capacity, want):
    """"auto": persistent where the batch fits F32_CHUNK rows and is more
    than F32_RB, the grid of ceil(H / 25) blocks a direction is resident at
    once and has F32_MIN_BLOCKS blocks a direction; else one launch a step;
    the named variants as asked; anything else raises."""
    nj = -(-hidden // F32_TJ)
    assert (F32_RB < b <= F32_CHUNK and f32_blocks(ndir, hidden) <= capacity
            and nj >= F32_MIN_BLOCKS) == (want == 2)
    assert scan_f32_variant("auto", b, hidden, ndir, capacity) == want
    for name, mode in (("step", 1), ("persistent", 2)):
        assert scan_f32_variant(name, b, hidden, ndir, capacity) == mode
    with pytest.raises(ValueError, match="variant"):
        scan_f32_variant("resident", b, hidden, ndir, capacity)


def test_f32_blocks():
    assert f32_blocks(2, 1600) == 128
    assert f32_blocks(1, 60) == 3


def test_f32_layout_is_the_kernels():
    """F32_LAYOUT repeats the kernel's TJ, ROW, KC, RT and NB, as
    ``csrc/gru_scan.cu`` states them in ``namespace f32_scan`` (on the card
    ``gru._scan_kernel`` holds them to the built library's
    ``gru_scan_f32_layout`` too)."""
    src = (Path(gru_k.__file__).parents[2] / "csrc" / "gru_scan.cu"
           ).read_text()
    body = src.split("namespace f32_scan {", 1)[1].split(
        "}  // namespace f32_scan", 1)[0]
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", body))
    assert tuple(int(consts[k]) for k in ("TJ", "ROW", "KC", "RT", "NB")) \
        == F32_LAYOUT == (F32_TJ, F32_ROW, F32_KC, F32_RB, F32_CHUNK)
