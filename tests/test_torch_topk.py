"""PyTorch port: the total-order top-k (K10) against the JAX package.

``ops/cuda/topk.py:plain``, which the wrapper runs for CPU tensors, is held
bit for bit (values as int32 bits, and indices) against the Pallas kernel
``topk_total_order(..., interpret=True, force=True)`` and against the numpy
lexsort oracle of tests/test_topk_kernel.py, on that file's cases, batched
rows and NaNs. The kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeech_tpu.ops.pallas.topk_kernel import topk_total_order as jax_topk
from deepspeech_tpu_torch.ops.cuda import topk


def ref_topk(x: np.ndarray, k: int):
    u = x.view(np.int32).astype(np.int64)
    key = u ^ (0x7FFFFFFF & (u >> 31))
    order = np.lexsort((np.arange(len(x)), -key))
    return x[order[:k]], order[:k].astype(np.int32)


def port(x: np.ndarray, k: int):
    """The wrapper on (R, n) rows (a 1-D row runs as one row)."""
    v, i = topk.topk_total_order(torch.from_numpy(np.atleast_2d(x).copy()), k)
    return v.numpy().reshape(x.shape[:-1] + (k,)), i.numpy().reshape(
        x.shape[:-1] + (k,))


def jax_kernel(x: np.ndarray, k: int):
    v, i = jax_topk(jnp.asarray(x), k, interpret=True, force=True)
    return np.asarray(v), np.asarray(i)


def assert_same(got, ref):
    (gv, gi), (rv, ri) = got, ref
    assert np.array_equal(gv.view(np.int32), rv.view(np.int32))
    assert np.array_equal(gi, ri)


@pytest.mark.parametrize("n,k", [(300, 10), (960, 32), (3840, 128)])
def test_matches_total_order(n, k):
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal(n).astype(np.float32)
    x[rng.integers(0, n, n // 6)] = np.float32(1.5)          # exact ties
    x[rng.integers(0, n, n // 8)] = np.float32(-np.inf)
    got = port(x, k)
    assert_same(got, ref_topk(x, k))
    assert_same(got, jax_kernel(x, k))


def test_signed_zero_and_inf_edges():
    x = np.array([-0.0, 1.0, 0.0, -np.inf, np.inf, -0.0, 0.0, 1.0],
                 np.float32)
    got = port(x, 5)
    assert_same(got, ref_topk(x, 5))
    assert_same(got, jax_kernel(x, 5))
    # inf, the 1.0s by index, then +0.0 above -0.0 wherever they stand
    assert list(got[1]) == [4, 1, 7, 2, 6]
    v8, i8 = port(x, 8)
    assert list(i8[5:]) == [0, 5, 3]
    assert np.signbit(v8[5:7]).all()  # the bits come back as given


def test_all_equal_is_index_order():
    x = np.full(600, 0.25, np.float32)
    got = port(x, 17)
    assert np.array_equal(got[1], np.arange(17))
    assert np.all(got[0] == 0.25)
    assert_same(got, jax_kernel(x, 17))


def test_fuzz_vs_reference():
    rng = np.random.default_rng(7)
    for _ in range(6):
        n = int(rng.integers(130, 2500))
        k = int(rng.integers(1, 129))
        x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 1e30])
             ).astype(np.float32)
        x[rng.integers(0, n, n // 5)] = np.float32(
            rng.choice([0.0, -0.0, np.inf, -np.inf, 3.25]))
        got = port(x, k)
        assert_same(got, ref_topk(x, k))
        assert_same(got, jax_kernel(x, k))


@pytest.mark.parametrize("r,n,k", [(20, 310, 10), (5, 3968, 128),
                                   (3, 1, 1), (4, 7, 7)])
def test_batched_rows_match_each_row(r, n, k):
    """(R, n) rows in one call, the beam's shapes among them: each row as
    the oracle gives it alone."""
    rng = np.random.default_rng(r * n + k)
    x = rng.standard_normal((r, n)).astype(np.float32)
    x[:, rng.integers(0, n, max(1, n // 4))] = np.float32(-np.inf)
    x[r // 2] = np.float32(0.5)  # one row of exact ties
    v, i = port(x, k)
    for row in range(r):
        assert_same((v[row], i[row]), ref_topk(x[row], k))


def test_nans_rank_by_their_bits():
    """Positive NaNs above +inf, negative NaNs below -inf, payloads kept;
    a negative NaN is returned where it ranks, never padding."""
    pos_nan = np.array([0x7FC00001], np.uint32).view(np.float32)[0]
    neg_nan = np.array([0xFFC00002], np.uint32).view(np.float32)[0]
    x = np.array([1.0, neg_nan, -np.inf, pos_nan, np.inf, -0.0, neg_nan],
                 np.float32)
    v, i = port(x, 7)
    assert_same((v, i), ref_topk(x, 7))
    assert list(i) == [3, 4, 0, 5, 2, 1, 6]
    assert v.view(np.uint32)[0] == 0x7FC00001
    assert v.view(np.uint32)[-1] == 0xFFC00002
    rng = np.random.default_rng(11)
    rows = rng.standard_normal((6, 300)).astype(np.float32)
    rows[:, rng.integers(0, 300, 60)] = rng.choice([pos_nan, neg_nan], 60)
    vr, ir = port(rows, 300)
    for row in range(6):
        assert_same((vr[row], ir[row]), ref_topk(rows[row], 300))


def test_wrapper_checks():
    x = torch.zeros(2, 5)
    with pytest.raises(ValueError, match="1 <= k <= n"):
        topk.topk_total_order(x, 6)
    with pytest.raises(ValueError, match="R, n"):
        topk.topk_total_order(x[0], 2)
    with pytest.raises(TypeError, match="float32"):
        topk.topk_total_order(x.double(), 2)
    assert [topk.padded_size(n) for n in (1, 2, 3, 310, 3968)] == [
        2, 2, 4, 512, 4096]
