"""PyTorch port: the CTC loss against the JAX package.

The port's loss and logit gradient (the CPU side of the K8/K9 wrappers,
their plain versions) are held to ``ctc_loss(impl="pallas_interpret")``,
the Pallas alpha/beta kernels in interpret mode, and to the XLA scan, at
the tolerances of tests/test_pallas_ctc.py: 1e-4 for the loss, rtol 1e-3 /
atol 1e-4 for the gradient. ``torch.nn.functional.ctc_loss`` is a second
oracle (same loss; its gradient with reduction="sum" is the same closed
form). An impossible alignment gives +inf and a gradient of exactly 0.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from deepspeech_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from deepspeech_tpu.ops.ctc import ctc_loss_mean as jax_ctc_loss_mean
from deepspeech_tpu_torch.ops import ctc as port_ctc
from deepspeech_tpu_torch.ops.cuda import ctc as ctc_k

torch.set_num_threads(2)


def _case(seed, b=4, t=37, c=8, lmax=7):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, c)).astype(np.float32)
    ll = rng.integers(lmax * 2 + 2, t + 1, b).astype(np.int32)
    targets = rng.integers(1, c, (b, lmax)).astype(np.int32)
    tl = rng.integers(0, lmax + 1, b).astype(np.int32)
    return logits, ll, targets, tl


def _full_lengths():
    rng = np.random.default_rng(1)
    b, t, c, lmax = 3, 29, 6, 5
    logits = rng.standard_normal((b, t, c)).astype(np.float32)
    return (logits, np.full(b, t, np.int32),
            rng.integers(1, c, (b, lmax)).astype(np.int32),
            np.array([lmax, 3, 0], np.int32))


def _zero_targets():
    logits, ll, targets, _ = _case(4)
    return logits, ll, targets, np.array([0, 3, 0, 7], np.int32)


CASES = {"random": lambda: _case(0),
         "grad_case": lambda: _case(2, 3, 25, 7, 5),
         "full_lengths": _full_lengths, "zero_target": _zero_targets}


def _jax_loss_and_grad(args, impl):
    logits, ll, targets, tl = (jnp.asarray(a) for a in args)

    def f(lg):
        per = jax_ctc_loss(lg, ll, targets, tl, impl=impl)
        return jnp.where(jnp.isfinite(per), per, 0.0).sum() / lg.shape[0], \
            per

    (_, per), grad = jax.value_and_grad(f, has_aux=True)(logits)
    return np.asarray(per), np.asarray(grad)


def _port_loss_and_grad(args):
    logits, ll, targets, tl = (torch.from_numpy(a) for a in args)
    logits.requires_grad_(True)
    per = port_ctc.ctc_loss(logits, ll, targets, tl)
    mean = torch.where(torch.isfinite(per), per, 0.0).sum() / logits.shape[0]
    mean.backward()
    return per.detach().numpy(), logits.grad.numpy()


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grad_match_jax(case, impl):
    args = CASES[case]()
    want_per, want_grad = _jax_loss_and_grad(args, impl)
    got_per, got_grad = _port_loss_and_grad(args)
    np.testing.assert_allclose(got_per, want_per, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grad_match_torch_ctc(case):
    logits, ll, targets, tl = (torch.from_numpy(a) for a in CASES[case]())
    lg = logits.clone().requires_grad_(True)
    want = F.ctc_loss(F.log_softmax(lg, -1).transpose(0, 1), targets, ll, tl,
                      blank=0, reduction="none", zero_infinity=False)
    want.sum().backward()
    got_in = logits.clone().requires_grad_(True)
    got = port_ctc.ctc_loss(got_in, ll, targets, tl)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_in.grad.numpy(), lg.grad.numpy(),
                               rtol=1e-3, atol=1e-4)


def test_impossible_alignment_inf_loss_zero_grad():
    logits = torch.zeros((2, 4, 5), requires_grad=True)
    ll = torch.tensor([4, 4])
    targets = torch.tensor([[1, 2, 1, 2, 1, 2], [1, 2, 0, 0, 0, 0]])
    tl = torch.tensor([6, 2])
    per = port_ctc.ctc_loss(logits, ll, targets, tl)
    assert not torch.isfinite(per[0]) and per[0] > 0
    assert torch.isfinite(per[1])
    # even an unmasked sum: the Function zeroes the row itself
    (per * torch.tensor([0.0, 1.0])).sum().backward()
    assert torch.equal(logits.grad[0], torch.zeros_like(logits.grad[0]))
    assert logits.grad[1].abs().sum() > 0


def test_ctc_loss_mean_matches_jax():
    args = _case(5)
    want = jax_ctc_loss_mean(*(jnp.asarray(a) for a in args))
    got = port_ctc.ctc_loss_mean(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)


def test_plain_recursions_freeze_past_length():
    """Alpha holds its last value and beta is -1e30 past each length."""
    logits, ll, targets, tl = (torch.from_numpy(a) for a in _case(6))
    log_probs, ext = port_ctc._prep(logits, targets, 0)
    alphas, loss = ctc_k.ctc_alpha(log_probs, ext, tl, ll)
    _, betas = ctc_k.ctc_beta(log_probs, ext, tl, ll, alphas, loss,
                              torch.ones(len(ll)), with_betas=True)
    for i, n in enumerate(ll.tolist()):
        assert torch.equal(alphas[i, n:], alphas[i, n - 1].expand_as(
            alphas[i, n:]))
        assert (betas[i, n:] == ctc_k.NEG_INF).all()
