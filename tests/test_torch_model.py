"""PyTorch port: the DeepSpeech2 forward against the JAX model.

Weights come from a JAX ``model.init`` with randomized BatchNorm statistics
and reach the port through ``convert.py``. In f32 the logits agree to
rtol 1e-3 / atol 2e-3 (the precedent of tests/test_model.py: the JAX conv
is a banded matmul, the port's a direct convolution, so sums run in other
orders); output lengths are equal and probs equal softmax(logits). In bf16
both round the same operands, but the conv and recurrent sums differ in
order and a value on a bf16 rounding boundary may round the other way, so
the bf16 logits are held to atol 3e-2 + rtol 3e-2.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeech_tpu.models import build_model as jax_build_model
from deepspeech_tpu_torch.convert import jax_to_torch, torch_to_jax
from deepspeech_tpu_torch.models import build_model

torch.set_num_threads(2)

HIDDEN, LAYERS, CLASSES = 32, 2, 30


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([45, 31, 20], np.int32)  # T=45, not a multiple of 8
    x = rng.standard_normal((3, 161, 45)).astype(np.float32) * 0.5
    for i, n in enumerate(lengths):
        x[i, :, n:] = 0
    return x, lengths


def _jax_variables(model, x, lengths, seed=0):
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                           jnp.asarray(lengths), False)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(
        lambda a: (rng.uniform(-0.2, 0.2, a.shape) if a.ndim else a
                   ).astype(np.float32), variables["batch_stats"])
    # running variances in [0.6, 1.4], as tests/test_model.py randomizes them
    for path in [("conv", "bn0"), ("conv", "bn1"), ("fc_bn",)] + [
            (f"rnn{i}", "bn") for i in range(1, LAYERS)]:
        node = stats
        for k in path:
            node = node[k]
        node["var"] = rng.uniform(0.6, 1.4, node["var"].shape).astype(
            np.float32)
    return params, stats


def _run_both(compute_dtype, bidirectional=True, seed=0):
    x, lengths = _inputs(seed)
    jm, _ = jax_build_model("gru", CLASSES, HIDDEN, LAYERS,
                            bidirectional=bidirectional,
                            compute_dtype=compute_dtype)
    params, stats = _jax_variables(jm, x, lengths, seed)
    ref = jm.apply({"params": params, "batch_stats": stats},
                   jnp.asarray(x), jnp.asarray(lengths), False)
    tm, _ = build_model("gru", CLASSES, HIDDEN, LAYERS,
                        bidirectional=bidirectional,
                        compute_dtype=compute_dtype, device="cpu")
    tm.load_state_dict(jax_to_torch(params, stats))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(lengths))
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("bidirectional", [True, False])
def test_forward_matches_jax_f32(bidirectional):
    (rl, rp, ro), (gl, gp, go) = _run_both(None, bidirectional)
    np.testing.assert_array_equal(go, ro)
    assert gl.shape == rl.shape
    for i, n in enumerate(ro):
        np.testing.assert_allclose(gl[i, :n], rl[i, :n], rtol=1e-3,
                                   atol=2e-3)
    np.testing.assert_allclose(
        gp, torch.softmax(torch.from_numpy(gl), -1).numpy(), atol=1e-6)


def test_forward_matches_jax_bf16():
    (rl, _, ro), (gl, _, go) = _run_both("bfloat16", seed=1)
    np.testing.assert_array_equal(go, ro)
    for i, n in enumerate(ro):
        np.testing.assert_allclose(gl[i, :n], rl[i, :n], rtol=3e-2,
                                   atol=3e-2)


def test_params_round_trip_jax_port_jax():
    x, lengths = _inputs()
    jm, _ = jax_build_model("gru", CLASSES, HIDDEN, LAYERS)
    params, stats = _jax_variables(jm, x, lengths)
    tm, _ = build_model("gru", CLASSES, HIDDEN, LAYERS, device="cpu")
    tm.load_state_dict(jax_to_torch(params, stats))
    p2, s2 = torch_to_jax(tm.state_dict())
    for a, b in ((params, p2), (stats, s2)):
        assert (jax.tree_util.tree_structure(a)
                == jax.tree_util.tree_structure(b))
        for u, v in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("fold", [False, True])
def test_batchnorm_train_and_eval_match_jax(fold):
    """Train-mode statistics (biased to normalize, unbiased running update,
    padding rows included) and the folded affine, against the JAX layer."""
    from deepspeech_tpu.models.layers import TorchBatchNorm as JaxBN
    from deepspeech_tpu_torch.models.layers import TorchBatchNorm

    rng = np.random.default_rng(9)
    x = rng.standard_normal((7, 3, 16)).astype(np.float32) * 2 + 0.5
    x[5:, 1] = 0  # padded rows count, as in the reference
    jbn = JaxBN(momentum=0.1, fold=fold)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    params = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
              "bias": rng.uniform(-0.5, 0.5, 16).astype(np.float32)}
    stats = {"mean": rng.uniform(-0.2, 0.2, 16).astype(np.float32),
             "var": rng.uniform(0.6, 1.4, 16).astype(np.float32)}
    assert set(variables["params"]) == set(params)
    tbn = TorchBatchNorm(16, momentum=0.1, fold=fold)
    tbn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                         "bias": torch.from_numpy(params["bias"]),
                         "running_mean": torch.from_numpy(stats["mean"]),
                         "running_var": torch.from_numpy(stats["var"])})
    for train in (True, False):
        ref, new_vars = jbn.apply({"params": params, "batch_stats": stats},
                                  jnp.asarray(x), train,
                                  mutable=["batch_stats"])
        tbn.train(train)
        with torch.no_grad():
            got = tbn(torch.from_numpy(x))
        got = got if fold else (got,)
        ref = ref if fold else (ref,)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(tbn.running_mean.numpy(),
                                   np.asarray(new_vars["batch_stats"]["mean"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tbn.running_var.numpy(),
                                   np.asarray(new_vars["batch_stats"]["var"]),
                                   rtol=1e-6, atol=1e-6)
        stats = jax.tree.map(np.asarray, new_vars["batch_stats"])


@pytest.mark.parametrize("rnn_type", ["lstm", "rnn", "cnn"])
def test_unported_models_raise(rnn_type):
    """The other DS2 cells and a CNN (Wav2Letter, whose stride-2 prolog
    gives the DS2 front's lengths) build and run forward; only
    glu_flexible raises, as in the JAX package."""
    if rnn_type == "cnn":
        with pytest.raises(NotImplementedError):
            build_model("glu_flexible", CLASSES, device="cpu")
    model, meta = build_model(rnn_type, CLASSES, HIDDEN, LAYERS,
                              device="cpu")
    assert meta["rnn_type"] == rnn_type
    x, lengths = _inputs()
    model.eval()
    with torch.no_grad():
        logits, probs, out_lens = model(torch.from_numpy(x),
                                        torch.from_numpy(lengths))
    assert logits.shape == (3, 23, CLASSES)
    assert out_lens.tolist() == [23, 16, 10]
    assert torch.isfinite(logits).all()
