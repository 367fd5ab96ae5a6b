"""PyTorch port: the train step against the JAX package's ``make_train_step``.

A 2-layer, H-32 bidirectional DS2 starts from the JAX model's init, copied
into the port through ``convert.py``. Both packages run 3 SGD-Nesterov
steps (clip 100) on the same int16-wire batches, with the JAX step's
max-frame jitter passed to the port's step, in f32 (the JAX step on the
CPU takes its XLA paths: matmul STFT, banded conv, scan recurrence, scan
CTC). Both run the same f32 algorithm with sums in other orders. After
each step the loss and per-sample losses agree to rtol 1e-4 (seen: 5e-6).
The grad norm agrees to rtol 1e-3 (seen: up to 1.2e-4, depending on the
CPU's convolution algorithm): it is dominated by the first conv's weight
grad, a sum over ~10^5 positions of products with the spectrogram, where
the two STFTs' ~1e-4 differences add up. Every parameter agrees to atol
3e-4 / rtol 1e-3 (seen: 8e-5 after three steps; one step moves a weight
by up to ~1e-2 at this learning rate), every BatchNorm stat to atol 1e-4
(seen: 1e-5).

The optimizer's update is held to optax's on random tensors (clip, SGD
with Nesterov momentum and weight decay, Adam) at 1e-6. The guard case
mirrors tests/test_step_guard.py: a NaN in the audio makes the logits NaN,
the step is skipped, params and optimizer state keep their values, and the
BatchNorm running stats and the step counter move.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from deepspeech_tpu.audio import AudioConf as JaxAudioConf
from deepspeech_tpu.data.loader import BucketSpec as JaxBucketSpec
from deepspeech_tpu.data.loader import collate_batch as jax_collate
from deepspeech_tpu.models import build_model as jax_build_model
from deepspeech_tpu.train import StepConfig as JaxStepConfig
from deepspeech_tpu.train import TrainState as JaxTrainState
from deepspeech_tpu.train import build_optimizer as jax_build_optimizer
from deepspeech_tpu.train import make_train_step as jax_make_train_step
from deepspeech_tpu_torch.convert import jax_to_torch, torch_to_jax
from deepspeech_tpu_torch.models import build_model
from deepspeech_tpu_torch.train import optim
from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                             make_eval_step, make_train_step)

torch.set_num_threads(2)

NUM_CLASSES, HIDDEN, LAYERS, B = 29, 32, 2, 3
LR, STEPS = 3e-3, 3


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for k in range(STEPS):
        samples = []
        for i in range(B):
            n = int(16000 * (0.35 + 0.1 * i + 0.05 * k))
            t = np.arange(n) / 16000
            y = (np.sin(2 * np.pi * rng.uniform(150, 400) * t)
                 * np.sin(2 * np.pi * 2.0 * t)
                 + 0.1 * rng.standard_normal(n)).astype(np.float32)
            y /= np.abs(y).max()
            tgt = rng.integers(1, NUM_CLASSES, rng.integers(2, 9))
            samples.append({"audio": y, "target": tgt.astype(np.int32),
                            "path": f"u{i}"})
        batch = jax_collate(samples, B, JaxBucketSpec(
            audio_step=1600, target_step=10, min_target=10,
            wire_dtype="int16"))
        batch.pop("paths")
        out.append(batch)
    return out


def _port_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:  # a copy: the port's arrays share memory with its tensors
            yield "/".join(prefix + (k,)), np.array(v)


@pytest.fixture(scope="module")
def runs():
    """3 steps through each package from the same init; per-step
    metrics and the weights and stats after each step."""
    model, _ = jax_build_model("gru", NUM_CLASSES, HIDDEN, LAYERS)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 161, 51)),
                           jnp.asarray([51]), False)
    tx = jax_build_optimizer("sgd", lr=LR, momentum=0.9, max_norm=100.0)
    state = JaxTrainState.create(variables, tx)
    step = jax_make_train_step(model, tx, JaxStepConfig(
        audio_conf=JaxAudioConf()), donate=False)

    port, _ = build_model("gru", NUM_CLASSES, HIDDEN, LAYERS, device="cpu")
    port.load_state_dict(jax_to_torch(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"])))
    opt = optim.build_optimizer("sgd", lr=LR, momentum=0.9, max_norm=100.0)
    pstate = TrainState.create(port, opt)
    pstep = make_train_step(port, opt, StepConfig())

    jax_out, port_out = [], []
    for k, batch in enumerate(_batches()):
        key = jax.random.PRNGKey(100 + k)
        state, m = step(state, {kk: jnp.asarray(v) for kk, v in
                                batch.items()}, key)
        k_jit = jax.random.split(key, 3)[0]
        jitter = np.asarray(jax.random.uniform(k_jit, (B,), minval=-0.5,
                                               maxval=0.5))
        pm = pstep(pstate, _port_batch(batch),
                   jitter=torch.tensor(jitter))
        jax_out.append(({n: np.asarray(v) for n, v in m.items()},
                        dict(_flat(state.params)),
                        dict(_flat(state.batch_stats))))
        params, stats = torch_to_jax(port.state_dict())
        port_out.append(({n: v.numpy() for n, v in pm.items()},
                         dict(_flat(params)), dict(_flat(stats))))
    return jax_out, port_out, int(pstate.step)


@pytest.mark.parametrize("k", range(STEPS))
def test_train_step_matches_jax(runs, k):
    (jm, jp, js), (pm, pp, ps) = runs[0][k], runs[1][k]
    assert not jm["step_skipped"] and not pm["step_skipped"]
    for name in ("loss", "per_sample"):
        np.testing.assert_allclose(pm[name], jm[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"], rtol=1e-3)
    np.testing.assert_array_equal(pm["out_lens"], jm["out_lens"])
    assert sorted(pp) == sorted(jp) and sorted(ps) == sorted(js)
    for name in jp:
        np.testing.assert_allclose(pp[name], jp[name], rtol=1e-3, atol=3e-4,
                                   err_msg=name)
    for name in js:
        np.testing.assert_allclose(ps[name], js[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    if k == STEPS - 1:
        assert runs[2] == STEPS


def _model_and_batch():
    torch.manual_seed(0)
    model, _ = build_model("gru", NUM_CLASSES, HIDDEN, LAYERS, device="cpu")
    return model, _port_batch(_batches()[0])


def test_every_parameter_gets_a_finite_gradient():
    model, batch = _model_and_batch()
    from deepspeech_tpu_torch.train.step import _loss, featurize

    model.train()
    spect, lengths = featurize(batch, StepConfig())
    logits, _, out_lens = model(spect, lengths)
    loss, _ = _loss(logits, out_lens, batch)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    for name, g in zip(names, grads):
        assert torch.isfinite(g).all(), name
        assert g.abs().sum() > 0, name


def test_nan_batch_skips_update_but_moves_bn_stats():
    model, batch = _model_and_batch()
    opt = optim.build_optimizer("sgd", lr=1e-2)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, StepConfig(max_frame_jitter=False))
    m = step(state, batch)  # one clean step so the momentum is not zero
    assert not m["step_skipped"]
    params = [p.detach().clone() for p in model.parameters()]
    trace = [t.clone() for t in state.opt_state["trace"]]
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    bad = dict(batch, audio=batch["audio"].float() * 0 + float("nan"),
               audio_scale=batch["audio_scale"])
    m = step(state, bad)
    assert bool(m["step_skipped"])
    for p, q in zip(model.parameters(), params):
        assert torch.equal(p, q)
    for t, u in zip(state.opt_state["trace"], trace):
        assert torch.equal(t, u)
    now = model.state_dict()
    assert any(not torch.equal(now[k], v) for k, v in stats.items())
    assert int(state.step) == 2
    m = step(state, batch)
    assert not m["step_skipped"] and torch.isfinite(m["loss"])
    assert any(not torch.equal(p, q)
               for p, q in zip(model.parameters(), params))


def test_adam_takes_one_step():
    model, batch = _model_and_batch()
    opt = optim.build_optimizer("adam", lr=1e-3)
    state = TrainState.create(model, opt)
    before = [p.detach().clone() for p in model.parameters()]
    m = make_train_step(model, opt, StepConfig(max_frame_jitter=False))(
        state, batch)
    assert not m["step_skipped"] and torch.isfinite(m["loss"])
    assert int(state.opt_state["count"]) == 1
    moved = [(p - q).abs().max().item()
             for p, q in zip(model.parameters(), before)]
    # Adam's first step moves every weight by about lr
    assert all(0 < d <= 1.5e-3 for d in moved), moved


@pytest.mark.parametrize("kind,kw", [
    ("sgd", dict(momentum=0.9, weight_decay=0.0, max_norm=100.0)),
    ("sgd", dict(momentum=0.9, weight_decay=1e-2, max_norm=1.0)),
    ("adam", dict(max_norm=0.5))])
def test_optimizer_matches_optax(kind, kw):
    rng = np.random.default_rng(7)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = jax_build_optimizer(kind, lr=0.1, **kw)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    opt = optim.build_optimizer(kind, lr=0.1, **kw)
    tp = [torch.from_numpy(p) for p in params]
    ts = opt.init(tp)
    for g in grads:
        updates, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, updates)
        tp, ts = opt.update([torch.from_numpy(x) for x in g], ts, tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    assert optim.get_lr(ts) == pytest.approx(0.1)
    assert optim.get_lr(optim.set_lr(ts, 0.05)) == 0.05


def test_eval_step_runs_without_grad():
    model, batch = _model_and_batch()
    m = make_eval_step(model, StepConfig())(batch)
    assert m["probs"].shape[:2] == m["greedy"].shape
    assert torch.isfinite(m["loss"]) and not m["loss"].requires_grad
    assert not model.training


def test_backward_runs_with_tf32_off(monkeypatch):
    """cuDNN's TF32 flag is off when the first conv's weight gradient is
    made, though the process default is on, and is restored after."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    model, batch = _model_and_batch()
    flags = []
    model.conv.conv0.weight.register_hook(lambda g: flags.append(
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32)))
    opt = optim.build_optimizer("sgd", lr=1e-3)
    make_train_step(model, opt, StepConfig())(TrainState.create(model, opt),
                                              batch)
    assert flags == [(False, False)]
    assert torch.backends.cudnn.allow_tf32
