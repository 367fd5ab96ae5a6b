"""PyTorch port: the LSTM layer's training forward and backward, the LSTM
train step, the train CLI with ``--rnn-type lstm`` and LSTM checkpoints,
against the JAX package.

``LSTMLayer`` (the autograd Function over K3 with residuals and K7; their
plain versions on the CPU) is held, through ``rnn_scan``, to JAX
``rnn_scan(..., compute_dtype=float32, impl="pallas_interpret")``, which
runs the fused forward with residuals and ``_lstm_bwd_kernel`` in interpret
mode, and to the XLA scan: output at 1e-5, the grads of x, W_ih, b_ih, W_hh
and b_hh at 2e-4 (the tolerances of tests/test_pallas_fused.py:56-69). The
vanilla ``rnn`` cell (plain PyTorch, autograd) is held to the XLA scan's
grads at the same tolerances. The explicit ``plain_bwd`` is held to
autograd through the plain forward at 1e-5, and a forward without grad
writes no residuals.

A 2-layer, H-32 bidirectional LSTM DS2 starts from the JAX model's init and
runs 3 SGD-Nesterov steps (clip 100) in both packages at the default lr
3e-4, with the loss and grad-norm tolerances and reasons of
tests/test_torch_train_step.py. Every parameter agrees to atol 3e-5 /
rtol 1e-4 (seen: 1.2e-7; a step moves a weight by up to ~3e-3). At lr
3e-3 this model's clipped steps (grad norm 630-840 against the clip of
100) drive the loss up, 61 -> 68 -> 77, and the f32 summation-order
differences grow with it to 5e-4 in a weight by the third step, so that
rate measures the divergence, not the port. The train CLI trains a
1 x BiLSTM-16 for one epoch on a 4-utterance manifest; its checkpoint
answers a transcribe request through both packages' CLIs with the same
JSON, and a JAX-written LSTM checkpoint answers the port's CLI as the JAX
CLI does.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeech_tpu.audio import AudioConf as JaxAudioConf
from deepspeech_tpu.cli.transcribe import main as jax_transcribe
from deepspeech_tpu.models import build_model as jax_build_model
from deepspeech_tpu.ops.rnn import rnn_scan as jax_rnn_scan
from deepspeech_tpu.train import StepConfig as JaxStepConfig
from deepspeech_tpu.train import TrainState as JaxTrainState
from deepspeech_tpu.train import build_optimizer as jax_build_optimizer
from deepspeech_tpu.train import checkpoint as jax_ckpt
from deepspeech_tpu.train import make_train_step as jax_make_train_step
from deepspeech_tpu_torch.audio.io import save_wav
from deepspeech_tpu_torch.cli.transcribe import main as port_transcribe
from deepspeech_tpu_torch.convert import jax_to_torch, torch_to_jax
from deepspeech_tpu_torch.models import build_model
from deepspeech_tpu_torch.ops.cuda import lstm as lstm_k
from deepspeech_tpu_torch.ops.rnn import rnn_scan
from deepspeech_tpu_torch.train import checkpoint as ckpt
from deepspeech_tpu_torch.train import optim
from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                             make_train_step)
from test_torch_train_step import _batches, _flat, _port_batch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, B, F, H = 13, 3, 24, 32  # T not a multiple of 8; one row at full length
NAMES = ("x", "w_ih", "b_ih", "w_hh", "b_hh")
LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 "


def _mk(seed, d, gates=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    lens = np.array([T, 9, 4], np.int32)
    w_ih = (rng.standard_normal((d, F, gates * H)) * 0.2).astype(np.float32)
    b_ih = (rng.standard_normal((d, gates * H)) * 0.1).astype(np.float32)
    w_hh = (rng.standard_normal((d, H, gates * H)) * 0.2).astype(np.float32)
    b_hh = (rng.standard_normal((d, gates * H)) * 0.1).astype(np.float32)
    return x, lens, w_ih, b_ih, w_hh, b_hh


def _objective(out):
    return (out * out * torch.cos(out)).sum()


def _port(x, lens, *ws, bidir, cell):
    params = [torch.from_numpy(a).requires_grad_(True) for a in (x, *ws)]
    out = rnn_scan(params[0], torch.from_numpy(lens), *params[1:],
                   cell=cell, bidirectional=bidir)
    _objective(out).backward()
    return out.detach().numpy(), [p.grad.numpy() for p in params]


def _jax(x, lens, *ws, bidir, impl, cell):
    kw = dict(cell=cell, bidirectional=bidir, compute_dtype=jnp.float32,
              impl=impl)
    lens_j = jnp.asarray(lens)

    def f(params):
        out = jax_rnn_scan(params[0], lens_j, *params[1:], **kw)
        return (out * out * jnp.cos(out)).sum(), out

    (_, out), grads = jax.value_and_grad(f, has_aux=True)(
        [jnp.asarray(a) for a in (x, *ws)])
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("cell,impl", [("lstm", "pallas_interpret"),
                                       ("lstm", "xla"), ("rnn", "xla")])
@pytest.mark.parametrize("bidir", [True, False])
def test_function_matches_jax(bidir, cell, impl):
    args = _mk(11, 2 if bidir else 1, 4 if cell == "lstm" else 1)
    got_out, got = _port(*args, bidir=bidir, cell=cell)
    want_out, want = _jax(*args, bidir=bidir, impl=impl, cell=cell)
    np.testing.assert_allclose(got_out, want_out, rtol=1e-5, atol=1e-5)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("bidir", [True, False])
def test_plain_bwd_matches_autograd_of_plain(bidir):
    x, lens, w_ih, b_ih, w_hh, b_hh = _mk(12, 2 if bidir else 1)
    params = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, w_ih, b_ih, w_hh, b_hh)]
    lens_t = torch.from_numpy(lens)
    out = lstm_k.plain(*params, lens_t)
    _objective(out).backward()
    want = [p.grad.numpy() for p in params]

    params2 = [torch.from_numpy(a).requires_grad_(True)
               for a in (x, w_ih, b_ih, w_hh, b_hh)]
    out2 = lstm_k.LSTMLayer.apply(*params2, lens_t)
    np.testing.assert_array_equal(out2.detach().numpy(),
                                  out.detach().numpy())
    _objective(out2).backward()
    for name, p, w in zip(NAMES, params2, want):
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    # one sum serves both biases, in two tensors
    assert torch.equal(params2[2].grad, params2[4].grad)
    assert params2[2].grad.data_ptr() != params2[4].grad.data_ptr()


def test_forward_without_grad_writes_no_residuals(monkeypatch):
    seen = []
    plain = lstm_k.plain

    def recorded(*args, **kwargs):
        seen.append(bool(args[6] if len(args) > 6
                         else kwargs.get("residuals", False)))
        return plain(*args, **kwargs)

    monkeypatch.setattr(lstm_k, "plain", recorded)
    x, lens, *ws = (torch.from_numpy(a) for a in _mk(14, 2))
    rnn_scan(x, lens, *ws, cell="lstm")  # no input requires grad
    ws = [w.requires_grad_(True) for w in ws]
    with torch.no_grad():
        rnn_scan(x, lens, *ws, cell="lstm")
    assert seen == [False, False]
    out = rnn_scan(x, lens, *ws, cell="lstm")
    assert seen == [False, False, True]
    assert out.grad_fn is not None


NUM_CLASSES, HIDDEN, LAYERS = 29, 32, 2
LR, STEPS = 3e-4, 3


def _run_both():
    """3 LSTM steps through each package from the same init; per-step
    metrics and the weights and stats after each step."""
    model, _ = jax_build_model("lstm", NUM_CLASSES, HIDDEN, LAYERS)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 161, 51)),
                           jnp.asarray([51]), False)
    tx = jax_build_optimizer("sgd", lr=LR, momentum=0.9, max_norm=100.0)
    state = JaxTrainState.create(variables, tx)
    step = jax_make_train_step(model, tx, JaxStepConfig(
        audio_conf=JaxAudioConf()), donate=False)

    port, _ = build_model("lstm", NUM_CLASSES, HIDDEN, LAYERS, device="cpu")
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
        pm = pstep(pstate, _port_batch(batch), jitter=torch.tensor(jitter))
        jax_out.append(({n: np.asarray(v) for n, v in m.items()},
                        dict(_flat(state.params)),
                        dict(_flat(state.batch_stats))))
        params, stats = torch_to_jax(port.state_dict())
        port_out.append(({n: v.numpy() for n, v in pm.items()},
                         dict(_flat(params)), dict(_flat(stats))))
    return jax_out, port_out


@pytest.fixture(scope="module")
def runs():
    return _run_both()


@pytest.mark.parametrize("k", range(STEPS))
def test_lstm_train_step_matches_jax(runs, k):
    (jm, jp, js), (pm, pp, ps) = runs[0][k], runs[1][k]
    assert not jm["step_skipped"] and not pm["step_skipped"]
    for name in ("loss", "per_sample"):
        np.testing.assert_allclose(pm[name], jm[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"], rtol=1e-3)
    np.testing.assert_array_equal(pm["out_lens"], jm["out_lens"])
    assert sorted(pp) == sorted(jp) and sorted(ps) == sorted(js)
    assert jp["rnn1/w_hh"].shape == (2, HIDDEN, 4 * HIDDEN)
    for name in jp:
        np.testing.assert_allclose(pp[name], jp[name], rtol=1e-4, atol=3e-5,
                                   err_msg=name)
    for name in js:
        np.testing.assert_allclose(ps[name], js[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def _wav(path, seconds, freq, rng):
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    y = np.sin(2 * np.pi * freq * t) + 0.1 * rng.standard_normal(n)
    save_wav(path, (y / np.abs(y).max()).astype(np.float32), 16000)
    return n


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The train CLI, 1 epoch of a 1 x BiLSTM-16 in f32 on the CPU."""
    d = tmp_path_factory.mktemp("torch_lstm_cli")
    rng = np.random.default_rng(0)
    rows = []
    for i, text in enumerate(("HELLO WORLD", "THE CAT", "A DOG RAN",
                              "GOOD DAY")):
        wav, txt = str(d / f"u{i}.wav"), str(d / f"u{i}.txt")
        n = _wav(wav, 0.5 + 0.15 * i, 200 + 50 * i, rng)
        with open(txt, "w") as f:
            f.write(text)
        rows.append(f"{wav},{txt},{n / 16000}")
    manifest = d / "manifest.csv"
    manifest.write_text("\n".join(rows) + "\n")
    save = d / "models"
    cmd = [sys.executable, "-m", "deepspeech_tpu_torch.cli.train",
           "--device", "cpu", "--rnn-type", "lstm",
           "--train-manifest", str(manifest), "--val-manifest",
           str(manifest), "--epochs", "1", "--batch-size", "2",
           "--val-batch-size", "2", "--hidden-size", "16",
           "--hidden-layers", "1", "--compute-dtype", "float32",
           "--num-workers", "1", "--lr", "1e-3", "--save-folder", str(save)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    return save, r.stdout, str(d / "u0.wav")


def test_train_cli_trains_an_lstm(trained):
    save, out, _ = trained
    assert "epoch 1 iter 1/2 loss" in out and "[val] epoch 1: loss" in out
    package = ckpt.load(str(save / "deepspeech_final.ckpt"))
    assert package["rnn_type"] == "lstm" and package["step"] == 2
    assert package["params"]["rnn0"]["w_hh"].shape == (2, 16, 64)


def test_both_transcribe_clis_read_the_trained_lstm(trained, capsys):
    save, _, wav = trained
    args = ["--model-path", str(save / "deepspeech_final.ckpt"),
            "--audio-path", wav, "--offsets"]
    assert jax_transcribe(args) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_transcribe(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == ref


def test_port_transcribes_a_jax_lstm_checkpoint(tmp_path, capsys):
    model, meta = jax_build_model("lstm", len(LABELS), HIDDEN, LAYERS)
    variables = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 161, 21)),
                           jnp.asarray([21]), False)
    rng = np.random.default_rng(3)
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
        np.float32), variables["batch_stats"])
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=stats, opt_state={}, step=0)
    path = str(tmp_path / "jax_lstm.ckpt")
    jax_ckpt.save(path, jax_ckpt.serialize(meta, state, LABELS,
                                           JaxAudioConf().to_dict()))
    wav = str(tmp_path / "a.wav")
    _wav(wav, 0.45, 300, rng)
    args = ["--model-path", path, "--audio-path", wav, "--offsets"]
    assert jax_transcribe(args) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_transcribe(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == ref
