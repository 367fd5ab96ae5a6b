"""PyTorch port: resuming, both ways, and the rest of the train CLI.

- The optimizer state as optax's leaves (``optim.to_optax_leaves`` /
  ``from_optax_leaves``) for SGD, SGD with weight decay and Adam: the
  port's state goes through the JAX ``restore_state`` (its leaf-count and
  shape assertions) into the same model's ``TrainState`` bit for bit, and
  the JAX state back into the port bit for bit; ``inject_hyperparams``'
  count after 3 updates, one of them skipped by the guard, equals optax's.
- Across packages, on a 6-utterance synthetic manifest (1 x BiGRU-16, f32,
  batch 2, 3 iterations an epoch): the port CLI writes a mid-epoch
  checkpoint (``--checkpoint-per-samples 4``); the JAX CLI resumes it with
  ``--continue-from`` and writes its own mid-epoch checkpoints in the next
  epoch; the port CLI resumes one of those at the same epoch, iteration
  and bins as the JAX loader's ``iter_from``, with the JAX package's
  weights and optimizer leaves bit for bit. The JAX CLI runs as a
  subprocess on one CPU device. From one restored state one train step in
  each package on the same batch with the same jitter gives parameters
  within tests/test_torch_train_step.py's tolerances (atol 3e-4, rtol
  1e-3).
- Within the port: an epoch-boundary resume does not re-run the finished
  epoch and the history grows; ``--finetune`` restores the weights with a
  fresh optimizer state; ``--checkpoint-anneal`` divides the learning rate
  and logs ``lr_find``; ``--train-val-manifest`` writes its sidecar and
  history; the JSONL events have the JAX run's names and keys; the
  observers fire in the JAX loop's order (the port's twin of
  tests/test_observer.py); ``render_dashboard`` writes the JAX package's
  HTML; ``--profile-dir`` writes a Chrome trace.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp
import optax

from deepspeech_tpu.data import AudioDataLoader as JaxLoader
from deepspeech_tpu.data import AudioDataset as JaxDataset
from deepspeech_tpu.data import BucketingSampler as JaxSampler
from deepspeech_tpu.data import BucketSpec as JaxBucketSpec
from deepspeech_tpu.models import build_model as jax_build_model
from deepspeech_tpu.train import StepConfig as JaxStepConfig
from deepspeech_tpu.train import TrainState as JaxTrainState
from deepspeech_tpu.train import build_optimizer as jax_build_optimizer
from deepspeech_tpu.train import checkpoint as jax_ckpt
from deepspeech_tpu.train import make_train_step as jax_make_train_step
from deepspeech_tpu_torch.cli.train import main as train_main
from deepspeech_tpu_torch.convert import jax_to_torch, torch_to_jax
from deepspeech_tpu_torch.data import AudioDataLoader
from deepspeech_tpu_torch.models import build_model
from deepspeech_tpu_torch.train import checkpoint as ckpt
from deepspeech_tpu_torch.train import optim
from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                             make_train_step)
from deepspeech_tpu_torch.utils import Observer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ("AB", "BA", "AAB", "ABB", "A B", "B A")


def write_manifest(d, texts=TEXTS, seconds=0.3):
    rng = np.random.default_rng(0)
    rows = []
    for i, txt in enumerate(texts):
        sr = 16000
        t = np.arange(int(sr * seconds)) / sr
        y = 0.2 * np.sin(2 * np.pi * (300 + 140 * i) * t)
        y = (y + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
        wav, tx = d / f"u{i}.wav", d / f"u{i}.txt"
        wavfile.write(wav, sr, (y * 32767).astype(np.int16))
        tx.write_text(txt)
        rows.append(f"{wav},{tx},{seconds:.2f}")
    m = d / "manifest.csv"
    m.write_text("\n".join(rows) + "\n")
    return str(m)


def common_flags(manifest, save, log_dir, run_id):
    return ["--train-manifest", manifest, "--val-manifest", manifest,
            "--batch-size", "2", "--val-batch-size", "2",
            "--hidden-size", "16", "--hidden-layers", "1",
            "--compute-dtype", "float32", "--save-folder", save,
            "--log-dir", log_dir, "--id", run_id]


def port_cli(argv, observers=()):
    return train_main(["--device", "cpu", "--num-workers", "1", *argv],
                      observers=observers)


def events(log_dir, run_id):
    with open(os.path.join(log_dir, f"{run_id}.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---- the optimizer state as optax's leaves ----

@functools.cache
def _jax_model(classes, layers, seed):
    """A JAX GRU DS2 (H 16) and its variables, initialised once, under jit
    (one compile instead of one for each op of an eager init)."""
    model, _ = jax_build_model("gru", classes, 16, layers)
    variables = jax.jit(model.init, static_argnums=3)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 161, 51)), jnp.asarray([51]),
        False)
    return model, variables


def _models(kind, kw):
    model, variables = _jax_model(29, 2, 1)
    tx = jax_build_optimizer(kind, lr=0.01, **kw)
    jstate = JaxTrainState.create(variables, tx)
    port, _ = build_model("gru", 29, 16, 2, device="cpu")
    port.load_state_dict(jax_to_torch(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"])))
    opt = optim.build_optimizer(kind, lr=0.01, **kw)
    return jstate, tx, port, opt


def _grads(port, rng):
    """Random gradients below the clip norm (100)."""
    return [torch.from_numpy(0.01 * rng.standard_normal(p.shape).astype(
        np.float32)) for p in port.parameters()]


OPTIMIZERS = [("sgd", {}), ("sgd", {"weight_decay": 1e-3}), ("adam", {})]


@pytest.mark.parametrize("kind,kw", OPTIMIZERS)
def test_optax_leaves_both_ways(kind, kw):
    jstate, tx, port, opt = _models(kind, kw)
    rng = np.random.default_rng(3)
    state = TrainState.create(port, opt)
    params = [p.detach() for p in port.parameters()]
    for _ in range(2):  # a state whose every leaf has moved
        params, state.opt_state = opt.update(_grads(port, rng),
                                             state.opt_state, params)
    leaves = optim.to_optax_leaves(state.opt_state, port)
    package = {"params": jax.tree.map(np.asarray, jstate.params),
               "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats),
               "optim_state": leaves, "step": 2}
    restored = jax_ckpt.restore_state(package, jstate)
    got = jax.tree_util.tree_leaves(restored.opt_state)
    assert len(got) == len(leaves)
    for a, b in zip(got, leaves):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    # and back: the JAX state's leaves (as its checkpoint holds them) into
    # the port, bit for bit
    stored = jax_ckpt._to_host(restored.opt_state)
    back = optim.from_optax_leaves(stored, port, opt)
    for key, value in state.opt_state.items():
        if isinstance(value, list):
            for x, y in zip(value, back[key]):
                assert torch.equal(x, y), key
        elif isinstance(value, torch.Tensor):
            assert torch.equal(value, back[key]), key
        else:
            assert np.float32(value) == np.float32(back[key]), key


def test_optax_leaves_refuse_another_optimizer():
    _, _, port, opt = _models("sgd", {})
    leaves = optim.to_optax_leaves(opt.init(list(port.parameters())), port)
    with pytest.raises(AssertionError, match="stored leaves"):
        optim.from_optax_leaves(leaves, port, optim.build_optimizer("adam"))
    bad = list(leaves)
    bad[2] = np.zeros(bad[2].shape[0] + 1, np.float32)
    with pytest.raises(AssertionError, match="shape"):
        optim.from_optax_leaves(bad, port, opt)


@pytest.mark.parametrize("kind,kw", OPTIMIZERS)
def test_inject_count_skips_with_the_guard(kind, kw):
    """3 updates, the second skipped by the guard (the whole optimizer
    state kept, as train/step.py:150-164 does): optax's leaves and the
    port's agree, the inject count at 2."""
    jstate, tx, port, opt = _models(kind, kw)
    rng = np.random.default_rng(5)
    jp, js = jstate.params, jstate.opt_state
    tp = [p.detach() for p in port.parameters()]
    ts = opt.init(tp)
    for ok in (True, False, True):
        grads = _grads(port, rng)
        jg = torch_to_jax(dict(port.state_dict(), **dict(zip(
            [n for n, _ in port.named_parameters()], grads))))[0]
        updates, new_js = tx.update(jax.tree.map(jnp.asarray, jg), js, jp)
        new_jp = optax.apply_updates(jp, updates)
        take = jnp.asarray(ok)
        jp = jax.tree.map(lambda n, o: jnp.where(take, n, o), new_jp, jp)
        js = jax.tree.map(lambda n, o: jnp.where(take, n, o), new_js, js)
        new_tp, new_ts = opt.update(grads, ts, tp)
        flag = torch.tensor(ok)
        optim.assign_where(flag, new_tp, tp)
        optim.assign_where(flag, new_ts, ts)
    want = jax.tree_util.tree_leaves(js)
    got = optim.to_optax_leaves(ts, port)
    assert int(got[0]) == int(want[0]) == 2
    if kind == "adam":
        assert int(got[2]) == int(want[2]) == 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)


# ---- across packages, through both CLIs ----

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port CLI's first epoch with a mid-epoch checkpoint, then the JAX
    CLI resuming it for a second epoch with its own mid-epoch checkpoints
    (a subprocess on one CPU device)."""
    d = tmp_path_factory.mktemp("torch_resume")
    manifest = write_manifest(d)
    logs = str(d / "logs")
    port_save, jax_save = str(d / "port"), str(d / "jax")
    flags = ["--train-val-manifest", manifest, "--checkpoint-per-samples",
             "4", "--checkpoint-anneal", "1.1", "--log-params"]
    assert port_cli(common_flags(manifest, port_save, logs, "port")
                    + flags + ["--epochs", "1"]) == 0
    mid = os.path.join(port_save, "deepspeech_checkpoint_0001.ckpt")
    env = dict(os.environ, XLA_FLAGS="", JAX_PLATFORMS="cpu")
    cmd = [sys.executable, os.path.join(ROOT, "train.py"),
           *common_flags(manifest, jax_save, logs, "jax"), *flags,
           "--epochs", "2", "--num-workers", "0", "--continue-from", mid]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=400)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(d=d, manifest=manifest, logs=logs, port=port_save,
                jax=jax_save, mid=mid, jax_out=r.stdout + r.stderr)


def test_port_mid_epoch_checkpoint(runs):
    """6 utterances, batch 2: after 2 steps (4 samples) checkpoint 1 at
    epoch 1, iteration 2, with the optax leaves, the id, the nine history
    keys (empty: as in the JAX CLI, its own validation comes after the
    write) and the trainval sidecar; the final checkpoint holds one
    val_checkpoint and one trainval point each; the LR anneal after the
    mid-epoch checkpoint and the lr_find event."""
    package = ckpt.load(runs["mid"])
    assert (package["epoch"], package["iteration"], package["checkpoint"],
            package["step"]) == (1, 2, 1, 2)
    leaves = optim.tree_leaves(package["optim_state"])
    assert int(leaves[0]) == 2 and leaves[1] == np.float32(3e-4)
    final = ckpt.load(os.path.join(runs["port"], "deepspeech_final.ckpt"))
    for key in ("checkpoint", "trainval_checkpoint"):
        for metric in ("loss", "wer", "cer"):
            assert package[f"{key}_{metric}_results"] == []
            assert len(final[f"{key}_{metric}_results"]) == 1
    assert package["loss_results"] == [] and len(final["loss_results"]) == 1
    assert os.path.exists(runs["mid"] + ".trainval.curriculum.csv")
    lr = float(optim.tree_leaves(final["optim_state"])[1])
    assert lr == pytest.approx(3e-4 / 1.1 / 1.1, rel=1e-6)
    lr_find = [e for e in events(runs["logs"], "port")
               if e["event"] == "lr_find"]
    assert len(lr_find) == 1 and lr_find[0]["step"] == 1
    assert lr_find[0]["lr"] == pytest.approx(3e-4)


def test_jax_cli_resumes_the_port_checkpoint(runs):
    assert "Resuming from" in runs["jax_out"]
    final = jax_ckpt.load(os.path.join(runs["jax"], "deepspeech_final.ckpt"))
    # the rest of epoch 1 (one step) and epoch 2 (three steps)
    assert final["step"] == 2 + 1 + 3
    assert len(final["loss_results"]) == 2
    assert len(final["checkpoint_loss_results"]) == 2
    assert int(jax.tree_util.tree_leaves(final["optim_state"])[0]) == 6
    # the JAX restore_state takes the port's package: the leaf count and
    # shapes hold, the values bit for bit
    package = ckpt.load(runs["mid"])
    _, variables = _jax_model(len(package["labels"]), 1, 0)
    state = JaxTrainState.create(variables, jax_build_optimizer("sgd"))
    restored = jax_ckpt.restore_state(package, state)
    for a, b in zip(jax.tree_util.tree_leaves(restored.opt_state),
                    optim.tree_leaves(package["optim_state"])):
        np.testing.assert_array_equal(np.asarray(a), b)


class Recorder(Observer):
    def __init__(self):
        self.events = []

    def on_epoch_start(self, epoch, **kw):
        self.events.append(("epoch_start", epoch))

    def on_epoch_end(self, epoch, **kw):
        self.events.append(("epoch_end", epoch, kw.get("loss")))

    def on_batch_start(self, epoch, iteration, **kw):
        self.events.append(("batch_start", epoch, iteration))

    def on_batch_end(self, epoch, iteration, **kw):
        self.events.append(("batch_end", epoch, iteration, kw.get("loss")))

    def on_checkpoint(self, epoch, iteration, path, **kw):
        self.events.append(("checkpoint", os.path.basename(path)))


def _record_bins(monkeypatch):
    """Spy on the port loader's iter_from: the paths of every batch."""
    seen = []
    original = AudioDataLoader.iter_from

    def iter_from(self, start_bin=0):
        for batch in original(self, start_bin):
            seen.append(list(batch["paths"][:int(batch["valid"].sum())]))
            yield batch

    monkeypatch.setattr(AudioDataLoader, "iter_from", iter_from)
    return seen


def test_port_cli_resumes_the_jax_mid_epoch_checkpoint(runs, monkeypatch,
                                                       tmp_path):
    """The JAX CLI's checkpoint 2 (epoch 2, iteration 1): the port resumes
    inside epoch 2 at iteration 1, on the bins the JAX loader's
    iter_from(1) gives for that epoch, and its restored state is the
    package's, bit for bit."""
    path = os.path.join(runs["jax"], "deepspeech_checkpoint_0002.ckpt")
    package = jax_ckpt.load(path)
    assert (package["epoch"], package["iteration"]) == (2, 1)
    jax_ds = JaxDataset({"sample_rate": 16000}, runs["manifest"],
                        package["labels"])
    jax_ds.set_curriculum_epoch(1)
    sampler = JaxSampler(len(jax_ds), 2)
    sampler.shuffle(1)
    want = [list(b["paths"]) for b in JaxLoader(
        jax_ds, sampler, 2, JaxBucketSpec(), 0).iter_from(1)]

    seen = _record_bins(monkeypatch)
    rec = Recorder()
    save = str(tmp_path / "resumed")
    assert port_cli(common_flags(runs["manifest"], save, str(tmp_path),
                                 "resumed")
                    + ["--epochs", "2", "--continue-from", path],
                    observers=[rec]) == 0
    assert seen[:len(want)] == want
    starts = [e[1:] for e in rec.events if e[0] == "batch_start"]
    assert starts == [(1, 1), (1, 2)]
    final = ckpt.load(os.path.join(save, "deepspeech_final.ckpt"))
    assert final["step"] == package["step"] + 2
    assert len(final["loss_results"]) == len(package["loss_results"]) + 1

    # the restore itself: weights, stats and optimizer leaves bit for bit
    model, _ = build_model("gru", len(package["labels"]), 16, 1,
                           device="cpu")
    state = TrainState.create(model, optim.build_optimizer("sgd"))
    state = ckpt.restore_state(package, state)
    params, stats = torch_to_jax(model.state_dict())
    for a, b in zip(optim.tree_leaves(params),
                    jax.tree_util.tree_leaves(package["params"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(optim.tree_leaves(stats),
                    jax.tree_util.tree_leaves(package["batch_stats"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(optim.to_optax_leaves(state.opt_state, model),
                    jax.tree_util.tree_leaves(package["optim_state"])):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    assert int(state.step) == package["step"]


def test_one_step_after_a_restore_matches_jax(runs):
    """The port's mid-epoch checkpoint restored into both packages, one
    SGD step each on the same int16-wire batch with the JAX step's
    jitter: the parameters agree within test_torch_train_step.py's
    tolerances."""
    package = ckpt.load(runs["mid"])
    classes = len(package["labels"])
    jmodel, variables = _jax_model(classes, 1, 0)
    tx = jax_build_optimizer("sgd", lr=3e-4, momentum=0.9, max_norm=100.0)
    jstate = jax_ckpt.restore_state(package, JaxTrainState.create(variables,
                                                                  tx))
    port, _ = build_model("gru", classes, 16, 1, device="cpu")
    opt = optim.build_optimizer("sgd", lr=3e-4, momentum=0.9, max_norm=100.0)
    pstate = ckpt.restore_state(package, TrainState.create(port, opt))

    ds = JaxDataset({"sample_rate": 16000}, runs["manifest"],
                    package["labels"])
    batch = next(iter(JaxLoader(ds, JaxSampler(len(ds), 2), 2,
                                JaxBucketSpec(wire_dtype="int16"), 0)))
    batch.pop("paths")
    step = jax_make_train_step(jmodel, tx, JaxStepConfig(), donate=False)
    key = jax.random.PRNGKey(7)
    jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                      key)
    jitter = np.asarray(jax.random.uniform(jax.random.split(key, 3)[0], (2,),
                                           minval=-0.5, maxval=0.5))
    pm = make_train_step(port, opt, StepConfig())(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()},
        jitter=torch.tensor(jitter))
    assert not bool(jm["step_skipped"]) and not bool(pm["step_skipped"])
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    params, _ = torch_to_jax(port.state_dict())
    for a, b in zip(optim.tree_leaves(params),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=3e-4)


def test_jsonl_events_match_the_jax_run(runs):
    """Every event the JAX CLI's log has, the port's has, with the same
    keys (train, params, val_checkpoint, trainval, lr_find, checkpoint,
    epoch, val)."""
    def keys(run_id):
        out: dict = {}
        for e in events(runs["logs"], run_id):
            out.setdefault(e["event"], set()).update(e)
        return out

    jax_keys, port_keys = keys("jax"), keys("port")
    assert set(jax_keys) == set(port_keys) == {
        "train", "params", "val_checkpoint", "trainval", "lr_find",
        "checkpoint", "epoch", "val"}
    for name, ks in jax_keys.items():
        assert port_keys[name] == ks, name
    norms = [e for e in events(runs["logs"], "port")
             if e["event"] == "params"][0]["norms"]
    jax_norms = [e for e in events(runs["logs"], "jax")
                 if e["event"] == "params"][0]["norms"]
    assert sorted(norms) == sorted(jax_norms)


# ---- within the port ----

def test_epoch_boundary_resume_and_finetune(runs, tmp_path, capsys):
    """The port's twin of tests/test_resume.py:84: from the final
    checkpoint of epoch 1 the run goes on at epoch 2 and the history
    grows; ``--finetune`` restores the weights alone (``--epochs 0``
    writes them back with a fresh optimizer state)."""
    final = os.path.join(runs["port"], "deepspeech_final.ckpt")
    save = str(tmp_path / "again")
    capsys.readouterr()
    assert port_cli(common_flags(runs["manifest"], save, str(tmp_path), "b")
                    + ["--epochs", "2", "--continue-from", final]) == 0
    out = capsys.readouterr().out
    assert "epoch 1 " not in out and "epoch 2 iter 1/3" in out
    package = ckpt.load(os.path.join(save, "deepspeech_final.ckpt"))
    assert len(package["loss_results"]) == 2

    tuned = str(tmp_path / "tuned")
    assert port_cli(common_flags(runs["manifest"], tuned, str(tmp_path), "f")
                    + ["--epochs", "0", "--continue-from", final,
                       "--finetune"]) == 0
    source = ckpt.load(final)
    package = ckpt.load(os.path.join(tuned, "deepspeech_final.ckpt"))
    for a, b in zip(optim.tree_leaves(package["params"]),
                    optim.tree_leaves(source["params"])):
        np.testing.assert_array_equal(a, b)
    leaves = optim.tree_leaves(package["optim_state"])
    assert int(leaves[0]) == 0 and package["step"] == 0
    assert leaves[1] == np.float32(3e-4)
    assert not any(np.any(x) for x in leaves[2:])


def test_observer_hooks_fire_in_the_jax_order(tmp_path):
    """tests/test_observer.py's run (4 utterances, batch 2) on the port: a
    step's batch_end fires after the next step's batch_start, as the JAX
    loop reads a step back after queueing the next; the checkpoints after
    the epoch."""
    manifest = write_manifest(tmp_path, TEXTS[:4])
    rec = Recorder()
    assert port_cli(common_flags(manifest, str(tmp_path / "ckpt"),
                                 str(tmp_path / "logs"), "observer-test")
                    + ["--epochs", "1", "--silent"], observers=[rec]) == 0
    kinds = [e[0] if e[0] != "checkpoint" else e for e in rec.events]
    assert kinds[:6] == ["epoch_start", "batch_start", "batch_start",
                         "batch_end", "batch_end", "epoch_end"]
    assert kinds[6:] == [("checkpoint", "best_model.ckpt"),
                         ("checkpoint", "deepspeech_final.ckpt")]
    assert [e[2] for e in rec.events if e[0] == "batch_end"] == [0, 1]
    assert isinstance(rec.events[3][3], float)


def test_dashboard_html_matches_jax(tmp_path):
    from deepspeech_tpu.utils.liveplot import render_dashboard as jax_render
    from deepspeech_tpu_torch.utils.liveplot import render_dashboard

    rng = np.random.default_rng(0)
    loss = [float(x) for x in 90 * np.exp(-np.arange(40) / 20)
            + rng.standard_normal(40)]
    loss[3] = float("nan")
    state = {"train_steps": list(range(40)), "train_loss": loss,
             "train_avg": loss, "epochs": [0, 1, 2],
             "epoch_loss": [50.0, 25.0, None], "val_loss": [60.0, None, 20.0],
             "val_epochs": [0, 1, 2], "val_wer": [100.0, 50.0, 33.3],
             "val_cer": [55.0, 27.5, 18.3]}
    jax_render(str(tmp_path / "jax.html"), "run", state)
    render_dashboard(str(tmp_path / "port.html"), "run", state)
    assert ((tmp_path / "port.html").read_text()
            == (tmp_path / "jax.html").read_text())


def test_profile_dir_writes_a_trace_on_the_cpu(runs, tmp_path):
    prof = tmp_path / "prof"
    assert port_cli(common_flags(runs["manifest"], str(tmp_path / "m"),
                                 str(tmp_path), "p")
                    + ["--epochs", "1", "--profile-dir", str(prof),
                       "--profile-start", "1", "--profile-steps", "1"]) == 0
    assert sorted(os.listdir(prof)) == ["summary_1_2.json",
                                        "trace_steps_1_2.json"]
    with open(prof / "trace_steps_1_2.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("aten::" in n for n in names)
    assert {"ds.step", "ds.forward", "ds.optim"} <= names
    with open(prof / "summary_1_2.json") as f:
        assert json.load(f)["spans"]["step"]["count"] == 1
