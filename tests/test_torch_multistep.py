"""PyTorch port: ``--steps-per-dispatch`` k > 1 (``make_multi_train_step``,
``stack_microbatches``, the train CLI's group loop) against the JAX
package and against k=1.

* ``stack_microbatches`` gives the JAX function's arrays bit for bit, on
  every wire, for a ragged group and a short one.
* k=2 with one dead lane equals one port ``train_step`` exactly
  (``torch.equal``) on the parameters, BatchNorm buffers, optimizer state,
  step counter and the generator's state: the port's form of JAX
  ``tests/test_multistep.py``'s dead-lane test (rtol 1e-6 / atol 1e-7
  inside one package). The step draws its max-frame jitter from the
  generator, so the generator's state is held too.
* Three live lanes and one dead one against JAX ``make_multi_train_step``
  on ``tests/test_torch_train_step.py``'s model, weights and first batch
  (jitter off on both sides: the two packages draw from different
  generators): the losses at rtol 1e-4, the parameters at rtol 1e-3 /
  atol 3e-4 and the BatchNorm stats at 1e-4, that test's bounds; and
  equal to three port ``train_step`` calls exactly.
* The train CLI with ``--steps-per-dispatch 2`` over an odd batch count
  with two buckets, 2 epochs and a checkpoint anneal every 6 samples (an
  epoch's: ``set_lr`` on the live tensor between groups) against k=1:
  final parameters and the loss curves at rtol 1e-5 / atol 1e-6 (JAX ``tests/test_multistep.py``'s
  bounds), the same JSONL events, the LR annealed alike.
* The same three steps at 3e-3, fed the JAX step's spectrogram, against
  JAX at that test's bound: the gap at 3e-3 is the two STFTs'.
* The learning rate as a device tensor: ``set_lr`` writes it in place,
  ``get_lr`` returns the float, the optax leaves round-trip.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeech_tpu.audio import AudioConf as JaxAudioConf
from deepspeech_tpu.data.loader import BucketSpec as JaxBucketSpec
from deepspeech_tpu.data.loader import collate_batch as jax_collate
from deepspeech_tpu.data.loader import \
    stack_microbatches as jax_stack_microbatches
from deepspeech_tpu.models import build_model as jax_build_model
from deepspeech_tpu.train import StepConfig as JaxStepConfig
from deepspeech_tpu.train import TrainState as JaxTrainState
from deepspeech_tpu.train import build_optimizer as jax_build_optimizer
from deepspeech_tpu.train import \
    make_multi_train_step as jax_make_multi_train_step
from deepspeech_tpu_torch.audio.io import save_wav
from deepspeech_tpu_torch.cli.train import main as train_main
from deepspeech_tpu_torch.convert import jax_to_torch, torch_to_jax
from deepspeech_tpu_torch.data import (BucketSpec, collate_batch,
                                       stack_microbatches)
from deepspeech_tpu_torch.models import build_model
from deepspeech_tpu_torch.train import checkpoint as ckpt
from deepspeech_tpu_torch.train import optim
from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                             make_multi_train_step,
                                             make_train_step)

import test_torch_train_step as ts  # noqa: E402  (its model and batches)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES, HIDDEN, LAYERS, B, LR = 29, 16, 1, 2, 3e-3
JAX_LR = 1e-3  # the JAX comparison's (test_live_lanes_match_jax_and_k1)


def _samples(rng, seconds, n_labels):
    out = []
    for i, (sec, n) in enumerate(zip(seconds, n_labels)):
        m = int(16000 * sec)
        t = np.arange(m) / 16000
        y = (np.sin(2 * np.pi * rng.uniform(150, 400) * t)
             * np.sin(2 * np.pi * 2.0 * t)
             + 0.1 * rng.standard_normal(m)).astype(np.float32)
        out.append({"audio": y / np.abs(y).max(), "path": f"u{i}",
                    "target": rng.integers(1, NUM_CLASSES, n).astype(
                        np.int32)})
    return out


def _group(wire, seconds=((0.3, 0.4), (0.35, 0.3), (0.2, 0.45)),
           labels=((3, 5), (4, 2), (6, 3))):
    """Host batches, collated alike by both packages (asserted)."""
    rng = np.random.default_rng(0)
    out = []
    for sec, n in zip(seconds, labels):
        samples = _samples(rng, sec, n)
        kw = dict(audio_step=1600, target_step=4, min_target=4,
                  wire_dtype=wire)
        ours = collate_batch(samples, B, BucketSpec(**kw))
        theirs = jax_collate(samples, B, JaxBucketSpec(**kw))
        ours.pop("paths")
        theirs.pop("paths")
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])
        out.append(ours)
    return out


@pytest.mark.parametrize("wire", ["int16", "float32", "mulaw8"])
@pytest.mark.parametrize("n,k", [(3, 3), (2, 4), (1, 2)])
def test_stack_microbatches_matches_jax(wire, n, k):
    group = _group(wire)[:n]
    ours, live = stack_microbatches(group, k)
    theirs, jlive = jax_stack_microbatches(group, k)
    np.testing.assert_array_equal(live, jlive)
    assert live.tolist() == [True] * n + [False] * (k - n)
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


def test_stack_microbatches_refuses_an_empty_or_long_group():
    with pytest.raises(ValueError):
        stack_microbatches([], 2)
    with pytest.raises(ValueError):
        stack_microbatches(_group("int16"), 2)


def _port(seed=1, layers=LAYERS):
    """A port DS2 (f32, CPU), its SGD-Nesterov state, a generator."""
    torch.manual_seed(seed)
    model, _ = build_model("gru", NUM_CLASSES, HIDDEN, layers, device="cpu")
    opt = optim.build_optimizer("sgd", lr=LR, momentum=0.9, max_norm=100.0)
    return model, opt, TrainState.create(model, opt), \
        torch.Generator().manual_seed(7)


def _port_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _assert_states_equal(a, b):
    """Two (model, TrainState, generator) triples, bit for bit."""
    (ma, sa, ga), (mb, sb, gb) = a, b
    for (name, x), (_, y) in zip(ma.state_dict().items(),
                                 mb.state_dict().items()):
        assert torch.equal(x, y), name
    for key in sa.opt_state:
        x, y = sa.opt_state[key], sb.opt_state[key]
        if isinstance(x, list):
            assert all(torch.equal(u, v) for u, v in zip(x, y)), key
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), key
        else:
            assert x == y, key
    assert torch.equal(sa.step, sb.step)
    assert torch.equal(ga.get_state(), gb.get_state())


def test_dead_lane_is_exactly_neutral():
    """k=2, one live lane: one train_step, bit for bit, the generator's
    state included (the jitter is drawn from it)."""
    batch = _group("int16")[0]
    cfg = StepConfig()
    m1, o1, s1, g1 = _port()
    one = make_train_step(m1, o1, cfg)(s1, _port_batch(batch), generator=g1)
    m2, o2, s2, g2 = _port()
    stacked, live = stack_microbatches([batch], 2)
    multi = make_multi_train_step(m2, o2, cfg)(
        s2, _port_batch(stacked), g2, live, {})
    _assert_states_equal((m1, s1, g1), (m2, s2, g2))
    assert int(s2.step) == 1 and int(s2.opt_state["inject_count"]) == 1
    for key, v in one.items():
        assert multi[key].shape == (1, *v.shape), key
        assert torch.equal(multi[key][0], v), key


def test_live_lanes_match_jax_and_k1():
    """3 live lanes + 1 dead on the train-step test's model and first
    batch (2 x BiGRU-32, B 3), three steps on it (the train CLI groups
    same-shape batches only; that test's three batches differ in width):
    against JAX make_multi_train_step (jitter off) at that test's bounds,
    and against three port train_step calls exactly. The learning rate is
    JAX_LR, not that test's 3e-3: three steps on one batch at 3e-3 carry
    the first conv's gradient, which the two STFTs' differences dominate
    (that test's docstring), to a third per-sample loss 6e-4 apart
    (2.3e-5 at JAX_LR), with or without the multi-step."""
    group = ts._batches()[:1] * 3
    stacked, live = stack_microbatches(group, 4)

    model, _ = jax_build_model("gru", ts.NUM_CLASSES, ts.HIDDEN, ts.LAYERS)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 161, 51)),
                           jnp.asarray([51]), False)
    tx = jax_build_optimizer("sgd", lr=JAX_LR, momentum=0.9, max_norm=100.0)
    jstate = JaxTrainState.create(variables, tx)
    jmulti = jax_make_multi_train_step(model, tx, JaxStepConfig(
        audio_conf=JaxAudioConf(), max_frame_jitter=False), donate=False)
    keys = jnp.stack([jax.random.PRNGKey(100 + j) for j in range(4)])
    jstate, jm = jmulti(jstate, {k: jnp.asarray(v) for k, v in
                                 stacked.items()}, keys, jnp.asarray(live),
                        {})
    init = jax_to_torch(jax.tree.map(np.asarray, variables["params"]),
                        jax.tree.map(np.asarray, variables["batch_stats"]))
    cfg = StepConfig(max_frame_jitter=False)
    lanes = _port_batch(stacked)

    runs = []
    for multi in (True, False):
        port, _ = build_model("gru", ts.NUM_CLASSES, ts.HIDDEN, ts.LAYERS,
                              device="cpu")
        port.load_state_dict(init)
        opt = optim.build_optimizer("sgd", lr=JAX_LR, momentum=0.9,
                                    max_norm=100.0)
        state, gen = TrainState.create(port, opt), torch.Generator()
        if multi:
            m = make_multi_train_step(port, opt, cfg)(state, lanes, gen,
                                                      live, {})
        else:
            step = make_train_step(port, opt, cfg)
            ms = [step(state, {k: v[j] for k, v in lanes.items()},
                       generator=gen) for j in range(3)]
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
        runs.append(((port, state, gen), m))
    _assert_states_equal(runs[0][0], runs[1][0])
    for key, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][key]), key

    (port, state, _), m = runs[0]
    assert int(state.step) == int(jstate.step) == 3
    np.testing.assert_allclose(m["loss"].numpy(),
                               np.asarray(jm["loss"])[:3], rtol=1e-4)
    np.testing.assert_allclose(m["per_sample"].numpy(),
                               np.asarray(jm["per_sample"])[:3], rtol=1e-4,
                               atol=1e-6)
    params, stats = torch_to_jax(port.state_dict())
    for ours, theirs, tol in ((params, jstate.params,
                               dict(rtol=1e-3, atol=3e-4)),
                              (stats, jstate.batch_stats,
                               dict(rtol=1e-4, atol=1e-4))):
        flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
        for path, leaf in flat:
            node = ours
            for p in path:
                node = node[p.key]
            np.testing.assert_allclose(np.asarray(node), np.asarray(leaf),
                                       err_msg=str(path), **tol)


def test_three_steps_at_3e3_match_jax_on_its_spectrogram():
    """The steps of test_live_lanes_match_jax_and_k1 at the train-step
    test's rate, 3e-3, where the port's third per-sample losses sit up to
    6.3e-4 from JAX's: fed the JAX step's spectrogram, they agree within
    that test's rtol 1e-4 (seen 2.3e-6 to 9.4e-6). So the gap is the two
    STFTs' differences (their log-spectrograms up to ~1e-3 apart),
    carried through the first conv's gradient, not the step."""
    from deepspeech_tpu.train.step import _featurize
    from deepspeech_tpu_torch.train import step as port_step

    lr = 3e-3
    group = ts._batches()[:1] * 3
    stacked, live = stack_microbatches(group, 4)
    model, _ = jax_build_model("gru", ts.NUM_CLASSES, ts.HIDDEN, ts.LAYERS)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 161, 51)),
                           jnp.asarray([51]), False)
    tx = jax_build_optimizer("sgd", lr=lr, momentum=0.9, max_norm=100.0)
    jcfg = JaxStepConfig(audio_conf=JaxAudioConf(), max_frame_jitter=False)
    keys = jnp.stack([jax.random.PRNGKey(100 + j) for j in range(4)])
    _, jm = jax_make_multi_train_step(model, tx, jcfg, donate=False)(
        JaxTrainState.create(variables, tx),
        {k: jnp.asarray(v) for k, v in stacked.items()}, keys,
        jnp.asarray(live), {})
    # the three lanes are one batch, and no draw reaches the featurizer
    spect = tuple(np.asarray(x) for x in _featurize(
        {k: jnp.asarray(v[0]) for k, v in stacked.items()}, jcfg, keys[0],
        True))
    port, _ = build_model("gru", ts.NUM_CLASSES, ts.HIDDEN, ts.LAYERS,
                          device="cpu")
    port.load_state_dict(jax_to_torch(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"])))
    opt = optim.build_optimizer("sgd", lr=lr, momentum=0.9, max_norm=100.0)
    state = TrainState.create(port, opt)
    step = make_train_step(port, opt, StepConfig(max_frame_jitter=False))
    lanes = _port_batch(stacked)
    original = port_step.featurize
    port_step.featurize = lambda *a, **kw: tuple(
        torch.from_numpy(x.copy()) for x in spect)
    try:
        got = [step(state, {k: v[j] for k, v in lanes.items()},
                    generator=torch.Generator())["per_sample"].numpy()
               for j in range(3)]
    finally:
        port_step.featurize = original
    np.testing.assert_allclose(np.stack(got),
                               np.asarray(jm["per_sample"])[:3], rtol=1e-4,
                               atol=1e-6)


def test_lr_tensor_set_get_and_optax_leaves():
    model, opt, state, _ = _port()
    lr = state.opt_state["lr"]
    assert lr.dtype == torch.float32 and lr.ndim == 0
    ptr = lr.data_ptr()
    assert optim.get_lr(state.opt_state) == LR
    optim.set_lr(state.opt_state, 0.05)
    assert state.opt_state["lr"] is lr and lr.data_ptr() == ptr
    assert optim.get_lr(state.opt_state) == 0.05
    assert lr.item() == np.float32(0.05)
    leaves = optim.to_optax_leaves(state.opt_state, model)
    assert leaves[1].dtype == np.float32 and leaves[1] == np.float32(0.05)
    back = optim.from_optax_leaves(leaves, model, opt)
    assert torch.equal(back["lr"], lr)
    assert back["lr_host"] == float(np.float32(0.05))
    # the update reads the tensor: a step at lr 0 leaves the weights
    optim.set_lr(state.opt_state, 0.0)
    before = [p.detach().clone() for p in model.parameters()]
    make_train_step(model, opt, StepConfig())(
        state, _port_batch(_group("int16")[0]))
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                 before))


def test_read_counters_finds_every_launch_counter():
    """``ops.cuda.read_counters`` reads every wrapper's ``*launches``
    integer, a new one too, with no list to keep (a counter it missed
    would not move under a graph's replays); ``reset_counters`` zeroes
    them."""
    from deepspeech_tpu_torch.ops.cuda import (read_counters, reset_counters,
                                               stft)

    names = set(read_counters())
    assert {("stft", "launches"), ("gru", "bwd_launches"),
            ("gru", "proj_launches"), ("lstm", "scan_res_launches"),
            ("gru", "scan_f32_persistent_launches"),
            ("ctc", "alpha_launches"), ("ctc", "beta_launches"),
            ("topk", "launches"), ("attention", "mhsa_sdpa_launches"),
            ("attention", "mhsa_plain_launches")} <= names
    assert len(names) == 18
    stft.extra_launches = 3
    try:
        assert read_counters()[("stft", "extra_launches")] == 3
        reset_counters()
        assert set(read_counters().values()) == {0}
    finally:
        del stft.extra_launches


@pytest.mark.parametrize("k, calls, started", [
    (1, [(4, 1), (5, 1)], [False, True]),
    (1, [(6, 1)], [False]),            # resumed past the start
    (4, [(4, 4)], [True]),             # the start inside the group
    (4, [(0, 4), (8, 4)], [False, False]),
])
def test_profiler_starts_at_its_step_or_group(tmp_path, k, calls, started):
    """``--profile-start 5``: at k 1 the trace starts at step 5 only (a run
    resumed past it takes none, as the JAX CLI's ``step ==
    profile_start``); at k > 1 with the group that holds step 5."""
    from deepspeech_tpu_torch.cli.train import Profiler

    prof = Profiler(str(tmp_path), 5, 2, torch.device("cpu"),
                    say=lambda *a: None)
    for (step, steps), want in zip(calls, started):
        prof.step(step, steps)
        assert (prof.prof is not None) == want, (k, step)
    if prof.prof is not None:
        prof.step(8, k)
        assert prof.path == str(tmp_path / "trace_steps_5_7.json")
        assert os.path.exists(prof.path)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """6 utterances in two audio buckets: 3 batches of 2, so that a group
    of 2 is cut short by the epoch's end or a bucket switch (JAX
    tests/test_multistep.py's manifest)."""
    d = tmp_path_factory.mktemp("torch_multistep")
    rng = np.random.default_rng(0)
    rows = []
    texts = ["AB", "BA", "AAB", "ABB", "A B", "B A"]
    durs = [0.4, 0.5, 0.7, 1.2, 1.3, 0.6]
    for i, (txt, dur) in enumerate(zip(texts, durs)):
        t = np.arange(int(16000 * dur)) / 16000
        y = 0.2 * np.sin(2 * np.pi * (300 + 140 * i) * t)
        y = (y + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
        wav, tx = str(d / f"u{i}.wav"), str(d / f"u{i}.txt")
        save_wav(wav, y, 16000)
        with open(tx, "w") as f:
            f.write(txt)
        rows.append(f"{wav},{tx},{dur:.2f}")
    path = d / "manifest.csv"
    path.write_text("\n".join(rows) + "\n")
    return d, str(path)


def _cli(d, manifest, tag, extra):
    save = d / tag
    argv = ["--device", "cpu", "--train-manifest", manifest,
            "--val-manifest", manifest, "--batch-size", "2",
            "--hidden-size", "16", "--hidden-layers", "1",
            "--compute-dtype", "float32", "--num-workers", "1",
            "--epochs", "2", "--checkpoint-per-samples", "6",
            "--checkpoint-anneal", "1.5",
            "--labels-path", os.path.join(ROOT, "labels.json"),
            "--save-folder", str(save), "--id", "spd",
            "--log-dir", str(save / "logs"), "--silent", *extra]
    assert train_main(argv) == 0
    with open(save / "logs" / "spd.jsonl") as f:
        events = [json.loads(line) for line in f]
    return ckpt.load(str(save / "deepspeech_final.ckpt")), events


def test_cli_steps_per_dispatch_matches_k1(manifest):
    d, path = manifest
    (k1, ev1), (k2, ev2) = (_cli(d, path, "k1", []),
                            _cli(d, path, "k2", ["--steps-per-dispatch",
                                                 "2"]))
    flat1 = jax.tree_util.tree_leaves(k1["params"])
    flat2 = jax.tree_util.tree_leaves(k2["params"])
    assert len(flat1) == len(flat2)
    for a, b in zip(flat1, flat2):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    for key in ("loss_results", "checkpoint_loss_results"):
        assert len(k1[key]) == len(k2[key]) > 0, key
        np.testing.assert_allclose(k2[key], k1[key], rtol=1e-5, atol=1e-6)
    assert k1["step"] == k2["step"] == 6
    # the checkpoint anneals happened in both runs, at each epoch's end
    # (6 samples; a group's checkpoint check follows the group)
    lrs = [[e["lr"] for e in ev if e["event"] == "lr_find"]
           for ev in (ev1, ev2)]
    assert len(lrs[0]) == 2 and lrs[0] == lrs[1]
    assert [e["event"] for e in ev1] == [e["event"] for e in ev2]
    train1 = [e for e in ev1 if e["event"] == "train"]
    train2 = [e for e in ev2 if e["event"] == "train"]
    assert [e["step"] for e in train1] == [e["step"] for e in train2]
    for a, b in zip(train1, train2):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5,
                                   atol=1e-6)
        assert a["lr"] == b["lr"]


# a rank of the train CLI whose host name is its argument
_RANK_ON_HOST = """
import socket, sys
socket.gethostname = lambda: sys.argv[1]
from deepspeech_tpu_torch.cli.train import main
raise SystemExit(main(sys.argv[2:]))
"""


def test_cli_steps_per_dispatch_refused_on_several_processes(tmp_path):
    """k > 1 runs on the ranks of one machine, as the JAX CLI runs it over
    one host's devices and refuses it across hosts: two ranks whose host
    names differ both exit at the join, naming the hosts (ranks of one
    machine train: ``tests/test_torch_mesh_rule.py``)."""
    import subprocess
    import sys

    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_ON_HOST, f"machine{rank}", "--device",
         "cpu", "--steps-per-dispatch", "2", "--dist-url",
         "file://" + str(tmp_path / "rdv"), "--dist-rank", str(rank),
         "--dist-world-size", "2"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode != 0, out
        assert "one machine" in out and "machine0" in out \
            and "machine1" in out, out
