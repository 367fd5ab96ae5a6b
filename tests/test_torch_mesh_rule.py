"""PyTorch port: the whole JAX sharding rule on a (data, model) mesh, and
``--steps-per-dispatch`` k > 1 across ranks, on gloo CPU ranks against the
JAX package.

* ``parallel.param_spec`` on every state_dict entry equals the JAX
  ``_spec_for_leaf`` (through ``make_param_shardings``) on the same leaf,
  found through ``convert.torch_to_jax``'s name map, with the JAX spec
  moved into the port's axis order by the converter's transposition, on
  a JAX CPU mesh of (8 / M) x M devices (2 x 3 at M 3) at M = 1, 2, 3 and
  4: the DS2 GRU, LSTM and vanilla RNN, bidirectional and not, at 30 and
  12 classes, and the six CNN keys. The shapes come from a port model on
  the meta device and the JAX model's ``eval_shape``, so the full-size
  CNN tables cost no memory.
* 2 train steps (SGD lr 0.3, momentum 0.9, clip 1; f32;
  ``tests/test_torch_parallel.py``'s batch of 8 whose halves differ) of
  small models on gloo ranks, each rank a process of this file
  (``--worker``): data 1 x model 4 on a bidirectional GRU (gate-sharded,
  the head class-sharded at 12 classes), data 2 x model 2 on a
  unidirectional LSTM (gate-sharded), data 1 x model 2 on a
  unidirectional vanilla RNN (gate-sharded), and data 1 x model 2 on
  ``cnn`` with dropout 0.2 (its head sharded on its input channels).
  Every port step is fed the JAX step's spectrogram (``_fed``) and
  clamps its Hardtanh(0, 20)s (a DeepSpeech2) or drops (a ConvStack)
  where the JAX step does (``_replayed``): what is held is the mesh, not
  the two packages' STFTs, convs and generators. The ranks' free-running
  steps are held to the one-process port's (rtol 1e-5, atol 1e-6: only
  the grad norm's summation order, and at data 2 the shards' sums,
  differ) and to the JAX single-device ``make_train_step``'s on the whole
  batch at FREE_TOL; each step again from the JAX run's state before it
  is held to that JAX step at the JAX mesh's bounds (losses and grad
  norms at 2e-4, parameters gathered whole at 5e-4, as
  ``tests/test_parallel.py`` holds it); the ``cnn`` steps on the port's
  own dropout draws are held to the one-process port's.
* Each rank holds exactly 1/M of each sharded tensor and of its momentum
  trace, its own slice of the whole.
* The collective audit by ``Mesh.counts``: one gather a sharded tensor a
  forward and none backward, no all-reduce of a (T, B, H) output outside
  the direction path.
* The train CLI on 4 ranks at ``--mesh-model 4``, resuming the
  one-process CLI's one-epoch checkpoint (``--continue-from``: the whole
  container sliced), against the same resume on one process (weights at
  rtol 2e-4 / atol 2e-5, momentum traces at rtol 1e-3 / atol 1e-4,
  ``tests/test_torch_parallel.py``'s bounds); its checkpoint read by the
  JAX ``ckpt.load`` with whole leaves.
* The train CLI on 2 gloo ranks at ``--steps-per-dispatch 2`` against the
  same ranks at k 1 and against the JAX CLI at k 2 on 2 virtual devices
  (a subprocess), at the CLI bounds, from one initial checkpoint
  (``--continue-from --finetune``), for one epoch of 8 utterances whose
  bins run A B B B (``--no-shuffle``): a group cut by a bucket switch, a
  full one and the epoch's short tail.

The step workers make the CLI runs first, in process (``_worker``), so
that one set of rank processes serves both. Every rank process computes
on one thread; ``init_process_group`` has a 60 s timeout and every
``communicate`` one of ``TIMEOUT``.
"""

import contextlib
import functools
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_parallel as tp  # noqa: E402  (its batch and CLI helpers)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
RANK_ENV = dict(os.environ, OMP_NUM_THREADS="1")
NUM_CLASSES, HIDDEN, LAYERS, CNN_WIDTH = 12, 16, 2, 8
LR, MAX_NORM, STEPS = 0.3, 1.0, 2
# name: (data, model, rnn_type, bidirectional, dropout)
CASES = {
    "m4_gru": (1, 4, "gru", True, 0.0),
    "dp2_m2_lstm": (2, 2, "lstm", False, 0.0),
    "m2_rnn": (1, 2, "rnn", False, 0.0),
    "m2_cnn": (1, 2, "cnn", True, 0.2),
}
SCENARIOS = {"quad": (4, ("m4_gru", "dp2_m2_lstm")),
             "pair": (2, ("m2_rnn", "m2_cnn"))}
# the train CLI runs each scenario's rank processes make first, in process
# (``_worker_cli``): the model-4 resume, and the k 1 and k 2 runs
SCENARIO_CLIS = {"quad": ("m4",), "pair": ("k1_", "k2_")}
SEED_GEN = 5  # the step generator's seed (the port's own dropout draws)
ONE_EPOCH = ["--epochs", "1"]  # the one-process CLI run (2 steps)
# two free-running steps of the ranks against two of the JAX step, both
# fed the same spectrograms, clamps and dropout masks: the second step
# starts from parameters that already differ by the first step's round-off
# (the two packages' f32 sums), which its gradients carry on. The largest
# readings on the CPU, all in the unidirectional LSTM's second step: loss
# 6.9e-6 and grad norm 2.7e-4 relative, parameters 5.4e-6 apart (0.40 of
# the parameters' bound below); the first steps' at most 1.8e-6, 6.6e-5
# and 6.4e-7. Held at FREE_TOL, a fixed bound 2.5-7 times the readings
FREE_TOL = dict(loss=5e-5, grad_norm=2e-3, rtol=1e-3, atol=1e-5)


def _kw(name):
    _, _, rnn_type, bi, drop = CASES[name]
    return dict(rnn_type=rnn_type, num_classes=NUM_CLASSES,
                hidden_size=HIDDEN, hidden_layers=LAYERS, bidirectional=bi,
                cnn_width=CNN_WIDTH, dropout=drop)


def _spawn(argv: list, env=RANK_ENV) -> subprocess.Popen:
    return subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _workers(scenario: str, d: str) -> list:
    world = SCENARIOS[scenario][0]
    return [_spawn([sys.executable, os.path.abspath(__file__), "--worker",
                    scenario, str(rank), str(world), d])
            for rank in range(world)]


def _wait_for(path: str) -> None:
    """Block until ``path`` exists (another process writes it whole and
    then renames or marks it), at most TIMEOUT seconds."""
    import time

    end = time.monotonic() + TIMEOUT
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(path)
        time.sleep(0.1)


# -- the rule, leaf for leaf --------------------------------------------------

RULE_MODELS = {
    **{f"{cell}_{'bi' if bi else 'uni'}_{c}": dict(
        rnn_type=cell, bidirectional=bi, num_classes=c, hidden_size=HIDDEN,
        hidden_layers=LAYERS)
       for cell in ("gru", "lstm", "rnn") for bi in (True, False)
       for c in (30, 12)},
    **{key: dict(rnn_type=key, num_classes=30, hidden_size=32,
                 hidden_layers=2, cnn_width=24)
       for key in ("cnn", "cnn_residual", "glu_small", "glu_large",
                   "large_cnn", "cnn_jasper")},
}


@functools.cache
def _rule_trees(key):
    """(port {name: shape}, JAX (params, batch_stats) shape trees, the
    JAX leaf's port name by its key path)."""
    import jax
    import jax.numpy as jnp

    from deepspeech_tpu.models import build_model as jax_build_model
    from deepspeech_tpu_torch.convert import torch_to_jax
    from deepspeech_tpu_torch.models import build_model

    kw = RULE_MODELS[key]
    with torch.device("meta"):
        model, _ = build_model(**kw, device="meta")
    shapes = {n: tuple(v.shape) for n, v in model.state_dict().items()}
    # each entry a one-element tensor of its index: the converter's name
    # map, whatever it transposes
    names = sorted(shapes)
    tagged = {n: torch.full((1,) * len(shapes[n]), float(i))
              for i, n in enumerate(names)}
    where = {}
    for tree in torch_to_jax(tagged):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            where[tuple(p.key for p in path)] = names[int(leaf.flat[0])]
    jm, _ = jax_build_model(**kw)
    variables = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, 161, 51)), jnp.asarray([51]),
                          False), jax.random.PRNGKey(0))
    return shapes, variables, where


@pytest.mark.parametrize("model", [1, 2, 3, 4])
@pytest.mark.parametrize("key", sorted(RULE_MODELS))
def test_param_spec_matches_jax(key, model):
    import jax

    from deepspeech_tpu.parallel.mesh import make_mesh, make_param_shardings
    from deepspeech_tpu_torch.parallel import param_spec

    shapes, variables, where = _rule_trees(key)
    n = 6 if model == 3 else 8
    mesh = make_mesh(data=n // model, model=model,
                     devices=jax.devices()[:n])
    seen = set()
    for part in ("params", "batch_stats"):
        specs = make_param_shardings(mesh, variables[part])
        flat = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: hasattr(x, "spec"))[0]
        leaves = dict(jax.tree_util.tree_flatten_with_path(
            variables[part])[0])
        for path, sharding in flat:
            name = where[tuple(p.key for p in path)]
            jshape = tuple(leaves[path].shape)
            spec = tuple(sharding.spec) + (None,) * (
                len(jshape) - len(tuple(sharding.spec)))
            # the converter stores the head's kernel transposed; every other
            # leaf the rule can shard keeps the JAX layout (the convs'
            # kernels are permuted too, and replicated)
            if name == "fc.weight":
                spec, jshape = spec[::-1], jshape[::-1]
            want = spec if "model" in spec else ()
            if want:
                assert jshape == shapes[name], name
            assert sorted(jshape) == sorted(shapes[name]), name
            assert param_spec(name, shapes[name], model) == want, (name, want)
            seen.add(name)
    assert seen == set(shapes)


# -- inputs and references ----------------------------------------------------


def _jax_model(name):
    """The JAX model of a case and its init: the port model's, seeded,
    through ``convert.torch_to_jax`` (no JAX init to compile)."""
    from deepspeech_tpu.models import build_model as jax_build_model
    from deepspeech_tpu_torch.convert import torch_to_jax
    from deepspeech_tpu_torch.models import build_model

    model, _ = jax_build_model(**_kw(name))
    torch.manual_seed(0)
    port, _ = build_model(**_kw(name), device="cpu")
    params, stats = torch_to_jax(port.state_dict())
    return model, {"params": params, "batch_stats": stats}


def _jitters(batch):
    """The key of each JAX step, the max-frame jitter it draws and the
    (spectrogram, frame lengths) the JAX step featurizes from it."""
    import jax
    import jax.numpy as jnp

    from deepspeech_tpu.audio import AudioConf
    from deepspeech_tpu.train import StepConfig
    from deepspeech_tpu.train.step import _featurize

    keys = [jax.random.fold_in(jax.random.PRNGKey(1), i)
            for i in range(STEPS)]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cfg = StepConfig(audio_conf=AudioConf())
    featurize = jax.jit(lambda b, k: _featurize(b, cfg, k, train=True))
    return keys, [np.asarray(jax.random.uniform(
        jax.random.split(k, 3)[0], (tp.B,), minval=-0.5, maxval=0.5))
        for k in keys], [tuple(np.asarray(x) for x in featurize(jbatch, k))
                         for k in keys]


@contextlib.contextmanager
def _fed(spect, rows=slice(None)):
    """Inside, the port step featurizes to ``spect`` (the JAX step's
    (spectrogram, lengths), its ``rows``). The two packages'
    log-spectrograms differ by up to ~1e-3 (two f32 STFTs' ~1e-7 relative
    differences magnified by log1p(|X| 2^20),
    ``tests/test_torch_train_cli.py``'s featurize test): fed the same
    one, the steps compare the models and the mesh."""
    from deepspeech_tpu_torch.train import step as port_step

    original = port_step.featurize
    port_step.featurize = lambda *a, **kw: tuple(
        torch.from_numpy(x[rows].copy()) for x in spect)
    try:
        yield
    finally:
        port_step.featurize = original


def _jax_refs(model, variables, keys, batch, replays: list):
    """(loss, grad norm, port state_dict after it, (port state_dict,
    optax leaves) before it) of each JAX single-device step. ``replays``
    gets, for each step, what the port replays of it (the JAX forward of
    that step's parameters on its featurized batch with its dropout key,
    ``capture_intermediates``), in the port's call order and layout: in a
    DeepSpeech2 the (below 0, above 20) masks of every Hardtanh(0, 20)
    input, the conv front's two (its BatchNorms' outputs, masked) and,
    unidirectional, the Lookahead's output; in a ConvStack each dropout's
    keep mask (where its output is not 0: a dropped value and a zero kept
    by it both give 0, and a zero input makes the mask moot)."""
    import jax
    import jax.numpy as jnp

    from deepspeech_tpu.audio import AudioConf
    from deepspeech_tpu.train import (StepConfig, TrainState,
                                      build_optimizer, make_train_step)
    from deepspeech_tpu.train.step import _featurize
    from deepspeech_tpu_torch.convert import jax_to_torch

    tx = build_optimizer("sgd", lr=LR, momentum=0.9, max_norm=MAX_NORM)
    state = TrainState.create(variables, tx)
    cfg = StepConfig(audio_conf=AudioConf())
    step = make_train_step(model, tx, cfg, donate=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def forward(params, batch_stats, k):
        spect, lengths = _featurize(jbatch, cfg, k, train=True)
        _, inter = model.apply(
            {"params": params, "batch_stats": batch_stats}, spect, lengths,
            True, capture_intermediates=True,
            mutable=["batch_stats", "intermediates"],
            rngs={"dropout": jax.random.fold_in(k, 1)})
        return lengths, inter["intermediates"]

    refs = []
    for k in keys:
        lengths, inter = forward(state.params, state.batch_stats, k)
        if "block0" in inter:  # a ConvStack: (B, T, C) -> (B, C, T)
            blocks = [inter[f"block{i}"] for i in range(len(inter))
                      if f"block{i}" in inter]
            replays.append([
                np.asarray(b["Dropout_0"]["__call__"][0] != 0).transpose(
                    0, 2, 1) for b in blocks if "Dropout_0" in b])
        if "conv" in state.params:
            t_out = (np.asarray(lengths) - 1) // 2 + 1
            pre = []
            for i in (0, 1):  # (B, T', F, C) -> the port's (B, C, F, T')
                x = np.asarray(inter["conv"][f"bn{i}"]["__call__"][0])
                x = x * (np.arange(x.shape[1])[None, :] < t_out[:, None])[
                    :, :, None, None]
                pre.append(x.transpose(0, 3, 2, 1))
            if "lookahead" in inter:
                pre.append(np.asarray(inter["lookahead"]["__call__"][0]))
            replays.append([(x < 0, x > 20) for x in pre])
        before = jax_to_torch(jax.device_get(state.params),
                              jax.device_get(state.batch_stats))
        leaves = [np.asarray(x) for x in
                  jax.tree_util.tree_leaves(jax.device_get(state.opt_state))]
        state, m = step(state, jbatch, k)
        sd = jax_to_torch(jax.device_get(state.params),
                          jax.device_get(state.batch_stats))
        refs.append((float(m["loss"]), float(m["grad_norm"]),
                     {n: v.numpy() for n, v in sd.items()},
                     ({n: v.numpy() for n, v in before.items()}, leaves)))
    return refs


@contextlib.contextmanager
def _replayed(replays, rows=slice(None)):
    """Inside, the model clamps and drops where the JAX step did
    (``_jax_refs``' ``replays`` of one step, of which this rank takes its
    ``rows`` of the batch), not where its own inputs and draws say: the
    same value and gradient wherever the two agree. ``replays`` None: the
    model as it is, drawing its dropout from its generator.

    A DeepSpeech2's Hardtanh(0, 20) calls take one (below 0, above 20)
    pair of masks a call, in call order. An input can sit within
    round-off of a clamp, where the two packages' f32 sums (the JAX conv
    front is banded matmuls) put it on either side, and a clamp that flips
    moves the gradients by percents (the case of
    ``tests/test_torch_cuda.py``'s ``_held_and_clamped``): seen here on
    the unidirectional models' Lookahead output (+1.0e-5 in the port,
    -4.6e-7 in JAX). A ConvStack's dropouts take one keep mask a call:
    the two packages draw from different generators."""
    from deepspeech_tpu_torch.models import cnn, ds2

    saved = (ds2.hardtanh_0_20, cnn.dropout)
    calls = iter(replays or ())

    def clamped(x):
        # the conv front's (B, C, F, T) rows on dim 0, the Lookahead's
        # (T, B, H) on dim 1
        at = (slice(None), rows) if x.ndim == 3 else (rows,)
        lo, hi = (torch.from_numpy(m[at]) for m in next(calls))
        return torch.where(lo | hi, torch.where(hi, 20.0, 0.0), x)

    def dropped(x, rate, generator, mesh=None):
        keep = torch.from_numpy(np.array(next(calls)[rows]))
        return torch.where(keep, x / (1.0 - rate), 0.0)

    if replays is not None:
        ds2.hardtanh_0_20, cnn.dropout = clamped, dropped
    try:
        yield
    finally:
        ds2.hardtanh_0_20, cnn.dropout = saved


def _port_refs(name, sd, batch, jitters, spects, replays):
    """(loss, grad norm, parameters) after each one-process port step on
    the JAX steps' spectrograms, the JAX run's clamps and dropout masks
    replayed (``replays`` None: the port's own dropout draws)."""
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.train.optim import build_optimizer
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_train_step)

    model, _ = build_model(**_kw(name), device="cpu")
    model.load_state_dict(sd)
    opt = build_optimizer("sgd", lr=LR, momentum=0.9, max_norm=MAX_NORM)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, StepConfig())
    gen = torch.Generator().manual_seed(SEED_GEN)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    refs = []
    for k, j in enumerate(jitters):
        with _replayed(None if replays is None else replays[k]), \
                _fed(spects[k]):
            m = step(state, batch, jitter=torch.tensor(j), generator=gen)
        refs.append((float(m["loss"]), float(m["grad_norm"]),
                     {n: p.detach().numpy().copy()
                      for n, p in model.named_parameters()}))
    return refs


def _replay_arrays(name, replays) -> dict:
    """``_jax_refs``' replays as the ranks' ``.npz`` entries."""
    out = {}
    for k, calls in enumerate(replays):
        for i, call in enumerate(calls):
            if isinstance(call, tuple):
                out[f"{name}:clamp:{k}:{i}:lo"] = call[0]
                out[f"{name}:clamp:{k}:{i}:hi"] = call[1]
            else:
                out[f"{name}:keep:{k}:{i}"] = call
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the file, overlapped: the JAX CLI at k 2 and the step
    workers (4 and 2 ranks) start first, the workers running their train
    CLI runs before their step cases (``_worker``); the one-process CLI
    runs here for one epoch, whose checkpoint the model-4 ranks resume;
    the JAX and one-process step references are computed here and handed
    to the workers, and the one-process CLI resumes its checkpoint here
    too -> dict of the step references (``refs``), the workers' outputs by
    (case, rank) (``out``), the directory (``d``) and every CLI's stdout
    by run (``cli``)."""
    from deepspeech_tpu_torch.convert import jax_to_torch

    d = str(tmp_path_factory.mktemp("mesh_rule"))
    tp._manifest(d)
    _spd_manifest(d)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = {"jax": [_spawn([sys.executable, os.path.join(ROOT, "train.py"),
                             *_spd_args(d, os.path.join(d, "jax_k2"),
                                        "jax_k2"),
                             "--steps-per-dispatch", "2"], env=env)]}
    refs, cli = {}, {}
    try:
        procs.update({s: _workers(s, d) for s in SCENARIOS})
        cli["single"] = _single_cli(d, "single", ONE_EPOCH)
        open(os.path.join(d, "single.done"), "w").close()
        batch = tp._step_batch()
        keys, jitters, spects = _jitters(batch)
        arrays = {f"batch:{k}": v for k, v in batch.items()}
        arrays.update({f"jitter:{i}": j for i, j in enumerate(jitters)})
        for i, (spect, lengths) in enumerate(spects):
            arrays[f"spect:{i}"], arrays[f"spect_lengths:{i}"] = (spect,
                                                                  lengths)
        # the JAX steps first: the ranks replay their clamps and dropout
        # masks and start from their states
        for name in CASES:
            model, init = _jax_model(name)
            sd = jax_to_torch(init["params"], init["batch_stats"])
            arrays.update({f"{name}:sd:{k}": v.numpy()
                           for k, v in sd.items()})
            replays: list = []
            refs[name] = {"jax": _jax_refs(model, init, keys, batch,
                                           replays)}
            for k, (*_, (before, leaves)) in enumerate(refs[name]["jax"]):
                arrays.update({f"{name}:jax:{k}:sd:{n}": v
                               for n, v in before.items()})
                arrays.update({f"{name}:jax:{k}:leaf:{i}": v
                               for i, v in enumerate(leaves)})
            arrays.update(_replay_arrays(name, replays))
            refs[name]["port"] = _port_refs(name, sd, batch, jitters,
                                            spects, replays)
            if CASES[name][4]:
                refs[name]["draws"] = _port_refs(name, sd, batch, jitters,
                                                 spects, None)
        np.savez(os.path.join(d, "inputs.part.npz"), **arrays)
        os.replace(os.path.join(d, "inputs.part.npz"),
                   os.path.join(d, "inputs.npz"))
        cli["single_resume"] = _single_cli(d, "single_resume", _resume(d))
        for key, ps in procs.items():
            cli[key] = tp._wait(ps)
    finally:
        tp._stop([p for ps in procs.values() for p in ps])
    out = {}
    for scenario, (world, names) in SCENARIOS.items():
        for run in SCENARIO_CLIS[scenario]:
            cli[run.rstrip("_")] = []
            for rank in range(world):
                with open(os.path.join(d, f"{run}{rank}.stdout")) as f:
                    cli[run.rstrip("_")].append(f.read())
        for rank in range(world):
            with np.load(os.path.join(d, f"{scenario}_{rank}.npz")) as f:
                got = dict(f)
            for name in names:
                out[name, rank] = {k[len(name) + 1:]: v
                                   for k, v in got.items()
                                   if k.startswith(name + ":")}
    return dict(refs=refs, out=out, d=d, cli=cli)


def _ranks_of(name):
    data, model = CASES[name][:2]
    return range(data * model)


def _held(got, want, rtol, atol, what):
    for n, ref in want.items():
        np.testing.assert_allclose(got[f"p:{n}"], ref, rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {n}")


@pytest.mark.parametrize("k", range(STEPS))
@pytest.mark.parametrize("name", list(CASES))
def test_train_steps_match_jax_single_device(runs, name, k):
    """Step k on the ranks from the JAX run's state before it (parameters,
    BatchNorm stats and momentum, loaded whole and sharded) against that
    JAX step, at the JAX mesh's bounds. Each step from the same state: the
    unidirectional LSTM's second step carries the first step's round-off
    into its grad norm past the 2e-4 bound (FREE_TOL's readings), so
    ``test_free_running_steps_match_jax`` holds the free-running steps at
    FREE_TOL."""
    refs, out = runs["refs"], runs["out"]
    loss, norm, params, _ = refs[name]["jax"][k]
    assert norm > MAX_NORM  # the step clips
    for rank in _ranks_of(name):
        got = out[name, rank]
        np.testing.assert_allclose(got[f"jax{k}:loss"], loss, rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(got[f"jax{k}:grad_norm"], norm,
                                   rtol=2e-4)
        _held({key[len(f"jax{k}:"):]: v for key, v in got.items()
               if key.startswith(f"jax{k}:")},
              {n: params[n] for n in params if f"jax{k}:p:{n}" in got},
              5e-4, 5e-4, f"rank {rank}")


def _steps_held(got, pre, loss, norm, params, loss_tol, norm_tol, rtol,
                atol, what):
    """A rank's step (its ``pre`` entries) against a reference's."""
    np.testing.assert_allclose(got[f"{pre}loss"], loss, rtol=loss_tol,
                               err_msg=what)
    np.testing.assert_allclose(got[f"{pre}grad_norm"], norm, rtol=norm_tol,
                               err_msg=what)
    _held({key[len(pre):]: v for key, v in got.items()
           if key.startswith(pre)}, params, rtol, atol, what)


@pytest.mark.parametrize("k", range(STEPS))
@pytest.mark.parametrize("name", list(CASES))
def test_train_steps_match_one_process(runs, name, k):
    """The ranks' free-running steps against the one-process port's, both
    replaying the JAX run's clamps and dropout masks."""
    refs, out = runs["refs"], runs["out"]
    loss, norm, params = refs[name]["port"][k]
    for rank in _ranks_of(name):
        _steps_held(out[name, rank], f"{k}:", loss, norm, params, 1e-5,
                    1e-5, 1e-5, 1e-6, f"rank {rank}")


@pytest.mark.parametrize("k", range(STEPS))
def test_dropout_draws_match_one_process(runs, k):
    """The ``cnn`` case with the port's own dropout draws (the global
    batch's, from the generator every rank seeds alike) against the
    one-process port's."""
    refs, out = runs["refs"], runs["out"]
    loss, norm, params = refs["m2_cnn"]["draws"][k]
    for rank in _ranks_of("m2_cnn"):
        _steps_held(out["m2_cnn", rank], f"draws{k}:", loss, norm, params,
                    1e-5, 1e-5, 1e-5, 1e-6, f"rank {rank}")


@pytest.mark.parametrize("k", range(STEPS))
@pytest.mark.parametrize("name", list(CASES))
def test_free_running_steps_match_jax(runs, name, k):
    """The ranks' free-running steps from the JAX init against the JAX
    run's (``_jax_refs``), at FREE_TOL."""
    refs, out = runs["refs"], runs["out"]
    loss, norm, params, _ = refs[name]["jax"][k]
    params = {n: v for n, v in params.items() if f"{k}:p:{n}" in
              out[name, 0]}
    for rank in _ranks_of(name):
        _steps_held(out[name, rank], f"{k}:", loss, norm, params,
                    FREE_TOL["loss"], FREE_TOL["grad_norm"],
                    FREE_TOL["rtol"], FREE_TOL["atol"], f"rank {rank}")


def _want_sharded(name):
    """{parameter: sharded dim} the rule gives a case."""
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.parallel import param_spec, shard_dim

    with torch.device("meta"):
        model, _ = build_model(**_kw(name), device="meta")
    m = CASES[name][1]
    return {n: shard_dim(param_spec(n, p.shape, m))
            for n, p in model.named_parameters()
            if param_spec(n, p.shape, m)}


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_slice(runs, name):
    """Each rank stores 1/M of every sharded tensor and of its momentum
    trace, its own slice of the whole (checked on the rank), and every
    replicated tensor whole."""
    out = runs["out"]
    m = CASES[name][1]
    want = _want_sharded(name)
    assert any(n.startswith("rnns.") for n in want) == (
        CASES[name][2] != "cnn")
    assert "fc.weight" in want
    for rank in _ranks_of(name):
        got = out[name, rank]
        for n in [k[len("shape:param:"):] for k in got
                  if k.startswith("shape:param:")]:
            whole = got[f"{STEPS - 1}:p:{n}"].shape
            for what in ("param", "trace"):
                shape = tuple(got[f"shape:{what}:{n}"])
                if n in want:
                    dim = want[n]
                    assert shape[dim] * m == whole[dim], (n, what, shape)
                    assert shape[:dim] + shape[dim + 1:] == \
                        whole[:dim] + whole[dim + 1:], (n, what)
                else:
                    assert shape == whole, (n, what, shape)
        assert int(got["slices_checked"]) == 2 * len(want)


def _audit(name) -> dict:
    """The collectives of one step of a case: per sharded tensor one gather
    forward (the RNN's four a layer, the head's one), none backward; the
    BN moments (sum and n, then the squares, forward and backward) over a
    data group of more than one rank; the valid-row count and the flat
    gradient there too; the replicated parameters' gradients broadcast and
    the sharded squares of the grad norm summed over the model group; the
    NaN flag over the world. No ``tp`` all-reduce of a (T, B, H) output:
    no case runs the direction path."""
    data = CASES[name][0]
    want = _want_sharded(name)
    counts = {"grad_norm": 1, "nan": 1, "gather_head": 1, "replicas": 1}
    rnn = sum(n.startswith("rnns.") for n in want)
    if rnn:
        counts["gather_rnn"] = rnn
    if data > 1:
        bns = 2 + (LAYERS - 1) + 1  # the conv front's two, rnns.1, fc_bn
        counts.update(bn=2 * bns, bn_grad=2 * bns, valid=1, grads=1)
    return counts


@pytest.mark.parametrize("name", list(CASES))
def test_collective_audit(runs, name):
    out = runs["out"]
    for rank in _ranks_of(name):
        got = out[name, rank]
        counts = {k.split(":")[-1]: int(v) for k, v in got.items()
                  if k.startswith("counts:")}
        assert counts == _audit(name), (rank, counts)


# -- the train CLI at --mesh-model 4 ------------------------------------------


def _resume(d):
    """The flags of a resume of the one-process CLI's one-epoch checkpoint
    for a second epoch."""
    return ["--continue-from", os.path.join(d, "single",
                                            "deepspeech_final.ckpt"),
            "--epochs", "2"]


def _rank_cli_argv(d, run, rank, world) -> list:
    """Rank ``rank``'s train CLI flags of a worker's CLI run (``run`` in
    SCENARIO_CLIS), saving into ``<d>/<run><rank>``."""
    save, log_id = os.path.join(d, f"{run}{rank}"), f"{run}{rank}"
    if run == "m4":
        argv = tp._cli_args(os.path.join(d, "manifest.csv"), save, log_id,
                            d) + ["--mesh-model", "4", *_resume(d)]
    else:  # k1_, k2_
        argv = _spd_args(d, save, log_id) + [
            "--device", "cpu", "--steps-per-dispatch", run[1]]
    return argv + ["--dist-url", "file://" + os.path.join(d, f"rdv_{run}"),
                   "--dist-rank", str(rank), "--dist-world-size",
                   str(world)]


def _worker_cli(d, run, rank, world) -> None:
    """A worker's CLI run in process, its stdout to
    ``<d>/<run><rank>.stdout``; the model-4 resume waits for the
    one-process checkpoint."""
    from deepspeech_tpu_torch.cli.train import main as train_main

    if run == "m4":
        _wait_for(os.path.join(d, "single.done"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_main(_rank_cli_argv(d, run, rank, world))
    with open(os.path.join(d, f"{run}{rank}.stdout"), "w") as f:
        f.write(buf.getvalue())
    assert rc == 0, buf.getvalue()[-4000:]


def _single_cli(d, name, extra=(), args=None) -> str:
    """The train CLI in this process into ``<d>/<name>`` -> its stdout."""
    from deepspeech_tpu_torch.cli.train import main as train_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train_main((args or tp._cli_args(
            os.path.join(d, "manifest.csv"), os.path.join(d, name), name,
            d)) + ["--device", "cpu", *extra]) == 0
    return buf.getvalue()


def _assert_same_run(a, b):
    """Two CLI runs' final packages at the CLI bounds."""
    assert a["step"] == b["step"]
    x, y = dict(tp._flat(a["params"])), dict(tp._flat(b["params"]))
    assert sorted(x) == sorted(y)
    for key in x:
        np.testing.assert_allclose(y[key], x[key], rtol=2e-4, atol=2e-5,
                                   err_msg=key)
    for u, v in zip(a["optim_state"][2:], b["optim_state"][2:]):
        np.testing.assert_allclose(np.asarray(v), np.asarray(u), rtol=1e-3,
                                   atol=1e-4)


def test_train_cli_model_4_matches_one_process(runs):
    """The train CLI on 4 ranks at --mesh-model 4 (resuming the
    one-process CLI's checkpoint) against the one-process CLI's same
    resume: the final weights and momenta at the CLI bounds, the epoch's
    loss; rank 0 alone prints and writes."""
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    d, outs = runs["d"], runs["cli"]
    assert "mesh: data=1 x model=4 (gloo)" in outs["m4"][0]
    single = tp._final(d, "single_resume", ckpt.load)
    got = tp._final(d, "m40", ckpt.load)
    _assert_same_run(single, got)
    assert tp._epoch_losses(outs["m4"][0]) == pytest.approx(
        tp._epoch_losses(outs["single_resume"]), rel=1e-3)
    for rank in range(1, 4):
        assert not tp._epoch_losses(outs["m4"][rank])
        assert not os.path.exists(os.path.join(d, f"m4{rank}"))


def test_model_4_checkpoint_loads_in_jax_with_whole_leaves(runs):
    import jax

    from deepspeech_tpu.train import checkpoint as jax_ckpt

    d = runs["d"]
    pkg = tp._final(d, "m40", jax_ckpt.load)
    single = tp._final(d, "single_resume", jax_ckpt.load)
    for k in ("w_ih", "b_ih", "w_hh", "b_hh"):
        assert pkg["params"]["rnn0"][k].shape == \
            single["params"]["rnn0"][k].shape
        assert pkg["params"]["rnn0"][k].shape[-1] == 3 * HIDDEN
    assert [np.shape(x) for x in jax.tree.leaves(pkg["optim_state"])] == \
        [np.shape(x) for x in jax.tree.leaves(single["optim_state"])]


# -- the resume at model 4 and k > 1 on two ranks -----------------------------


def _spd_manifest(d):
    """8 utterances, 2 of up to 1 s and 6 of 1-2 s: at batch 2 the bins
    run A B B B (``--no-shuffle``: the same global batches in one
    process, on one host's two devices and on two ranks), so at k 2 a
    bucket switch cuts the first group to one batch and the epoch's end
    the last (one epoch: 4 steps in 3 groups); and an initial checkpoint
    every run starts from."""
    from scipy.io import wavfile

    from deepspeech_tpu_torch.audio.features import AudioConf
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.text.labels import load_labels
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    rng = np.random.default_rng(0)
    rows = []
    texts = ["AB", "BA", "AAB", "ABB", "A B", "B A", "BB", "AA"]
    durs = [0.4, 0.5, 1.1, 1.2, 1.3, 1.4, 1.5, 1.6]
    for i, (txt, dur) in enumerate(zip(texts, durs)):
        t = np.arange(int(16000 * dur)) / 16000
        y = 0.2 * np.sin(2 * np.pi * (300 + 140 * i) * t)
        y = y + 0.01 * rng.standard_normal(len(t))
        wav, tx = (os.path.join(d, f"s{i}.wav"),
                   os.path.join(d, f"s{i}.txt"))
        wavfile.write(wav, 16000, (y * 32767).astype(np.int16))
        with open(tx, "w") as f:
            f.write(txt)
        rows.append(f"{wav},{tx},{dur:.2f}")
    with open(os.path.join(d, "spd.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    labels = load_labels(os.path.join(ROOT, "labels.json"))
    torch.manual_seed(11)
    model, meta = build_model("gru", len(labels), HIDDEN, 1, device="cpu")
    ckpt.save(os.path.join(d, "spd_init.ckpt"), ckpt.package_from_model(
        model, meta, labels, AudioConf().to_dict()))


def _spd_args(d, save, log_id):
    m = os.path.join(d, "spd.csv")
    return ["--train-manifest", m, "--val-manifest", m, "--batch-size", "2",
            "--val-batch-size", "2", "--compute-dtype", "float32",
            "--norm", "none", "--epochs", "1", "--num-workers", "0",
            "--no-shuffle",
            "--continue-from", os.path.join(d, "spd_init.ckpt"),
            "--finetune", "--save-folder", save, "--id", log_id,
            "--log-dir", os.path.join(d, "logs")]


def test_model_4_resume_slices_the_whole_checkpoint(runs):
    """--continue-from at --mesh-model 4 loads the one-process container
    (weights and optimizer leaves) of one epoch, slices it, and trains
    the second epoch on as one process does: its step, epoch and loss
    history (the first epoch's carried over from the checkpoint)."""
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    d = runs["d"]
    first = tp._final(d, "single", ckpt.load)
    single = tp._final(d, "single_resume", ckpt.load)
    got = tp._final(d, "m40", ckpt.load)
    assert first["step"] == 2 and first["epoch"] == 1
    assert got["step"] == single["step"] == 4 and got["epoch"] == 2
    for key in ("loss_results", "wer_results", "cer_results"):
        assert np.asarray(got[key])[:1] == pytest.approx(
            np.asarray(first[key])[:1], rel=1e-6)
        assert np.asarray(got[key]) == pytest.approx(
            np.asarray(single[key]), rel=1e-3)


@pytest.mark.parametrize("ref", ["k1", "jax"])
def test_steps_per_dispatch_2_on_two_ranks(runs, ref):
    """Two gloo ranks at --steps-per-dispatch 2 (eager lanes: gloo) for one
    epoch (4 steps: a group cut by the bucket switch, a full one, the
    short tail) against the same ranks at k 1 and against the JAX CLI at
    k 2 on two devices, at the CLI bounds. Over a second epoch the
    one-process port CLI and the JAX CLI part: on conv1's kernel 1.19e-4
    after 8 steps, 5.7 times the bound, the conv front's Hardtanh clamps
    that the two packages' f32 convs place on either side
    (``_replayed``); after the first epoch the largest gap is 0.25 of
    the bound."""
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    d, outs = runs["d"], runs["cli"]
    got = ckpt.load(os.path.join(d, "k2_0", "deepspeech_final.ckpt"))
    want = ckpt.load(os.path.join(d, "k1_0" if ref == "k1" else "jax_k2",
                                  "deepspeech_final.ckpt"))
    assert got["step"] == want["step"] == 4
    assert tp._epoch_losses(outs["k2"][0]) == pytest.approx(
        tp._epoch_losses(outs["k1" if ref == "k1" else "jax"][0]),
        rel=1e-3)
    assert not os.path.exists(os.path.join(d, "k2_1"))
    _assert_same_run(want, got)


# -- the rank processes -------------------------------------------------------


def _step_inputs(inputs, name, k, mesh, replay=True):
    """Step k's jitter, replays (``_replayed``; ``replay`` False: none)
    and fed spectrogram, this rank's rows."""
    data = CASES[name][0]
    rows = slice(mesh.data_index * tp.B // data,
                 (mesh.data_index + 1) * tp.B // data)
    jitter = mesh.data_rows(torch.from_numpy(inputs[f"jitter:{k}"]))
    replays = [tuple(inputs[f"{name}:clamp:{k}:{i}:{m}"]
                     for m in ("lo", "hi")) for i in range(3)
               if f"{name}:clamp:{k}:{i}:lo" in inputs]
    replays += [inputs[f"{name}:keep:{k}:{i}"] for i in range(len(inputs))
                if f"{name}:keep:{k}:{i}" in inputs]
    spect = (inputs[f"spect:{k}"], inputs[f"spect_lengths:{k}"])
    return jitter, _replayed(replays if replay else None, rows), _fed(
        spect, rows)


def _rank_state(inputs, name, mesh, pre):
    """The case's model loaded whole from ``inputs`` (``pre`` + name; with
    ``pre + "leaf:"`` entries, the optimizer state from those optax
    leaves), sharded onto ``mesh`` -> (model, optimizer, state)."""
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.parallel import shard_state
    from deepspeech_tpu_torch.train.optim import (build_optimizer,
                                                  from_optax_leaves)
    from deepspeech_tpu_torch.train.step import TrainState

    model, _ = build_model(**_kw(name), device="cpu")
    model.load_state_dict({k[len(pre) + 3:]: torch.from_numpy(v)
                           for k, v in inputs.items()
                           if k.startswith(pre + "sd:")})
    opt = build_optimizer("sgd", lr=LR, momentum=0.9, max_norm=MAX_NORM)
    state = TrainState.create(model, opt)
    leaves = [inputs[f"{pre}leaf:{i}"] for i in range(len(inputs))
              if f"{pre}leaf:{i}" in inputs]
    if leaves:
        state.opt_state = from_optax_leaves(leaves, model, opt)
    return model, opt, shard_state(state, mesh)


def _run_steps(out, inputs, name, mesh, pre, replay=True):
    """STEPS free-running train steps on this rank from the JAX init, each
    step's loss, grad norm and parameters gathered whole under
    ``<name>:<pre><k>:``, and the first step's collectives -> the final
    (state, whole state_dict, whole optimizer state)."""
    from deepspeech_tpu_torch.parallel import gather_state
    from deepspeech_tpu_torch.train.step import StepConfig, make_train_step

    model, opt, state = _rank_state(inputs, name, mesh, f"{name}:")
    step = make_train_step(model, opt, StepConfig(), mesh)
    batch = mesh.data_rows({k[6:]: torch.from_numpy(v)
                            for k, v in inputs.items()
                            if k.startswith("batch:")})
    gen = torch.Generator().manual_seed(SEED_GEN)
    for k in range(STEPS):
        jitter, replayed, fed = _step_inputs(inputs, name, k, mesh, replay)
        mesh.counts.clear()
        with replayed, fed:
            m = step(state, batch, jitter=jitter, generator=gen)
        if k == 0:
            for tag, n in mesh.counts.items():
                out[f"{name}:{pre}counts:{tag}"] = np.asarray(n)
        out[f"{name}:{pre}{k}:loss"] = m["loss"].numpy()
        out[f"{name}:{pre}{k}:grad_norm"] = m["grad_norm"].numpy()
        sd, opt_state = gather_state(state, mesh)
        for n, _ in model.named_parameters():  # a copy: updated in place
            out[f"{name}:{pre}{k}:p:{n}"] = sd[n].numpy().copy()
    return state, sd, opt_state


def _worker_case(out, inputs, name):
    """A case on this rank: its STEPS free-running steps from the JAX init,
    replaying the JAX run's clamps and dropout masks (``<k>:``), every
    parameter's and momentum trace's shape on the rank, and each sharded
    one checked against its slice of the whole; with dropout, the steps
    again on the port's own draws (``draws<k>:``); then each step again
    from the JAX run's state before it (``jax<k>:``)."""
    from deepspeech_tpu_torch.parallel import (gather_state, make_mesh,
                                               shard_dims, shard_slice)
    from deepspeech_tpu_torch.train.step import StepConfig, make_train_step

    data, model_axis = CASES[name][:2]
    mesh = make_mesh(data=data, model=model_axis)
    state, sd, opt_state = _run_steps(out, inputs, name, mesh, "")
    model = state.model
    dims = shard_dims(model)
    checked = 0
    for pos, (n, p) in enumerate(model.named_parameters()):
        trace = state.opt_state["trace"][pos]
        out[f"{name}:shape:param:{n}"] = np.asarray(p.shape)
        out[f"{name}:shape:trace:{n}"] = np.asarray(trace.shape)
        if n in dims:
            for mine, whole in ((p.detach(), sd[n]),
                                (trace, opt_state["trace"][pos])):
                assert torch.equal(mine, shard_slice(whole, dims[n], mesh))
                checked += 1
    out[f"{name}:slices_checked"] = np.asarray(checked)
    if CASES[name][4]:
        _run_steps(out, inputs, name, mesh, "draws", replay=False)
    names = [n for n, _ in model.named_parameters()]
    batch = mesh.data_rows({k[6:]: torch.from_numpy(v)
                            for k, v in inputs.items()
                            if k.startswith("batch:")})
    for k in range(STEPS):
        model, opt, state = _rank_state(inputs, name, mesh,
                                        f"{name}:jax:{k}:")
        step = make_train_step(model, opt, StepConfig(), mesh)
        jitter, replayed, fed = _step_inputs(inputs, name, k, mesh)
        with replayed, fed:
            m = step(state, batch, jitter=jitter)
        out[f"{name}:jax{k}:loss"] = m["loss"].numpy()
        out[f"{name}:jax{k}:grad_norm"] = m["grad_norm"].numpy()
        sd, _ = gather_state(state, mesh)
        for n in names:
            out[f"{name}:jax{k}:p:{n}"] = sd[n].numpy().copy()


def _worker(scenario, rank, world, d):
    """A rank of ``scenario``: its train CLI runs (``SCENARIO_CLIS``), then,
    once the fixture has written the inputs, its step cases."""
    import datetime

    for run in SCENARIO_CLIS[scenario]:
        _worker_cli(d, run, rank, world)
    _wait_for(os.path.join(d, "inputs.npz"))
    torch.distributed.init_process_group(
        "gloo", init_method="file://" + os.path.join(d, f"rdv_{scenario}"),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        with np.load(os.path.join(d, "inputs.npz")) as f:
            inputs = dict(f)
        out = {}
        for name in SCENARIOS[scenario][1]:
            _worker_case(out, inputs, name)
        np.savez(os.path.join(d, f"{scenario}_{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, ROOT)
    _worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
