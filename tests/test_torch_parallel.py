"""PyTorch port: multi-GPU training (``parallel/``) on gloo CPU ranks,
against the JAX package.

Each rank is a process of this file (``python test_torch_parallel.py
--worker <scenario> <rank> <world> <rendezvous file> <dir>``) that imports
only the port; the rendezvous is a ``file://`` in the test's temporary
directory, every ``init_process_group`` has a 60 s timeout and every
``communicate`` one of ``TIMEOUT``. The JAX references are computed in the
pytest process, the inputs handed to the ranks as ``.npz``:

* ``DistributedBucketingSampler`` against the JAX class, bit for bit, for
  every (rows, batch, replicas, rank, epoch, shuffle, reverse) of a grid;
* the direction-sharded layer on 2 ranks (GRU and LSTM) against the JAX
  ``direction_sharded_rnn`` on a 2-device CPU mesh and the single-device
  ``rnn_scan`` (both in Pallas interpret mode): forward at 1e-5, the four
  weight grads and dx of sum(out^2) at 2e-4 (``tests/test_tp_rnn.py``);
* 2 train steps of the small DS2 of ``tests/test_parallel.py`` (hidden 16,
  2 layers, 12 classes, batch 8, f32) at data 2 x model 1, data 1 x model
  2 and data 2 x model 2 (4 ranks) against the JAX single-device
  ``make_train_step`` on the whole batch: losses at 2e-4, parameters
  (gathered whole) at 5e-4, as ``tests/test_parallel.py`` holds the JAX
  mesh. The batch's halves differ in content and length, so a BatchNorm
  that took its shard's moments fails, and the steps clip (lr 0.3,
  max_norm 1), so a grad norm that counted a sharded element twice fails;
* the collective audit: under tensor parallelism each rank holds (1, ...)
  RNN weights and moments, and a step issues exactly the expected
  collectives, counted by ``Mesh.counts``: no gather of an RNN weight,
  one of the head's class-sharded kernel (the JAX rule shards the 12
  classes at model 2);
* sharded validation on 2 ranks against the single-process pass;
* a ``--use-curriculum`` epoch draw that differs between ranks becomes
  rank 0's on every rank;
* the train CLI on 2 ranks (``--dist-url file://...``) against the
  single-process CLI at the same global batch, its checkpoint's weights at
  rtol 2e-4 / atol 2e-5 (``tests/test_multihost.py``'s pair) and momentum
  traces at rtol 1e-3 / atol 1e-4, written by rank 0 alone; and with
  ``--mesh-model 2``, whose checkpoint the JAX ``ckpt.load`` reads with
  (2, ...) leaves; ``--continue-from`` at ``--mesh-model 2`` from the
  single-process checkpoint (loaded whole, then sliced) against the same
  resume on one process.
"""

import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
# each rank process computes on one thread: they share the host's cores
RANK_ENV = dict(os.environ, OMP_NUM_THREADS="1")
NUM_CLASSES, HIDDEN, LAYERS, B, S = 12, 16, 2, 8, 4800
LR, MAX_NORM, STEPS = 0.3, 1.0, 2
LAYOUTS = {"dp": (2, 1), "tp": (1, 2), "dp_tp": (2, 2)}
CELLS = {"gru": 3, "lstm": 4}
EVAL_UTTS = 8


def _spawn(scenario: str, world: int, d: str) -> list:
    init = os.path.join(d, f"rdv_{scenario}")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", scenario,
         str(rank), str(world), init, d], cwd=ROOT, env=RANK_ENV,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]


def _wait(procs: list) -> list:
    outs = []
    for rank, p in enumerate(procs):
        out, _ = p.communicate(timeout=TIMEOUT)
        outs.append(out)
        assert p.returncode == 0, f"rank {rank}:\n{out[-4000:]}"
    return outs


def _stop(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield ":".join(prefix + (k,)), np.array(v)


# -- inputs and JAX references -------------------------------------------------


def _step_batch():
    """8 rows collated as the loader does (zeros past each length, its
    reflect tail, f32 wire) whose halves differ: rows 0-3 0.3 s of noise
    with 6 labels, rows 4-7 0.15 s noisy tones with 3."""
    from deepspeech_tpu.data.loader import BucketSpec, collate_batch

    rng = np.random.default_rng(0)
    samples = []
    for i in range(B):
        n = S if i < B // 2 else S // 2
        t = np.arange(n) / 16000
        # a pure tone's near-zero bins would magnify the two STFTs'
        # round-off in the log-spectrogram; the tones carry some noise
        y = rng.standard_normal(n) * (0.1 if i < B // 2 else 0.02)
        if i >= B // 2:
            y += 0.5 * np.sin(2 * np.pi * (200 + 90 * i) * t)
        labels = rng.integers(1, NUM_CLASSES, 6 if i < B // 2 else 3)
        samples.append({"audio": y.astype(np.float32),
                        "target": labels.astype(np.int32), "path": ""})
    batch = collate_batch(samples, B, BucketSpec(
        audio_step=1600, target_step=6, min_target=6, wire_dtype="float32"))
    return {k: batch[k] for k in ("audio", "audio_lengths", "targets",
                                  "target_lengths")}


def _tp_layer_inputs(rng, g):
    t, b, f, h = 12, 8, 16, 16
    x = rng.standard_normal((t, b, f)).astype(np.float32)
    lens = np.full(b, t, np.int32)
    lens[1::2] = rng.integers(2, t, size=b // 2)

    def mk(*s):
        return (rng.standard_normal(s) * 0.2).astype(np.float32)

    return x, lens, mk(2, f, g * h), mk(2, g * h), mk(2, h, g * h), \
        mk(2, g * h)


def _jax_model():
    """The JAX single-device model and its init; the key of each step and
    the max-frame jitter the JAX step draws from it."""
    import jax
    import jax.numpy as jnp

    from deepspeech_tpu.models import DeepSpeech2

    model = DeepSpeech2(num_classes=NUM_CLASSES, hidden_size=HIDDEN,
                        hidden_layers=LAYERS, cell="gru", bidirectional=True)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 161, 51)),
                           jnp.asarray([51]), False)
    keys = [jax.random.fold_in(jax.random.PRNGKey(1), i)
            for i in range(STEPS)]
    jitters = [np.asarray(jax.random.uniform(
        jax.random.split(k, 3)[0], (B,), minval=-0.5, maxval=0.5))
        for k in keys]
    return model, variables, keys, jitters


def _jax_step_refs(model, variables, keys, batch):
    """(loss, grad norm, params) after each JAX single-device step."""
    import jax
    import jax.numpy as jnp

    from deepspeech_tpu.audio import AudioConf
    from deepspeech_tpu.train import (StepConfig, TrainState,
                                      build_optimizer, make_train_step)

    tx = build_optimizer("sgd", lr=LR, momentum=0.9, max_norm=MAX_NORM)
    state = TrainState.create(variables, tx)
    step = make_train_step(model, tx, StepConfig(audio_conf=AudioConf()),
                           donate=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    refs = []
    for k in keys:
        state, m = step(state, jbatch, k)
        refs.append((float(m["loss"]), float(m["grad_norm"]),
                     dict(_flat(jax.device_get(state.params)))))
    return refs


def _jax_tp_layer_refs(inputs):
    """Per cell: (output, grads of sum(out^2) wrt x and the 4 weights) of
    the JAX direction_sharded_rnn on a 1 x 2 mesh and of rnn_scan."""
    import jax
    import jax.numpy as jnp

    from deepspeech_tpu.ops.rnn import rnn_scan
    from deepspeech_tpu.parallel.mesh import make_mesh
    from deepspeech_tpu.parallel.tp_rnn import direction_sharded_rnn

    mesh = make_mesh(data=1, model=2, devices=jax.devices()[:2])
    out = {}
    for cell, args in inputs.items():
        args = [jnp.asarray(a) for a in args]
        kw = dict(cell=cell, compute_dtype=jnp.float32,
                  impl="xla")

        def sharded(x, *w, lens=args[1]):
            return direction_sharded_rnn(x, lens, *w, **kw)

        def single(x, *w, lens=args[1]):
            return rnn_scan(x, lens, *w, bidirectional=True, **kw)

        for name, fn in (("sharded", sharded), ("single", single)):
            def both(*a, fn=fn):
                y, vjp = jax.vjp(fn, *a)
                return y, vjp(2 * y)  # the grads of sum(y^2)

            with (jax.set_mesh(mesh) if name == "sharded"
                  else contextlib.nullcontext()):
                y, grads = jax.jit(both)(args[0], *args[2:])
            out[cell, name] = (np.asarray(y),
                               [np.asarray(g) for g in grads])
    return out


def _eval_fixture(d):
    """A seeded 1-layer model's checkpoint and a manifest of EVAL_UTTS
    utterances of 0.3-2.4 s (bins of 2 land on several pad widths)."""
    from scipy.io import wavfile

    from deepspeech_tpu_torch.audio.features import AudioConf
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.text.labels import load_labels
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    rng = np.random.default_rng(1)
    rows = []
    for i, txt in enumerate(["AB", "BA", "AAB", "ABB", "A B", "B A", "BB",
                             "AA"][:EVAL_UTTS]):
        dur = 0.3 + 0.3 * i
        t = np.arange(int(16000 * dur)) / 16000
        y = 0.2 * np.sin(2 * np.pi * (300 + 120 * i) * t) \
            + 0.01 * rng.standard_normal(len(t))
        wav, tx = os.path.join(d, f"v{i}.wav"), os.path.join(d, f"v{i}.txt")
        wavfile.write(wav, 16000, (y * 32767).astype(np.int16))
        with open(tx, "w") as f:
            f.write(txt)
        rows.append(f"{wav},{tx},{dur:.2f}")
    with open(os.path.join(d, "eval.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    labels = load_labels(os.path.join(ROOT, "labels.json"))
    torch.manual_seed(3)
    model, meta = build_model("gru", len(labels), HIDDEN, 1, device="cpu")
    ckpt.save(os.path.join(d, "eval.ckpt"), ckpt.package_from_model(
        model, meta, labels, AudioConf().to_dict()))


def _evaluate(d, mesh=None):
    """The greedy validation of the eval checkpoint over the manifest, on
    ``mesh``'s data shard (sharded, summed) or whole."""
    from deepspeech_tpu_torch.audio.features import AudioConf
    from deepspeech_tpu_torch.convert import jax_to_torch
    from deepspeech_tpu_torch.data import (AudioDataLoader, AudioDataset,
                                           BucketingSampler, BucketSpec,
                                           DistributedBucketingSampler)
    from deepspeech_tpu_torch.decoders import GreedyDecoder
    from deepspeech_tpu_torch.models import model_from_meta
    from deepspeech_tpu_torch.text.labels import Labels
    from deepspeech_tpu_torch.train import checkpoint as ckpt
    from deepspeech_tpu_torch.train.evaluate import evaluate
    from deepspeech_tpu_torch.train.step import StepConfig, make_eval_step

    pkg = ckpt.load(os.path.join(d, "eval.ckpt"))
    model = model_from_meta(pkg, device="cpu")
    model.load_state_dict(jax_to_torch(pkg["params"], pkg["batch_stats"]))
    labels = Labels(pkg["labels"])
    conf = AudioConf.from_dict(pkg["audio_conf"])
    dataset = AudioDataset(conf, os.path.join(d, "eval.csv"), labels)
    sampler = (BucketingSampler(len(dataset), 2) if mesh is None else
               DistributedBucketingSampler(len(dataset), 2, mesh.data,
                                           mesh.data_index))
    loader = AudioDataLoader(dataset, sampler, 2, BucketSpec(), 1)

    def to_device(batch):
        return {k: torch.from_numpy(v) for k, v in batch.items()
                if k != "paths"}

    return evaluate(loader, make_eval_step(model, StepConfig(audio_conf=conf)),
                    GreedyDecoder(labels.labels,
                                  blank_index=labels.blank_index),
                    labels, to_device, all_reduce=mesh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the rank processes (the train CLI's, then the 2-rank and
    4-rank workers) and computes the JAX references and the
    single-process runs here while they run -> (refs, worker outputs by
    (scenario, rank), the CLI runs' directory, their outputs by name)."""
    import jax

    from deepspeech_tpu_torch.convert import jax_to_torch

    d = str(tmp_path_factory.mktemp("parallel"))
    cli = _start_cli(d)
    batch = _step_batch()
    model, variables, keys, jitters = _jax_model()
    init = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(2)
    layer_inputs = {c: _tp_layer_inputs(rng, g) for c, g in CELLS.items()}
    sd = jax_to_torch(init["params"], init["batch_stats"])
    arrays = {f"sd:{k}": v.numpy() for k, v in sd.items()}
    arrays.update({f"batch:{k}": v for k, v in batch.items()})
    arrays.update({f"jitter:{i}": j for i, j in enumerate(jitters)})
    for cell, args in layer_inputs.items():
        arrays.update({f"{cell}:{i}": a for i, a in enumerate(args)})
    np.savez(os.path.join(d, "inputs.npz"), **arrays)
    _eval_fixture(d)
    pair, quad = _spawn("pair", 2, d), _spawn("quad", 4, d)
    try:
        refs = dict(layer=_jax_tp_layer_refs(layer_inputs),
                    steps=_jax_step_refs(model, variables, keys, batch),
                    eval=_evaluate(d))
        cli_outs = _finish_cli(d, cli)
        _wait(pair)
        _wait(quad)
    finally:
        _stop(cli["dp"] + cli["tp"] + pair + quad)
    out = {}
    for scenario, world in (("pair", 2), ("quad", 4)):
        for rank in range(world):
            with np.load(os.path.join(d, f"{scenario}_{rank}.npz")) as f:
                out[scenario, rank] = dict(f)
    return refs, out, d, cli_outs


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[:2]


@pytest.fixture(scope="module")
def cli_runs(runs):
    return runs[2:]


# -- the sampler ---------------------------------------------------------------


@pytest.mark.parametrize("n,batch", [(23, 4), (8, 2), (5, 3)])
@pytest.mark.parametrize("replicas", [1, 2, 3, 4])
@pytest.mark.parametrize("order", ["sorted", "shuffle", "reverse"])
def test_distributed_sampler_matches_jax(n, batch, replicas, order):
    from deepspeech_tpu.data.sampler import \
        DistributedBucketingSampler as JaxSampler
    from deepspeech_tpu_torch.data import DistributedBucketingSampler

    for rank in range(replicas):
        for epoch in (0, 1, 7):
            ours = DistributedBucketingSampler(n, batch, replicas, rank)
            theirs = JaxSampler(n, batch, num_replicas=replicas, rank=rank)
            if order == "shuffle":
                ours.shuffle(epoch)
                theirs.shuffle(epoch)
            elif order == "reverse":
                ours.reverse()
                theirs.reverse()
            assert list(ours) == list(theirs)
            assert len(ours) == len(theirs)


# -- the direction-sharded layer ----------------------------------------------


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("ref", ["sharded", "single"])
def test_tp_layer_matches_jax(ranks, cell, ref):
    refs, out = ranks
    y, grads = refs["layer"][cell, ref]
    names = ["x", "w_ih", "b_ih", "w_hh", "b_hh"]
    for rank in range(2):
        got = out["pair", rank]
        np.testing.assert_allclose(got[f"{cell}:out"], y, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[f"{cell}:d:x"], grads[0], rtol=2e-4,
                                   atol=2e-4, err_msg="dx")
        for name, g in zip(names[1:], grads[1:]):
            # each rank holds its direction's slice of the weight grads
            np.testing.assert_allclose(got[f"{cell}:d:{name}"],
                                       g[rank:rank + 1], rtol=2e-4,
                                       atol=2e-4, err_msg=name)


# -- whole train steps ---------------------------------------------------------


def _layout_ranks(layout):
    data, model = LAYOUTS[layout]
    return (("quad", range(4)) if data * model == 4
            else ("pair", range(2)))


@pytest.mark.parametrize("k", range(STEPS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_train_steps_match_jax_single_device(ranks, layout, k):
    refs, out = ranks
    loss, norm, params = refs["steps"][k]
    assert norm > MAX_NORM  # the step clips
    scenario, members = _layout_ranks(layout)
    for rank in members:
        got = out[scenario, rank]
        np.testing.assert_allclose(got[f"{layout}:{k}:loss"], loss,
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got[f"{layout}:{k}:grad_norm"], norm,
                                   rtol=2e-4)
        for name, ref in params.items():
            np.testing.assert_allclose(got[f"{layout}:{k}:p:{name}"], ref,
                                       rtol=5e-4, atol=5e-4, err_msg=name)


# the collectives of one step of the 2-layer model: BN moments (bn0, bn1,
# rnns.1.bn, fc_bn; sum and n, then the squares, forward and backward) over
# the data group; the layer's g forward and f backward over the model group;
# the gather of the head's class-sharded kernel (12 classes, 6 a rank)
# forward, none backward; the valid-row count and the flat gradient over
# the data group; the replicated parameters' gradients broadcast over the
# model group; the sharded squares of the grad norm over the model group;
# the NaN flag over the world
AUDIT = {
    "dp": {"bn": 8, "bn_grad": 8, "valid": 1, "grads": 1, "nan": 1},
    "tp": {"tp": 2, "tp_grad": 2, "gather_head": 1, "replicas": 1,
           "grad_norm": 1, "nan": 1},
    "dp_tp": {"bn": 8, "bn_grad": 8, "tp": 2, "tp_grad": 2,
              "gather_head": 1, "valid": 1, "grads": 1, "replicas": 1,
              "grad_norm": 1, "nan": 1},
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_collective_audit(ranks, layout):
    _, out = ranks
    scenario, members = _layout_ranks(layout)
    data, model = LAYOUTS[layout]
    names = ["w_ih", "b_ih", "w_hh", "b_hh"]
    for rank in members:
        got = out[scenario, rank]
        counts = {k.split(":")[-1]: int(v) for k, v in got.items()
                  if k.startswith(f"{layout}:counts:")}
        assert counts == AUDIT[layout], (rank, counts)
        for i in range(LAYERS):
            for name in names:
                for what in ("param", "trace"):
                    shape = got[f"{layout}:shape:{what}:rnns.{i}.{name}"]
                    assert shape[0] == 2 // model, (what, name, shape)


def test_sharded_validation_matches_single_process(ranks):
    refs, out = ranks
    want = refs["eval"]
    for rank in range(2):
        got = out["pair", rank]
        assert int(got["eval:num_utterances"]) == want["num_utterances"] \
            == EVAL_UTTS
        for key in ("loss", "wer", "cer", "utt_wer", "utt_cer"):
            assert float(got[f"eval:{key}"]) == pytest.approx(
                want[key], rel=1e-6), key


def test_ranks_take_rank_zeros_curriculum_draw(ranks):
    """``--use-curriculum`` on several data shards: every rank's epoch list
    is rank 0's draw (two broadcasts: its length, its rows)."""
    _, out = ranks
    for rank in range(2):
        got = out["pair", rank]
        assert got["draw"].tolist() == [3, 1, 4, 1, 5, 6]
        assert int(got["draw:broadcasts"]) == 2


# -- the train CLI -------------------------------------------------------------


def _manifest(d):
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    rows = []
    for i, txt in enumerate(["AB", "BA", "AAB", "ABB", "A B", "B A", "BB",
                             "AA"]):
        t = np.arange(4800) / 16000
        y = 0.2 * np.sin(2 * np.pi * (300 + 120 * i) * t) \
            + 0.01 * rng.standard_normal(len(t))
        wav, tx = os.path.join(d, f"u{i}.wav"), os.path.join(d, f"u{i}.txt")
        wavfile.write(wav, 16000, (y * 32767).astype(np.int16))
        with open(tx, "w") as f:
            f.write(txt)
        rows.append(f"{wav},{tx},0.30")
    path = os.path.join(d, "manifest.csv")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


def _cli_args(manifest, save, log_id, d):
    return ["--device", "cpu", "--train-manifest", manifest,
            "--val-manifest", manifest, "--batch-size", "4",
            "--val-batch-size", "2", "--hidden-size", "16",
            "--hidden-layers", "1", "--num-workers", "1", "--epochs", "2",
            "--no-shuffle", "--seed", "7", "--compute-dtype", "float32",
            "--norm", "none", "--save-folder", save, "--id", log_id,
            "--log-dir", os.path.join(d, "logs")]


def _ranks_cli(d, name, extra=()) -> list:
    """The train CLI on 2 ranks into ``<d>/<name><rank>``."""
    return [subprocess.Popen(
        [sys.executable, "-m", "deepspeech_tpu_torch.cli.train",
         *_cli_args(os.path.join(d, "manifest.csv"),
                    os.path.join(d, f"{name}{rank}"), f"{name}{rank}", d),
         "--dist-url", "file://" + os.path.join(d, f"rdv_{name}"),
         "--dist-rank", str(rank), "--dist-world-size", "2", *extra],
        cwd=ROOT, env=RANK_ENV, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]


def _start_cli(d) -> dict:
    """The train CLI on 2 ranks (data 2) and on 2 ranks at --mesh-model 2."""
    return {"manifest": _manifest(d), "dp": _ranks_cli(d, "dp"),
            "tp": _ranks_cli(d, "tp", ["--mesh-model", "2"])}


def _finish_cli(d, procs) -> dict:
    """The single-process CLI run here, then the ranks' outputs."""
    from deepspeech_tpu_torch.cli.train import main as train_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train_main(_cli_args(procs["manifest"],
                                    os.path.join(d, "single"), "single",
                                    d)) == 0
    return {"single": [buf.getvalue()], "dp": _wait(procs["dp"]),
            "tp": _wait(procs["tp"])}


@pytest.fixture(scope="module")
def tp_resume(cli_runs):
    """One more epoch from the single-process run's final checkpoint, at
    --mesh-model 2 (the whole container loaded, then sliced) and on one
    process."""
    from deepspeech_tpu_torch.cli.train import main as train_main

    d, _ = cli_runs
    extra = ["--continue-from", os.path.join(d, "single",
                                             "deepspeech_final.ckpt"),
             "--epochs", "3"]
    procs = _ranks_cli(d, "tp_resume", ["--mesh-model", "2", *extra])
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert train_main(_cli_args(
                os.path.join(d, "manifest.csv"),
                os.path.join(d, "single_resume"), "single_resume",
                d) + extra) == 0
        _wait(procs)
    finally:
        _stop(procs)
    return d


def _final(d, name, loader):
    return loader(os.path.join(d, name, "deepspeech_final.ckpt"))


def _epoch_losses(out):
    return [float(x) for x in re.findall(r"avg loss ([0-9.]+)", out)]


@pytest.mark.parametrize("name", ["dp", "tp"])
def test_train_cli_ranks_match_single_process(cli_runs, name):
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    d, outs = cli_runs
    single = _final(d, "single", ckpt.load)
    got = _final(d, f"{name}0", ckpt.load)
    assert got["step"] == single["step"] == 4
    a, b = dict(_flat(single["params"])), dict(_flat(got["params"]))
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=2e-4, atol=2e-5,
                                   err_msg=key)
    # the momentum traces are sums of gradients, not scaled by the lr: f32
    # sums in other orders move them by up to ~1e-4 of their scale
    for x, y in zip(single["optim_state"][2:], got["optim_state"][2:]):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=1e-3,
                                   atol=1e-4)
    # rank 0 alone prints, logs and writes
    want = _epoch_losses(outs["single"][0])
    assert len(want) == 2
    assert _epoch_losses(outs[name][0]) == pytest.approx(want, rel=1e-3)
    assert not _epoch_losses(outs[name][1])
    assert not os.path.exists(os.path.join(d, f"{name}1"))
    logs = os.listdir(os.path.join(d, "logs"))
    assert f"{name}0.jsonl" in logs and f"{name}1.jsonl" not in logs


def test_tp_resume_slices_the_whole_checkpoint(tp_resume):
    """--continue-from at --mesh-model 2 loads the whole container (weights
    and optimizer leaves), slices it, and trains on as one process does."""
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    single = _final(tp_resume, "single_resume", ckpt.load)
    got = _final(tp_resume, "tp_resume0", ckpt.load)
    assert got["step"] == single["step"] == 6 and got["epoch"] == 3
    a, b = dict(_flat(single["params"])), dict(_flat(got["params"]))
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=2e-4, atol=2e-5,
                                   err_msg=key)
    for x, y in zip(single["optim_state"][2:], got["optim_state"][2:]):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=1e-3,
                                   atol=1e-4)


def test_tp_checkpoint_loads_in_jax_with_whole_leaves(cli_runs):
    import jax

    from deepspeech_tpu.train import checkpoint as jax_ckpt

    d, outs = cli_runs
    assert "mesh: data=1 x model=2 (gloo)" in outs["tp"][0]
    pkg = _final(d, "tp0", jax_ckpt.load)
    single = _final(d, "single", jax_ckpt.load)
    for k in ("w_ih", "b_ih", "w_hh", "b_hh"):
        assert pkg["params"]["rnn0"][k].shape[0] == 2
    assert [np.shape(x) for x in jax.tree.leaves(pkg["optim_state"])] == \
        [np.shape(x) for x in jax.tree.leaves(single["optim_state"])]


# -- the rank processes --------------------------------------------------------


def _worker_tp_layer(out, inputs):
    from deepspeech_tpu_torch.parallel import direction_sharded_rnn, make_mesh

    mesh = make_mesh(data=1, model=2)
    r = mesh.model_index
    for cell in CELLS:
        x, lens, *ws = (torch.from_numpy(inputs[f"{cell}:{i}"])
                        for i in range(6))
        x.requires_grad_(True)
        ws = [w[r:r + 1].clone().requires_grad_(True) for w in ws]
        y = direction_sharded_rnn(x, lens, *ws, mesh=mesh, cell=cell)
        grads = torch.autograd.grad((y ** 2).sum(), [x, *ws])
        out[f"{cell}:out"] = y.detach().numpy()
        for name, g in zip(["x", "w_ih", "b_ih", "w_hh", "b_hh"], grads):
            out[f"{cell}:d:{name}"] = g.numpy()


def _worker_steps(out, inputs, layout):
    from deepspeech_tpu_torch.convert import torch_to_jax
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.parallel import (gather_state, make_mesh,
                                               shard_state)
    from deepspeech_tpu_torch.train.optim import build_optimizer
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_train_step)

    data, model_axis = LAYOUTS[layout]
    mesh = make_mesh(data=data, model=model_axis)
    model, _ = build_model("gru", NUM_CLASSES, HIDDEN, LAYERS, device="cpu")
    model.load_state_dict({k[3:]: torch.from_numpy(v)
                           for k, v in inputs.items() if k.startswith("sd:")})
    opt = build_optimizer("sgd", lr=LR, momentum=0.9, max_norm=MAX_NORM)
    state = shard_state(TrainState.create(model, opt), mesh)
    for (name, p), t in zip(model.named_parameters(),
                            state.opt_state["trace"]):
        out[f"{layout}:shape:param:{name}"] = np.asarray(p.shape)
        out[f"{layout}:shape:trace:{name}"] = np.asarray(t.shape)
    step = make_train_step(model, opt, StepConfig(), mesh)
    batch = mesh.data_rows({k[6:]: torch.from_numpy(v)
                            for k, v in inputs.items()
                            if k.startswith("batch:")})
    for k in range(STEPS):
        jitter = mesh.data_rows(torch.from_numpy(inputs[f"jitter:{k}"]))
        mesh.counts.clear()
        m = step(state, batch, jitter=jitter)
        if k == 0:
            for tag, n in mesh.counts.items():
                out[f"{layout}:counts:{tag}"] = np.asarray(n)
        out[f"{layout}:{k}:loss"] = m["loss"].numpy()
        out[f"{layout}:{k}:grad_norm"] = m["grad_norm"].numpy()
        params, _ = torch_to_jax(gather_state(state, mesh)[0])
        for name, v in _flat(params):
            out[f"{layout}:{k}:p:{name}"] = v


def _worker_share_draw(out, rank):
    """Ranks whose curriculum draws differ (as their stores would) take
    rank 0's, broadcast."""
    from types import SimpleNamespace

    from deepspeech_tpu_torch.cli.train import share_epoch_draw
    from deepspeech_tpu_torch.parallel import make_mesh

    mesh = make_mesh(data=2)
    rows = [(f"u{i}.wav", f"u{i}.txt", 1.0) for i in range(7)]
    mine = [[3, 1, 4, 1, 5, 6], [2, 0]][rank]
    dataset = SimpleNamespace(all_ids=rows, ids=[rows[i] for i in mine])
    share_epoch_draw(dataset, mesh)
    out["draw"] = np.asarray([rows.index(r) for r in dataset.ids])
    out["draw:broadcasts"] = np.asarray(mesh.counts["broadcast"])


def _worker_eval(out, d):
    from deepspeech_tpu_torch.parallel import make_mesh

    summary = _evaluate(d, make_mesh(data=2, model=1))
    for key, v in summary.items():
        out[f"eval:{key}"] = np.asarray(v)


def _worker(scenario, rank, world, init, d):
    import datetime

    torch.distributed.init_process_group(
        "gloo", init_method="file://" + init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    try:
        with np.load(os.path.join(d, "inputs.npz")) as f:
            inputs = dict(f)
        out = {}
        if scenario == "pair":
            _worker_tp_layer(out, inputs)
            _worker_steps(out, inputs, "dp")
            _worker_steps(out, inputs, "tp")
            _worker_eval(out, d)
            _worker_share_draw(out, rank)
        else:
            _worker_steps(out, inputs, "dp_tp")
        np.savez(os.path.join(d, f"{scenario}_{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, ROOT)
    _worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
            sys.argv[6])
