"""PyTorch port: the ``train`` CLI end to end, and the data path against the
JAX package.

``python -m deepspeech_tpu_torch.cli.train --device cpu`` trains a tiny
DS2 (1 x BiGRU-16, f32) for one epoch on a 4-utterance synthetic manifest
and writes ``deepspeech_final.ckpt`` and ``best_model.ckpt``. The final
checkpoint answers a ``transcribe`` request through both packages' CLIs
with the same JSON. ``collate_batch`` gives the JAX package's arrays on
each wire, the step's featurize from each wire the JAX step's
spectrogram, the sampler the JAX bins and ``get_cer_wer`` its WER/CER.
Every flag the port has ported runs on the CPU in-process and shows its
effect (augmentation, resuming, mid-epoch checkpoints, train-val, the
metric log and dashboard, TensorBoard, profiling); the flag values no
path takes (``--mesh-model`` 0, or above 1 on one process) exit naming
the flag.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch

from deepspeech_tpu.cli.transcribe import main as jax_transcribe
from deepspeech_tpu.data.loader import BucketSpec as JaxBucketSpec
from deepspeech_tpu.data.loader import collate_batch as jax_collate
from deepspeech_tpu.data.sampler import BucketingSampler as JaxSampler
from deepspeech_tpu.metrics import get_cer_wer as jax_get_cer_wer
from deepspeech_tpu_torch.audio.io import save_wav
from deepspeech_tpu_torch.cli.train import main as train_main
from deepspeech_tpu_torch.cli.transcribe import main as port_transcribe
from deepspeech_tpu_torch.data import BucketingSampler, BucketSpec, \
    collate_batch
from deepspeech_tpu_torch.metrics import get_cer_wer
from deepspeech_tpu_torch.train import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ("HELLO WORLD", "THE CAT", "A DOG RAN", "GOOD DAY")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_train_cli")
    rng = np.random.default_rng(0)
    rows = []
    for i, text in enumerate(TEXTS):
        n = int(16000 * (0.5 + 0.15 * i))
        t = np.arange(n) / 16000
        y = (np.sin(2 * np.pi * (200 + 50 * i) * t)
             + 0.1 * rng.standard_normal(n))
        wav, txt = str(d / f"u{i}.wav"), str(d / f"u{i}.txt")
        save_wav(wav, (y / np.abs(y).max()).astype(np.float32), 16000)
        with open(txt, "w") as f:
            f.write(text)
        rows.append(f"{wav},{txt},{n / 16000}")
    manifest = d / "manifest.csv"
    manifest.write_text("\n".join(rows) + "\n")
    save = d / "models"
    cmd = [sys.executable, "-m", "deepspeech_tpu_torch.cli.train",
           "--device", "cpu", "--train-manifest", str(manifest),
           "--val-manifest", str(manifest), "--epochs", "1",
           "--batch-size", "2", "--val-batch-size", "2",
           "--hidden-size", "16", "--hidden-layers", "1",
           "--compute-dtype", "float32", "--num-workers", "1",
           "--lr", "1e-3", "--save-folder", str(save)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    return save, r.stdout, str(d / "u0.wav")


def test_train_cli_runs_one_epoch(trained):
    save, out, _ = trained
    assert "epoch 1 iter 1/2 loss" in out
    assert "[val] epoch 1: loss" in out
    for name in ("deepspeech_final.ckpt", "best_model.ckpt"):
        assert (save / name).exists(), name
    package = ckpt.load(str(save / "deepspeech_final.ckpt"))
    assert package["step"] == 2 and package["epoch"] == 1
    # the optimizer state as optax's leaves: the inject count, the LR and
    # one momentum trace a parameter
    from deepspeech_tpu_torch.train.optim import tree_leaves

    leaves = package["optim_state"]
    assert package["hidden_size"] == 16 and int(leaves[0]) == 2
    assert len(leaves) == 2 + len(tree_leaves(package["params"]))
    assert len(package["loss_results"]) == 1


def test_both_transcribe_clis_read_the_trained_checkpoint(trained, capsys):
    save, _, wav = trained
    args = ["--model-path", str(save / "deepspeech_final.ckpt"),
            "--audio-path", wav]
    assert jax_transcribe(args) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_transcribe(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == ref


@pytest.mark.parametrize("wire", ["int16", "mulaw8", "float32"])
def test_collate_matches_jax(wire):
    rng = np.random.default_rng(1)
    samples = [{"audio": rng.uniform(-1, 1, n).astype(np.float32),
                "target": rng.integers(1, 29, m).astype(np.int32),
                "path": f"p{n}"} for n, m in ((7000, 5), (12345, 61))]
    got = collate_batch(samples, 3, BucketSpec(wire_dtype=wire))
    ref = jax_collate(samples, 3, JaxBucketSpec(wire_dtype=wire))
    assert sorted(got) == sorted(ref)
    for key in ref:
        if key == "paths":
            assert got[key] == ref[key]
        else:
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_sampler_matches_jax():
    ours, theirs = BucketingSampler(23, 4), JaxSampler(23, 4)
    assert list(ours) == list(theirs)
    ours.shuffle(3)
    theirs.shuffle(3)
    assert list(ours) == list(theirs)


@pytest.mark.parametrize("hyp,ref", [("THE CAT SAT", "THE CAT SAT"),
                                     ("THE CAT", "A CAT SAT"),
                                     ("", "HELLO"), ("HELO WRLD", " ")])
def test_cer_wer_match_jax(hyp, ref):
    assert get_cer_wer(hyp, ref) == jax_get_cer_wer(hyp, ref)


@pytest.mark.parametrize("flags", [
    # a width below 1 is refused before any rendezvous
    ["--mesh-model", "0", "--dist-url", "tcp://localhost:1234",
     "--dist-rank", "0", "--dist-world-size", "2"],
    # a model axis of 4 needs 4 ranks or more
    ["--mesh-model", "4"]])
def test_unported_flags_exit(flags):
    with pytest.raises(SystemExit, match="--mesh-model"):
        train_main(["--device", "cpu", *flags])


def _calls(monkeypatch, module, name):
    """Count the calls of ``module.name`` (patched in place)."""
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def _has_tensorboard():
    try:
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401
    except Exception:
        return False
    return True


# The flags that were refused before they were ported; each runs one epoch
# (2 steps) of the 4-utterance manifest on the CPU and shows its effect.
PORTED_FLAGS = ["--augment", "--finetune", "--train-val-manifest",
                "--checkpoint-per-samples", "--aug-prob-spect", "--noise-dir",
                "--continue-from", "--profile-dir", "--tensorboard",
                "--visdom", "--log-params"]


@pytest.mark.parametrize("flag", PORTED_FLAGS)
def test_ported_flag_runs(trained, tmp_path, monkeypatch, capsys, flag):
    from deepspeech_tpu_torch.augment import spectrogram, waveform
    from deepspeech_tpu_torch.train import step

    base_save, _, wav = trained
    d = base_save.parent
    manifest = str(d / "manifest.csv")
    base = str(base_save / "deepspeech_final.ckpt")
    save, logs = tmp_path / "models", tmp_path / "logs"
    extra = {
        "--augment": ["--augment", "--noise-prob", "1.0"],
        "--finetune": ["--finetune", "--continue-from", base],
        "--train-val-manifest": ["--train-val-manifest", manifest],
        "--checkpoint-per-samples": ["--checkpoint-per-samples", "2"],
        "--aug-prob-spect": ["--aug-prob-spect", "0.5"],
        "--noise-dir": ["--noise-dir", wav, "--device-noise"],
        "--continue-from": ["--continue-from", base, "--epochs", "2"],
        "--profile-dir": ["--profile-dir", str(tmp_path / "prof"),
                          "--profile-start", "0", "--profile-steps", "1"],
        "--tensorboard": ["--tensorboard"],
        "--visdom": ["--visdom"],
        "--log-params": ["--log-params"],
    }[flag]
    pipeline = _calls(monkeypatch, waveform.OneOf, "__call__")
    masks = _calls(monkeypatch, spectrogram, "apply_spec_augment")
    mixes = _calls(monkeypatch, step, "apply_noise")
    assert train_main(["--device", "cpu", "--train-manifest", manifest,
                       "--val-manifest", manifest, "--epochs", "1",
                       "--batch-size", "2", "--val-batch-size", "2",
                       "--hidden-size", "16", "--hidden-layers", "1",
                       "--compute-dtype", "float32", "--num-workers", "1",
                       "--save-folder", str(save), "--log-dir", str(logs),
                       "--id", "flag", *extra]) == 0
    out = capsys.readouterr().out
    final = ckpt.load(str(save / "deepspeech_final.ckpt"))
    with open(logs / "flag.jsonl") as f:
        names = [json.loads(line)["event"] for line in f]
    if flag == "--augment":
        assert len(pipeline) == 4  # one pipeline call an utterance
    elif flag == "--finetune":  # the weights only: a fresh optimizer
        assert final["step"] == 2 and int(final["optim_state"][0]) == 2
    elif flag == "--train-val-manifest":
        assert "[trainval] epoch 1" in out and "trainval" in names
        assert (save / "deepspeech_final.ckpt.trainval.curriculum.csv"
                ).exists()
    elif flag == "--checkpoint-per-samples":
        mid = ckpt.load(str(save / "deepspeech_checkpoint_0001.ckpt"))
        assert (mid["iteration"], mid["checkpoint"]) == (1, 1)
        assert "val_checkpoint" in names
    elif flag == "--aug-prob-spect":
        assert len(masks) == 2 and final["audio_conf"]["aug_prob_spect"] == 0.5
    elif flag == "--noise-dir":
        assert "device noise bank: 1 clips" in out and len(mixes) == 2
    elif flag == "--continue-from":
        assert "Resuming from" in out and final["step"] == 2 + 2
        assert int(final["optim_state"][0]) == 4
    elif flag == "--profile-dir":  # the trace and its spans' summary
        assert sorted(os.listdir(tmp_path / "prof")) == [
            "summary_0_1.json", "trace_steps_0_1.json"]
    elif flag == "--tensorboard":  # where TensorBoard imports, it mirrors
        tb = logs / "flag"
        assert tb.exists() == _has_tensorboard()
    elif flag == "--visdom":
        assert (logs / "flag.html").read_text().startswith("<!doctype html>")
    elif flag == "--log-params":
        assert "params" in names


def _valid_value(action):
    """A command-line value the JAX option accepts (None: a switch)."""
    if action.nargs == 0:
        return None
    if action.choices:
        return str(list(action.choices)[-1])
    if action.type in (int, float):
        return "2"
    return "x"


def test_every_jax_train_option_parses():
    """Every option string of the JAX train parser, with a valid value,
    parses in the port's parser to the same value."""
    from deepspeech_tpu.cli.train import build_parser as jax_parser
    from deepspeech_tpu_torch.cli.train import build_parser

    ours, theirs = build_parser(), jax_parser()
    checked = set()
    for action in theirs._actions:
        for opt in action.option_strings:
            if opt in ("-h", "--help"):
                continue
            value = _valid_value(action)
            argv = [opt] if value is None else [opt, value]
            got = vars(ours.parse_args(argv))
            want = vars(theirs.parse_args(argv))
            assert got[action.dest] == want[action.dest], opt
            checked.add(opt)
    # the 18 option strings the port lacked before are among them
    assert {"--enorm", "--id", "--log-dir", "--rank",
            "--world-size"} <= checked and len(checked) == 77


# (flag, a value other than the default) of the rendezvous flags, each an
# incomplete rendezvous on its own (torchrun's variables are not set here)
REFUSED = [["--dist-url", "tcp://localhost:1234"],
           ["--dist-init"], ["--dist-rank", "0"], ["--rank", "1"],
           ["--dist-world-size", "2"], ["--world-size", "2"]]


@pytest.mark.parametrize("flags", REFUSED)
def test_unported_rendezvous_and_log_flags_exit(flags, monkeypatch):
    """Each rendezvous flag alone exits naming what the rendezvous lacks,
    before any connection is tried (the rendezvous itself runs in
    tests/test_torch_parallel.py)."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="rendezvous"):
        train_main(["--device", "cpu", *flags])


def test_refused_and_dependent_flags_pass_at_their_defaults(trained,
                                                            tmp_path):
    """At the JAX defaults (``--dist-rank -1`` is one) the refused flags
    pass the check, and so do the flags that act only with another one,
    at any value; ``--enorm`` is accepted, and ``--id`` and ``--log-dir``
    name the JSONL metric log the run writes."""
    from deepspeech_tpu_torch.cli.train import build_parser, check_ported

    argv = ["--dist-url", "", "--dist-rank", "-1", "--rank", "-1",
            "--dist-world-size", "0", "--world-size", "0",
            "--noise-prob", "0.9", "--noise-min", "0.1", "--noise-max",
            "0.7", "--device-noise-limit", "0.5", "--aug-type", "2",
            "--checkpoint-anneal", "1.2", "--profile-start", "3",
            "--profile-steps", "9", "--enorm", "--id", "cli-e2e",
            "--log-dir", str(tmp_path / "logs")]
    check_ported(build_parser().parse_args(argv))
    manifest = str(trained[0].parent / "manifest.csv")
    assert train_main(argv + ["--device", "cpu", "--epochs", "0",
                              "--hidden-size", "16", "--hidden-layers", "1",
                              "--train-manifest", manifest,
                              "--val-manifest", manifest, "--save-folder",
                              str(tmp_path / "models")]) == 0
    with open(tmp_path / "logs" / "cli-e2e.jsonl") as f:
        (event,) = [json.loads(line) for line in f]
    assert event["event"] == "checkpoint"
    assert event["path"].endswith("deepspeech_final.ckpt")


def test_train_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        train_main(["--train-manifest", str(tmp_path / "none.csv")])


@pytest.mark.parametrize("wire", ["int16", "mulaw8", "float32"])
def test_featurize_from_the_wire_matches_jax(wire):
    """The step's wire descale and featurize against the JAX step's, at
    atol 1e-3 on the log-spectrogram (log1p(|STFT| * 2^20) magnifies the
    ~1e-7 relative differences of two f32 DFTs)."""
    import jax.numpy as jnp

    from deepspeech_tpu.train.step import StepConfig as JaxStepConfig
    from deepspeech_tpu.train.step import _featurize as jax_featurize
    from deepspeech_tpu_torch.train.step import StepConfig, featurize

    rng = np.random.default_rng(2)
    t = np.arange(9000) / 16000
    samples = [{"audio": (np.sin(2 * np.pi * f * t[:n]) + 0.1
                          * rng.standard_normal(n)).astype(np.float32),
                "target": np.array([3, 4], np.int32), "path": "p"}
               for f, n in ((300, 9000), (450, 6100))]
    batch = collate_batch(samples, 2, BucketSpec(wire_dtype=wire))
    batch.pop("paths")
    want, want_lens = jax_featurize({k: jnp.asarray(v) for k, v in
                                     batch.items()}, JaxStepConfig(), None,
                                    train=False)
    got, got_lens = featurize({k: torch.from_numpy(v) for k, v in
                               batch.items()}, StepConfig())
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)
