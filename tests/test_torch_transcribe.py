"""PyTorch port: checkpoints and the transcribe CLI against the JAX package.

Each package reads the other's checkpoint file. Both transcribe CLIs, run
in-process on the same synthetic wav and checkpoint (f32, as the JAX CLI
runs), print the same transcription. The logits agree to rtol 1e-3 /
atol 2e-3 (tests/test_model.py's precedent), and their argmax agrees at
every frame whose top-2 margin exceeds that tolerance.
"""

import json
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeech_tpu.audio.features import AudioConf as JaxAudioConf
from deepspeech_tpu.audio.features import featurize_batch as jax_featurize
from deepspeech_tpu.cli.common import (
    load_inference_model as jax_load_inference_model)
from deepspeech_tpu.cli.transcribe import main as jax_main
from deepspeech_tpu.models import build_model as jax_build_model
from deepspeech_tpu.train import checkpoint as jax_ckpt
from deepspeech_tpu_torch.audio.features import featurize_batch
from deepspeech_tpu_torch.audio.io import load_audio_norm, save_wav
from deepspeech_tpu_torch.cli.common import load_inference_model
from deepspeech_tpu_torch.cli.transcribe import main as torch_main
from deepspeech_tpu_torch.models import build_model
from deepspeech_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)

LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 "
HIDDEN, LAYERS = 32, 2


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A JAX checkpoint with random weights and BN stats, and a wav."""
    d = tmp_path_factory.mktemp("torch_transcribe")
    model, meta = jax_build_model("gru", len(LABELS), HIDDEN, LAYERS)
    variables = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 161, 21)),
                           jnp.asarray([21]), False)
    rng = np.random.default_rng(3)
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
        np.float32), variables["batch_stats"])
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=stats, opt_state={}, step=0)
    package = jax_ckpt.serialize(meta, state, LABELS,
                                 JaxAudioConf().to_dict())
    jax_path = str(d / "jax.ckpt")
    jax_ckpt.save(jax_path, package)
    sr = 16000
    t = np.arange(int(0.45 * sr)) / sr
    y = (np.sin(2 * np.pi * 300 * t) * np.sin(2 * np.pi * 3 * t)
         + 0.2 * rng.standard_normal(len(t)))
    wav = str(d / "a.wav")
    save_wav(wav, (y / np.abs(y).max()).astype(np.float32), sr)
    return d, jax_path, wav


def _port_logits(path, wav):
    model, _, conf, _ = load_inference_model(path, device="cpu")
    y, _ = load_audio_norm(wav)
    with torch.no_grad():
        spect, lens = featurize_batch(torch.from_numpy(y[None]),
                                      torch.tensor([len(y)]), conf)
        logits, _, out_lens = model(spect, lens)
    return logits.numpy()[0], int(out_lens[0])


def _jax_logits(path, wav):
    model, state, _, conf, _ = jax_load_inference_model(path)
    y, _ = load_audio_norm(wav)
    spect, lens = jax_featurize(jnp.asarray(y[None]), jnp.asarray([len(y)]),
                                conf)
    logits, _, out_lens = model.apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        spect, lens, False)
    return np.asarray(logits)[0], int(out_lens[0])


def _assert_logits_agree(got, ref):
    (gl, gn), (rl, rn) = got, ref
    assert gn == rn
    np.testing.assert_allclose(gl[:gn], rl[:rn], rtol=1e-3, atol=2e-3)
    top2 = np.sort(rl[:rn], axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 4e-3
    np.testing.assert_array_equal(gl[:gn].argmax(-1)[clear],
                                  rl[:rn].argmax(-1)[clear])


def test_port_reads_jax_checkpoint(files):
    _, jax_path, wav = files
    _assert_logits_agree(_port_logits(jax_path, wav),
                         _jax_logits(jax_path, wav))


def test_jax_reads_port_checkpoint(files):
    d, jax_path, wav = files
    model, _, conf, package = load_inference_model(jax_path, device="cpu")
    meta = {k: package[k] for k in ("rnn_type", "num_classes", "hidden_size",
                                    "hidden_layers", "bidirectional", "bnm",
                                    "cnn_width", "dropout", "context")}
    port_path = str(d / "port.ckpt")
    ckpt.save(port_path, ckpt.package_from_model(model, meta, LABELS,
                                                 conf.to_dict()))
    loaded = jax_ckpt.load(port_path)
    original = jax_ckpt.load(jax_path)
    for key in ("params", "batch_stats"):
        a, b = original[key], loaded[key]
        assert (jax.tree_util.tree_structure(a)
                == jax.tree_util.tree_structure(b))
        for u, v in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(u, v)
    _assert_logits_agree(_port_logits(port_path, wav),
                         _jax_logits(port_path, wav))


def test_transcribe_cli_matches_jax(files, capsys):
    _, jax_path, wav = files
    args = ["--model-path", jax_path, "--audio-path", wav, "--offsets"]
    assert jax_main(args) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert torch_main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == ref
    assert ref["output"][0]["transcription"]  # random weights, not all blank


@pytest.mark.parametrize("flags", [["--decoder", "beam"],
                                   ["--decoder", "device_beam"],
                                   ["--chunk-seconds", "0.5"],
                                   ["--lm-path", "lm.arpa"]])
def test_unported_cli_flags_exit(files, flags, capsys):
    """The beam decoders and --lm-path (unread by greedy) print the JAX
    CLI's JSON; streaming a bidirectional checkpoint raises the JAX
    package's error in both."""
    _, jax_path, wav = files
    argv = ["--model-path", jax_path, "--audio-path", wav, "--offsets",
            "--meta", *flags]
    if "--chunk-seconds" in flags:
        with pytest.raises(ValueError, match="unidirectional") as ref:
            jax_main(argv)
        with pytest.raises(ValueError, match="unidirectional") as got:
            torch_main(argv + ["--device", "cpu"])
        assert str(got.value) == str(ref.value)
        return
    assert jax_main(argv) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert torch_main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == ref
