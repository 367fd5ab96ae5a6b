"""PyTorch port: the continuous-batching pool, the ``serve`` CLI and
``transcribe --chunk-seconds`` against the JAX package.

* ``StreamPool`` with staggered joins, a split write and a reused slot
  (both families; the running normalization for the DS2): each slot's
  logits against the JAX pool's at rtol 1e-3 / atol 2e-3 (f32 convs and
  STFTs with sums in other orders, tests/test_torch_model.py's
  precedent), its text equal, and against a single port stream of the
  same audio at 2e-4 (the JAX package's own pool tolerance); the beam
  pool's text against the one-shot device beam over the slot's logits;
* both ``serve`` CLIs on one JAX checkpoint of a unidirectional DS2 (and
  of a CNN stack) write the same JSONL records; a bidirectional
  checkpoint is refused with the JAX message;
* both ``transcribe --chunk-seconds`` CLIs print the same JSON with the
  greedy, beam and device-beam decoders, and for a CNN with
  ``--se-mode two_pass``.
"""

import functools
import json
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeech_tpu.audio import AudioConf as JaxAudioConf
from deepspeech_tpu.cli.serve import main as jax_serve
from deepspeech_tpu.cli.transcribe import main as jax_transcribe
from deepspeech_tpu.models import build_model as jax_build_model
from deepspeech_tpu.serve import StreamPool as JaxStreamPool
from deepspeech_tpu.text import Labels as JaxLabels
from deepspeech_tpu.train import checkpoint as jax_ckpt
from deepspeech_tpu_torch.audio.features import AudioConf
from deepspeech_tpu_torch.audio.io import save_wav
from deepspeech_tpu_torch.cli.serve import main as port_serve
from deepspeech_tpu_torch.cli.transcribe import main as port_transcribe
from deepspeech_tpu_torch.convert import jax_to_torch
from deepspeech_tpu_torch.models import build_model
from deepspeech_tpu_torch.serve import StreamingTranscriber, StreamPool
from deepspeech_tpu_torch.text.labels import Labels

torch.set_num_threads(2)

LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 "
JAX_TOL = dict(rtol=1e-3, atol=2e-3)
SELF_TOL = dict(rtol=2e-4, atol=2e-4)
CHUNK = 24
# (rnn_type, JAX/port factory keywords) of the served models
MODELS = {"ds2": dict(rnn_type="gru", hidden_size=32, hidden_layers=2,
                      bidirectional=False),
          "cnn": dict(rnn_type="cnn_residual", hidden_size=32,
                      hidden_layers=1, cnn_width=24)}


def audio(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * (300 + 50 * seed) * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


@functools.cache
def models(kind, seed=0):
    """(JAX module, its variables with random BN stats, meta, port)."""
    jm, meta = jax_build_model(num_classes=len(LABELS), **MODELS[kind])
    variables = jax.jit(jm.init, static_argnums=3)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 161, 51)), jnp.asarray([51]),
        False)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
        np.float32), variables["batch_stats"])
    port, _ = build_model(num_classes=len(LABELS), device="cpu",
                          **MODELS[kind])
    port.load_state_dict(jax_to_torch(params, stats))
    return jm, {"params": params, "batch_stats": stats}, meta, port.eval()


def drive(pool, ys):
    """Staggered joins: stream 0 alone for a tick, stream 1 written in two
    parts across a tick, stream 2 after; then a fourth stream reuses the
    first freed slot."""
    s0 = pool.open()
    pool.write(s0, ys[0])
    pool.close(s0)
    pool.tick()
    s1 = pool.open()
    pool.write(s1, ys[1][:5000])
    pool.tick()
    pool.write(s1, ys[1][5000:])
    pool.close(s1)
    s2 = pool.open()
    pool.write(s2, ys[2])
    pool.close(s2)
    out = {}
    slots = [s0, s1, s2]
    while pool.busy():
        pool.tick()
        for i, s in enumerate(slots):
            if i not in out and pool.done(s):
                out[i] = (pool.collected_logits(s), pool.text(s))
                if i == 0:  # reuse the slot for stream 3
                    s3 = pool.open()
                    pool.write(s3, ys[3])
                    pool.close(s3)
                    slots.append(s3)
    for i, s in enumerate(slots):
        out.setdefault(i, (pool.collected_logits(s), pool.text(s)))
    return out


@pytest.mark.parametrize("kind,normalize", [("ds2", "max_frame"),
                                            ("cnn", "none")])
def test_pool_matches_jax_pool(kind, normalize):
    jm, variables, _, port = models(kind)
    ys = [audio(0.8, 1), audio(1.3, 2), audio(0.6, 3), audio(0.7, 4)]
    ref = drive(JaxStreamPool(jm, variables, JaxLabels(LABELS),
                              JaxAudioConf(), normalize=normalize,
                              chunk_frames=CHUNK, slots=3,
                              collect_logits=True), ys)
    got = drive(StreamPool(port, Labels(LABELS), AudioConf(),
                           normalize=normalize, chunk_frames=CHUNK, slots=3,
                           collect_logits=True), ys)
    assert sorted(got) == sorted(ref) == [0, 1, 2, 3]
    for i in ref:
        assert got[i][0].shape == ref[i][0].shape
        np.testing.assert_allclose(got[i][0], ref[i][0], **JAX_TOL)
        assert got[i][1] == ref[i][1]
    if kind == "ds2":  # each slot equals one lockstep stream of its audio
        for i, y in enumerate(ys):
            st = StreamingTranscriber(port, Labels(LABELS), AudioConf(),
                                      normalize=normalize,
                                      chunk_frames=CHUNK)
            st.feed(y)
            st.finish()
            np.testing.assert_allclose(got[i][0], st.collected_logits()[0],
                                       **SELF_TOL)
            assert got[i][1] == st.texts[0]


def test_pool_beam_matches_one_shot():
    from deepspeech_tpu_torch.decoders.beam_device import \
        ctc_beam_search_device
    _, _, _, port = models("ds2")
    pool = StreamPool(port, Labels(LABELS), AudioConf(), normalize="none",
                      chunk_frames=CHUNK, slots=2, decoder="beam",
                      beam_width=8, collect_logits=True)
    pool.tick()  # the stream joins at a nonzero chunk boundary
    s = pool.open()
    pool.write(s, audio(1.0, 13))
    pool.close(s)
    while pool.busy():
        pool.tick()
    logits = torch.from_numpy(pool.collected_logits(s))[None]
    prefixes, lens, _, _ = ctc_beam_search_device(
        torch.log_softmax(logits, -1), torch.tensor([logits.shape[1]]),
        beam_width=8, blank=0)
    text = "".join(LABELS[int(x)] for x in prefixes[0, 0, :int(lens[0, 0])])
    assert pool.beam_text(s) == text


# ---- the CLIs on one checkpoint ----

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """JAX checkpoints of each served model and of a bidirectional DS2,
    three wavs and their manifest."""
    d = tmp_path_factory.mktemp("torch_serve")
    paths = {}
    for kind in MODELS:
        _, variables, meta, _ = models(kind)
        state = types.SimpleNamespace(params=variables["params"],
                                      batch_stats=variables["batch_stats"],
                                      opt_state={}, step=0)
        paths[kind] = str(d / f"{kind}.ckpt")
        jax_ckpt.save(paths[kind], jax_ckpt.serialize(
            meta, state, LABELS, JaxAudioConf().to_dict()))
    bm, meta = jax_build_model("gru", len(LABELS), 16, 1)
    v = jax.jit(bm.init, static_argnums=3)(
        jax.random.PRNGKey(0), jnp.zeros((1, 161, 21)), jnp.asarray([21]),
        False)
    paths["bidirectional"] = str(d / "bi.ckpt")
    jax_ckpt.save(paths["bidirectional"], jax_ckpt.serialize(
        meta, types.SimpleNamespace(params=v["params"],
                                    batch_stats=v["batch_stats"],
                                    opt_state={}, step=0),
        LABELS, JaxAudioConf().to_dict()))
    wavs = []
    for i, seconds in enumerate((0.9, 0.6, 1.2)):
        wavs.append(str(d / f"u{i}.wav"))
        save_wav(wavs[-1], audio(seconds, 20 + i), 16000)
    manifest = d / "m.csv"
    manifest.write_text("".join(f"{w},\n" for w in wavs))
    return d, paths, wavs, str(manifest)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("kind,flags", [
    ("ds2", []), ("ds2", ["--decoder", "device_beam"]), ("cnn", [])])
def test_serve_cli_matches_jax(files, kind, flags, capsys):
    d, paths, _, manifest = files
    argv = ["--model-path", paths[kind], "--manifest", manifest,
            "--slots", "2", "--chunk-seconds", "0.32", "--beam-width", "8",
            *flags]
    ref_out, got_out = str(d / "ref.jsonl"), str(d / "got.jsonl")
    assert jax_serve(argv + ["--output", ref_out]) == 0
    assert port_serve(argv + ["--output", got_out, "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "served 3 utterances" in err and "audio-s/s" in err
    ref, got = _jsonl(ref_out), _jsonl(got_out)
    assert [r["wav"] for r in got] == [r["wav"] for r in ref]
    assert got == ref


def test_serve_cli_refuses_bidirectional(files):
    _, paths, _, manifest = files
    argv = ["--model-path", paths["bidirectional"], "--manifest", manifest]
    with pytest.raises(SystemExit) as ref:
        jax_serve(argv)
    with pytest.raises(SystemExit) as got:
        port_serve(argv + ["--device", "cpu"])
    assert "bidirectional" in str(got.value)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("kind,flags", [
    ("ds2", []), ("ds2", ["--decoder", "beam"]),
    ("ds2", ["--decoder", "device_beam", "--top-paths", "2"]),
    ("cnn", ["--se-mode", "two_pass"])])
def test_transcribe_chunked_matches_jax(files, kind, flags, capsys):
    _, paths, wavs, _ = files
    argv = ["--model-path", paths[kind], "--audio-path", wavs[2],
            "--chunk-seconds", "0.32", "--beam-width", "8", *flags]
    assert jax_transcribe(argv) == 0
    ref = capsys.readouterr()
    assert port_transcribe(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert json.loads(got.out.strip().splitlines()[-1]) == \
        json.loads(ref.out.strip().splitlines()[-1])
    assert got.err == ref.err  # the incremental greedy fragments
