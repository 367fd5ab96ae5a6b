"""PyTorch port: the ``test`` (evaluation) CLI and the beam decoders of the
``transcribe`` CLI against the JAX package's CLIs.

One JAX checkpoint (a 2 x BiGRU-32 DS2 with random weights, its output
layer scaled so that the posteriors are peaked and the two frameworks'
f32 differences cannot flip a decision) and a 4-utterance synthetic
manifest go through ``deepspeech_tpu.cli.test`` and
``deepspeech_tpu_torch.cli.test --device cpu`` in-process, with greedy,
``beam`` and ``device_beam --lm-path`` decoding: the CSV rows and both
summary lines must be equal. ``transcribe --decoder device_beam --lm-path``
prints the same JSON through both packages.

The port's ``test`` on two gloo CPU ranks (two processes of ``python -m
deepspeech_tpu_torch.cli.test`` under torchrun's environment variables,
``env://`` on a free localhost port, one thread each) against one process
of it: rank 0's stdout (the ``--verbose`` prints and both summaries) and
the report CSV byte for byte, greedy with the ranks' rows padded alike
(one bin of 4, a short and a long pair) and with ``--output-path`` (each
rank's dumps equal to the one process's, the list in row order),
``device_beam`` with the LM over two bins, a bin that leaves rank 1 no row
(batch 8), and a batch size the ranks do not divide (rank 0 alone; rank 1
exits 0 without output).
"""

import csv
import json
import os
import pickle
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeech_tpu.audio.features import AudioConf as JaxAudioConf
from deepspeech_tpu.cli.test import main as jax_test
from deepspeech_tpu.cli.transcribe import main as jax_transcribe
from deepspeech_tpu.models import build_model as jax_build_model
from deepspeech_tpu.train import checkpoint as jax_ckpt
from deepspeech_tpu_torch.audio.io import save_wav
from deepspeech_tpu_torch.cli.test import main as port_test
from deepspeech_tpu_torch.cli.transcribe import main as port_transcribe

torch.set_num_threads(2)

LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 "
TEXTS = ("HI ME", "ME HI HI", "A HI", "ME")
ARPA = """\\data\\
ngram 1=6
ngram 2=4
ngram 3=2

\\1-grams:
-0.30103\t<s>\t-0.1
-0.60206\t</s>\t0
-0.52288\tHI\t-0.2
-0.69897\tME\t-0.15
-1.39794\tA\t-0.30103
-2.0\t<unk>\t0

\\2-grams:
-0.17609\t<s> HI\t-0.05
-0.30103\tHI ME\t-0.1
-0.45\tME HI\t-0.08
-0.52\tA HI\t0

\\3-grams:
-0.1\t<s> HI ME
-0.2\tME HI HI

\\end\\
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_test_cli")
    model, meta = jax_build_model("gru", len(LABELS), 32, 2)
    variables = model.init(jax.random.PRNGKey(5), jnp.zeros((1, 161, 21)),
                           jnp.asarray([21]), False)
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, variables["params"])
    params["fc"]["kernel"] = params["fc"]["kernel"] * 6.0
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
        np.float32), variables["batch_stats"])
    state = types.SimpleNamespace(params=params, batch_stats=stats,
                                  opt_state={}, step=0)
    path = str(d / "ds2.ckpt")
    jax_ckpt.save(path, jax_ckpt.serialize(meta, state, LABELS,
                                           JaxAudioConf().to_dict()))
    rows = []
    for i, text in enumerate(TEXTS):
        n = int(16000 * (0.6 + 0.2 * i))
        t = np.arange(n) / 16000
        y = (np.sin(2 * np.pi * (180 + 60 * i) * t)
             * np.sin(2 * np.pi * (2 + i) * t) + 0.2 * rng.standard_normal(n))
        wav, txt = str(d / f"u{i}.wav"), str(d / f"u{i}.txt")
        save_wav(wav, (y / np.abs(y).max()).astype(np.float32), 16000)
        with open(txt, "w") as f:
            f.write(text)
        rows.append(f"{wav},{txt},{n / 16000}")
    manifest = d / "manifest.csv"
    manifest.write_text("\n".join(rows) + "\n")
    lm = d / "lm.arpa"
    lm.write_text(ARPA)
    return d, path, str(manifest), str(lm), str(d / "u1.wav")


def _run(main, argv, capsys, report):
    assert main(argv + ["--report-file", report]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    with open(report, newline="") as f:
        return list(csv.reader(f)), out[-2:]


@pytest.mark.parametrize("decoder", [
    [], ["--decoder", "beam", "--beam-width", "8", "--top-paths", "2"],
    ["--decoder", "device_beam", "--beam-width", "8", "--lm-path", "LM",
     "--alpha", "1.5", "--beta", "0.5"]],
    ids=["greedy", "beam", "device_beam_lm"])
def test_test_cli_matches_jax(files, capsys, decoder):
    d, path, manifest, lm, _ = files
    decoder = [lm if a == "LM" else a for a in decoder]
    argv = ["--model-path", path, "--test-manifest", manifest,
            "--batch-size", "3", "--num-workers", "1", "--verbose",
            *decoder]
    ref = _run(jax_test, argv, capsys, str(d / "jax.csv"))
    got = _run(port_test, argv + ["--device", "cpu"], capsys,
               str(d / "port.csv"))
    assert got == ref
    rows, summary = got
    assert len(rows) == 1 + len(TEXTS)
    assert summary[1].endswith(f"({len(TEXTS)} utterances)")
    assert any(r[2] for r in rows[1:])  # not every transcript empty


def test_test_cli_output_dumps(files, capsys, tmp_path):
    """--output-path: per-utterance pickles of the posteriors and the list
    of them, as the JAX CLI writes."""
    import pickle

    _, path, manifest, _, _ = files
    out = str(tmp_path / "dumps.pkl")
    assert port_test(["--model-path", path, "--test-manifest", manifest,
                      "--batch-size", "4", "--num-workers", "1",
                      "--output-path", out, "--device", "cpu"]) == 0
    with open(out, "rb") as f:
        dumps = pickle.load(f)
    assert len(dumps) == len(TEXTS)
    with open(dumps[0], "rb") as f:
        rec = pickle.load(f)
    assert rec["probs"].shape == (rec["len"], len(LABELS))
    np.testing.assert_allclose(rec["probs"].sum(-1), 1.0, rtol=1e-5)
    assert capsys.readouterr().out.count("Summary") == 2


@pytest.mark.parametrize("decoder", ["beam", "device_beam"])
def test_transcribe_beam_with_lm_matches_jax(files, capsys, decoder):
    _, path, _, lm, wav = files
    argv = ["--model-path", path, "--audio-path", wav, "--offsets",
            "--meta", "--decoder", decoder, "--lm-path", lm,
            "--top-paths", "2", "--alpha", "1.5", "--beta", "0.5"]
    assert jax_transcribe(argv) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_transcribe(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == ref
    assert len(got["output"]) == 2 and got["output"][0]["transcription"]


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 180


def _two_ranks(argv: list) -> list:
    """Two ranks of the port's test CLI on the CPU -> [(rc, stdout,
    stderr)] by rank."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "deepspeech_tpu_torch.cli.test",
                 *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
        return [(p.returncode, *o) for p, o in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _dumps(listing: str) -> list:
    with open(listing, "rb") as f:
        paths = pickle.load(f)
    out = []
    for path in paths:
        with open(path, "rb") as f:
            out.append((path, pickle.load(f)))
    return out


@pytest.mark.parametrize("batch,decoder", [
    ("4", ["--verbose", "--output-path", "DUMPS"]),
    ("2", ["--decoder", "device_beam", "--beam-width", "8", "--lm-path",
           "LM", "--alpha", "1.5", "--beta", "0.5", "--verbose"]),
    ("8", ["--errors", "--best"]),
    ("3", ["--verbose"])], ids=["greedy", "device_beam_lm", "empty_shard",
                                "undivided"])
def test_test_cli_two_ranks_match_one_process(files, capsys, tmp_path,
                                              batch, decoder):
    d, path, manifest, lm, _ = files
    dumps = str(tmp_path / "dumps.pkl")
    decoder = [{"LM": lm, "DUMPS": dumps}.get(a, a) for a in decoder]
    argv = ["--model-path", path, "--test-manifest", manifest,
            "--batch-size", batch, "--num-workers", "1", "--device", "cpu",
            *decoder]
    one = str(tmp_path / "one.csv")
    assert port_test(argv + ["--report-file", one]) == 0
    want = capsys.readouterr().out
    want_dumps = _dumps(dumps) if dumps in decoder else None

    two = str(tmp_path / "two.csv")
    (rc0, out0, err0), (rc1, out1, err1) = _two_ranks(
        argv + ["--report-file", two])
    assert rc0 == 0, err0[-3000:]
    assert rc1 == 0, err1[-3000:]
    assert out0 == want
    assert out1 == ""
    with open(one, "rb") as f, open(two, "rb") as g:
        assert f.read() == g.read()
    assert want.count("Summary") == 2
    assert ("rank 0 evaluates alone" in err0) == (batch == "3")
    if want_dumps is not None:
        got = _dumps(dumps)
        assert [p for p, _ in got] == [p for p, _ in want_dumps]
        for (_, a), (_, b) in zip(got, want_dumps):
            assert a["transcript"] == b["transcript"]
            # a rank's 2 rows against the batch of 4: f32 sums in other
            # orders
            np.testing.assert_allclose(a["probs"], b["probs"], rtol=1e-4,
                                       atol=1e-6)
