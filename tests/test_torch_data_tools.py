"""PyTorch port: the dataset and checkpoint tools against the JAX package.

* ``order_and_prune_files``, ``txt_for_wav``, ``create_manifest`` and
  ``merge_manifests`` write what the JAX functions write on the same
  directory; the ``merge_manifests`` and ``info`` CLIs print and write what
  the JAX CLIs do.
* The ``librispeech`` CLI on synthetic LibriSpeech tarballs (FLAC written
  by the port's encoder, one chapter at 32 kHz so the resampler runs, a
  train split pruned by duration) with no network: its wavs equal the JAX
  ``resample`` + ``save_wav`` of the encoded samples byte for byte, its
  transcripts are upper-cased, and its manifests equal the JAX
  ``order_and_prune_files`` of the same wavs. (The JAX CLI itself is not
  run: it reads FLAC through the JAX native library.)
* ``import_torch`` on reference-format packages built here (DS2: rnn, gru,
  lstm, bi- and unidirectional; CNN: cnn, cnn with GLU, cnn_residual,
  glu_small, large_cnn, with the reference's key names) gives the state
  dict of the JAX importer's checkpoint loaded by the port, tensor for
  tensor; the port's checkpoint loads in both packages, and the logits
  of the two agree at 1e-5 (x max(1, max|logits|)). The dead-code
  variants and a malformed CNN state dict are refused as in the JAX
  importer.
"""

import contextlib
import io
import os
import tarfile

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from deepspeech_tpu.audio.dsp import resample as jax_resample
from deepspeech_tpu.audio.io import save_wav as jax_save_wav
from deepspeech_tpu.cli import import_torch as jax_import
from deepspeech_tpu.cli.common import \
    load_inference_model as jax_load_inference_model
from deepspeech_tpu.cli.info import main as jax_info_main
from deepspeech_tpu.cli.merge_manifests import main as jax_merge_main
from deepspeech_tpu.data import manifest as jax_manifest
from deepspeech_tpu_torch.audio.flac_encode import save_flac
from deepspeech_tpu_torch.cli import import_torch, librispeech
from deepspeech_tpu_torch.cli.common import load_inference_model
from deepspeech_tpu_torch.cli.info import main as info_main
from deepspeech_tpu_torch.cli.merge_manifests import main as merge_main
from deepspeech_tpu_torch.convert import jax_to_torch
from deepspeech_tpu_torch.data import manifest
from deepspeech_tpu_torch.models import build_model
from deepspeech_tpu_torch.train import checkpoint as ckpt

LABELS = "_'ABCD E"  # 8 classes


# --- manifests -------------------------------------------------------------

def _wav_tree(root, durations):
    """root/{a,b}/wav/*.wav (16 kHz) with their txt files; -> wav paths."""
    rng = np.random.default_rng(0)
    paths = []
    for i, d in enumerate(durations):
        sub = os.path.join(root, "ab"[i % 2])
        for kind in ("wav", "txt"):
            os.makedirs(os.path.join(sub, kind), exist_ok=True)
        wav = os.path.join(sub, "wav", f"u{i}.wav")
        wavfile.write(wav, 16000, (rng.standard_normal(int(16000 * d))
                                   * 3000).astype(np.int16))
        with open(manifest.txt_for_wav(wav), "w") as f:
            f.write("AB CD")
        paths.append(wav)
    return paths


DURS = [2.5, 0.4, 1.25, 16.5, 3.0, 1.0, 0.75]


@pytest.mark.parametrize("bounds", [(None, None), (1, 15), (0.5, 3)])
def test_create_manifest_matches_jax(tmp_path, bounds):
    wavs = _wav_tree(str(tmp_path / "data"), DURS)
    ours, theirs = str(tmp_path / "p.csv"), str(tmp_path / "j.csv")
    n = manifest.create_manifest(str(tmp_path / "data"), ours, *bounds)
    assert n == jax_manifest.create_manifest(str(tmp_path / "data"), theirs,
                                             *bounds)
    assert open(ours).read() == open(theirs).read()
    assert manifest.order_and_prune_files(wavs, *bounds) == \
        jax_manifest.order_and_prune_files(wavs, *bounds)
    assert manifest.order_and_prune_files(wavs, *bounds, True) == \
        jax_manifest.order_and_prune_files(wavs, *bounds, True)
    for w in wavs:
        assert manifest.txt_for_wav(w) == jax_manifest.txt_for_wav(w)


def test_merge_manifests_and_cli_match_jax(tmp_path, capsys):
    wavs = _wav_tree(str(tmp_path / "data"), DURS)
    mdir = tmp_path / "manifests"
    mdir.mkdir()
    manifest.write_manifest(str(mdir / "one.csv"),
                            [(w, manifest.txt_for_wav(w)) for w in wavs[:4]])
    manifest.write_manifest(str(mdir / "two.csv"),
                            [(w, manifest.txt_for_wav(w), 0.0)
                             for w in wavs[4:]])
    paths = [str(mdir / "one.csv"), str(mdir / "two.csv")]
    ours, theirs = str(tmp_path / "p.csv"), str(tmp_path / "j.csv")
    assert manifest.merge_manifests(paths, ours) == \
        jax_manifest.merge_manifests(paths, theirs)
    assert open(ours).read() == open(theirs).read()
    assert len(open(ours).read().splitlines()) == 4  # [1, 15] s

    out = {}
    for name, main in (("port", merge_main), ("jax", jax_merge_main)):
        path = str(tmp_path / f"{name}_merged.csv")
        assert main(["--merge-dir", str(mdir), "--min-duration", "0",
                     "--max-duration", "20", "--output-path", path]) == 0
        out[name] = (capsys.readouterr().out.replace(path, "OUT"),
                     open(path).read())
    assert out["port"] == out["jax"]
    assert len(out["port"][1].splitlines()) == len(DURS)


# --- the librispeech CLI ---------------------------------------------------

def _utterance(rng, seconds, sr):
    t = np.arange(int(sr * seconds)) / sr
    y = 0.3 * np.sin(2 * np.pi * (300 + 200 * rng.random()) * t)
    return (y + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


def _tarball(path, set_name, chapters):
    """chapters: {(spk, chap, sr): [(utt, seconds, text)]} -> a LibriSpeech
    layout .tar.gz at ``path``; -> {utt name: (quantized samples, sr,
    text)}."""
    rng = np.random.default_rng(len(set_name))
    stage = path.parent / f"stage_{set_name}"
    known = {}
    for (spk, chap, sr), utts in chapters.items():
        d = stage / "LibriSpeech" / set_name / str(spk) / str(chap)
        d.mkdir(parents=True)
        lines = []
        for utt, seconds, text in utts:
            name = f"{spk}-{chap}-{utt:04d}"
            y = _utterance(rng, seconds, sr)
            save_flac(str(d / f"{name}.flac"), y, sr)
            # save_flac's quantization (audio/flac_encode.py)
            q = np.clip(np.round(y * 32767.0), -32768, 32767)
            known[name] = (q.astype(np.int64), sr, text.upper())
            lines.append(f"{name} {text.lower()}")
        (d / f"{spk}-{chap}.trans.txt").write_text("\n".join(lines) + "\n")
    with tarfile.open(path, "w:gz") as tar:
        tar.add(stage / "LibriSpeech", arcname="LibriSpeech")
    return known


def test_librispeech_cli_writes_jax_wavs_and_manifests(tmp_path,
                                                       monkeypatch):
    target = tmp_path / "libri"
    (target / "test_clean").mkdir(parents=True)
    (target / "train").mkdir(parents=True)
    known = _tarball(target / "test_clean" / "test-clean.tar.gz",
                     "test-clean",
                     {(61, 70968, 16000): [(0, 1.3, "ab cd"),
                                           (1, 1.1, "d e")],
                      (121, 121726, 32000): [(0, 1.2, "abc"),
                                             (1, 1.45, "e")]})
    known.update(_tarball(target / "train" / "train-clean-100.tar.gz",
                          "train-clean-100",
                          {(19, 198, 16000): [(0, 1.5, "a"), (1, 0.6, "b"),
                                              (2, 1.25, "c")]}))

    fetch = librispeech.maybe_download

    def local_only(url, target_dir):
        """The tarballs on disk; a download would raise."""
        if not os.path.exists(os.path.join(target_dir, url.split("/")[-1])):
            raise AssertionError(f"the CLI would download {url}")
        return fetch(url, target_dir)

    monkeypatch.setattr(librispeech, "maybe_download", local_only)
    monkeypatch.chdir(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        assert librispeech.main([
            "--target-dir", str(target), "--files-to-use",
            "test-clean.tar.gz,train-clean-100.tar.gz",
            "--min-duration", "1", "--max-duration", "15"]) == 0

    for split, names in (("test_clean", [n for n in known
                                         if not n.startswith("19-")]),
                         ("train", [n for n in known if n.startswith("19-")])):
        wavs = []
        for name in names:
            q, sr, text = known[name]
            wav = target / split / "wav" / f"{name}.wav"
            want = str(tmp_path / "want.wav")
            y = q.astype(np.float32) / 32768.0
            if sr != 16000:
                y = jax_resample(y, sr, 16000)
            jax_save_wav(want, y, 16000)
            assert wav.read_bytes() == open(want, "rb").read(), name
            txt = target / split / "txt" / f"{name}.txt"
            assert txt.read_text() == text
            wavs.append(str(wav))
        rows = manifest.read_manifest(f"libri_{split}_manifest.csv")
        bounds = (1, 15) if split == "train" else (None, None)
        want = jax_manifest.order_and_prune_files(wavs, *bounds,
                                                  with_durations=True)
        assert rows == [(os.path.abspath(w),
                         os.path.abspath(jax_manifest.txt_for_wav(w)),
                         round(d, 3)) for w, d in want]
    assert len(manifest.read_manifest("libri_train_manifest.csv")) == 2
    assert not (target / "test_clean" / "LibriSpeech").exists()


# --- import_torch ----------------------------------------------------------

GATES = {"rnn": 1, "gru": 3, "lstm": 4}


def _ds2_reference(rnn_type, bidirectional, hidden=16, layers=2, seed=0):
    """A torch.save package with the reference's DS2 key names (reference
    model.py:183-341, 426-450)."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=0.05):
        return torch.randn(*shape, generator=gen) * scale

    sd = {}

    def put_bn(prefix, n):
        sd[prefix + "weight"] = torch.rand(n, generator=gen) + 0.5
        sd[prefix + "bias"] = rnd(n, scale=0.1)
        sd[prefix + "running_mean"] = rnd(n, scale=0.1)
        sd[prefix + "running_var"] = torch.rand(n, generator=gen) + 0.5

    sd["conv.seq_module.0.weight"] = rnd(32, 1, 41, 11)
    sd["conv.seq_module.0.bias"] = rnd(32, scale=0.1)
    put_bn("conv.seq_module.1.", 32)
    sd["conv.seq_module.3.weight"] = rnd(32, 32, 21, 11, scale=0.02)
    sd["conv.seq_module.3.bias"] = rnd(32, scale=0.1)
    put_bn("conv.seq_module.4.", 32)
    g = GATES[rnn_type] * hidden
    dirs = ("", "_reverse") if bidirectional else ("",)
    for i in range(layers):
        f_in = 32 * 41 if i == 0 else hidden
        for s in dirs:
            pre = f"rnns.{i}.rnn."
            sd[pre + f"weight_ih_l0{s}"] = rnd(g, f_in)
            sd[pre + f"weight_hh_l0{s}"] = rnd(g, hidden)
            sd[pre + f"bias_ih_l0{s}"] = rnd(g)
            sd[pre + f"bias_hh_l0{s}"] = rnd(g)
        if i > 0:
            put_bn(f"rnns.{i}.batch_norm.module.", f_in)
    if not bidirectional:
        sd["lookahead.0.weight"] = rnd(hidden, 21, scale=0.1)
    put_bn("fc.0.module.0.", hidden)
    sd["fc.0.module.1.weight"] = rnd(len(LABELS), hidden, scale=0.1)
    return {"version": "0.0.1", "hidden_size": hidden,
            "hidden_layers": layers, "rnn_type": rnn_type,
            "audio_conf": {"sample_rate": 16000, "window_size": 0.02},
            "labels": LABELS, "state_dict": sd, "bnm": 0.1,
            "bidirectional": bidirectional, "dropout": 0, "cnn_width": 0,
            "epoch": 3, "checkpoint": 2, "avg_loss": 1.5,
            "loss_results": torch.tensor([3.0, 2.0, 1.0]),
            "wer_results": torch.tensor([50.0, 40.0, 30.0]),
            "cer_results": torch.tensor([20.0, 15.0, 10.0])}


CNN_CASES = {"cnn": ("cnn", True), "cnn_glu": ("cnn", False),
             "cnn_residual": ("cnn_residual", True),
             "glu_small": ("glu_small", True),
             "large_cnn": ("large_cnn", True)}


def _cnn_reference(case, seed=1):
    """A reference-format CNN package: the port's ConvStack of the variant
    with random weights and BN stats, renamed to the reference's keys
    (``rnns.{i}`` convs and BatchNorms as Wav2Letter's flat Sequential
    numbers them, ``rnns.layers.{i}.conv`` / ``_se_reduce`` as the nested
    blocks do, ``fc.0`` the k=1 head) beside the DS2 conv stack the
    reference always builds."""
    rnn_type, bidirectional = CNN_CASES[case]
    model, _ = build_model(rnn_type, len(LABELS), hidden_size=32,
                           hidden_layers=2, cnn_width=24,
                           bidirectional=bidirectional, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    nested = rnn_type != "cnn"
    sd = {"conv.seq_module.0.weight": torch.zeros(32, 1, 41, 11)}
    for k, v in model.state_dict().items():
        v = (torch.rand(v.shape, generator=gen) + 0.5 if "running_var" in k
             else torch.randn(v.shape, generator=gen) * 0.1)
        if k.startswith("fc."):
            sd["fc.0." + k[3:]] = v
            continue
        _, i, rest = k.split(".", 2)
        i = int(i)
        if rest.startswith("se_"):
            which, leaf = rest.split(".")
            sd[f"rnns.layers.{i}._{which}.{leaf}"] = (
                v[:, :, None] if leaf == "weight" else v)
        elif nested:
            sd[f"rnns.layers.{i}.{rest}"] = v
        else:
            mod, leaf = rest.split(".")
            sd[f"rnns.{3 * i + (mod == 'bn')}.{leaf}"] = v
    return {"version": "0.0.1", "hidden_size": 32, "hidden_layers": 2,
            "rnn_type": rnn_type, "labels": LABELS, "state_dict": sd,
            "bidirectional": bidirectional, "cnn_width": 24, "bnm": 0.1,
            "audio_conf": {"sample_rate": 16000}}


def _port_sd(package):
    return jax_to_torch(package["params"], package["batch_stats"])


def _same_logits(model, jax_model, jax_state):
    """The port's logits against the JAX model's on the same checkpoint,
    at 1e-5 x max(1, max|logits|)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 161, 41)).astype(np.float32) * 0.5
    lengths = np.array([41, 27])
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(lengths))[0]
    ref = np.asarray(jax_model.apply(
        {"params": jax_state.params, "batch_stats": jax_state.batch_stats},
        jnp.asarray(x), jnp.asarray(lengths), False)[0])
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * scale)


def _same_state(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("rnn_type", ["rnn", "gru", "lstm"])
def test_import_ds2_matches_jax(tmp_path, rnn_type, bidirectional):
    tpkg = _ds2_reference(rnn_type, bidirectional)
    tpath = str(tmp_path / "ref.pth")
    torch.save(tpkg, tpath)
    ours, theirs = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    with contextlib.redirect_stdout(io.StringIO()):
        assert import_torch.main([tpath, ours]) == 0
        assert jax_import.main([tpath, theirs]) == 0
    model, labels, _, package = load_inference_model(ours, device="cpu")
    jax_pkg = ckpt.load(theirs)
    _same_state(model.state_dict(), _port_sd(jax_pkg))
    assert labels.labels == LABELS
    for k in ("rnn_type", "hidden_size", "hidden_layers", "bidirectional",
              "epoch", "iteration", "checkpoint", "loss_results",
              "wer_results", "cer_results", "audio_conf", "num_classes"):
        assert package.get(k) == jax_pkg.get(k), k
    assert package["epoch"] == 3 and package["avg_loss"] == 1.5

    jm, jst, *_ = jax_load_inference_model(ours)
    _same_logits(model, jm, jst)


@pytest.mark.parametrize("case", sorted(CNN_CASES))
def test_import_cnn_matches_jax(tmp_path, case):
    tpkg = _cnn_reference(case)
    package = import_torch.convert_package(tpkg)
    jax_pkg = jax_import.convert_package(tpkg)
    path = str(tmp_path / "port.ckpt")
    ckpt.save(path, package)
    model, _, _, loaded = load_inference_model(path, device="cpu")
    _same_state(model.state_dict(), _port_sd(jax_pkg))
    assert loaded["rnn_type"] == CNN_CASES[case][0]
    jm, jst, *_ = jax_load_inference_model(path)
    assert len(jm.blocks) == len(model.blocks)
    _same_logits(model, jm, jst)


def test_import_refusals_match_jax():
    for rnn_type in ("glu_large", "cnn_jasper"):
        bad = {"rnn_type": rnn_type, "hidden_size": 8, "hidden_layers": 1,
               "labels": "ab", "state_dict": {}, "bidirectional": True}
        with pytest.raises(NotImplementedError, match="dead"):
            import_torch.convert_package(bad)
        with pytest.raises(NotImplementedError, match="dead"):
            jax_import.convert_package(bad)
    bad = {"rnn_type": "cnn", "hidden_size": 8, "hidden_layers": 1,
           "labels": "ab", "state_dict": {}, "bidirectional": True}
    with pytest.raises(ValueError, match="convs"):
        import_torch.convert_package(bad)
    with pytest.raises(ValueError, match="convs"):
        jax_import.convert_package(bad)


# --- info ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["imported", "port"])
def test_info_cli_matches_jax(tmp_path, capsys, kind):
    path = str(tmp_path / "m.ckpt")
    if kind == "imported":
        ckpt.save(path, import_torch.convert_package(
            _ds2_reference("gru", True)))
    else:
        model, meta = build_model("lstm", len(LABELS), hidden_size=16,
                                  hidden_layers=1, device="cpu")
        ckpt.save(path, ckpt.package_from_model(
            model, meta, LABELS, {"sample_rate": 16000}, epoch=0,
            history={"loss_results": [2.0]}))
    assert info_main([path]) == 0
    ours = capsys.readouterr().out
    assert jax_info_main([path]) == 0
    assert ours == capsys.readouterr().out
    assert "parameters:" in ours
