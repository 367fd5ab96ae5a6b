"""PyTorch port: it stands alone.

* Every module of deepspeech_tpu_torch imports with ``jax`` blocked, and
  none of them pulls in deepspeech_tpu.
* No source of the port, nor the chip scripts (chip_smoke.py, chip_ab.py,
  chip_stamps.py), imports deepspeech_tpu.
* A kernel wrapper given CPU tensors runs the plain version.
* An entry point called without ``device`` asks for the card and raises
  where there is none, rather than running on the CPU.
"""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import deepspeech_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "deepspeech_tpu_torch")


def _modules():
    names = ["deepspeech_tpu_torch"]
    for info in pkgutil.walk_packages([PKG], "deepspeech_tpu_torch."):
        names.append(info.name)
    return names


def test_imports_without_jax_or_the_jax_package():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'deepspeech_tpu'\n"
        "       or m.startswith('deepspeech_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(dirpath, f)
    for script in ("chip_smoke.py", "chip_ab.py", "chip_stamps.py"):
        yield os.path.join(ROOT, script)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_the_jax_package(path):
    with open(path) as f:
        text = f.read()
    pat = re.compile(r"^\s*(from|import)\s+(deepspeech_tpu|jax|flax|optax)"
                     r"(\.|\s|$)", re.M)
    assert not pat.findall(text), path


def test_kernel_wrappers_use_plain_versions_on_cpu(monkeypatch):
    """CPU tensors go to the plain versions and count no launch; a tensor
    on any other device that is not CUDA raises."""
    from deepspeech_tpu_torch.ops.cuda import gru, stft

    calls = []

    def recorded(name, fn):
        def run(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(stft, "plain", recorded("stft", stft.plain))
    monkeypatch.setattr(gru, "plain", recorded("gru", gru.plain))
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal((2, 3200)).astype(np.float32))
    win = np.hamming(320).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((5, 2, 4)).astype(np.float32))
    w_ih = torch.randn(2, 4, 9)
    w_hh = torch.randn(2, 3, 9)
    b = torch.zeros(2, 9)
    lens = torch.tensor([5, 3])
    n_stft, n_gru = stft.launches, gru.launches
    assert stft.stft_mag(y, 320, 160, win).shape == (2, 161, 21)
    assert gru.gru_layer(x, w_ih, b, w_hh, b, lens).shape == (2, 5, 2, 3)
    assert calls == ["stft", "gru"]
    assert (stft.launches, gru.launches) == (n_stft, n_gru)
    with pytest.raises(ValueError, match="unsupported device"):
        stft.stft_mag(y.to("meta"), 320, 160, win)
    with pytest.raises(ValueError, match="unsupported device"):
        gru.gru_layer(x.to("meta"), w_ih, b, w_hh, b, lens)
    assert calls == ["stft", "gru"]


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from deepspeech_tpu_torch.cli.common import load_inference_model
    from deepspeech_tpu_torch.cli.transcribe import main
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    with pytest.raises(RuntimeError, match="cuda"):
        build_model("gru", 30, 8, 1)
    model, meta = build_model("gru", 30, 8, 1, device="cpu")
    path = str(tmp_path / "m.ckpt")
    ckpt.save(path, ckpt.package_from_model(
        model, meta, "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 ", {"sample_rate": 16000}))
    with pytest.raises(RuntimeError, match="cuda"):
        load_inference_model(path)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--model-path", path, "--audio-path", "unused.wav"])
    from deepspeech_tpu_torch.cli.test import main as test_main
    from deepspeech_tpu_torch.decoders import DeviceBeamCTCDecoder
    with pytest.raises(RuntimeError, match="cuda"):
        test_main(["--model-path", path, "--test-manifest", "unused.csv"])
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceBeamCTCDecoder("_AB ")
    assert deepspeech_tpu_torch.resolve_device("cpu").type == "cpu"


def test_training_kernel_wrappers_use_plain_versions_on_cpu(monkeypatch):
    """K5, K8 and K9 take their plain versions for CPU tensors, count no
    launch there, and raise on a device that is neither CPU nor CUDA."""
    from deepspeech_tpu_torch.ops import ctc as ctc_loss_mod
    from deepspeech_tpu_torch.ops.cuda import ctc, gru

    calls = []
    for mod, name in ((gru, "plain_bwd"), (ctc, "plain_alpha"),
                      (ctc, "plain_beta")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, (lambda n, f: lambda *a, **k: (
            calls.append(n), f(*a, **k))[1])(name, fn))
    t, b, h = 5, 2, 3
    x, w_ih = torch.randn(t, b, 4), torch.randn(2, 4, 3 * h)
    w_hh, bias = torch.randn(2, h, 3 * h), torch.zeros(2, 3 * h)
    lens = torch.tensor([5, 3])
    out, g, hn = gru.gru_layer(x, w_ih, bias, w_hh, bias, lens,
                               residuals=True)
    logits = torch.randn(b, t, 6)
    targets, tl = torch.tensor([[1, 2], [3, 0]]), torch.tensor([2, 1])
    log_probs, ext = ctc_loss_mod._prep(logits, targets, 0)
    before = (gru.bwd_launches, ctc.alpha_launches, ctc.beta_launches)
    gru.gru_bwd(out, g, hn, out, w_hh, lens)
    alphas, loss = ctc.ctc_alpha(log_probs, ext, tl, lens)
    ctc.ctc_beta(log_probs, ext, tl, lens, alphas, loss, torch.ones(b))
    assert calls == ["plain_bwd", "plain_alpha", "plain_beta"]
    assert (gru.bwd_launches, ctc.alpha_launches,
            ctc.beta_launches) == before
    meta = [a.to("meta") for a in (out, g, hn, w_hh)]
    with pytest.raises(ValueError, match="unsupported device"):
        gru.gru_bwd(meta[0], meta[1], meta[2], meta[0], meta[3], lens)
    with pytest.raises(ValueError, match="unsupported device"):
        ctc.ctc_alpha(log_probs.to("meta"), ext, tl, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        ctc.ctc_beta(log_probs.to("meta"), ext, tl, lens, alphas, loss,
                     torch.ones(b))
    assert len(calls) == 3


def test_lstm_kernel_wrappers_use_plain_versions_on_cpu(monkeypatch):
    """K3 (both variants) and K7 take their plain versions for CPU tensors,
    count no launch there, and raise on a device that is neither CPU nor
    CUDA."""
    from deepspeech_tpu_torch.ops.cuda import lstm

    calls = []
    for name in ("plain", "plain_bwd"):
        fn = getattr(lstm, name)
        monkeypatch.setattr(lstm, name, (lambda n, f: lambda *a, **k: (
            calls.append(n), f(*a, **k))[1])(name, fn))
    t, b, h = 5, 2, 3
    x, w_ih = torch.randn(t, b, 4), torch.randn(2, 4, 4 * h)
    w_hh, bias = torch.randn(2, h, 4 * h), torch.zeros(2, 4 * h)
    lens = torch.tensor([5, 3])
    before = (lstm.launches, lstm.res_launches, lstm.bwd_launches)
    assert lstm.lstm_layer(x, w_ih, bias, w_hh, bias, lens).shape == (
        2, t, b, h)
    out, c, g = lstm.lstm_layer(x, w_ih, bias, w_hh, bias, lens,
                                residuals=True)
    dg, db = lstm.lstm_bwd(out, g, c, w_hh, lens)
    assert dg.shape == g.shape and db.shape == (2, 4 * h)
    assert calls == ["plain", "plain", "plain_bwd"]
    assert (lstm.launches, lstm.res_launches, lstm.bwd_launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        lstm.lstm_layer(x.to("meta"), w_ih, bias, w_hh, bias, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        lstm.lstm_bwd(out, g, c.to("meta"), w_hh, lens)
    assert len(calls) == 3


def test_topk_wrapper_uses_plain_version_on_cpu(monkeypatch):
    """K10 takes its plain version for CPU tensors, counts no launch
    there, and raises on a device that is neither CPU nor CUDA; the device
    beam search selects through the wrapper."""
    from deepspeech_tpu_torch.decoders import beam_device
    from deepspeech_tpu_torch.ops.cuda import topk

    calls = []
    fn = topk.plain
    monkeypatch.setattr(topk, "plain", lambda *a: (calls.append(1),
                                                   fn(*a))[1])
    before = topk.launches
    v, i = topk.topk_total_order(torch.tensor([[0.5, 2.0, -1.0]]), 2)
    assert v.tolist() == [[2.0, 0.5]] and i.tolist() == [[1, 0]]
    assert i.dtype == torch.int32
    lp = torch.log_softmax(torch.randn(2, 6, 5), -1)
    beam_device.ctc_beam_search_device(lp, torch.tensor([6, 4]),
                                       beam_width=3)
    assert len(calls) == 1 + 6 and topk.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        topk.topk_total_order(torch.zeros(2, 3, device="meta"), 2)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scan_wrappers_use_plain_versions_on_cpu(monkeypatch, cell):
    """K4 and K6 (both variants) take plain_scan for CPU tensors, count no
    launch there, and raise on a device that is neither CPU nor CUDA."""
    from deepspeech_tpu_torch.ops.cuda import gru, lstm

    mod, g = (gru, 3) if cell == "gru" else (lstm, 4)
    scan = gru.gru_scan if cell == "gru" else lstm.lstm_scan
    calls = []
    fn = mod.plain_scan
    monkeypatch.setattr(mod, "plain_scan", lambda *a, **k: (
        calls.append(1), fn(*a, **k))[1])
    t, b, h = 5, 2, 3
    xp, w_hh = torch.randn(2, t, b, g * h), torch.randn(2, h, g * h)
    bias, lens = torch.zeros(2, g * h), torch.tensor([5, 3])
    before = (mod.scan_launches, mod.scan_res_launches)
    assert scan(xp, bias, w_hh, bias, lens).shape == (2, t, b, h)
    assert len(scan(xp, bias, w_hh, bias, lens, residuals=True)) == 3
    assert len(calls) == 2
    assert (mod.scan_launches, mod.scan_res_launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        scan(xp.to("meta"), bias, w_hh, bias, lens)
    assert len(calls) == 2


def test_serve_and_cnn_modules_are_covered():
    """The import check above walks serve/ and models/cnn.py too."""
    names = _modules()
    for name in ("deepspeech_tpu_torch.serve", "deepspeech_tpu_torch.serve.pool",
                 "deepspeech_tpu_torch.serve.streaming",
                 "deepspeech_tpu_torch.serve.streaming_cnn",
                 "deepspeech_tpu_torch.models.cnn",
                 "deepspeech_tpu_torch.cli.serve"):
        assert name in names, name
    paths = {os.path.relpath(p, ROOT) for p in _sources()}
    assert "deepspeech_tpu_torch/serve/pool.py" in paths
    assert "deepspeech_tpu_torch/models/cnn.py" in paths


def test_serve_and_cnn_default_to_the_card(tmp_path, monkeypatch):
    """A CNN builds on the card by default and the serve CLI loads there,
    raising where there is none; a stream on the CPU runs K1's plain
    version and counts no launch."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from deepspeech_tpu_torch.cli.serve import main as serve_main
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.ops.cuda import stft
    from deepspeech_tpu_torch.serve import CNNStreamingTranscriber
    from deepspeech_tpu_torch.text.labels import Labels
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    with pytest.raises(RuntimeError, match="cuda"):
        build_model("cnn", 30, 8, 1, cnn_width=8)
    model, meta = build_model("cnn", 30, 8, 1, cnn_width=8, device="cpu")
    path = str(tmp_path / "m.ckpt")
    ckpt.save(path, ckpt.package_from_model(
        model, meta, "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 ", {"sample_rate": 16000}))
    with pytest.raises(RuntimeError, match="cuda"):
        serve_main(["--model-path", path, "--manifest", "unused.csv"])
    calls = []
    plain = stft.plain
    monkeypatch.setattr(stft, "plain", lambda *a, **k: (
        calls.append(1), plain(*a, **k))[1])
    before = stft.launches
    st = CNNStreamingTranscriber(model, Labels("_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 "),
                                 chunk_frames=8)
    st.feed(np.zeros(16000, np.float32))
    st.finish()
    assert calls and stft.launches == before
