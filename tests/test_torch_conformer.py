"""PyTorch port: the Conformer-CTC (``models/conformer.py``) against the
benchmark's plain reference (``portbench/reference/conformer.py``), on
seeded weights from that reference, at d 64, 2 blocks, 4 heads and
depthwise kernels 8 and 7 (one even, one odd).

Tolerances: f32 logits 1e-5 of the largest (the two compute the same
products in other orders: the front's K1 twin against ``torch.stft``,
one fused softmax against another; the readings lie near 1e-6); the CTC
loss 1e-5 relative (the reference sums in float64); each gradient 2e-4
of its own norm or the median one's, the larger; one Adam step's
parameters 1e-6 absolute (a step of at most lr 1e-3 an element; an
element whose gradient is near nought moves by the sign of its rounding,
lr at most). In bf16, against the reference's rounded operands: each
module, given the same input, 1e-4 of its largest output (both take
f32 products of the same rounded operands and differ in their sums'
order alone: the readings lie under 2e-5, where a module that rounded
its products' results to bf16 reads 3.7e-3 to 6.1e-3); the logits 5e-3
of the largest (the sums' order flips a few operands' roundings, which
the blocks carry on: 3.3e-3 to 4.0e-3 over three batches and both
kernels, where the f32 reference reads 5.2e-3 to 6.6e-3, a program that
rounds its products' results 5.5e-3 to 7.7e-3 and the fp8 reference
8e-2 and more).

Beside them: the relative shift against a direct loop; the log-mel front
against a numpy STFT and filterbank; the valid rows' logits when the
padding grows; dropout drawn from the step's generator; a checkpoint's
meta round trip; Adam's beta2 and eps against a hand-written update; the
global norm's bits and the guard's select; the
``train``, ``test`` and ``transcribe`` CLIs on a conformer; the
benchmark's ``train_model`` entry on tiny cells; the reference's imports.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepspeech_tpu_torch.audio.features import (AudioConf, featurize_batch,
                                                 mel_filterbank)
from deepspeech_tpu_torch.models import build_model, model_from_meta
from deepspeech_tpu_torch.ops.attention import rel_shift
from deepspeech_tpu_torch.train.optim import build_optimizer
from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                             make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from portbench.reference import conformer as ref  # noqa: E402

SR = 16000
SIZES = dict(d_model=64, heads=4, layers=2, ff=128, n_mels=80)


def cfg_of(kernel: int) -> dict:
    return {**SIZES, "conv_kernel": kernel, "num_classes": 30,
            "sample_rate": SR, "window_size": 0.025, "window_stride": 0.01,
            "window": "hann",
            "optimizer": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.98,
                          "eps": 1e-9, "max_norm": 100.0}}


CONF = AudioConf(window_size=0.025, window="hann", n_mels=80)


def program(cfg: dict, compute_dtype=None, dropout: float = 0.0):
    model, meta = build_model("conformer", 30, dropout=dropout,
                              compute_dtype=compute_dtype, device="cpu",
                              conv_kernel=cfg["conv_kernel"], **SIZES)
    model.load_state_dict(ref.make_weights(cfg, 7, "cpu"), strict=True)
    return model, meta


def batch_of(seed: int = 0, lengths=(16000, 12100, 8300)) -> dict:
    g = torch.Generator().manual_seed(seed)
    s = max(lengths) + 800
    audio = torch.randn(len(lengths), s, generator=g) * 0.1
    lens = torch.tensor(lengths)
    audio = audio * (torch.arange(s)[None] < lens[:, None])
    targets = torch.randint(1, 30, (len(lengths), 12), generator=g,
                            dtype=torch.int32)
    return {"audio": audio, "audio_lengths": lens.int(), "targets": targets,
            "target_lengths": torch.tensor([12, 9, 6], dtype=torch.int32),
            "valid": torch.ones(len(lengths))}


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("kernel", [8, 7])
def test_f32_logits_match_the_reference(kernel):
    cfg = cfg_of(kernel)
    model, _ = program(cfg)
    b = batch_of()
    spect, frames = featurize_batch(b["audio"], b["audio_lengths"], CONF)
    logits, probs, out_lens = model(spect, frames)
    with torch.no_grad():
        want, want_lens = ref.forward(ref.make_weights(cfg, 7, "cpu"), b, cfg)
    assert torch.equal(out_lens, want_lens)
    assert rel_err(logits.detach(), want) <= 1e-5
    assert torch.allclose(probs.sum(-1), torch.ones(()), atol=1e-5)


@pytest.mark.parametrize("kernel", [8, 7])
def test_loss_gradients_and_one_adam_step_match_the_reference(kernel):
    cfg = cfg_of(kernel)
    model, _ = program(cfg)
    opt = build_optimizer("adam", lr=1e-3, beta2=0.98, eps=1e-9)
    state = TrainState.create(model, opt)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, opt, StepConfig(audio_conf=CONF))
    b = batch_of(1)
    m = step(state, b, return_grads=True)

    w = ref.make_weights(cfg, 7, "cpu")
    names = [n for n in w if ref.is_param(n)]
    leaves = {n: v.clone().requires_grad_(True) for n, v in w.items()}
    logits, lens = ref.forward(leaves, b, cfg)
    loss = ref.mean_loss(logits, lens, b)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    loss = float(loss.detach())
    assert abs(float(m["loss"]) - loss) <= 1e-5 * abs(loss)
    got = dict(zip([n for n, _ in model.named_parameters()], m["grads"]))
    # a gradient held to its own norm or the median one's, the larger (the
    # depthwise bias feeds a BatchNorm: its gradient is rounding alone)
    med = float(np.median([float(g.norm()) for g in grads]))
    for n, g in zip(names, grads):
        assert float((got[n] - g).norm()) <= 2e-4 * max(float(g.norm()),
                                                        med), n
    # one Adam step from zero moments: p - lr g / (|g| + eps); an element
    # whose gradient is near nought (or a tensor's whose gradient is
    # rounding alone, as the key bias's: the softmax ignores it) moves by
    # its sign, lr either way
    params = dict(model.named_parameters())
    for n, g in zip(names, grads):
        diff = (params[n].detach() - (before[n] - 1e-3 * g / (g.abs() + 1e-9))
                ).abs()
        assert float(diff.max()) <= 2e-3, n
        if float(g.norm()) >= 1e-3 * med:
            firm = g.abs() > 1e-3 * g.abs().max()
            assert float(diff[firm].max()) <= 1e-6, n


def test_bf16_logits_match_the_reference_at_rounded_operands():
    cfg = cfg_of(8)
    model, _ = program(cfg, "bfloat16")
    b = batch_of(2)
    spect, frames = featurize_batch(b["audio"], b["audio_lengths"], CONF)
    logits = model(spect, frames)[0].detach()
    with torch.no_grad():
        want, _ = ref.forward(ref.make_weights(cfg, 7, "cpu"), b, cfg,
                              "bfloat16")
        f32, _ = ref.forward(ref.make_weights(cfg, 7, "cpu"), b, cfg)
    assert rel_err(logits, want) <= 5e-3
    assert rel_err(want, f32) > 1e-4  # the rounding shows


@pytest.mark.parametrize("module", ["subsample", "ffn", "mhsa",
                                    "conv_module", "head"])
def test_bf16_modules_match_the_reference_on_the_same_input(module):
    """Each module's products give f32 results of bf16 operands: given the
    same input as the reference, its output matches to the sums' order."""
    from deepspeech_tpu_torch.models.conformer import linear, rel_positions
    from deepspeech_tpu_torch.models.layers import length_mask
    from deepspeech_tpu_torch.ops.attention import key_mask

    cfg = cfg_of(8)
    model, _ = program(cfg, "bfloat16")
    w, op, block = ref.make_weights(cfg, 7, "cpu"), "bfloat16", "blocks.0"
    x = torch.randn(3, 25, 64, generator=torch.Generator().manual_seed(3))
    lens = torch.tensor([25, 19, 11])
    masks = {"keys": key_mask(lens, 25),
             "frames": length_mask(lens, 25)[..., None]}
    b = batch_of(2)
    spect, frames = featurize_batch(b["audio"], b["audio_lengths"], CONF)
    blk = model.blocks[0]
    got, want = {
        "subsample": lambda: (model.subsample(spect, frames),
                              ref.subsample(spect, frames, w, cfg, op)[0]),
        "ffn": lambda: (blk.ffn1(x),
                        ref.feed_forward(x, w, f"{block}.ffn1", op)),
        "mhsa": lambda: (blk.mhsa(x, rel_positions(25, 64, "cpu"), masks),
                         ref.mhsa(x, ref.sinusoids(25, 64, "cpu"), lens, w,
                                  f"{block}.mhsa", 4, op)),
        "conv_module": lambda: (blk.conv_module(x, masks),
                                ref.conv_module(x, lens, w,
                                                f"{block}.conv_module", 8,
                                                op)),
        "head": lambda: (linear(x, model.head, torch.bfloat16),
                         ref.dense(x, w, "head", op)),
    }[module]()
    assert got.dtype == torch.float32
    assert rel_err(got.detach(), want) <= 1e-4


def test_products_return_f32_results_of_rounded_operands():
    """``ops/products.py``: forward and backward, each product is the f32
    product of the bf16-rounded operands, and its result is not rounded."""
    from deepspeech_tpu_torch.ops.products import bmm_nt, matmul_nt, rounded

    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def r(t):
        return t.to(bf).float()

    def unrounded(t):  # an f32 result: most elements are no bf16 value
        return float((t != r(t)).float().mean()) > 0.5

    x = torch.randn(2, 5, 48, generator=g, requires_grad=True)
    w = torch.randn(24, 48, generator=g, requires_grad=True)
    gy = torch.randn(2, 5, 24, generator=g)
    y = matmul_nt(x, w, bf)
    dx, dw = torch.autograd.grad(y, [x, w], gy)
    want = r(x.detach()) @ r(w.detach()).t()
    assert torch.allclose(y, want, rtol=1e-6, atol=1e-6) and unrounded(y)
    assert torch.allclose(dx, r(gy) @ r(w.detach()), rtol=1e-6, atol=1e-6)
    assert torch.allclose(dw, r(gy).reshape(-1, 24).t()
                          @ r(x.detach()).reshape(-1, 48),
                          rtol=1e-6, atol=1e-6)
    assert unrounded(dx) and unrounded(dw)

    a = torch.randn(3, 7, 16, generator=g, requires_grad=True)
    c = torch.randn(3, 9, 16, generator=g, requires_grad=True)
    gz = torch.randn(3, 7, 9, generator=g)
    z = bmm_nt(a, c, bf)
    da, dc = torch.autograd.grad(z, [a, c], gz)
    assert torch.allclose(z, r(a.detach()) @ r(c.detach()).transpose(1, 2),
                          rtol=1e-6, atol=1e-6) and unrounded(z)
    assert torch.allclose(da, r(gz) @ r(c.detach()), rtol=1e-6, atol=1e-6)
    assert torch.allclose(dc, r(gz).transpose(1, 2) @ r(a.detach()),
                          rtol=1e-6, atol=1e-6)

    v = torch.randn(9, generator=g, requires_grad=True)
    rv = rounded(v, bf)
    assert torch.equal(rv, r(v.detach()))
    assert torch.equal(torch.autograd.grad(rv, v, gz[0, 0])[0], gz[0, 0])


def test_relative_shift_matches_a_direct_loop():
    t = 7
    bd = torch.randn(2, 3, t, 2 * t - 1)
    out = rel_shift(bd)
    for i in range(t):
        for j in range(t):
            assert torch.equal(out[..., i, j], bd[..., i, t - 1 - i + j])
    # the reference's index matrix reads the same
    qv, p = torch.randn(2, 3, t, 4), torch.randn(3, 2 * t - 1, 4)
    direct = rel_shift(torch.einsum("bhid,hrd->bhir", qv, p))
    assert torch.allclose(ref.rel_scores(qv, p), direct, atol=1e-6)


def test_mel_front_matches_numpy():
    assert np.abs(mel_filterbank(SR, 400, 80)
                  - ref.mel_matrix(SR, 400, 80)).max() < 1e-6
    b = batch_of(3, (16000, 9000))
    spect, frames = featurize_batch(b["audio"], b["audio_lengths"], CONF)
    fb = ref.mel_matrix(SR, 400, 80)
    win = np.hanning(400)  # the symmetric Hann window
    for row in range(2):
        y = np.pad(b["audio"][row].numpy().astype(np.float64), 200,
                   mode="reflect")
        n = (len(y) - 400) // 160 + 1
        frames_ = np.stack([y[i * 160:i * 160 + 400] * win
                            for i in range(n)])
        power = np.abs(np.fft.rfft(frames_, axis=-1)) ** 2
        lm = np.log(power @ fb.T + 2.0 ** -24).T  # (80, n)
        v = int(frames[row])
        lm = lm[:, :v]
        want = (lm - lm.mean(1, keepdims=True)) / (
            lm.std(1, ddof=1, keepdims=True) + 1e-5)
        got = spect[row].numpy()
        assert np.abs(got[:, :v] - want).max() < 2e-3
        assert not got[:, v:].any()


def test_valid_rows_do_not_change_when_the_padding_grows():
    model, _ = program(cfg_of(8))
    model.eval()
    g = torch.Generator().manual_seed(4)
    spect = torch.randn(2, 80, 120, generator=g)
    lens = torch.tensor([120, 90])
    short = model(spect, lens)[0]
    wide = torch.cat([spect, 5 * torch.randn(2, 80, 60, generator=g)], -1)
    long_, _, out = model(wide, lens)
    for r in range(2):
        n = int(out[r])
        assert rel_err(long_[r, :n], short[r, :n]) <= 1e-5


def test_dropout_draws_from_the_step_generator():
    cfg = cfg_of(7)
    model, _ = program(cfg, dropout=0.1)
    model.train()
    b = batch_of(5)
    spect, frames = featurize_batch(b["audio"], b["audio_lengths"], CONF)

    def run(seed):
        return model(spect, frames, torch.Generator().manual_seed(seed))[0]

    a, a2, c = run(1), run(1), run(2)
    assert torch.equal(a, a2) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
    model.eval()
    assert torch.equal(model(spect, frames)[0],
                       model(spect, frames, torch.Generator())[0])


def test_checkpoint_meta_round_trip(tmp_path):
    from deepspeech_tpu_torch.convert import jax_to_torch
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    model, meta = program(cfg_of(7))
    path = str(tmp_path / "c.ckpt")
    ckpt.save(path, ckpt.package_from_model(model, meta, "_'AB ",
                                            CONF.to_dict()))
    package = ckpt.load(path)
    again = model_from_meta(package, device="cpu")
    again.load_state_dict(jax_to_torch(package["params"],
                                       package["batch_stats"]))
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), again.state_dict().values()))
    assert AudioConf.from_dict(package["audio_conf"]) == CONF
    assert "n_mels" not in AudioConf().to_dict()  # the DS2 dicts unchanged


def test_adam_beta2_and_eps_against_a_hand_written_update():
    torch.manual_seed(0)
    p = [torch.randn(5, 3), torch.randn(4)]
    opt = build_optimizer("adam", lr=0.01, beta2=0.98, eps=1e-9,
                          max_norm=0)
    state = opt.init(p)
    mu = [torch.zeros_like(x) for x in p]
    nu = [torch.zeros_like(x) for x in p]
    want = [x.clone() for x in p]
    for t in range(1, 4):
        g = [torch.randn_like(x) for x in p]
        p, state = opt.update(g, state, p)
        for i, gi in enumerate(g):
            mu[i] = 0.9 * mu[i] + 0.1 * gi
            nu[i] = 0.98 * nu[i] + 0.02 * gi * gi
            want[i] = want[i] - 0.01 * (mu[i] / (1 - 0.9 ** t)) / (
                torch.sqrt(nu[i] / (1 - 0.98 ** t)) + 1e-9)
    for a, b in zip(p, want):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)
    default = build_optimizer("adam")
    assert (default.beta2, default.eps) == (0.999, 1e-8)


def test_global_norm_and_the_guard_keep_the_one_tensor_bits():
    """The global norm is the sum of per-tensor sums of squares, bit for
    bit; the guard's select takes every new tensor where the step is kept
    and none where it is skipped, NaNs included."""
    from deepspeech_tpu_torch.train import optim

    ts = [torch.randn(s) for s in ((50, 30), (7,), (3, 4, 5))]
    want = torch.sqrt(sum(torch.sum(t * t) for t in ts))
    assert torch.equal(optim.global_norm(ts), want)
    shapes = [(2, 3), (4,), (9,), (1,), (3, 2)]
    old = [torch.randn(s) for s in shapes]
    new = [torch.full(s, float("nan")) for s in shapes]
    kept = [o.clone() for o in old]
    optim.assign_where(torch.tensor(False), new, old)
    assert all(torch.equal(a, b) for a, b in zip(old, kept))
    new = [torch.randn(s) for s in shapes]
    optim.assign_where(torch.tensor(True), {"l": new}, {"l": old})
    assert all(torch.equal(a, b) for a, b in zip(old, new))


def test_conformer_refuses_model_parallel_and_streaming():
    from deepspeech_tpu_torch.cli.common import refuse_conformer
    from deepspeech_tpu_torch.cli.train import build_parser, check_ported

    args = build_parser().parse_args(["--rnn-type", "conformer",
                                      "--mesh-model", "2"])
    with pytest.raises(SystemExit, match="data parallel"):
        check_ported(args)
    with pytest.raises(SystemExit, match="does not stream"):
        refuse_conformer(program(cfg_of(7))[0], "serve")


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    from deepspeech_tpu_torch.audio.io import save_wav

    d = tmp_path_factory.mktemp("conformer_cli")
    rng = np.random.default_rng(0)
    rows = []
    for i, text in enumerate(("HELLO WORLD", "THE CAT", "A DOG RAN",
                              "GOOD DAY")):
        n = int(SR * (0.6 + 0.15 * i))
        t = np.arange(n) / SR
        y = np.sin(2 * np.pi * (200 + 50 * i) * t) + 0.1 * rng.standard_normal(
            n)
        wav, txt = str(d / f"u{i}.wav"), str(d / f"u{i}.txt")
        save_wav(wav, (y / np.abs(y).max()).astype(np.float32), SR)
        with open(txt, "w") as f:
            f.write(text)
        rows.append(f"{wav},{txt},{n / SR}")
    path = d / "manifest.csv"
    path.write_text("\n".join(rows) + "\n")
    return d, str(path), wav


def test_train_test_and_transcribe_clis_run_a_conformer(manifest, capsys):
    from deepspeech_tpu_torch.cli.test import main as test_main
    from deepspeech_tpu_torch.cli.train import main as train_main
    from deepspeech_tpu_torch.cli.transcribe import main as transcribe_main
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    d, path, wav = manifest
    save = d / "models"
    assert train_main([
        "--device", "cpu", "--train-manifest", path, "--val-manifest", path,
        "--epochs", "1", "--batch-size", "2", "--val-batch-size", "2",
        "--rnn-type", "conformer", "--conformer-d-model", "32",
        "--conformer-heads", "4", "--conformer-layers", "1",
        "--conformer-ff", "64", "--conformer-kernel", "7",
        "--window-size", "0.025", "--window", "hann",
        "--compute-dtype", "float32", "--optimizer", "adam", "--lr", "1e-3",
        "--adam-beta2", "0.98", "--adam-eps", "1e-9", "--num-workers", "1",
        "--save-folder", str(save), "--log-dir", str(d / "logs")]) == 0
    out = capsys.readouterr().out
    assert "epoch 1 iter 1/2 loss" in out and "[val] epoch 1" in out
    package = ckpt.load(str(save / "deepspeech_final.ckpt"))
    assert package["rnn_type"] == "conformer" and package["layers"] == 1
    assert package["audio_conf"]["n_mels"] == 80
    assert (package["adam_beta2"], package["adam_eps"]) == (0.98, 1e-9)
    assert math.isfinite(package["loss_results"][0])
    model = str(save / "deepspeech_final.ckpt")
    assert test_main(["--model-path", model, "--test-manifest", path,
                      "--batch-size", "2", "--num-workers", "1",
                      "--device", "cpu"]) == 0
    assert "utterances" in capsys.readouterr().out
    assert transcribe_main(["--model-path", model, "--audio-path", wav,
                            "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "transcription" in got["output"][0]
    with pytest.raises(SystemExit, match="does not stream"):
        transcribe_main(["--model-path", model, "--audio-path", wav,
                         "--device", "cpu", "--chunk-seconds", "0.5"])


def _tiny_copy(dst: str) -> str:
    """A copy of the benchmark with a tiny conformer cell and a tiny DS2
    cell, both on the ``train_model`` entry in f32."""
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    files = {c["name"]: c["file"] for c in bench["configs"]}
    for name, full, sizes in (
            ("tiny-conformer", "train-conformer-l-b32-ls100",
             dict(d_model=32, heads=4, layers=2, ff=64, conv_kernel=8,
                  compute_dtype="float32")),
            ("tiny-ds2", "train-gru1600-b64-ls100",
             dict(hidden_size=16, hidden_layers=2))):
        w = cells[full]
        with open(os.path.join(ROOT, files[w["config"]])) as f:
            cfg = {**json.load(f), **sizes}
        with open(os.path.join(ROOT, "portbench", "traffic",
                               f"{w['traffic']}.json")) as f:
            mix = json.load(f)
        mix.update(split_utterances=8, bins=4, batch=2, loader_workers=2,
                   duration_quantiles=[[0.0, 1.0], [1.0, 3.0]])
        if "compute_dtype" in mix:
            mix["compute_dtype"] = "float32"
        for sub, obj in (("configs", cfg), ("traffic", mix)):
            with open(os.path.join(dst, "portbench", sub, f"{name}.json"),
                      "w") as f:
                json.dump(obj, f)
        shutil.copy(os.path.join(ROOT, "portbench", "limits",
                                 f"{full}.json"),
                    os.path.join(dst, "portbench", "limits", f"{name}.json"))
        bench["configs"].append({"name": name, "source": "tests",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "tests"})
        bench["workloads"].append({"name": name, "config": name,
                                   "traffic": name, "chips": 1,
                                   "why": "tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if full in m.get("workloads", ()):
                m["workloads"].append(name)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


@pytest.mark.parametrize("workload", ["tiny-conformer", "tiny-ds2"])
def test_train_model_entry_runs_tiny_cells_correct(tmp_path, workload):
    root = _tiny_copy(str(tmp_path))
    script = (f"import sys\nsys.path[:0] = [{root!r}, {ROOT!r}]\n"
              "import torch\ntorch.set_num_threads(2)\n"
              "from portbench import run\n"
              f"raise SystemExit(run.main(['--workload', {workload!r}, "
              "'--seed', '2147495000', '--seconds', '0', '--trace', '0'], "
              "device=torch.device('cpu')))\n")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600, cwd=root)
    assert p.returncode == 0, p.stderr
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["check"]
    assert set(line["metrics"]) == {"train_audio_s_per_s", "setup_s"}
    assert set(line["check"]) == {"loss_gap", "grad_gap", "change_gap"}


def test_the_reference_imports_neither_jax_nor_the_port():
    code = ("import sys\nsys.path.insert(0, %r)\n"
            "import portbench.reference.conformer\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'deepspeech_tpu', "
            "'deepspeech_tpu_torch'))\n"
            "print(bad)\nraise SystemExit(1 if bad else 0)\n" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
