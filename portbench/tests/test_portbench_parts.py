"""The benchmark's parts on the CPU: traffic, counts, the import rules,
files found by name, the trace's attribution, the reference against the
port's CPU path, and the controls against the committed limits."""

from __future__ import annotations

import ast
import glob
import hashlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

sys.path.insert(0, tiny.REPO)
from portbench.harness import check, counts, result, spec, trace  # noqa: E402
from portbench.harness import traffic  # noqa: E402
from portbench.reference import ds2  # noqa: E402

MIXES = sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(tiny.REPO, "portbench", "traffic", "*.json")))


def mix(name):
    with open(os.path.join(tiny.REPO, "portbench", "traffic",
                           f"{name}.json")) as f:
        return json.load(f)


# -- traffic --------------------------------------------------------------

@pytest.mark.parametrize("name", MIXES)
def test_mix_work_is_fixed_across_seeds_and_draws_repeat(name, tmp_path):
    m = dict(mix(name), split_utterances=6, bins=3, batch=2)
    m["duration_quantiles"] = [[0.0, 1.0], [0.5, 1.5], [1.0, 2.5]]
    digests = {}
    for seed in (7, 7, 2 ** 31 + 3):
        d = tmp_path / f"s{seed}-{len(digests)}"
        d.mkdir()
        traffic.write_inputs(m, 16000, seed, str(d))
        files = sorted(p for p in os.listdir(d) if p != "manifest.csv")
        digests.setdefault(seed, []).append(
            [hashlib.sha256((d / p).read_bytes()).hexdigest()
             for p in files])
        sizes = [os.path.getsize(d / p) for p in files]
        if "sizes" in digests:
            assert sizes == digests["sizes"]  # the same work every seed
        digests["sizes"] = sizes
    assert digests[7][0] == digests[7][1]  # a seed repeats its inputs
    assert digests[7][0] != digests[2 ** 31 + 3][0]  # and another differs


@pytest.mark.parametrize("name", MIXES)
def test_mix_durations_bins_and_orders(name):
    m = mix(name)
    n, b, k = m["split_utterances"], m["batch"], m["bins"]
    d = traffic.durations(m)
    knots = np.asarray(m["duration_quantiles"])
    assert knots[0, 1] <= d[0] and d[-1] <= knots[-1, 1]
    assert np.all(np.diff(d) >= 0)
    bins = traffic.bins(m)
    assert sum(bins, []) == list(range(k * b))
    assert all(len(g) == b for g in bins)
    # each bin is one of the split's own bins of ``batch`` consecutive
    # ranks, the one at the middle of its 1/bins of the split
    r = traffic.ranks(m).reshape(k, b)
    assert np.all(np.diff(r, axis=1) == 1) and np.all(r[:, 0] % b == 0)
    whole = -(-n // b)
    for i, start in enumerate(r[:, 0] // b):
        assert i * whole <= (start + 0.5) * k <= (i + 1) * whole
    # so a bin holds the durations of the split's bin there
    full = np.interp((np.arange(n) + 0.5) / n, knots[:, 0], knots[:, 1])
    assert np.allclose(d.reshape(k, b), full[r])
    a = traffic.pass_order(m, 5)
    assert a == traffic.pass_order(m, 5)
    assert sorted(a) == list(range(len(bins)))
    assert traffic.stream(m, 5, 2) == [bins[i] for i in a + a]
    # every seed's passes follow one cycle: the same neighbours
    b2 = traffic.pass_order(m, 2 ** 31 + 9)
    pairs = {(x, y) for x, y in zip(a, a[1:] + a[:1])}
    assert pairs == {(x, y) for x, y in zip(b2, b2[1:] + b2[:1])}


def test_transcripts_keep_their_length_through_the_label_codec():
    from deepspeech_tpu_torch.text.labels import Labels

    labels = Labels("_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 ")
    r = np.random.default_rng(0)
    for n in range(1, 300):
        text = traffic.transcript(r, n)
        assert len(text) == n and len(labels.parse(text)) == n


# -- counts ---------------------------------------------------------------

def config(name):
    bench = spec.benchmark()
    c = next(c for c in bench["configs"] if c["name"] == name)
    with open(os.path.join(tiny.REPO, c["file"])) as f:
        return json.load(f)


def test_forward_flops_of_a_7_5_s_gru800_utterance_match_the_anchor():
    """PERF.md's anchor: ~44.9 GFLOP a forward of a 7.5 s utterance of the
    default DS2 (~134.6 for its train step)."""
    cfg = config("ds2-gru800")
    n = [int(7.5 * 16000)]
    fwd = counts.model_flops(n, cfg, train=False)
    assert fwd == pytest.approx(44.9e9, rel=0.01)
    assert counts.model_flops(n, cfg, train=True) == 3 * fwd
    flops, nbytes = counts.recurrence_work(n, cfg, train=False)
    assert flops == counts.forward_flops(376, cfg)["recurrence"]
    assert 0 < nbytes and counts.least_seconds(flops, nbytes) > 0


def test_out_frames_follow_the_conv_front():
    cfg = config("ds2-gru800")
    assert [counts.out_frames(n, cfg) for n in (1, 159, 160, 120000)] == [
        1, 1, 1, 376]
    assert ds2.conv_features() == 1312 == counts.rnn_inputs(cfg)[0]


# -- the import rules -----------------------------------------------------

def test_forbidden_names_compare_whole_top_level_names():
    assert result.forbidden_modules(
        ["deepspeech_tpu_torch.ops", "jaxtyping", "flaxen", "numpy"]) == []
    assert result.forbidden_modules(
        ["jax.numpy", "deepspeech_tpu.ops", "jaxlib", "flax.linen"]) == [
        "deepspeech_tpu", "flax", "jax", "jaxlib"]


def imports_of(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_names_jax_and_the_reference_no_program():
    files = glob.glob(os.path.join(tiny.REPO, "portbench", "**", "*.py"),
                      recursive=True)
    for path in files:
        names = set(imports_of(path))
        assert not names & {"jax", "jaxlib", "flax", "deepspeech_tpu"}, path
        if os.sep + "reference" + os.sep in path:
            assert "deepspeech_tpu_torch" not in names, path


def test_loading_the_harness_loads_no_jax_and_the_reference_no_program():
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {tiny.REPO!r})
        import portbench.reference.ds2
        assert not any(m.split(".")[0] == "deepspeech_tpu_torch"
                       for m in sys.modules), "the reference loads the port"
        from portbench import run, calibrate
        from portbench.harness import spec, program
        for e in ("train", "eval"):
            spec.entry(e)
        import deepspeech_tpu_torch.train.step
        import deepspeech_tpu_torch.data
        import deepspeech_tpu_torch.decoders
        from portbench.harness.result import forbidden_modules
        print(forbidden_modules())
    """)
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


# -- files found by name --------------------------------------------------

def digest_tree(root):
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "portbench", "**", "*"),
                                 recursive=True)):
        if os.path.isfile(path) and "__pycache__" not in path:
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def test_a_config_mix_layer_and_metric_added_as_files_are_found(tmp_path):
    """The tiny copy adds configurations, mixes, cells and limits as new
    files; here a per-layer metric and a layer file are added too. No file
    that the benchmark had changes, and each new one is found by name."""
    root = str(tmp_path)
    tiny.make_copy(root)
    before = {k: v for k, v in digest_tree(tiny.REPO).items()
              if not k.startswith("portbench/_cache")}
    with open(os.path.join(root, "portbench", "metrics",
                           "head_ms.train.py"), "w") as f:
        f.write("from portbench.harness import readers\n\n\n"
                "def read(run):\n"
                "    return readers.layer_ms(run, 'train', 'head')\n")
    with open(os.path.join(root, "portbench", "layers", "head.json"),
              "w") as f:
        json.dump({"layer": "head", "modules": ["fc_bn", "fc"]}, f)
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "head_ms.train", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "head",
        "moves": "train_audio_s_per_s", "workloads": ["tiny-train"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    after = digest_tree(root)
    for name, digest in before.items():
        assert after.get(name) == digest, f"{name} was edited"
    script = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{root!r}, {tiny.REPO!r}]
        from portbench.harness import readers, spec
        cell = spec.cell(spec.benchmark(), "tiny-train")
        assert cell["config"]["hidden_size"] == 16
        assert cell["traffic"]["split_utterances"] == 8
        names = [m["name"] for m in cell["per_layer"]]
        assert "head_ms.train" in names, names
        assert spec.layers()["head"] == ["fc_bn", "fc"]
        run = readers.Run("train", cell["config"], {{"records": []}},
                          {{"layer_ms": {{"head": 1.5}}}})
        print(spec.reader("head_ms.train")(run))
    """)
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=root)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "1.5"


def test_benchmark_json_has_the_required_shape():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert e2e == {"train_audio_s_per_s", "infer_audio_s_per_s", "setup_s"}
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        assert cell["end_to_end"] and cell["per_layer"]
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        for m in cell["per_layer"]:
            assert m["moves"] in {x["name"] for x in cell["end_to_end"]}
            spec.reader(m["name"])
        spec.entry(cell["traffic"]["entry"])
        assert set(cell["limits"]) == set(
            {"train": ["loss_gap", "grad_gap", "change_gap"],
             "eval": ["output_gap"]}[cell["traffic"]["entry"]])


# -- the trace's attribution ----------------------------------------------

def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_device_time_goes_to_the_layer_whose_span_launched_it():
    events = [
        ev("spin_kernel", "kernel", 0, 10, tid=7, correlation=1),
        ev("cudaLaunchKernel", "cuda_runtime", 0, 1, correlation=1),
        # forward: the conv front's span launches k1; an op with sequence
        # number 5 inside it
        ev(trace.HOST + "launch", "user_annotation", 15, 200),
        ev(trace.LAYER + "conv front", "user_annotation", 20, 10),
        ev("aten::conv2d", "cpu_op", 21, 5, **{"Sequence number": 5,
                                               "Fwd thread id": 0}),
        ev("cudaLaunchKernel", "cuda_runtime", 22, 1, correlation=2),
        ev("k1", "kernel", 30, 10, tid=7, correlation=2),
        # outside any span: the rest
        ev("cudaLaunchKernel", "cuda_runtime", 40, 1, correlation=3),
        ev("k2", "kernel", 50, 5, tid=7, correlation=3),
        # backward on another thread: node 5 belongs to the conv front
        ev(trace.BACKWARD + "ConvolutionBackward0", "cpu_op", 60, 10, tid=2,
           **{"Sequence number": 5, "Fwd thread id": 1}),
        ev("cudaLaunchKernel", "cuda_runtime", 61, 1, tid=2, correlation=4),
        ev("k3", "kernel", 100, 20, tid=7, correlation=4),
        ev("k4", "kernel", 130, 5, tid=7, correlation=99),
    ]
    a = trace.analyse(events, steps=1)
    assert a["layer_ms"] == {"conv front": pytest.approx(0.030)}
    assert a["device_ms"] == pytest.approx(0.040)
    assert a["kernels"] == 4 and a["unlaunched"] == 1
    assert a["busy_s"] == pytest.approx(40e-6)
    assert a["window_s"] == pytest.approx(125e-6)
    assert a["idle_gaps"][0][0].startswith("launch")
    assert sum(s for _, s in a["idle_gaps"]) == pytest.approx(85e-6)
    assert a["device_ops"][0] == ["k3", pytest.approx(20e-6)]


# -- the reference against the port's CPU path -----------------------------

def small_cfg(dtype):
    cfg = config("ds2-gru800")
    cfg.update(hidden_size=16, hidden_layers=2, compute_dtype=dtype)
    return cfg


def small_batch(seed=0):
    from deepspeech_tpu_torch.data.loader import BucketSpec, collate_batch

    r = np.random.default_rng(seed)
    samples = [{"audio": traffic.waveform(r, n, 16000),
                "target": r.integers(1, 30, n // 1200).astype(np.int32),
                "path": ""} for n in (16000, 24000, 9000)]
    hb = collate_batch(samples, 4, BucketSpec(wire_dtype="int16"))
    return {k: torch.from_numpy(v) for k, v in hb.items() if k != "paths"}


def port_model(cfg, w):
    from portbench.harness import program

    return program.model(cfg, w, torch.device("cpu"))


def test_reference_eval_forward_matches_the_port_cpu_path():
    from deepspeech_tpu_torch.train.step import StepConfig, make_eval_step

    cfg = small_cfg("float32")
    w = ds2.make_weights(cfg, 11, "cpu")
    batch = small_batch()
    m = make_eval_step(port_model(cfg, w), StepConfig())(batch)
    lp, lens = ds2.posteriors(w, batch, cfg)
    assert m["out_lens"].tolist() == lens.tolist()
    rows = [{"probs": m["probs"][i].numpy(), "ids": m["greedy"][i].numpy(),
             "out_len": int(m["out_lens"][i])} for i in range(3)]
    assert check.eval_numbers(rows, lp.numpy(), lens.numpy())[
        "output_gap"] < 1e-5


@pytest.mark.parametrize("dtype,tol", [("float32", (1e-3, 1e-3, 1e-2)),
                                       ("bfloat16", (5e-3, 2e-2, 1e-1))])
def test_reference_train_steps_match_the_port_cpu_path(dtype, tol):
    from deepspeech_tpu_torch.train.optim import build_optimizer
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_train_step)

    cfg = small_cfg(dtype)
    w = ds2.make_weights(cfg, 12, "cpu")
    model = port_model(cfg, w)
    opt = build_optimizer("sgd", lr=3e-4, momentum=0.9, max_norm=100.0)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, StepConfig())
    batches = [small_batch(i) for i in range(3)]
    jitters = [torch.rand(4, generator=torch.Generator().manual_seed(i))
               - 0.5 for i in range(3)]
    names = [n for n, _ in model.named_parameters()]
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    prog = {"loss": []}
    for i, (b, j) in enumerate(zip(batches, jitters)):
        prog["loss"].append(float(step(state, b, jitter=j)["loss"]))
        if i == 0:
            prog["grad"] = {n: float(t.norm()) for n, t in
                            zip(names, state.opt_state["trace"])}
    prog["change"] = {n: float((p.detach() - start[n]).norm())
                      for n, p in model.named_parameters()}
    ref = ds2.train_steps(w, batches, jitters, cfg,
                          "bfloat16" if dtype == "bfloat16" else None)
    got = check.train_numbers(prog, ref)
    assert got["loss_gap"] < tol[0], got
    assert got["grad_gap"] < tol[1], got
    assert got["change_gap"] < tol[2], got


# -- the controls against the committed limits -----------------------------

def limits(workload):
    with open(os.path.join(tiny.REPO, "portbench", "limits",
                           f"{workload}.json")) as f:
        return json.load(f)


def test_train_control_float8_fails_the_committed_limits():
    """The reference one precision step below bf16 (float8 e4m3, scaled
    per tensor) in the program's place, at a size a test run holds."""
    cfg = small_cfg("bfloat16")
    cfg["hidden_size"] = 64
    w = ds2.make_weights(cfg, 13, "cpu")
    batches = [small_batch(i) for i in range(3)]
    jitters = [torch.zeros(4)] * 3
    ref = ds2.train_steps(w, batches, jitters, cfg, "bfloat16")
    ctl = ds2.train_steps(w, batches, jitters, cfg, "float8_e4m3fn")
    ok, table = check.verdict(check.train_numbers(ctl, ref),
                              limits("train-gru800-b20-ls100"))
    assert not ok, table


def test_eval_control_tf32_fails_the_committed_limit():
    cfg = small_cfg("float32")
    cfg["hidden_size"] = 64
    w = ds2.make_weights(cfg, 14, "cpu")
    batch = small_batch(3)
    lp, lens = ds2.posteriors(w, batch, cfg)
    ctl, _ = ds2.posteriors(w, batch, cfg, "tf32")
    rows = [{"probs": np.exp(c.numpy()), "ids": c.argmax(-1).numpy(),
             "out_len": int(n)} for c, n in zip(ctl, lens)]
    ok, table = check.verdict(check.eval_numbers(rows, lp.numpy(),
                                                 lens.numpy()),
                              limits("eval-gru1600-b64-testclean"))
    assert not ok, table


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -20,
                      -(1.0 + 2 ** -12), 3.0])
    assert ds2.quantize(x, "tf32").tolist() == [
        1.0 + 2 ** -10, 1.0 + 2 ** -10, -1.0, 3.0]
