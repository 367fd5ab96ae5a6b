"""The port's spans as the benchmark reads them (``harness/spans.py``,
``run_spans.py``): a synthetic device trace's attribution, and tiny runs
on the CPU with the recorder on and off."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

sys.path.insert(0, tiny.REPO)
from portbench.harness import spans, trace  # noqa: E402

SEED = 2 ** 31 + 777


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def launch(ts, corr, tid=1):
    return ev("cudaLaunchKernel", "cuda_runtime", ts, 1, tid=tid,
              correlation=corr)


def kernel(name, ts, dur, corr):
    return ev(name, "kernel", ts, dur, tid=7, correlation=corr)


def test_device_time_goes_to_the_program_span_that_launched_it():
    events = [
        kernel("spin_kernel", 0, 10, 1), launch(0, 1),
        ev("ds.step", "user_annotation", 12, 100),
        ev("ds.forward", "user_annotation", 14, 22),
        ev("ds.rnn.0", "user_annotation", 15, 20),
        # a forward op with sequence number 9 inside ds.rnn.0
        ev("GRULayer", "cpu_op", 16, 5, **{"Sequence number": 9}),
        launch(17, 2), kernel("k_fwd", 20, 10, 2),
        # step's own launch, outside its children
        launch(50, 3), kernel("k_step", 52, 4, 3),
        # the autograd thread: node 9 holds a backward span, whose launch
        # it holds directly; a second launch in the node outside the span
        ev(trace.BACKWARD + "GRULayerBackward", "cpu_op", 60, 30, tid=2,
           **{"Sequence number": 9, "Fwd thread id": 1}),
        ev("ds.rnn.bwd", "user_annotation", 61, 10, tid=2),
        launch(62, 4, tid=2), kernel("k_bwd", 70, 20, 4),
        launch(80, 5, tid=2), kernel("k_dw", 95, 5, 5),
        # outside ds.step on the loop's thread: a decode
        ev("ds.decode", "user_annotation", 120, 40),
        launch(121, 6), kernel("k_out", 150, 5, 6),
    ]
    a = spans.analyse(events, steps=1)
    us = 1e-3
    assert a["by_chain"] == {
        ("rnn.0", "forward", "step"): pytest.approx(10 * us),
        ("step",): pytest.approx(4 * us),
        ("rnn.bwd", "rnn.0"): pytest.approx(20 * us),
        ("rnn.0",): pytest.approx(5 * us),
        ("decode",): pytest.approx(5 * us)}
    assert spans.under(a, ["rnn.*"]) == pytest.approx(35 * us)
    assert spans.under(a, ["rnn.bwd"]) == pytest.approx(20 * us)
    assert spans.under(a, ["step"]) == pytest.approx(14 * us)
    assert spans.innermost(a)["rnn.0"] == pytest.approx(15 * us)
    # idle: 10-20 (rnn.0 at 15), 30-52 (step at 41), 56-70 (step at 63),
    # 90-95 (step at 92.5), 100-150 (decode at 125, outside ds.step)
    assert a["idle_ms"] == {"rnn.0": pytest.approx(10 * us),
                            "step": pytest.approx(41 * us),
                            "decode": pytest.approx(50 * us)}
    assert a["issue_idle_ms"] == pytest.approx(51 * us)


def test_a_trace_without_program_spans_reads_nothing():
    events = [kernel("spin_kernel", 0, 10, 1), launch(0, 1),
              launch(12, 2), kernel("k", 20, 5, 2)]
    assert spans.analyse(events, steps=1) is None


def test_window_reads_issue_loader_cpu_and_decode_work():
    from deepspeech_tpu_torch.utils.trace import Span

    ms = 1_000_000
    t0 = 100.0
    base = int(t0 * 1e9)
    recs = [Span(0, "step", None, 1, base + 1 * ms, base + 5 * ms, 4 * ms),
            Span(1, "step", None, 1, base + 11 * ms, base + 17 * ms, 6 * ms),
            Span(2, "loader.read", None, 2, base, base + 3 * ms, 2 * ms),
            Span(3, "loader.collate", None, 3, base + 3 * ms, base + 4 * ms,
                 ms),
            Span(5, "decode.readback", 4, 1, base + 6 * ms, base + 9 * ms, 0),
            Span(4, "decode", None, 1, base + 6 * ms, base + 10 * ms, ms),
            # before the window
            Span(6, "step", None, 1, base - 9 * ms, base - ms, 8 * ms)]
    w = spans.window(recs, t0, 0.05, steps=2)
    assert w["host_issue_ms"] == pytest.approx(5.0)
    assert w["loader_cpu_ms"] == pytest.approx(1.5)
    assert w["decode_work_ms"] == pytest.approx(0.5)
    assert w["self_ms"]["decode"] == pytest.approx(0.5)


def run_tiny(root, module, workload, trace_flag=0, tail=""):
    script = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{root!r}, {tiny.REPO!r}]
        import torch
        torch.set_num_threads(2)
        from portbench import {module} as entry
        code = entry.main(["--workload", {workload!r}, "--seed",
                           "{SEED}", "--seconds", "0", "--trace",
                           "{trace_flag}"], device=torch.device("cpu"))
    """) + textwrap.dedent(tail) + "raise SystemExit(code)\n"
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600, cwd=root)
    return p.returncode, p.stdout.strip().splitlines(), p.stderr


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("workload,kind", [("tiny-train", "train"),
                                           ("tiny-eval", "infer")])
def test_a_run_with_spans_reads_the_program_counters(copy, workload, kind):
    rc, lines, err = run_tiny(copy, "run_spans", workload)
    assert rc == 0, err
    result, got = json.loads(lines[-2]), json.loads(lines[-1])
    assert result["correct"] is True
    names = [f"host_issue_ms.{kind}", f"loader_cpu_ms.{kind}"]
    if kind == "infer":
        names.append("decode_work_ms.infer")
    for name in names:
        assert math.isfinite(got[name]) and got[name] >= 0, name
    assert got["host_issue_ms." + kind] > 0
    assert got["spans_dropped"] == 0
    assert "step" in got["host_self_ms"]
    assert any(line.startswith("spans: ") for line in err.splitlines())


def test_run_py_records_no_span(copy):
    tail = """
        from deepspeech_tpu_torch.utils import trace
        assert not trace.enabled()
        assert trace.take() == []
        print("no spans", file=sys.stderr)
    """
    rc, lines, err = run_tiny(copy, "run", "tiny-eval", tail=tail)
    assert rc == 0, err
    assert "no spans" in err
    assert json.loads(lines[-1])["correct"] is True
