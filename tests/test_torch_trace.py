"""PyTorch port: the span recorder (``utils/trace.py``) and its spans.

* Off, a span is one shared no-op: nothing recorded, no clock read, no
  ``record_function``, even under a profiler.
* On, spans nest by thread: each records its enclosing span on its own
  thread as its parent.
* A tiny DS2's CPU ``train_step`` and ``eval_step`` record the step's
  phases, the model's layers and the backward Functions' spans, in order.
* Under ``torch.profiler`` each span is a ``ds.`` range of the Chrome
  trace, nested as in memory.
* The loader's reads run on its pool threads and carry their CPU time;
  the decoder's read-back is a child of its decode.
* ``summary``: self time is wall time less the children's; the store's
  bound counts what it drops.
* The train CLI's ``--profile-dir`` window writes the summary beside its
  trace.
"""

import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from deepspeech_tpu_torch.cli.train import Profiler
from deepspeech_tpu_torch.data import AudioDataLoader, BucketSpec
from deepspeech_tpu_torch.decoders import GreedyDecoder
from deepspeech_tpu_torch.models import build_model
from deepspeech_tpu_torch.ops.cuda import build
from deepspeech_tpu_torch.train import optim
from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                             make_eval_step, make_train_step)
from deepspeech_tpu_torch.utils import trace

torch.set_num_threads(2)

LAYERS = 2
TRAIN_SPANS = (["step", "featurize", "forward", "conv"]
               + [f"rnn.{i}" for i in range(LAYERS)]
               + ["head", "ctc", "backward", "ctc.bwd"]
               + ["rnn.bwd"] * LAYERS + ["optim"])
EVAL_SPANS = (["step", "featurize", "forward", "conv"]
              + [f"rnn.{i}" for i in range(LAYERS)] + ["head", "ctc"])


@pytest.fixture(autouse=True)
def recorder_off():
    trace.enable(False)
    trace.take()
    yield
    trace.enable(False)
    trace.take()


def _model_and_batch(seed=0):
    torch.manual_seed(seed)
    model, _ = build_model("gru", 29, 16, LAYERS, device="cpu")
    rng = np.random.default_rng(seed)
    b, s = 2, 8000
    batch = {"audio": torch.from_numpy(
                 rng.standard_normal((b, s)).astype(np.float32) * 0.1),
             "audio_lengths": torch.tensor([8000, 6400], dtype=torch.int32),
             "targets": torch.tensor([[1, 2, 3], [4, 5, 0]],
                                     dtype=torch.int32),
             "target_lengths": torch.tensor([3, 2], dtype=torch.int32)}
    return model, batch


def _train_step(model):
    opt = optim.build_optimizer("sgd", lr=1e-3, momentum=0.9,
                                max_norm=100.0)
    return TrainState.create(model, opt), make_train_step(model, opt,
                                                          StepConfig())


def _by_start(spans):
    return sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))


class _Counting:
    """Stands in for ``record_function`` and the clocks: counts calls."""

    def __init__(self, real=None):
        self.calls, self.real = 0, real

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.real(*args, **kwargs) if self.real else None


def test_off_records_nothing_and_never_reads_a_clock(monkeypatch):
    rf = _Counting(torch.profiler.record_function)
    clocks = [_Counting(time.perf_counter_ns), _Counting(time.thread_time_ns)]
    monkeypatch.setattr(torch.profiler, "record_function", rf)
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(
        perf_counter_ns=clocks[0], thread_time_ns=clocks[1]))
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b")  # one shared no-op
    model, batch = _model_and_batch()
    state, step = _train_step(model)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, batch)
        make_eval_step(model)(batch)
    assert trace.take() == []
    assert rf.calls == 0
    assert [c.calls for c in clocks] == [0, 0]


def test_on_nests_spans_by_thread():
    trace.enable(True)
    done = threading.Event()

    def worker():
        with trace.span("t.outer"):
            with trace.span("t.inner"):
                pass
        done.set()

    with trace.span("outer"):
        with trace.span("inner"):
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=10)
        with trace.span("second"):
            pass
    assert done.is_set() and not th.is_alive()
    spans = {s.name: s for s in trace.take()}
    assert set(spans) == {"outer", "inner", "second", "t.outer", "t.inner"}
    assert spans["outer"].parent is None
    assert spans["inner"].parent == spans["outer"].id
    assert spans["second"].parent == spans["outer"].id
    assert spans["t.outer"].parent is None  # its own thread's top
    assert spans["t.inner"].parent == spans["t.outer"].id
    assert spans["t.outer"].tid != spans["outer"].tid
    assert spans["t.inner"].tid == spans["t.outer"].tid
    for s in spans.values():
        assert s.end_ns >= s.start_ns and s.cpu_ns >= 0
    assert spans["t.outer"].start_ns >= spans["inner"].start_ns
    assert spans["t.outer"].end_ns <= spans["inner"].end_ns


def _parents_hold_children(spans):
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, s.name


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_steps_record_the_layer_spans_in_order(kind):
    model, batch = _model_and_batch()
    trace.enable(True)
    if kind == "train":
        state, step = _train_step(model)
        step(state, batch)
        want = TRAIN_SPANS
    else:
        make_eval_step(model)(batch)
        want = EVAL_SPANS
    spans = _by_start(trace.take())
    assert [s.name for s in spans] == want
    _parents_hold_children(spans)
    by_id = {s.id: s.name for s in spans}
    parent = {s.name: by_id.get(s.parent) for s in spans}
    assert parent["step"] is None
    for phase in ("featurize", "forward", "ctc"):
        assert parent[phase] == "step"
    for layer in ("conv", "rnn.0", "rnn.1", "head"):
        assert parent[layer] == "forward"
    if kind == "train":
        # the CPU's autograd runs on the calling thread: inside backward
        assert parent["optim"] == "step"
        assert parent["ctc.bwd"] == parent["rnn.bwd"] == "backward"


def test_profiler_trace_holds_every_span_nested(tmp_path):
    model, batch = _model_and_batch()
    state, step = _train_step(model)
    step(state, batch)  # the first call's set-up outside the trace
    trace.enable(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, batch)
    trace.enable(False)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"
                  and e.get("name", "").startswith(trace.PREFIX)]
    spans = _by_start(trace.take())
    ranges = sorted(events, key=lambda e: (float(e["ts"]),
                                           -float(e["dur"])))
    assert [e["name"] for e in ranges] == [trace.PREFIX + s.name
                                           for s in spans]
    at = {s.id: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
          for s, e in zip(spans, ranges)}
    for s in spans:
        if s.parent is not None:
            (ps, pe), (cs, ce) = at[s.parent], at[s.id]
            assert ps <= cs and ce <= pe, s.name


class _Dataset:
    """Utterances whose reads burn CPU on the calling thread."""

    def __getitem__(self, i):
        x = np.random.default_rng(i).standard_normal(200_000)
        for _ in range(5):
            x = np.sort(x)
        return {"audio": x[:1600].astype(np.float32),
                "target": np.array([1, 2], np.int32), "path": f"u{i}"}


def test_loader_reads_run_on_pool_threads_with_cpu_time():
    bins = [[0, 1, 2], [3, 4, 5]]
    loader = AudioDataLoader(_Dataset(), bins, 3,
                             BucketSpec(audio_step=1600), num_workers=3)
    trace.enable(True)
    batches = list(loader)
    trace.enable(False)
    assert len(batches) == 2
    spans = trace.take()
    names = [s.name for s in spans]
    for name, n in (("loader.read", 6), ("loader.collate", 2),
                    ("loader.put", 2), ("loader.wait", 3)):
        assert names.count(name) == n, name
    main = threading.get_ident()
    reads = [s for s in spans if s.name == "loader.read"]
    (producer,) = {s.tid for s in spans if s.name == "loader.collate"}
    assert all(s.tid not in (main, producer) for s in reads)
    assert all(s.cpu_ns > 0 for s in reads)
    assert all(s.tid == main for s in spans if s.name == "loader.wait")
    table = trace.summary(spans)
    assert table["loader.read"]["cpu_ms"] > 0


def test_decode_holds_its_readback():
    dec = GreedyDecoder("_'ABCD ", blank_index=0)
    ids = torch.tensor([[1, 1, 0, 2, 3], [4, 0, 4, 6, 5]], dtype=torch.int32)
    trace.enable(True)
    strings, _ = dec.decode_ids(ids, torch.tensor([5, 4]))
    spans = _by_start(trace.take())
    assert [s.name for s in spans] == ["decode", "decode.readback"]
    assert spans[1].parent == spans[0].id
    assert strings[0] == ["'AB"]


def test_build_is_a_span_even_with_nothing_to_build():
    trace.enable(True)
    assert build.build_all(names=()) == {}
    assert [s.name for s in trace.take()] == ["build"]


def test_summary_self_time_is_wall_less_children():
    S = trace.Span
    ms = 1_000_000
    spans = [S(1, "child", 0, 7, 1 * ms, 3 * ms, 2 * ms),
             S(2, "child", 0, 7, 4 * ms, 5 * ms, 1 * ms),
             S(3, "leaf", 2, 7, 4 * ms, 4 * ms + ms // 2, 0),
             S(0, "top", None, 7, 0, 10 * ms, 6 * ms)]
    table = trace.summary(spans)
    assert table["top"] == {"count": 1, "wall_ms": 10.0, "self_ms": 7.0,
                            "cpu_ms": 6.0}
    assert table["child"] == {"count": 2, "wall_ms": 3.0, "self_ms": 2.5,
                              "cpu_ms": 3.0}
    assert table["leaf"]["self_ms"] == 0.5


def test_a_full_store_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    before = trace.dropped()
    trace.enable(True)
    for _ in range(5):
        with trace.span("x"):
            pass
    assert len(trace.take()) == 3
    assert trace.dropped() - before == 2


def test_profile_window_writes_the_summary_beside_the_trace(tmp_path):
    model, batch = _model_and_batch()
    state, step = _train_step(model)
    prof = Profiler(str(tmp_path), 1, 2, torch.device("cpu"),
                    say=lambda *a: None)
    with trace.span("before the window"):
        pass
    for i in range(4):
        prof.step(i)
        step(state, batch)
    assert not trace.enabled()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "summary_1_3.json", "trace_steps_1_3.json"]
    with open(tmp_path / "summary_1_3.json") as f:
        summary = json.load(f)
    assert summary["steps"] == [1, 3]
    spans = summary["spans"]
    assert set(spans) == set(TRAIN_SPANS)
    assert spans["step"]["count"] == 2 and spans["rnn.bwd"]["count"] == 4
    assert spans["step"]["self_ms"] < spans["step"]["wall_ms"]
    assert summary["spans_dropped"] == trace.dropped()
    assert all(isinstance(n, int) for n in summary["launches"].values())
    assert {"gru.bwd_launches", "gru.scan_f32_persistent_launches"} <= set(
        summary["launches"])
    assert summary["collectives"] is None
    assert summary["step_graphs"] is None
    with open(tmp_path / "trace_steps_1_3.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {trace.PREFIX + n for n in TRAIN_SPANS} <= names
