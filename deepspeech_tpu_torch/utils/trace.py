"""The port's span recorder: named host intervals at its layers' boundaries.

``span(name)`` is a context manager that the port opens at each layer
boundary where work happens: the train and eval steps and their phases
(``train/step.py``), the model's conv front, recurrent layers and head
(``models/ds2.py``), the backward of the port's own autograd Functions
(``ops/ctc.py``, ``ops/cuda/gru.py``, ``ops/cuda/lstm.py``), the loader's
threads (``data/loader.py``), the greedy decoder (``decoders/greedy.py``),
the kernel build (``ops/cuda/build.py``), the CUDA graphs' captures and
replays (``train/graph.py``) and the mesh's collectives
(``parallel/mesh.py``).

The recorder is off by default (``enable``):

* off, ``span`` returns one shared no-op context: no clock read, no
  allocation, no ``record_function``;
* on, each span records ``Span(id, name, parent, tid, start_ns, end_ns,
  cpu_ns)`` in memory: ``parent`` is the id of the enclosing span on the
  same thread (None at a thread's top), the times are
  ``time.perf_counter_ns`` and the thread's CPU time
  (``time.thread_time_ns``) over the span;
* on while a ``torch.profiler`` records on the span's thread, the span is
  also a ``record_function`` range named ``ds.<name>``, so the device
  trace holds it on the kernels' clock.

The store keeps at most ``MAX_RECORDS`` spans and counts the ones it
drops (``dropped``); ``take`` returns the spans and empties it;
``summary`` sums them by name. The train CLI's ``--profile-dir`` window
turns the recorder on and writes the summary beside its trace
(``cli/train.py:Profiler``).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch

PREFIX = "ds."  # the spans' names in a profiler trace
MAX_RECORDS = 1 << 20


class Span(NamedTuple):
    id: int
    name: str
    parent: int | None
    tid: int
    start_ns: int
    end_ns: int
    cpu_ns: int


class _Off:
    """The shared context ``span`` returns while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Store:
    """The recorder's state: the switch, the spans, the drop count, each
    thread's stack of open span ids."""

    def __init__(self):
        self.on = False
        self.spans: list[Span] = []
        self.dropped = 0
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count()

    def add(self, s: Span) -> None:
        with self.lock:
            if len(self.spans) < MAX_RECORDS:
                self.spans.append(s)
            else:
                self.dropped += 1


_store = _Store()


class _On:
    """One recorded span (``span`` with the recorder on)."""
    __slots__ = ("name", "id", "parent", "stack", "rf", "start", "cpu")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_store.local, "stack", None)
        if stack is None:
            stack = _store.local.stack = []
        self.stack = stack
        self.parent = stack[-1] if stack else None
        self.id = next(_store.ids)
        stack.append(self.id)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.cpu = time.thread_time_ns()
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        cpu = time.thread_time_ns() - self.cpu
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.stack.pop()
        _store.add(Span(self.id, self.name, self.parent,
                        threading.get_ident(), self.start, end, cpu))
        return False


def enable(on: bool = True) -> None:
    """Turn the recorder on or off (spans open at the switch finish as
    they began)."""
    _store.on = bool(on)


def enabled() -> bool:
    return _store.on


def span(name: str):
    """A context over one span named ``name`` (module docstring)."""
    if not _store.on:
        return _OFF
    return _On(name)


def take() -> list[Span]:
    """The recorded spans, in the order they closed; the store empties."""
    with _store.lock:
        out, _store.spans = _store.spans, []
    return out


def dropped() -> int:
    """Spans dropped on a full store since the process started."""
    return _store.dropped


def summary(spans: list[Span]) -> dict:
    """{name: {"count", "wall_ms", "self_ms", "cpu_ms"}} of ``spans``:
    self time is the wall time less that of the span's children."""
    children: dict = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = (children.get(s.parent, 0)
                                  + s.end_ns - s.start_ns)
    out: dict = {}
    for s in spans:
        wall = s.end_ns - s.start_ns
        row = out.setdefault(s.name, {"count": 0, "wall_ms": 0.0,
                                      "self_ms": 0.0, "cpu_ms": 0.0})
        row["count"] += 1
        row["wall_ms"] += wall / 1e6
        row["self_ms"] += (wall - children.get(s.id, 0)) / 1e6
        row["cpu_ms"] += s.cpu_ns / 1e6
    return out
