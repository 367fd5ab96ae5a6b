"""The traced pass: device time by layer, kernels, busy and idle time.

One pass of the cell's bins runs under ``torch.profiler`` (CPU and CUDA
activities) after one uncounted step and a marker kernel in the same
trace, the window pattern of ``chip_smoke.py:5072 spd_profile``: what the
start of a profiler window loses falls before the marker and is not
counted. Only the device ops that start after the marker count.

A device op belongs to the layer whose span held the host call that
launched it (the op's ``correlation`` to its launch record): a forward span, opened by the benchmark's own hooks on the
layer's modules (``layers/*.json``), or a backward node
(``autograd::engine::evaluate_function: ...``) whose sequence number is
that of a forward op inside such a span. Everything else is the rest of
the step.
"""

from __future__ import annotations

import bisect
import contextlib
import fnmatch
import json
import os

import torch

LAYER = "portbench.layer:"
HOST = "portbench.host:"
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD = "autograd::engine::evaluate_function: "
NAME_CHARS = 120  # a breakdown entry's name, cut


class LayerSpans:
    """Forward pre/post hooks that hold a ``record_function`` range named
    ``portbench.layer:<layer>`` open over each module of a layer."""

    def __init__(self, model: torch.nn.Module, layers: dict):
        self.handles, hooked = [], []
        for name, module in model.named_modules():
            if any(name.startswith(h + ".") for h in hooked):
                continue  # inside a hooked module: its span holds it
            for layer, patterns in layers.items():
                if any(fnmatch.fnmatchcase(name, p) for p in patterns):
                    self._hook(module, layer)
                    hooked.append(name)
                    break

    def _hook(self, module, layer):
        stack = []

        def pre(mod, args):
            rf = torch.profiler.record_function(LAYER + layer)
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out):
            stack.pop().__exit__(None, None, None)

        self.handles += [module.register_forward_pre_hook(pre),
                         module.register_forward_hook(post)]

    def remove(self):
        for h in self.handles:
            h.remove()


def host_span(name: str):
    return torch.profiler.record_function(HOST + name)


def record(run_uncounted, run_pass, directory: str) -> list:
    """The trace's events of ``run_uncounted()``, a synchronize, the
    marker, then ``run_pass()`` and a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_uncounted()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        run_pass()
        torch.cuda.synchronize()
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(ops: list) -> list:
    """Merged [start, end] intervals of (start, end, ...) sorted by start."""
    out = []
    for start, end, *_ in ops:
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


class _Intervals:
    """One thread's nested or disjoint intervals; ``inner(t)`` is the
    innermost one holding ``t``."""

    def __init__(self, items: list):
        self.items = sorted(items, key=lambda x: (x[0], -x[1]))
        self.starts = [x[0] for x in self.items]
        self.reach, last = [], float("-inf")  # the latest end so far
        for x in self.items:
            last = max(last, x[1])
            self.reach.append(last)

    def inner(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.reach[i] >= t:
            if self.items[i][1] >= t:
                return self.items[i]
            i -= 1
        return None


def analyse(events: list, steps: int) -> dict:
    """-> {"layer_ms": {layer: device ms a step}, "device_ms": device ms a
    step, "kernels": kernels a step, "busy_s", "window_s", "device_ops":
    [[name, s]] (most time first), "idle_gaps": [[host activity, s]]
    (longest first), "unlaunched": device ops with no launch record}."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    dev = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"], e.get("cat"), e.get("args", {}))
                  for e in xs if e.get("cat") in DEVICE_CATS),
                 key=lambda op: op[:2])
    marks = [end for start, end, name, _, _ in dev if MARKER in name]
    if not marks:
        raise RuntimeError("the trace holds no marker kernel")
    t0 = marks[-1]
    dev = [op for op in dev if op[0] > t0]
    if not dev:
        raise RuntimeError("the trace holds no device op after the marker")
    launches = {e["args"]["correlation"]: (e["tid"], float(e["ts"]))
                for e in xs if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    cpu = [e for e in xs if e.get("cat") in ("cpu_op", "user_annotation")]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"],
              e["name"][len(LAYER):]) for e in cpu
             if e["name"].startswith(LAYER)]
    by_tid: dict = {}
    for start, end, tid, layer in spans:
        by_tid.setdefault(tid, []).append((start, end, layer))
    layer_spans = {tid: _Intervals(v) for tid, v in by_tid.items()}
    seq_layer = {}
    for e in cpu:
        args = e.get("args", {})
        seq = args.get("Sequence number")
        if (seq is None or args.get("Fwd thread id", 0) != 0
                or e["name"].startswith(BACKWARD)
                or e["tid"] not in layer_spans):
            continue
        hit = layer_spans[e["tid"]].inner(float(e["ts"]))
        if hit is not None:
            seq_layer[seq] = hit[2]
    owners: dict = {tid: list(v) for tid, v in by_tid.items()}
    for e in cpu:
        seq = e.get("args", {}).get("Sequence number")
        if e["name"].startswith(BACKWARD) and seq in seq_layer:
            owners.setdefault(e["tid"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 seq_layer[seq]))
    owners = {tid: _Intervals(v) for tid, v in owners.items()}

    layer_us: dict = {}
    names: dict = {}
    total_us, kernels, unlaunched = 0.0, 0, 0
    for start, end, name, cat, args in dev:
        dur = end - start
        total_us += dur
        kernels += cat == "kernel"
        names[name] = names.get(name, 0.0) + dur
        launch = launches.get(args.get("correlation"))
        if launch is None:
            unlaunched += 1
            continue
        tid, ts = launch
        hit = owners[tid].inner(ts) if tid in owners else None
        if hit is not None:
            layer_us[hit[2]] = layer_us.get(hit[2], 0.0) + dur
    busy = _union(dev)
    busy_us = sum(end - start for start, end in busy)
    window_us = max(end for _, end, *_ in dev) - t0
    gaps = [(busy[0][0] - t0, t0, busy[0][0])] + [
        (b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])]
    return {"layer_ms": {k: v / 1e3 / steps for k, v in layer_us.items()},
            "device_ms": total_us / 1e3 / steps,
            "kernels": kernels / steps,
            "busy_s": busy_us / 1e6, "window_s": window_us / 1e6,
            "device_ops": [[n[:NAME_CHARS], s / 1e6] for n, s in sorted(
                names.items(), key=lambda x: -x[1])[:10]],
            "idle_gaps": _idle_gaps(cpu, gaps),
            "unlaunched": unlaunched}


def _idle_gaps(cpu: list, gaps: list, labelled: int = 400) -> list:
    """The idle gaps summed by what the loop's thread was doing at each
    gap's middle: the benchmark's host span and the innermost op there;
    the ``labelled`` longest gaps, the ten largest sums."""
    hosts = [e for e in cpu if e["name"].startswith(HOST)]
    if not hosts:
        return []
    tid = hosts[0]["tid"]
    spans = _Intervals([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         e["name"][len(HOST):]) for e in hosts])
    ops = _Intervals([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in cpu
                      if e["tid"] == tid and not e["name"].startswith(HOST)
                      and not e["name"].startswith(LAYER)])
    sums: dict = {}
    for dur, start, end in sorted(gaps, reverse=True)[:labelled]:
        mid = (start + end) / 2
        span, op = spans.inner(mid), ops.inner(mid)
        label = (span[2] if span else "outside the loop") + (
            f" / {op[2]}" if op else "")
        sums[label[:NAME_CHARS]] = sums.get(label[:NAME_CHARS], 0.0) + dur
    return [[k, v / 1e6] for k, v in sorted(sums.items(),
                                            key=lambda x: -x[1])[:10]]


@contextlib.contextmanager
def traced(model, layers: dict):
    """The layer hooks, installed for the traced pass only."""
    hooks = LayerSpans(model, layers)
    try:
        yield
    finally:
        hooks.remove()
