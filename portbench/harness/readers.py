"""What the per-layer metrics' readers (``metrics/<name>.py``) read.

A ``Run`` holds the cell's kind ("train" or "infer"), its configuration,
the untraced window (seconds, records, the host's loader wait), the
traced pass's analysis (``trace.analyse``) and its utterances' samples,
and the device's peak memory. Each helper returns None where the run has
nothing to read (another kind of cell, or no trace), and the harness then
leaves the metric out of the line.
"""

from __future__ import annotations

from portbench.harness import counts


class Run:
    def __init__(self, kind, cfg, window, trace=None, traced_samples=(),
                 traced_steps=0, peak_bytes=None):
        self.kind, self.cfg, self.window = kind, cfg, window
        self.trace, self.traced_samples = trace, list(traced_samples)
        self.traced_steps, self.peak_bytes = traced_steps, peak_bytes


def _traced(run: Run, kind: str):
    return run.trace if run.kind == kind and run.trace else None


def layer_ms(run: Run, kind: str, layer: str):
    """Device ms a step under the layer's spans (forward and backward)."""
    t = _traced(run, kind)
    if t is None or layer not in t["layer_ms"]:
        return None
    return t["layer_ms"][layer]


def rest_ms(run: Run, kind: str, layers: tuple):
    """Device ms a step outside the named layers' spans."""
    t = _traced(run, kind)
    if t is None:
        return None
    return t["device_ms"] - sum(t["layer_ms"].get(x, 0.0) for x in layers)


def kernels(run: Run, kind: str):
    t = _traced(run, kind)
    return None if t is None else t["kernels"]


def idle_pct(run: Run, kind: str):
    t = _traced(run, kind)
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]


def recurrence_roofline(run: Run, kind: str):
    """The recurrent layers' least time over the traced pass's utterances
    over their device time there, in %."""
    ms = layer_ms(run, kind, "recurrence")
    if not ms or not run.traced_samples:
        return None
    flops, nbytes = counts.recurrence_work(run.traced_samples, run.cfg,
                                           kind == "train")
    return 100.0 * counts.least_seconds(flops, nbytes) / (
        ms * run.traced_steps / 1e3)


def host_ms(run: Run, kind: str, key: str):
    """Host ms a step of ``key`` over the window: "loader_wait_s" (time in
    next() on the loader) or "decode_s" (the greedy decode)."""
    if run.kind != kind or not run.window["records"]:
        return None
    n = len(run.window["records"])
    if key == "loader_wait_s":
        return 1e3 * run.window[key] / n
    return 1e3 * sum(r[key] for r in run.window["records"]) / n


def mfu_pct(run: Run, kind: str):
    """The model's operations over the window's seconds over the bf16
    peak, in %."""
    if run.kind != kind or not run.window["records"]:
        return None
    samples = [n for r in run.window["records"] for n in r["samples"]]
    return 100.0 * counts.model_flops(samples, run.cfg, kind == "train") / (
        run.window["seconds"] * counts.PEAK_BF16)


def peak_gib(run: Run, kind: str):
    if run.kind != kind or run.peak_bytes is None:
        return None
    return run.peak_bytes / 2 ** 30
