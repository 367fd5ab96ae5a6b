"""One run of a cell, as ``run.py`` makes it, with the port's span
recorder on, and what the port's spans read.

    python3 portbench/run_spans.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

``run.py`` runs unchanged (its lines are printed as always) with the
recorder (``deepspeech_tpu_torch/utils/trace.py``) on from the start, so
its window runs with the spans on: a ``--trace 0`` run here against one
of ``run.py`` on the same seed is the recorder's cost. With ``--trace 1``
the traced pass's events are kept for ``harness/spans.py``. Then one more
standard-error line gives device ms a step by innermost program span,
host self ms a step by span and idle ms a step by innermost program span
(``spans:``), and the last line of standard output is a JSON object:
the cell's rate and the window's span readings, with ``--trace 1`` the
device's, and the benchmark's own layer times beside the program's
(``ds.conv`` and ``ds.rnn.*`` against ``conv_ms`` and ``rnn_ms``).

These readings are not metrics of the benchmark: ``run.py``, which the
benchmark runs, leaves the recorder off.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from portbench.harness import spans, trace  # noqa: E402


def _rounded(d: dict) -> dict:
    return {k: round(v, 4) for k, v in sorted(d.items(), key=lambda x: -x[1])}


def readings(out: dict, events, records: list) -> dict:
    """The window's and the traced pass's span readings of one run."""
    cell, w = out["cell"], out["run"].window
    kind = cell.kind
    host = spans.window(records, w["t0"], w["seconds"], len(w["records"]))
    got = {"rate": out["end_to_end"][cell.rate],
           f"host_issue_ms.{kind}": host["host_issue_ms"],
           f"loader_cpu_ms.{kind}": host["loader_cpu_ms"],
           "host_self_ms": _rounded(host["self_ms"]),
           "host_cpu_ms": _rounded(host["cpu_ms"]),
           "loader_wait_span_ms": host["wall_ms"].get("loader.wait", 0.0),
           "loader_wait_ms": 1e3 * w["loader_wait_s"] / len(w["records"])}
    if kind == "infer":
        got["decode_work_ms.infer"] = host["decode_work_ms"]
        got["decode_readback_ms"] = host["wall_ms"].get("decode.readback")
        got["decode_host_ms"] = 1e3 * sum(
            r["decode_s"] for r in w["records"]) / len(w["records"])
    a = out["analysis"]
    if events is not None and a is not None:
        s = spans.analyse(events, cell.traced_steps)
        got[f"featurize_ms.{kind}"] = spans.under(s, ["featurize"])
        got[f"issue_idle_ms.{kind}"] = s["issue_idle_ms"]
        if kind == "train":
            got["ctc_ms.train"] = spans.under(s, ["ctc", "ctc.bwd"])
            got["optimizer_ms.train"] = spans.under(s, ["optim"])
        got["device_ms"] = a["device_ms"]
        got["idle_ms"] = (a["window_s"] - a["busy_s"]) * 1e3 / (
            cell.traced_steps)
        got["ds_conv_ms"] = spans.under(s, ["conv"])
        got["ds_rnn_ms"] = spans.under(s, ["rnn.*"])
        got["conv_ms"] = a["layer_ms"].get("conv front")
        got["rnn_ms"] = a["layer_ms"].get("recurrence")
        got["device_innermost_ms"] = _rounded(spans.innermost(s))
        got["idle_innermost_ms"] = _rounded(s["idle_ms"])
    return got


def main(argv=None, device=None) -> int:
    """``device``, when given (tests), replaces the look for the card."""
    from deepspeech_tpu_torch.utils import trace as recorder

    kept: dict = {}
    record, run_cell = trace.record, run.run_cell

    def keep_events(*args):
        kept["events"] = record(*args)
        return kept["events"]

    def keep_out(*args):
        kept["out"] = run_cell(*args)
        return kept["out"]

    trace.record, run.run_cell = keep_events, keep_out
    recorder.take()
    recorder.enable(True)
    try:
        code = run.main(argv, device)
    finally:
        recorder.enable(False)
        trace.record, run.run_cell = record, run_cell
    if code != 0:
        return code
    got = readings(kept["out"], kept.get("events"), recorder.take())
    got["spans_dropped"] = recorder.dropped()
    line = " ".join(f"{k} {v}" for k, v in got.items()
                    if k in ("device_innermost_ms", "host_self_ms",
                             "idle_innermost_ms"))
    print(f"spans: {line}", file=sys.stderr, flush=True)
    print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
