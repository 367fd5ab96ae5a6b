"""Run one cell of the benchmark of ``deepspeech_tpu_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The cell (``BENCHMARK.json``'s workload) names a configuration and a
traffic mix; the mix names the entry it drives (``entries/<entry>.py``).
Set-up (imports, the kernel build, the inputs and weights made from the
seed, one pass of the mix's bins as warm-up) runs first, then the window:
whole passes until ``--seconds`` have gone by. With ``--trace 1`` one more
pass runs under the profiler and the per-layer metrics are read; with
``--trace 0`` the end-to-end metrics. Then the program is freed and the
plain reference checks what the program produced.

The last line of standard output is the result's JSON object; the last
lines of standard error give each compared number beside its limit. No
card, too few cards, or the JAX package loaded in this process: a
non-zero exit and no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import check, result, spec  # noqa: E402

# build and kernel caches: fixed directories inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", required=True, type=int, choices=(0, 1))
    return p.parse_args(argv)


class Context:
    """What an entry gets: the cell, the run's arguments, its device and
    temporary directory, and the set-up's phases on the host clock."""

    def __init__(self, cell, args, device, tmp):
        self.cell, self.seed = cell, args.seed
        self.seconds, self.trace = args.seconds, bool(args.trace)
        self.device, self.tmp = device, tmp
        self.layers = spec.layers()
        self.phases: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + time.perf_counter() - t)


def run_cell(ctx: Context, t_start: float) -> dict:
    """Set-up, window, optional traced pass, release, check -> what the
    result's line is made of."""
    from portbench.harness import readers

    cell = spec.entry(ctx.cell["traffic"]["entry"]).Cell(ctx)
    warm = time.perf_counter()
    cell.warm_up()
    cell.run_window()
    ctx.phases["warm-up"] = cell.window["t0"] - warm
    setup_s = cell.window["t0"] - t_start
    analysis = None
    if ctx.trace:
        with ctx.phase("traced pass"):
            analysis = cell.traced_pass()
    peak = cell.release()
    t = time.perf_counter()
    numbers = cell.numbers()
    ctx.phases["check, after the window"] = time.perf_counter() - t
    run = readers.Run(cell.kind, ctx.cell["config"], cell.window, analysis,
                      cell.traced_samples, cell.traced_steps, peak)
    rate = sum(r["audio_s"] for r in cell.records) / cell.window["seconds"]
    return {"cell": cell, "run": run, "numbers": numbers, "peak": peak,
            "analysis": analysis,
            "end_to_end": {cell.rate: rate, "setup_s": setup_s},
            **cell.outcome()}


def metrics_of(out: dict, entries: list, trace: bool) -> dict:
    """The cell's end-to-end metrics (``--trace 0``) or per-layer metrics
    (``--trace 1``) by name, with their units; a reader that finds
    nothing leaves its metric out."""
    found = {}
    for m in entries:
        if trace:
            value = spec.reader(m["name"])(out["run"])
        else:
            value = out["end_to_end"].get(m["name"])
            if value is None:
                raise KeyError(f"the entry reports no {m['name']}")
        if value is not None:
            found[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return found


def main(argv=None, device=None) -> int:
    """``device``, when given (tests), replaces the look for the card."""
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ.setdefault(var, os.path.join(ROOT, "portbench", "_cache",
                                                sub))
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    chips = cell["workload"]["chips"]
    with_phase = {}
    t = time.perf_counter()
    import torch
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < chips):
            print(f"portbench: {args.workload} needs {chips} CUDA "
                  f"device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    from portbench.harness import program
    with_phase["imports"] = time.perf_counter() - t
    t = time.perf_counter()
    built = program.build_all() if device.type == "cuda" else {}
    with_phase["build"] = time.perf_counter() - t
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        ctx = Context(cell, args, torch.device(device), tmp)
        ctx.phases.update(with_phase)
        out = run_cell(ctx, T_START)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = result.forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    phases = " ".join(f"{k} {v:.3f}" for k, v in ctx.phases.items())
    print(f"phases (s): {phases}; kernels built now: "
          f"{sorted(built) or 'none'}", file=sys.stderr)
    window = out["run"].window
    print(f"window: {out['end_to_end']} over {window['seconds']:.3f} s, "
          f"{len(out['cell'].records)} steps; each pass (s): "
          + " ".join(f"{s:.4f}" for s in window["passes_s"]),
          file=sys.stderr)
    if out["analysis"] is not None:
        a = out["analysis"]
        print(f"trace: device ops with no launch record "
              f"{a['unlaunched']}; layer ms a step {a['layer_ms']}; "
              f"device ms a step {a['device_ms']:.3f}", file=sys.stderr)
    entries = cell["per_layer"] if args.trace else cell["end_to_end"]
    metrics = metrics_of(out, entries, bool(args.trace))
    correct, table = check.verdict(out["numbers"], cell["limits"])
    breakdown = None
    if out["analysis"] is not None:
        breakdown = {k: out["analysis"][k] for k in ("device_ops",
                                                     "idle_gaps")}
    dev_info = (result.device(torch, chips, out["peak"], out["analysis"])
                if device.type == "cuda" else {"platform": "cpu",
                                               "kind": "cpu", "count": 0,
                                               "memory_peak_bytes": 0})
    result.emit(correct, out["attempted"], out["failed"], metrics, dev_info,
                table, breakdown)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
