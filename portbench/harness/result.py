"""The run's result: the import check, the device, the last lines."""

from __future__ import annotations

import json
import math
import sys

# top-level module names that must not be loaded in the process that
# prints the result, compared whole: the port's own name begins with the
# JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "deepspeech_tpu")


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device(torch, count: int, peak_bytes: int, trace: dict | None) -> dict:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        out["busy_s"], out["window_s"] = trace["busy_s"], trace["window_s"]
    return out


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def emit(correct: bool, attempted: int, failed: int, metrics: dict,
         device_info: dict, table: dict, breakdown: dict | None = None):
    """Print each compared number beside its limit as the last lines of
    standard error, then the result's line as the last of standard
    output, its ``check`` key last."""
    for name, row in table.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr, flush=True)
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check"] = {n: {"value": _number(r["value"]), "limit": r["limit"]}
                     for n, r in table.items()}
    print(json.dumps(line), flush=True)
