"""Readings that the limits of ``limits/<workload>.json`` are set from.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \\
        [--controls 3]

on the card, in one process: for every seed the cell's set-up and the
program's outputs as a run checks them (the train entry's three checked
steps; the eval entry's warm-up and one window pass), held to the plain
reference; for the first ``--controls`` seeds also

* the control: the reference one precision step below the
  configuration's, put in the program's place (bf16 -> float8 e4m3,
  scaled per tensor; f32 -> TF32);
* the faults a run must catch: for training, a loss that leaves half of
  each batch out (the reference with that fault, in the program's place);
  a step that leaves its state unchanged reads 1 on ``change_gap`` by
  construction; for evaluation, one greedy label changed where the
  program produced it;
* for evaluation, a second f32 witness: the reference's cuDNN f32 layer
  held to the float64 reference as the program is.

Each seed's numbers are a JSON line; the last line sums up, for each
number, the largest reading of the program and of the witness (the lower
reading) and the smallest of the control and of each fault. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from portbench.harness import check, spec  # noqa: E402

CONTROL = {"bfloat16": "float8_e4m3fn", "float32": "tf32"}


def train_readings(cell, control: bool) -> dict:
    cell.warm_up(whole=False)
    cell.release()
    ref = cell.reference()
    out = {"program": cell.numbers(ref)}
    if control:
        op = CONTROL[cell.cfg["compute_dtype"]]
        out["control"] = check.train_numbers(cell.reference(op), ref)
        out["half_batch"] = check.train_numbers(
            cell.reference(half_batch=True), ref)
    return out


def eval_readings(cell, control: bool) -> dict:
    import numpy as np

    cell.warm_up()
    cell.run_window()
    cell.release()
    ref = cell.reference()
    out = {"program": cell.numbers(ref)}
    if control:
        lp, lens = cell.reference(CONTROL[cell.cfg["compute_dtype"]])
        rows = [{"probs": np.exp(p), "ids": p.argmax(-1), "out_len": int(n)}
                for p, n in zip(lp, lens)]
        out["control"] = check.eval_numbers(rows, *ref)
        rows = [dict(r) for r in cell.sample[0]]
        longest = max(range(len(rows)), key=lambda i: rows[i]["out_len"])
        ids = rows[longest]["ids"].copy()
        mid = rows[longest]["out_len"] // 2
        ids[mid] = (ids[mid] + 1) % lp.shape[-1]
        rows[longest]["ids"] = ids
        out["token_altered"] = check.eval_numbers(rows, *ref)
        out["cudnn_f32"] = check.eval_numbers(cudnn_rows(cell), *ref)
    return out


def cudnn_rows(cell) -> list:
    """The sampled rows through the reference's cuDNN layer in f32 (the
    train steps' layer), as a program's rows: how far a second f32
    implementation lies from the float64 reference."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from portbench.reference import ds2

    dev = cell.ctx.device
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             cell.sample[1].items()}
    w = ds2.make_weights(cell.cfg, cell.ctx.seed, dev)
    with torch.no_grad(), ds2.precision(None):
        logits, lens = ds2.forward(w, batch, cell.cfg, False)
        lp = F.log_softmax(logits, -1).cpu().numpy()
    return [{"probs": np.exp(p), "ids": p.argmax(-1), "out_len": int(n)}
            for p, n in zip(lp, lens.cpu().numpy())]


def main(argv=None, device=None) -> int:
    """``device``, when given (tests), replaces the card."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args(argv)
    import torch

    cell_spec = spec.cell(spec.benchmark(), args.workload)
    from portbench.harness import program
    if device is None:
        device = torch.device("cuda", 0)
        program.build_all()
    entry = spec.entry(cell_spec["traffic"]["entry"])
    readings = (train_readings if entry.Cell.kind == "train"
                else eval_readings)
    summary: dict = {}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        tmp = tempfile.mkdtemp(prefix="portbench-")
        try:
            ns = types.SimpleNamespace(seed=seed, seconds=0.0, trace=0)
            cell = entry.Cell(run.Context(cell_spec, ns, device, tmp))
            out = readings(cell, i < args.controls)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({"seed": seed, **out}), flush=True)
        for kind, numbers in out.items():
            pick = min if kind in ("control", "half_batch",
                                   "token_altered") else max
            for name, v in numbers.items():
                key = f"{kind}.{name}"
                summary[key] = v if key not in summary else pick(
                    summary[key], v)
        del cell
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
