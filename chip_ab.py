#!/usr/bin/env python3
"""Train steps of two checkouts of the port, in turns, on one CUDA card.

    python3 chip_ab.py [--log-dir DIR] TREE [TREE ...]

Each TREE is the root of a checkout holding ``chip_smoke.py`` and
``deepspeech_tpu_torch`` (the current tree is ``.``; an older commit can
be unpacked with ``git archive`` into a git-ignored directory such as
``chip_checkout/``). Give them in turns, for example ``old . . old``, so
that a drift of the card over the call shows. For each TREE in order, one
fresh process started there builds that tree's kernels and runs its
``chip_smoke.py`` train-step phases: 6 x BiGRU-800 and 6 x BiLSTM-800 at
batch 20 (phases 12 and 17), 6 x BiGRU-1600 at batch 64 and 6 x
BiLSTM-1600 at batch 20 (phases 20 and 21): each step held to the plain
path and its launches checked, 5 steps timed by CUDA events and one
profiled. Each run's log goes to ``DIR/ab_<i>.log`` (by default to a
temporary directory, removed at the end); the last line printed is one
JSON object of each run's step times in ms. Exits non-zero if a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

RUN = r"""
import sys, time
import torch
import chip_smoke as c
from deepspeech_tpu_torch.ops.cuda import build

if not torch.cuda.is_available():
    sys.exit("no CUDA card")
t0 = time.perf_counter()
build.build_all(force=True)
c.log(f"built in {time.perf_counter() - t0:.1f} s")
floor = c.step_floor(torch)
c.phase_train(torch, {}, floor)
c.phase_train(torch, {}, floor, "lstm")
for cell, fused, wide in (("gru", 1, c.LAYERS - 1), ("lstm", 0, c.LAYERS)):
    fwd = {f"{cell}_fwd": fused, f"{cell}_scan": wide}
    c.phase_train(torch, {}, floor, cell, c.WIDE, c.WIDE_BATCH[cell],
                  want=c.expect_counts(
                      stft_mag=1, ctc_alpha=1, ctc_beta=1, **fwd,
                      **{f"{cell}_fwd_res": fused, f"{cell}_scan_res": wide,
                         f"{cell}_bwd": c.LAYERS}))
"""
STEP = re.compile(r"^(\w+-\d+) train path: ([\d.]+) ms per step")


def run(trees, log_dir: str) -> int:
    runs = []
    for i, tree in enumerate(trees):
        path = os.path.join(log_dir, f"ab_{i}.log")
        with open(path, "w") as log:
            rc = subprocess.run([sys.executable, "-c", RUN],
                                cwd=os.path.abspath(tree), stdout=log,
                                stderr=subprocess.STDOUT).returncode
        with open(path) as log:
            lines = log.read().splitlines()
        steps = {m.group(1): float(m.group(2))
                 for m in map(STEP.match, lines) if m}
        print(f"run {i} ({tree}): rc {rc}, {steps}", flush=True)
        if rc != 0:
            print("\n".join(lines[-30:]), file=sys.stderr)
            return 1
        runs.append({"tree": tree, "step_ms": steps})
    print(json.dumps({"runs": runs}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-dir", help="keep each run's log here")
    ap.add_argument("trees", nargs="+", help="checkout roots, in turns")
    args = ap.parse_args(argv)
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        return run(args.trees, args.log_dir)
    with tempfile.TemporaryDirectory() as log_dir:
        return run(args.trees, log_dir)


if __name__ == "__main__":
    raise SystemExit(main())
