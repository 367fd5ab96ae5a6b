#!/usr/bin/env python3
"""Train steps of two checkouts of the port, in turns, on one CUDA card.

    python3 chip_ab.py [--log-dir DIR] [--ctc | --serve] TREE [TREE ...]

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

With ``--ctc`` each run times that tree's CTC kernels and layer instead, at
phase 6's train shape (B 20, T 376, C 30, L 150): K8 and K9 by device time
and by CUDA events around a call, the layer (loss + dlogits) both ways, and
one profiled pass of the layer: the kernels it launches on the card and the
top-level ATen ops it issues. It handles both kernel interfaces, the one
that takes (B, T, S) emissions and the one that takes log-probs and the
extended labels (K9 then also computes the logit gradient).

With ``--serve`` each run times that tree's serving path instead
(``chip_smoke.py``'s ``phase_serve``: the pool's greedy and device-beam
ticks): each tick's p50 and p95 in ms and the steady audio seconds a
second, as that run printed them.
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
                      **c.conv_launches(steps=1),
                      **{f"{cell}_fwd_res": fused, f"{cell}_scan_res": wide,
                         f"{cell}_bwd": c.LAYERS}))
"""
RUN_CTC = r"""
import inspect, json
import numpy as np
import torch
import chip_smoke as c
from deepspeech_tpu_torch.ops import ctc as L
from deepspeech_tpu_torch.ops.cuda import build, ctc

build.build_all(("ctc",), force=True)
logits, ll, targets, tl = c.ctc_inputs(torch, np.random.default_rng(c.SEED + 5))
ones = torch.ones(logits.shape[0], device="cuda")
if "log_probs" in inspect.signature(ctc.ctc_alpha).parameters:
    lp, ext = L._prep(logits, targets, 0)
    alphas, loss = ctc.ctc_alpha(lp, ext, tl, ll)
    k8 = lambda: ctc.ctc_alpha(lp, ext, tl, ll)
    k9 = lambda: ctc.ctc_beta(lp, ext, tl, ll, alphas, loss, ones)
else:
    _, _, skip, valid, end, emit = L._prep(logits, targets, tl, 0)
    k8 = lambda: ctc.ctc_alpha(emit, skip, valid, ll)
    k9 = lambda: ctc.ctc_beta(emit, skip, valid, end, ll)


def layer():
    lg = logits.clone().requires_grad_(True)
    per = L.ctc_loss(lg, ll, targets, tl)
    return torch.autograd.grad(
        torch.where(torch.isfinite(per), per, 0.0).sum(), lg)


out = {"k8_device_ms": c.device_ms(k8), "k9_device_ms": c.device_ms(k9),
       "k8_ms": c.time_ms(k8, reps=20), "k9_ms": c.time_ms(k9, reps=20),
       "layer_device_ms": c.device_ms(layer, reps=20),
       "layer_ms": c.time_ms(layer)}
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    layer()
    torch.cuda.synchronize()
ev = p.events()
out["aten_ops"] = sum(
    1 for e in ev if e.name.startswith("aten::") and (
        e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))
out["device_kernels"] = sum(
    1 for e in ev if e.device_type == torch.autograd.DeviceType.CUDA
    and not e.name.startswith("Memcpy") and not e.name.startswith("Memset"))
print("CTC " + json.dumps(out), flush=True)
"""
RUN_SERVE = r"""
import json
import torch
import chip_smoke as c
from deepspeech_tpu_torch.ops.cuda import build

build.build_all(force=True)
out = c.phase_serve(torch, c.step_floor(torch))
keys = ("tick_p50_ms", "tick_p95_ms", "steady_audio_s_per_s")
print("SERVE " + json.dumps({k: {x: v[x] for x in keys} for k, v in out.items()
                             if isinstance(v, dict) and "tick_p50_ms" in v}),
      flush=True)
"""
STEP = re.compile(r"^(\w+-\d+) train path: ([\d.]+) ms per step")


def run(trees, log_dir: str, what: str = "train") -> int:
    runs = []
    code = {"train": RUN, "ctc": RUN_CTC, "serve": RUN_SERVE}[what]
    for i, tree in enumerate(trees):
        tag = "" if what == "train" else f"_{what}"
        path = os.path.join(log_dir, f"ab{tag}_{i}.log")
        with open(path, "w") as log:
            rc = subprocess.run([sys.executable, "-c", code],
                                cwd=os.path.abspath(tree), stdout=log,
                                stderr=subprocess.STDOUT).returncode
        with open(path) as log:
            lines = log.read().splitlines()
        if what != "train":
            head = what.upper() + " "
            found = [json.loads(x[len(head):]) for x in lines
                     if x.startswith(head)]
            result = {what: found[-1] if found else None}
        else:
            result = {"step_ms": {m.group(1): float(m.group(2))
                                  for m in map(STEP.match, lines) if m}}
        print(f"run {i} ({tree}): rc {rc}, {result}", flush=True)
        if rc != 0:
            print("\n".join(lines[-30:]), file=sys.stderr)
            return 1
        runs.append({"tree": tree, **result})
    print(json.dumps({"runs": runs}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-dir", help="keep each run's log here")
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--ctc", action="store_const", const="ctc",
                      dest="what", help="time the CTC kernels and layer, "
                      "not the steps")
    what.add_argument("--serve", action="store_const", const="serve",
                      dest="what", help="time the serving path's ticks, "
                      "not the steps")
    ap.add_argument("trees", nargs="+", help="checkout roots, in turns")
    args = ap.parse_args(argv)
    what = args.what or "train"
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        return run(args.trees, args.log_dir, what)
    with tempfile.TemporaryDirectory() as log_dir:
        return run(args.trees, log_dir, what)


if __name__ == "__main__":
    raise SystemExit(main())
