#!/usr/bin/env python3
"""Where a step of the W-resident bf16 fused forwards (K2, K3) goes, on one
CUDA card.

    python3 chip_stamps.py

Builds csrc/gru_fwd.cu and csrc/lstm_fwd.cu with -DDS_STEP_STAMPS (the
phase stamps of csrc/rnn_mma.cuh's resident_kernel) into
deepspeech_tpu_torch/_build/stamps/, runs K2 and K3 in the W-resident
variant with residuals at T 376, H 800, F 1312, B 20 and 64, every row of
full length, and prints for thread 0 of blocks 0 and 24 of direction 0
the median SM cycles of each phase of steps 100-163: the bulk copies'
issue, each column group's arrival, the product's tail, the K-split sums,
the epilogue, then the next step's projection load, the proxy fence and
the grid barrier with the blocks' skew. Then the card's name, power limit
and SM clock. The call time printed is the stamped build's (a stamp is one
clock read and one store by one thread). Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

T, H, F = 376, 800, 1312


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_stamps: torch.cuda.is_available() is false; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as c
    from deepspeech_tpu_torch.ops.cuda import build, gru, lstm
    from deepspeech_tpu_torch.ops.cuda.recurrence import RES_HCH

    build.NVCC_FLAGS = build.NVCC_FLAGS + ("-DDS_STEP_STAMPS",)
    build.BUILD_DIR = os.path.join(build.BUILD_DIR, "stamps")
    build.build_all(("gru_fwd", "lstm_fwd"), force=True)
    phases = (["bulk copies issued"]
              + [f"column group {g} in" for g in range(RES_HCH)]
              + ["the product's tail", "the K-split sums", "the epilogue",
                 "x load, fence, grid barrier"])
    points = 5 + RES_HCH
    for cell, mod in (("gru", gru), ("lstm", lstm)):
        lib = mod._fwd_kernel()
        lib.ds_read_stamps.argtypes = [ctypes.c_void_p]
        lib.ds_read_stamps.restype = ctypes.c_int
        layer = gru.gru_layer if cell == "gru" else lstm.lstm_layer
        for b in (20, 64):
            rng = np.random.default_rng(c.SEED)
            x, w_ih, b_ih, w_hh, b_hh, lens = c.layer_inputs(
                torch, rng, T, b, H, F, 3 if cell == "gru" else 4)
            lens[:] = T
            dt = torch.bfloat16
            args = (x.to(dt), w_ih.to(dt), b_ih, w_hh.to(dt), b_hh, lens)
            ms = c.time_ms(lambda: layer(*args, residuals=True,
                                         variant="resident"), reps=5)
            st = np.zeros((2, 64, points), np.int64)
            build.check(lib, lib.ds_read_stamps(st.ctypes.data),
                        "ds_read_stamps")
            for blk, name in enumerate(("block 0", "block 24")):
                s = st[blk].astype(np.float64)
                steps = np.diff(s[:, 0])
                cycles = [np.median(s[:, k + 1] - s[:, k])
                          for k in range(points - 1)]
                cycles.append(np.median(s[1:, 0] - s[:-1, points - 1]))
                c.log(f"{cell} B {b} {name}: a call {ms:.3f} ms; a step "
                      f"{np.median(steps):.0f} SM cycles (median of steps "
                      "100-163): "
                      + ", ".join(f"{p} {v:.0f} ({v / np.median(steps):.1%})"
                                  for p, v in zip(phases, cycles)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    c.log(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
