"""On the card, at each cell's own size: the program comes out correct,
and the control (the reference one precision step below the
configuration's, in the program's place) and each fault do not.

    python -m pytest portbench/tests/test_portbench_card.py -m cuda -q

(about a minute a cell; it skips where there is no card)."""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import types

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from portbench import calibrate, run  # noqa: E402
from portbench.harness import check, program, spec  # noqa: E402

SEED = 2 ** 31 + 777


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["train-gru800-b20-ls100",
                                      "eval-gru1600-b64-testclean"])
def test_program_passes_and_control_and_faults_fail(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    program.build_all()
    cell_spec = spec.cell(spec.benchmark(), workload)
    entry = spec.entry(cell_spec["traffic"]["entry"])
    readings = (calibrate.train_readings if entry.Cell.kind == "train"
                else calibrate.eval_readings)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        ns = types.SimpleNamespace(seed=SEED, seconds=0.0, trace=0)
        cell = entry.Cell(run.Context(cell_spec, ns,
                                      torch.device("cuda", 0), tmp))
        out = readings(cell, control=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    limits = cell_spec["limits"]
    assert check.verdict(out.pop("program"), limits)[0], out
    out.pop("cudnn_f32", None)  # a witness, not a fault
    for kind, numbers in out.items():
        assert not check.verdict(numbers, limits)[0], (kind, numbers)
