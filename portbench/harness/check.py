"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each held to its limit (``limits/<workload>.json``).

Training (the first three steps of the run, through the window's own call
and feed):

* ``loss_gap``: the widest gap of a step's loss, over the reference's;
* ``grad_gap``: over the parameters, the gap between the norm of the
  program's first gradient as its optimizer took it (SGD's momentum trace
  after one step, which is the clipped gradient) and the reference's,
  over the larger of the reference's norm of that parameter and the
  median parameter's;
* ``change_gap``: the same for the norm of each parameter's change over
  the three steps, leaving out the parameters whose reference gradient is
  under a thousandth of the median parameter's (nought to rounding: they
  move by round-off alone).

Evaluation (a sample of the utterances the window finished, drawn from
the seed, the longest among them):

* ``output_gap``: over the sampled utterances, the largest root mean
  square over an utterance's valid frames of the frame's gap: the wider of
  the program's log-posteriors' largest distance from the reference's and
  the distance of the program's greedy label's reference log-posterior
  below the reference's best (a label flipped at a near tie reads that
  tie's width, of the size of the log-posteriors' own gap; a label
  altered reads the distance to the best); infinite where an output
  length differs. The mean square over the frames keeps the number to the
  level of the whole utterance, where a lower precision moves every frame
  and an f32 program's rounding only a few; one altered label of a 35 s
  utterance still moves it far past the limit.
"""

from __future__ import annotations

import math

import numpy as np

RESTING = 1e-3  # a gradient under this share of the median leaf's


def _worst_leaf(prog: dict, ref: dict, names) -> float:
    med = float(np.median([ref[n] for n in ref]))
    return max((abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
                for n in names), default=0.0)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"loss": [per step], "grad": {name: norm},
    "change": {name: norm}}."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]) or not all(
            math.isfinite(x) for x in prog["loss"]):
        loss = math.inf
    med = float(np.median(list(ref["grad"].values())))
    moving = [n for n in ref["grad"] if ref["grad"][n] >= RESTING * med]
    return {"loss_gap": loss,
            "grad_gap": _worst_leaf(prog["grad"], ref["grad"], ref["grad"]),
            "change_gap": _worst_leaf(prog["change"], ref["change"],
                                      moving)}


def eval_numbers(prog: list, ref_logp, ref_lengths) -> dict:
    """``prog``: per sampled row {"probs" (T, C), "ids" (T,), "out_len"}
    as numpy; ``ref_logp`` (R, T', C) and ``ref_lengths`` (R,) numpy."""
    worst = 0.0
    for row, lp, n in zip(prog, ref_logp, ref_lengths):
        if int(row["out_len"]) != int(n):
            return {"output_gap": math.inf}
        n = int(n)
        lp = lp[:n].astype(np.float64)
        with np.errstate(divide="ignore"):
            gap = np.abs(np.log(row["probs"][:n].astype(np.float64)) - lp
                         ).max(-1)
        ids = row["ids"][:n].astype(np.int64)[:, None]
        tie = lp.max(-1) - np.take_along_axis(lp, ids, -1)[:, 0]
        rms = float(np.sqrt(np.mean(np.maximum(gap, tie) ** 2)))
        worst = max(worst, rms if math.isfinite(rms) else math.inf)
    return {"output_gap": worst}


def verdict(numbers: dict, limits: dict) -> tuple:
    """-> (correct, {name: {"value", "limit"}}); a number without a limit,
    or not finite, is not correct."""
    table = {n: {"value": v, "limit": limits.get(n)}
             for n, v in numbers.items()}
    ok = all(t["limit"] is not None and math.isfinite(t["value"])
             and t["value"] <= t["limit"] for t in table.values())
    return ok, table
