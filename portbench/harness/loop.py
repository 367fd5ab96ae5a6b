"""The closed loop that drives a cell's entry, and its measured window.

Each step pulls the next host batch from the port's loader, launches the
entry on it, then finishes the step before it: reads its outputs back on
the host (a loss, greedy ids) and decodes them, as the port's CLIs do
(``cli/train.py`` reads a step's metrics after queuing the next one,
``cli/test.py`` decodes batch N after queuing N + 1).

The window opens when the warm-up's last step is finished and closes at
the first pass boundary at or after ``seconds``: it holds whole passes of
the mix's bins, so every run does the same work, and a rate over it is
all the work over all the time.
"""

from __future__ import annotations

import contextlib
import time

clock = time.perf_counter


def no_span(name):
    return contextlib.nullcontext()


class Pipeline:
    """``launch(host batch) -> handle`` and ``finish(handle) -> record``
    over the ``batches`` iterator, one step in flight."""

    def __init__(self, launch, finish, batches, span=no_span):
        self.launch, self.finish = launch, finish
        self.batches, self.span = batches, span
        self.pending = None
        self.wait_s = 0.0  # host time in next() on the loader
        self.in_window = False

    def step(self):
        """Launch the next batch, then finish the one before -> its record
        (None on the first step)."""
        with self.span("pull"):
            t = clock()
            batch = next(self.batches)
            self.wait_s += clock() - t
        with self.span("launch"):
            handle = self.launch(batch)
        done = None
        if self.pending is not None:
            with self.span("finish"):
                done = self.finish(self.pending)
        self.pending = handle
        return done

    def drain(self):
        """Finish the step in flight -> its record (None if none)."""
        if self.pending is None:
            return None
        with self.span("finish"):
            done = self.finish(self.pending)
        self.pending = None
        return done


def window(pipe: Pipeline, per_pass: int, seconds: float) -> dict:
    """Whole passes of ``per_pass`` steps after the warm-up -> {"t0": the
    window's opening on the clock, "seconds", "records", "loader_wait_s"}.
    One step of the next pass is left in flight."""
    pipe.step()  # launches the window's first step, finishes the warm-up
    t0 = clock()
    wait0 = pipe.wait_s
    pipe.in_window = True
    records, passes = [], [t0]
    while True:
        records.append(pipe.step())
        if len(records) % per_pass == 0:
            passes.append(clock())
            if passes[-1] - t0 >= seconds:
                break
    pipe.in_window = False
    return {"t0": t0, "seconds": passes[-1] - t0, "records": records,
            "passes_s": [b - a for a, b in zip(passes, passes[1:])],
            "loader_wait_s": pipe.wait_s - wait0}
