"""The model's operations in the window's eval batches over the window's
seconds over the bf16 peak, in %."""

from portbench.harness import readers


def read(run):
    return readers.mfu_pct(run, "infer")
