"""The model's operations in the window's train steps over the window's
seconds over the bf16 peak, in %."""

from portbench.harness import readers


def read(run):
    return readers.mfu_pct(run, "train")
