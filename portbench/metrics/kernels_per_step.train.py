"""Device kernels a train step in the traced pass (eager dispatch)."""

from portbench.harness import readers


def read(run):
    return readers.kernels(run, "train")
