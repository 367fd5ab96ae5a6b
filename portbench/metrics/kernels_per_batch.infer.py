"""Device kernels an eval batch in the traced pass."""

from portbench.harness import readers


def read(run):
    return readers.kernels(run, "infer")
