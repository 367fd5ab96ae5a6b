"""The device's idle share of the traced eval pass, in %."""

from portbench.harness import readers


def read(run):
    return readers.idle_pct(run, "infer")
