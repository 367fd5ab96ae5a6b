"""The card's peak allocated memory over the eval run, in GiB."""

from portbench.harness import readers


def read(run):
    return readers.peak_gib(run, "infer")
