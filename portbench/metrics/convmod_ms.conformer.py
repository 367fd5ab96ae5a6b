"""Device ms a Conformer train step under the conv modules' spans,
forward and backward."""

from portbench.harness import readers


def read(run):
    return readers.layer_ms(run, "train", "conv module")
