"""Device ms a Conformer train step under the subsampling's spans,
forward and backward."""

from portbench.harness import readers


def read(run):
    return readers.layer_ms(run, "train", "subsampling")
