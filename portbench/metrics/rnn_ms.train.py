"""Device ms a train step under the six recurrent layers' spans, forward
and backward."""

from portbench.harness import readers


def read(run):
    return readers.layer_ms(run, "train", "recurrence")
