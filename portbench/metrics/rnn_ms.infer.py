"""Device ms an eval batch under the recurrent layers' spans."""

from portbench.harness import readers


def read(run):
    return readers.layer_ms(run, "infer", "recurrence")
