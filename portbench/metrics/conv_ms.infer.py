"""Device ms an eval batch under the conv front's spans."""

from portbench.harness import readers


def read(run):
    return readers.layer_ms(run, "infer", "conv front")
