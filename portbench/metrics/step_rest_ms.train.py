"""Device ms a train step outside the conv front's and the recurrent
layers' spans: K1, the head, CTC, the optimizer, copies."""

from portbench.harness import readers


def read(run):
    return readers.rest_ms(run, "train", ("conv front", "recurrence"))
