"""The recurrent layers' least time over their device time in the traced
train pass, in %."""

from portbench.harness import readers


def read(run):
    return readers.recurrence_roofline(run, "train")
