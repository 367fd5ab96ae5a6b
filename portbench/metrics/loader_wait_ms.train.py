"""Host ms a train step that the loop waits in next() on the port's
loader, over the window."""

from portbench.harness import readers


def read(run):
    return readers.host_ms(run, "train", "loader_wait_s")
