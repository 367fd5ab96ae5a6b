"""Host ms a batch that the eval loop waits in next() on the port's
loader, over the window."""

from portbench.harness import readers


def read(run):
    return readers.host_ms(run, "infer", "loader_wait_s")
