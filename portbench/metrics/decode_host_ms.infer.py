"""Host ms a batch in the greedy decoder's decode_ids, over the window."""

from portbench.harness import readers


def read(run):
    return readers.host_ms(run, "infer", "decode_s")
