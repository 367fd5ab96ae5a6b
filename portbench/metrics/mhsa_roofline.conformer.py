"""The attention layers' least time (``harness/counts_conformer.py``)
over their device time in the traced train pass, in %."""

from portbench.harness import counts, counts_conformer, readers


def read(run):
    ms = readers.layer_ms(run, "train", "self-attention")
    if not ms or not run.traced_samples or "d_model" not in run.cfg:
        return None
    flops, nbytes = counts_conformer.attention_work(run.traced_samples,
                                                    run.cfg, True)
    return 100.0 * counts.least_seconds(flops, nbytes) / (
        ms * run.traced_steps / 1e3)
