"""The Conformer's operations (``harness/counts_conformer.py``) in the
window's train steps over the window's seconds over the bf16 peak, in %."""

from portbench.harness import counts, counts_conformer


def read(run):
    if run.kind != "train" or not run.window["records"] or (
            "d_model" not in run.cfg):
        return None
    samples = [n for r in run.window["records"] for n in r["samples"]]
    return 100.0 * counts_conformer.model_flops(samples, run.cfg, True) / (
        run.window["seconds"] * counts.PEAK_BF16)
