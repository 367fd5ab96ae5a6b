"""Checkpoint inspection CLI (reference model.py:1070-1110 ``main``; the
JAX package's ``cli/info.py``, ported): prints the self-described metadata
of a checkpoint package written by either package.

    python -m deepspeech_tpu_torch.cli.info model.ckpt
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="DeepSpeech model information")
    p.add_argument("model_path", help="Path to model checkpoint")
    args = p.parse_args(argv)

    from deepspeech_tpu_torch.train import checkpoint as ckpt

    package = ckpt.load(args.model_path)
    print(f"Checkpoint: {args.model_path}")
    for key in ("version", "rnn_type", "hidden_size", "hidden_layers",
                "bidirectional", "bnm", "cnn_width", "dropout", "context",
                "epoch", "iteration", "checkpoint", "avg_loss"):
        if key in package and package[key] is not None:
            print(f"  {key}: {package[key]}")
    labels = package.get("labels", "")
    print(f"  labels ({len(labels)}): {labels!r}")
    print(f"  audio_conf: {package.get('audio_conf')}")
    n_params = sum(int(np.prod(np.shape(x)))
                   for x in _leaves(package.get("params", {})))
    print(f"  parameters: {n_params:,}")
    # embedded metric history (reference model.py:426-468)
    for k in ("loss_results", "wer_results", "cer_results"):
        vals = package.get(k)
        if vals is not None and len(vals):
            tail = ", ".join(f"{float(v):.3f}" for v in list(vals)[-5:])
            print(f"  {k} ({len(vals)} epochs): ... {tail}")
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    raise SystemExit(main())
