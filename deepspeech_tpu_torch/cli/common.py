"""Shared inference-CLI plumbing: checkpoint -> (model, labels, conf)."""

from __future__ import annotations

import torch

from deepspeech_tpu_torch.audio.features import AudioConf
from deepspeech_tpu_torch.convert import jax_to_torch
from deepspeech_tpu_torch.decoders import GreedyDecoder
from deepspeech_tpu_torch.models import model_from_meta
from deepspeech_tpu_torch.text.labels import Labels
from deepspeech_tpu_torch.train import checkpoint as ckpt


def load_inference_model(path: str, device: str | torch.device = "cuda"):
    """Load a checkpoint package (written by either package) for
    inference: model + labels + audio_conf all come from the file.

    Returns (f32 model in eval mode on ``device``, labels, audio_conf,
    package), f32 as the JAX CLI runs."""
    package = ckpt.load(path)
    model = model_from_meta(package, device=device)
    model.load_state_dict(jax_to_torch(package["params"],
                                       package["batch_stats"]))
    model.eval()
    labels = Labels(package["labels"])
    # augmentations off at inference (reference test.py:60-63)
    conf_dict = {**package["audio_conf"], "noise_dir": None, "noise_prob": 0,
                 "aug_prob_8khz": 0, "aug_prob_spect": 0}
    return model, labels, AudioConf.from_dict(conf_dict), package


def build_decoder(args, labels):
    """The greedy decoder; the beam decoders come in a later slice."""
    decoder = getattr(args, "decoder", "greedy")
    if decoder != "greedy":
        raise SystemExit(
            f"--decoder {decoder}: the PyTorch port has the greedy decoder "
            "only; the host and device beam decoders are a later slice "
            "(see ROADMAP.md)")
    return GreedyDecoder(labels.labels, blank_index=labels.blank_index)
