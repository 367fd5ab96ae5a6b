"""Shared inference-CLI plumbing: checkpoint -> (model, labels, conf)."""

from __future__ import annotations

import torch

from deepspeech_tpu_torch.audio.features import AudioConf
from deepspeech_tpu_torch.convert import jax_to_torch
from deepspeech_tpu_torch.decoders import (BeamCTCDecoder,
                                           DeviceBeamCTCDecoder,
                                           GreedyDecoder)
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
    """Greedy, host beam, or beam on ``args.device`` per CLI flags
    (reference test.py:73-83)."""
    decoder = getattr(args, "decoder", "greedy")
    if decoder == "device_beam":
        try:
            return DeviceBeamCTCDecoder(
                labels.labels, beam_width=args.beam_width,
                cutoff_top_n=args.cutoff_top_n, cutoff_prob=args.cutoff_prob,
                top_paths=args.top_paths, blank_index=labels.blank_index,
                lm_path=getattr(args, "lm_path", None),
                alpha=args.alpha, beta=args.beta,
                device=getattr(args, "device", "cuda"))
        except ValueError as e:
            raise SystemExit(
                f"--decoder device_beam: {e}\n"
                "KenLM .binary files are not read by the PyTorch port; "
                "convert the textual ARPA to a DSLM file "
                "(python -m deepspeech_tpu_torch.decoders.lm_binary) for "
                "the LM-fused device search.") from e
    if decoder == "beam":
        try:
            return BeamCTCDecoder(
                labels.labels, lm_path=args.lm_path, alpha=args.alpha,
                beta=args.beta, cutoff_top_n=args.cutoff_top_n,
                cutoff_prob=args.cutoff_prob, beam_width=args.beam_width,
                num_processes=args.lm_workers, top_paths=args.top_paths,
                blank_index=labels.blank_index,
                blank_collapse_threshold=getattr(args, "blank_collapse",
                                                 1.0))
        except ValueError as e:
            raise SystemExit(f"--decoder beam: {e}") from e
    return GreedyDecoder(labels.labels, blank_index=labels.blank_index)
