"""The benchmark's hold on the program under test, ``deepspeech_tpu_torch``:
its front-end settings, its model loaded with the benchmark's weights, its
dataset and loader over the generated files. The program is imported
here, inside the functions, once the run has set its environment."""

from __future__ import annotations

import os

import torch


def audio_conf(cfg: dict):
    from deepspeech_tpu_torch.audio.features import AudioConf

    return AudioConf(sample_rate=cfg["sample_rate"],
                     window_size=cfg["window_size"],
                     window_stride=cfg["window_stride"],
                     window=cfg["window"])


def labels(cfg: dict):
    from deepspeech_tpu_torch.text.labels import Labels

    return Labels(cfg["labels"])


def model(cfg: dict, weights: dict, device: torch.device):
    """The port's model of the configuration, built on ``device``, with the
    benchmark's weights copied in (every name and shape must match)."""
    from deepspeech_tpu_torch.models import build_model

    with torch.device(device):
        net, _ = build_model(
            cfg["rnn_type"], num_classes=cfg["num_classes"],
            hidden_size=cfg["hidden_size"],
            hidden_layers=cfg["hidden_layers"],
            bidirectional=cfg["bidirectional"], bnm=cfg["bnm"],
            compute_dtype=cfg["compute_dtype"], device=device)
    net.load_state_dict(weights, strict=True)
    return net


def dataset(cfg: dict, manifest: str):
    from deepspeech_tpu_torch.data import AudioDataset

    return AudioDataset(audio_conf(cfg), manifest, labels(cfg),
                        normalize=cfg["normalize"])


def loader(data, cfg: dict, mix: dict, bins: list):
    """The port's threaded loader over ``bins`` (lists of manifest rows),
    padded to the mix's bucket on its wire."""
    from deepspeech_tpu_torch.data import AudioDataLoader, BucketSpec

    conf = audio_conf(cfg)
    bucket = BucketSpec(
        audio_step=int(cfg["sample_rate"] * mix["bucket_seconds"]),
        reflect_tail=conf.n_fft // 2, wire_dtype=mix["wire"])
    return AudioDataLoader(data, bins, mix["batch"], bucket,
                           mix["loader_workers"])


def decoder(cfg: dict):
    from deepspeech_tpu_torch.decoders import GreedyDecoder

    lab = labels(cfg)
    return GreedyDecoder(lab.labels, blank_index=lab.blank_index)


def to_device(batch: dict, device: torch.device) -> dict:
    """A host batch's arrays on the device, queued (the CLIs' copy)."""
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items() if k != "paths"}


def row_index(path: str) -> int:
    """A generated utterance's manifest row, from its file name."""
    return int(os.path.basename(path).split(".")[0])


def build_all() -> dict:
    """Build (or find built) the port's kernel libraries -> {name: nvcc
    output} of the ones built now."""
    from deepspeech_tpu_torch.ops.cuda import build

    return build.build_all()
