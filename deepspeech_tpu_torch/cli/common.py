"""Shared CLI plumbing: checkpoint -> (model, labels, conf), the decoder
the flags ask for, and the multi-process rendezvous of the train and test
CLIs."""

from __future__ import annotations

import os

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


def refuse_conformer(model, what: str) -> None:
    """Exit where ``what`` (a streaming path) is handed a Conformer, whose
    attention reads the whole utterance."""
    from deepspeech_tpu_torch.models import Conformer

    if isinstance(model, Conformer):
        raise SystemExit(f"{what} streams the audio in chunks; a conformer "
                         "attends over the whole utterance and does not "
                         "stream: use test or transcribe without "
                         "--chunk-seconds")


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
                "KenLM .binary files are host-only; use --decoder beam, or "
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


def rendezvous(args):
    """The process group the ``--dist-*`` flags describe (``cli/train.py``'s
    docstring; the test CLI passes ``dist_init`` under torchrun) -> (rank,
    world size, init method), or None without one; nothing is joined
    here. Every incomplete spelling exits naming what is missing."""
    env = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
    if args.dist_init and args.dist_url:
        raise SystemExit("rendezvous: give --dist-init or --dist-url, not "
                         "both")
    if args.dist_init:
        missing = [k for k in env if k not in os.environ]
        if missing:
            raise SystemExit(f"rendezvous: --dist-init reads torchrun's "
                             f"environment (env://); {missing} not set")
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), \
            "env://"
    if not args.dist_url:
        if args.dist_rank != -1 or args.dist_world_size != 0:
            raise SystemExit("rendezvous: --dist-rank and --dist-world-size "
                             "act with --dist-url")
        return None
    if not 0 <= args.dist_rank < args.dist_world_size:
        raise SystemExit("rendezvous: --dist-url needs --dist-rank in "
                         "[0, --dist-world-size)")
    url = args.dist_url if "://" in args.dist_url else \
        "tcp://" + args.dist_url
    return args.dist_rank, args.dist_world_size, url


def rank_device(device: str, rank: int) -> torch.device:
    """A rank's device: ``--device`` as given, except that a bare ``cuda``
    becomes ``cuda:$LOCAL_RANK`` (torchrun's), else ``cuda:<rank % cards>``."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = rank % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", int(local))


def join_world(joined, device: str, backend: str = "auto", model: int = 1):
    """Join the process group ``rendezvous`` described (``joined``: rank,
    world size, init method) on the rank's device (``rank_device``) ->
    (device, its (data, model) mesh). ``backend`` is ``--dist-backend``:
    ``auto`` is NCCL on the card and gloo on the CPU."""
    from deepspeech_tpu_torch.device import resolve_device
    from deepspeech_tpu_torch.parallel import make_mesh

    rank, world, url = joined
    dev = resolve_device(rank_device(device, rank))
    if backend == "auto":
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise SystemExit(f"--dist-backend {backend!r}: choose auto, nccl "
                         "or gloo")
    if world % model:
        raise SystemExit(f"--mesh-model {model} does not divide the {world} "
                         "ranks")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(backend, init_method=url,
                                         rank=rank, world_size=world)
    return dev, make_mesh(model=model, device=dev)
