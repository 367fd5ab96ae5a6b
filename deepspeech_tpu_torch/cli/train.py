"""Training CLI: the JAX package's ``cli/train.py`` on one card or on
several, one process a card.

    python -m deepspeech_tpu_torch.cli.train --train-manifest train.csv \\
        --val-manifest val.csv [--epochs 70 --batch-size 20 --device cuda]
    torchrun --nproc-per-node 8 -m deepspeech_tpu_torch.cli.train \\
        --train-manifest train.csv --val-manifest val.csv --dist-init \\
        [--mesh-model M] [--steps-per-dispatch k]

Epochs over the train manifest: before each, the dataset's epoch list is
set (all rows, or with ``--use-curriculum`` the rows drawn by curriculum
probability, at least ``--curriculum-ratio`` of the manifest) and
shuffled by the epoch, as the JAX CLI does; then SortaGrad order on epoch
0 and shuffled bins after. One ``train_step`` per batch (the noise mix ->
featurize with its masks and jitter -> forward -> CTC -> backward -> clip
-> NaN guard -> SGD/Adam); each step's metrics are read back after the
next step is queued, as the JAX loop does, and its greedy ids decoded into
the train curriculum store. A log line every 10 iterations, greedy
validation loss/WER/CER at each epoch's end (which updates the val store;
``--train-val-manifest`` adds a train-val pass with its own store), the
LR annealed by ``--learning-anneal``, ``best_model.ckpt`` by WER + CER and
``deepspeech_final.ckpt`` in ``--save-folder``; ``--checkpoint`` adds one
a epoch, ``--checkpoint-per-samples`` mid-epoch ones (each validated,
``--checkpoint-anneal`` dividing the LR). Every checkpoint writes the
curriculum sidecars. Checkpoints are the JAX package's zip container with
the optimizer state as optax's leaves: both packages' ``transcribe`` load
them, and each package's ``--continue-from`` resumes the other's (mid-epoch
ones inside their epoch, through ``AudioDataLoader.iter_from``);
``--finetune`` takes the weights only.

``--rnn-type conformer`` trains a Conformer-CTC (``models/conformer.py``)
of the ``--conformer-*`` sizes over a log-mel front of
``--conformer-n-mels`` bands, data parallel only: ``--mesh-model`` > 1
exits. ``--adam-beta2`` and ``--adam-eps`` set Adam's (optax's defaults
unless given); a checkpoint carries them and a resume takes them back.

Augmentation as the JAX CLI: ``--augment`` runs the host waveform
pipeline (``--aug-type``) with the per-sample RNG seeded from (seed,
epoch, index); ``--aug-prob-spect`` and ``--aug-prob-8khz`` mask the
spectrogram on the card; ``--device-noise`` uploads the ``--noise-dir``
bank once and mixes it in the step. The step draws from a
``torch.Generator`` seeded with ``--seed``.

The JSONL metric log goes to ``<--log-dir>/<--id>.jsonl`` with the JAX
CLI's event names and keys (``--visdom`` adds the HTML dashboard,
``--tensorboard`` mirrors to TensorBoard where it imports, ``--log-params``
adds parameter and gradient summaries every 100 steps); ``--profile-dir``
writes a ``torch.profiler`` Chrome trace of ``--profile-steps`` steps from
``--profile-start``, with the port's spans in it and their summary beside
it (``Profiler``). ``main(argv, observers)`` fires the observers' hooks
as the JAX CLI does.

Several cards (``parallel/``): the rendezvous is ``--dist-init``
(torchrun's ``env://`` variables) or ``--dist-url`` (``tcp://host:port``,
bare ``host:port`` as the JAX CLI spells it, or ``file://path``) with
``--dist-rank`` and ``--dist-world-size``; ``--dist-backend`` picks NCCL or
gloo (``auto``: NCCL for the card, gloo for the CPU). Each rank runs on
``cuda:$LOCAL_RANK`` (else ``cuda:<rank % cards>``), or on the CPU with
``--device cpu``. The ranks form a (data, model) mesh with ``--mesh-model``
ranks a data shard: ``--batch-size`` stays the global batch, each shard
takes ``batch // data`` rows from rank-strided bins
(``DistributedBucketingSampler`` by data index), every shard pads alike,
and the step all-reduces what the JAX SPMD step sums (``train/step.py``).
Every model key runs at every ``--mesh-model`` M that divides the world:
each rank of a data shard stores its slice of the tensors the JAX rule
shards (``parallel/mesh.py:param_spec``: an RNN layer's direction axis
where it divides, else its gate axis; the head's classes, or a ConvStack
head's input channels) and of their moments, and gathers each whole
before the layer that reads it (at M 2, a bidirectional layer runs one
direction a rank instead). Validation is sharded and its counters summed.
Rank 0 alone prints, logs, fires the observers, profiles and writes
checkpoints (whole, gathered over the model group; a whole checkpoint,
of either package, resumes at any M by slicing), with its own curriculum
stores as sidecars; each rank feeds its rows to its stores, and a
``--use-curriculum`` epoch draw is rank 0's.

``--steps-per-dispatch k`` > 1: groups of up to k batches of one shape
(a bucket switch or the epoch's end closes a group early; on a mesh each
batch is padded alike first, so every rank closes its groups alike),
stacked on the host and copied to the card as one superbatch; each
microbatch a train step (``make_multi_train_step``), on the card the first
of a shape eagerly and the others as replays of its CUDA graph
(``train/graph.py``), with the same draws from the generator; the group's
metrics read back once and accounted microbatch by microbatch as at k=1,
mid-epoch checkpoints checked after each group. On several ranks the
collectives are captured with the step where every group is NCCL's; over
gloo the lanes run eagerly (logged once). The ranks must share one
machine, as the JAX CLI runs k > 1 over one host's devices: ranks on
several machines exit at the join.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

import numpy as np
import torch

from deepspeech_tpu_torch.cli.args import add_reference_noop_args
from deepspeech_tpu_torch.cli.common import rendezvous
from deepspeech_tpu_torch.ops.cuda import read_counters
from deepspeech_tpu_torch.utils import trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DeepSpeech training "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--train-manifest", default="data/train_manifest.csv")
    p.add_argument("--val-manifest", default="data/val_manifest.csv")
    p.add_argument("--train-val-manifest", default="",
                   help="held-out slice of train data for quality tracking")
    p.add_argument("--cache-dir", default="data/cache/",
                   help="accepted for flag parity; unused")
    p.add_argument("--curriculum", default="",
                   help="curriculum CSV sidecar to preload the train "
                        "store from")
    p.add_argument("--use-curriculum", action="store_true",
                   help="draw each epoch's utterances by curriculum "
                        "probability")
    p.add_argument("--curriculum-ratio", default=0.5, type=float,
                   help="least share of the manifest an epoch draws")
    p.add_argument("--sample-rate", default=16000, type=int)
    p.add_argument("--batch-size", default=20, type=int)
    p.add_argument("--val-batch-size", default=20, type=int)
    p.add_argument("--num-workers", default=4, type=int)
    p.add_argument("--labels-path", default="labels.json")
    p.add_argument("--window-size", default=0.02, type=float)
    p.add_argument("--window-stride", default=0.01, type=float)
    p.add_argument("--window", default="hamming")
    p.add_argument("--norm", default="max_frame",
                   help='"mean", "norm", "frame", "max_frame" or "none"')
    # model
    p.add_argument("--hidden-size", default=800, type=int)
    p.add_argument("--hidden-layers", default=6, type=int)
    p.add_argument("--rnn-type", default="gru",
                   help="gru, lstm, rnn, a CNN: cnn, cnn_residual, "
                        "glu_small, glu_large, large_cnn, cnn_jasper, or "
                        "conformer")
    p.add_argument("--conformer-d-model", default=512, type=int,
                   help="acts with --rnn-type conformer")
    p.add_argument("--conformer-heads", default=8, type=int,
                   help="acts with --rnn-type conformer")
    p.add_argument("--conformer-layers", default=17, type=int,
                   help="acts with --rnn-type conformer")
    p.add_argument("--conformer-ff", default=2048, type=int,
                   help="feed-forward width; acts with --rnn-type conformer")
    p.add_argument("--conformer-kernel", default=32, type=int,
                   help="depthwise conv kernel; acts with --rnn-type "
                        "conformer")
    p.add_argument("--conformer-n-mels", default=80, type=int,
                   help="log-mel bands of its front; acts with --rnn-type "
                        "conformer")
    p.add_argument("--cnn-width", default=256, type=int)
    p.add_argument("--dropout", default=0, type=float)
    p.add_argument("--no-bidirectional", dest="bidirectional",
                   action="store_false", default=True)
    p.add_argument("--batch-norm-momentum", default=0.1, type=float)
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="matmul operand type (weights stay float32)")
    # optimization
    p.add_argument("--epochs", default=70, type=int)
    p.add_argument("--lr", "--learning-rate", default=3e-4, type=float)
    p.add_argument("--optimizer", default="sgd", help="sgd or adam")
    p.add_argument("--weight-decay", default=0, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--adam-beta2", default=0.999, type=float,
                   help="acts with --optimizer adam")
    p.add_argument("--adam-eps", default=1e-8, type=float,
                   help="acts with --optimizer adam")
    p.add_argument("--max-norm", default=100, type=float,
                   help="gradient norm clip")
    p.add_argument("--learning-anneal", default=1.1, type=float)
    p.add_argument("--checkpoint-anneal", default=1.0, type=float,
                   help="LR anneal at each mid-epoch checkpoint (acts with "
                        "--checkpoint-per-samples)")
    p.add_argument("--silent", action="store_true")
    # checkpointing
    p.add_argument("--checkpoint", action="store_true",
                   help="save a checkpoint every epoch")
    p.add_argument("--checkpoint-per-samples", default=0, type=int,
                   help="a mid-epoch checkpoint every this many samples")
    p.add_argument("--save-folder", default="models/")
    p.add_argument("--continue-from", default="",
                   help="resume from a checkpoint of either package")
    p.add_argument("--finetune", action="store_true",
                   help="with --continue-from: the weights only, a fresh "
                        "optimizer")
    # augmentation
    p.add_argument("--augment", action="store_true")
    p.add_argument("--noise-dir", default=None)
    p.add_argument("--noise-prob", default=0.4, type=float,
                   help="acts with --noise-dir or --device-noise")
    p.add_argument("--noise-min", default=0.0, type=float)
    p.add_argument("--noise-max", default=0.5, type=float)
    p.add_argument("--device-noise", action="store_true",
                   help="mix the --noise-dir pool (+ gaussian) into the "
                        "waveforms in the train step at --noise-prob")
    p.add_argument("--device-noise-limit", default=0.2, type=float,
                   help="acts with --device-noise")
    p.add_argument("--aug-prob-8khz", default=0, type=float)
    p.add_argument("--aug-type", default=0, type=int, choices=[0, 1, 2, 3],
                   help="waveform augmentation pipeline; acts with "
                        "--augment")
    p.add_argument("--aug-prob-spect", default=0, type=float)
    # sampling
    p.add_argument("--no-shuffle", action="store_true")
    p.add_argument("--no-sortaGrad", dest="no_sorta_grad",
                   action="store_true")
    p.add_argument("--reverse-sort", dest="reverse_sort",
                   action="store_true",
                   help="longest utterances first on the SortaGrad epoch")
    # observability
    p.add_argument("--tensorboard", action="store_true",
                   help="mirror the metric log to TensorBoard where "
                        "torch.utils.tensorboard imports")
    p.add_argument("--visdom", dest="live_html", action="store_true",
                   help="live loss/WER/CER curves in a self-refreshing "
                        "<log-dir>/<id>.html dashboard")
    p.add_argument("--enorm", action="store_true",
                   help="accepted for reference-flag parity; no-op")
    p.add_argument("--log-dir", default="visualize/deepspeech_final",
                   help="directory of the JSONL metric log")
    p.add_argument("--log-params", action="store_true",
                   help="parameter and gradient summaries every 100 steps")
    p.add_argument("--id", default="Deepspeech training",
                   help="name of the JSONL metric log")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler Chrome trace to this dir")
    p.add_argument("--profile-start", default=10, type=int,
                   help="acts with --profile-dir")
    p.add_argument("--profile-steps", default=5, type=int,
                   help="acts with --profile-dir")
    p.add_argument("--seed", default=123456, type=int)
    # device / batching
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda)")
    p.add_argument("--mesh-model", default=1, type=int,
                   help="tensor-parallel width M, dividing the world: "
                        "each rank of a data shard stores its slice of the "
                        "RNN tensors and the head that the JAX rule shards")
    p.add_argument("--steps-per-dispatch", default=1, type=int,
                   help="k same-shape batches a group: the first batch of "
                        "a shape runs eagerly, the rest as replays of its "
                        "CUDA graph (eagerly over gloo), read back once a "
                        "group; numerics as k=1; ranks of one machine")
    p.add_argument("--bucket-audio-seconds", default=1.0, type=float,
                   help="audio padding granularity")
    p.add_argument("--wire-dtype", default="int16",
                   choices=["int16", "float32", "mulaw8"],
                   help="host->device waveform format")
    p.add_argument("--max-items", default=0, type=int,
                   help="truncate manifests (debug)")
    # multi-GPU rendezvous
    p.add_argument("--dist-url", default="",
                   help="tcp://host:port, host:port or file://path; acts "
                        "with --dist-rank and --dist-world-size")
    p.add_argument("--dist-rank", "--rank", dest="dist_rank", default=-1,
                   type=int)
    p.add_argument("--dist-world-size", "--world-size",
                   dest="dist_world_size", default=0, type=int)
    p.add_argument("--dist-init", action="store_true",
                   help="rendezvous from torchrun's environment (env://)")
    add_reference_noop_args(p)
    return p


# the metric history every checkpoint carries (JAX cli/train.py:474-480)
HIST_KEYS = ("loss_results", "wer_results", "cer_results",
             "checkpoint_loss_results", "checkpoint_wer_results",
             "checkpoint_cer_results", "trainval_checkpoint_loss_results",
             "trainval_checkpoint_wer_results",
             "trainval_checkpoint_cer_results")


def check_ported(args) -> None:
    """Refuse the flag values no path takes, before any rendezvous is
    joined (an incomplete rendezvous, a --mesh-model below 1)."""
    rendezvous(args)
    if args.mesh_model < 1:
        raise SystemExit("--mesh-model must be 1 or more")
    if args.rnn_type == "conformer" and args.mesh_model > 1:
        raise SystemExit("--rnn-type conformer trains data parallel only: "
                         "--mesh-model must be 1")


def check_one_machine(mesh) -> None:
    """``--steps-per-dispatch`` > 1 on several ranks runs on one machine,
    as the JAX CLI runs it over one host's devices and refuses it across
    hosts (``deepspeech_tpu/cli/train.py:438-443``): every rank's host
    name, gathered once at the join; every rank exits alike."""
    import socket

    hosts = mesh.all_gather_object(socket.gethostname(), tag="hosts")
    if len(set(hosts)) > 1:
        raise SystemExit("--steps-per-dispatch > 1 runs on the ranks of "
                         f"one machine; these span {sorted(set(hosts))}")


def init_distributed(args):
    """The rendezvous, the rank's device and the mesh -> (device, mesh),
    mesh None on one process (``common.join_world``)."""
    from deepspeech_tpu_torch.cli.common import join_world
    from deepspeech_tpu_torch.device import resolve_device

    joined = rendezvous(args)
    if joined is None:
        if args.mesh_model > 1:
            raise SystemExit(f"--mesh-model {args.mesh_model} needs "
                             f"{args.mesh_model} ranks or more: launch with "
                             "torchrun and --dist-init, or --dist-url")
        return resolve_device(args.device), None
    return join_world(joined, args.device, args.dist_backend,
                      args.mesh_model)


def _labels_path(path: str) -> str:
    """The cwd-relative default falls back to the copy at the repo root."""
    if path == "labels.json" and not os.path.exists(path):
        shipped = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), "labels.json")
        if os.path.exists(shipped):
            return shipped
    return path


def audio_conf_from_args(args, train: bool):
    """The front end's AudioConf; the augmentation fields only for
    training (JAX ``cli/train.py:187-196``)."""
    from deepspeech_tpu_torch.audio.features import AudioConf

    n_mels = args.conformer_n_mels if args.rnn_type == "conformer" else 0
    return AudioConf(
        sample_rate=args.sample_rate, window_size=args.window_size,
        window_stride=args.window_stride, window=args.window,
        noise_dir=args.noise_dir if train else None,
        noise_prob=args.noise_prob if train else 0,
        noise_levels=(args.noise_min, args.noise_max),
        aug_prob_8khz=args.aug_prob_8khz if train else 0,
        aug_prob_spect=args.aug_prob_spect if train else 0,
        n_mels=n_mels)


def sampler_for(n: int, batch_size: int, mesh):
    """Bins of ``batch_size`` over ``n`` rows: this data shard's
    rank-strided share on a mesh of several data shards (JAX
    ``cli/train.py:355-363, 615-620``), else all of them."""
    from deepspeech_tpu_torch.data import (BucketingSampler,
                                           DistributedBucketingSampler)

    if mesh is not None and mesh.data > 1:
        return DistributedBucketingSampler(n, batch_size, mesh.data,
                                           mesh.data_index)
    return BucketingSampler(n, batch_size)


def share_epoch_draw(dataset, mesh) -> None:
    """Every rank takes rank 0's curriculum draw of the epoch (the ranks'
    stores hold different rows, so their own draws could differ in length):
    its row indices broadcast from rank 0."""
    index = {row: i for i, row in enumerate(dataset.all_ids)}
    n = mesh.broadcast(torch.tensor([len(dataset.ids)], device=mesh.device))
    ids = torch.tensor([index[row] for row in dataset.ids]
                       if mesh.is_leader else [0] * int(n),
                       dtype=torch.int64, device=mesh.device)
    dataset.ids = [dataset.all_ids[i] for i in mesh.broadcast(ids).tolist()]


def epoch_loader(dataset, epoch: int, args, bucket, mesh=None):
    """The train loader of one epoch (JAX ``cli/train.py:612-633``): the
    dataset's epoch list first, then SortaGrad (no shuffle on epoch 0,
    reference train.py:89-94) or the bins shuffled by the epoch. On a mesh
    each data shard loads ``--batch-size // data`` rows a step."""
    from deepspeech_tpu_torch.data import AudioDataLoader

    dataset.set_curriculum_epoch(epoch, sample=args.use_curriculum,
                                 sample_size=args.curriculum_ratio)
    if args.use_curriculum and mesh is not None:
        share_epoch_draw(dataset, mesh)
    batch_size = max(args.batch_size // (mesh.data if mesh else 1), 1)
    sampler = sampler_for(len(dataset), batch_size, mesh)
    if not args.no_shuffle and (epoch > 0 or args.no_sorta_grad):
        sampler.shuffle(epoch)
    elif args.reverse_sort:
        sampler.reverse()
    return AudioDataLoader(dataset, sampler, batch_size, bucket,
                           args.num_workers)


def noise_bank(args, dataset, conf, bucket, dev):
    """The ``--device-noise`` bank on ``dev``, uploaded once (JAX
    ``cli/train.py:414-436``): every ``--noise-dir`` clip stacked to twice
    the longest utterance plus the reflect tail."""
    import glob

    from deepspeech_tpu_torch.augment.noise_device import build_noise_bank

    paths = sorted(glob.glob(args.noise_dir))
    max_dur = max((float(d or 0) for _, _, d in dataset.ids),
                  default=0.0) or 30.0
    width = bucket.pad_to(int(max_dur * conf.sample_rate)
                          + bucket.reflect_tail, bucket.audio_step)
    bank, lens = build_noise_bank(paths, conf.sample_rate, width,
                                  pad=bucket.reflect_tail)
    return len(paths), {"noise_bank": torch.from_numpy(bank).to(dev),
                        "noise_bank_lengths": torch.from_numpy(lens).to(dev)}


class Profiler:
    """``--profile-dir``: a torch.profiler window over global steps
    [start, start + steps) (at ``--steps-per-dispatch`` k > 1, over the
    groups that hold them), CPU and (on the card) CUDA activities, written
    as one Chrome trace into the directory when it closes.

    The port's span recorder (``utils/trace.py``) is on over the window,
    so its spans are ``ds.`` ranges of the trace, on the kernels' clock.
    Beside the trace, ``summary_<start>_<end>.json`` holds what the window
    recorded: ``spans`` (``trace.summary``: count, wall, self and thread
    CPU ms by span name) and ``spans_dropped``; ``launches``, each kernel
    launch counter's change (``ops.cuda.read_counters``); ``collectives``,
    the mesh's collectives by tag (``Mesh.counts``'s change; None without
    a mesh); ``step_graphs``, ``StepGraphs.stats()`` of the
    ``--steps-per-dispatch`` graphs (None where no graph cache exists)."""

    def __init__(self, directory: str, start: int, steps: int, dev,
                 say=print, mesh=None, multi_step=None):
        self.directory, self.start, self.steps = directory, start, steps
        self.dev, self.say = dev, say
        self.mesh, self.multi_step = mesh, multi_step
        self.prof = None
        self.path = None
        self.opened = None  # the window's counters as it opened

    def step(self, global_step: int, steps: int = 1):
        """Before the ``steps`` steps from ``global_step`` (a group of
        ``--steps-per-dispatch``): start the trace if the window starts
        among them, close it once the window has run."""
        if not self.directory:
            return
        if (self.prof is None and self.path is None
                and global_step <= self.start < global_step + steps):
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.opened = (time.perf_counter_ns(), read_counters(),
                           collections.Counter(
                               self.mesh.counts if self.mesh else ()))
            trace.enable(True)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.say(f"  profiler trace started -> {self.directory}")
        elif (self.prof is not None and self.path is None
              and global_step >= self.start + self.steps):
            self.close()

    def close(self):
        if self.prof is None or self.path is not None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.prof.__exit__(None, None, None)
        trace.enable(False)
        os.makedirs(self.directory, exist_ok=True)
        end = self.start + self.steps
        self.path = os.path.join(self.directory,
                                 f"trace_steps_{self.start}_{end}.json")
        self.prof.export_chrome_trace(self.path)
        with open(os.path.join(self.directory,
                               f"summary_{self.start}_{end}.json"),
                  "w") as f:
            json.dump(self.summary(), f, indent=1, sort_keys=True)
        self.say(f"  profiler trace stopped -> {self.path}")

    def summary(self) -> dict:
        """What the window recorded (class docstring)."""
        t0, counters, collectives = self.opened
        graphs = getattr(self.multi_step, "graphs", None)
        return {
            "steps": [self.start, self.start + self.steps],
            "spans": trace.summary([s for s in trace.take()
                                    if s.start_ns >= t0]),
            "spans_dropped": trace.dropped(),
            "launches": {f"{m}.{a}": n - counters.get((m, a), 0)
                         for (m, a), n in read_counters().items()},
            "collectives": (dict(collections.Counter(self.mesh.counts)
                                 - collectives)
                            if self.mesh is not None else None),
            "step_graphs": graphs.stats() if graphs is not None else None}


def main(argv=None, observers=()) -> int:
    """Run training. ``observers``: ``deepspeech_tpu_torch.utils.Observer``
    instances whose hooks fire at epoch, batch and checkpoint boundaries,
    in the JAX CLI's order."""
    args = build_parser().parse_args(argv)
    check_ported(args)
    dev, mesh = init_distributed(args)
    try:
        if mesh is not None and args.steps_per_dispatch > 1:
            check_one_machine(mesh)
        return train(args, dev, mesh, observers)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def train(args, dev, mesh, observers) -> int:
    """The run of ``main`` on this rank's device (``mesh`` None on one
    process)."""
    from deepspeech_tpu_torch.audio.features import AudioConf
    from deepspeech_tpu_torch.convert import torch_to_jax
    from deepspeech_tpu_torch.data import (AudioDataLoader, AudioDataset,
                                           BucketSpec, stack_microbatches)
    from deepspeech_tpu_torch.decoders import GreedyDecoder
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.models.factory import META_KEYS
    from deepspeech_tpu_torch.parallel import (equalize_batch_padding,
                                               gather_state,
                                               local_batch_to_global,
                                               metrics_to_local, shard_dims,
                                               shard_state, unshard)
    from deepspeech_tpu_torch.text.labels import Labels, load_labels
    from deepspeech_tpu_torch.train import checkpoint as ckpt
    from deepspeech_tpu_torch.train.evaluate import (decode_batch_greedy,
                                                     evaluate)
    from deepspeech_tpu_torch.train.optim import (ADAM_B2, ADAM_EPS,
                                                  build_optimizer, get_lr,
                                                  set_lr)
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_eval_step,
                                                 make_multi_train_step,
                                                 make_train_step)
    from deepspeech_tpu_torch.utils import (AverageMeter, MetricsLogger,
                                            ObserverList, StopWatch)

    is_leader = mesh is None or mesh.is_leader

    def say(*a):
        if is_leader and not args.silent:
            print(*a, flush=True)

    torch.manual_seed(args.seed)
    # -- config / resume (JAX cli/train.py:255-318) ------------------------
    package = None
    if args.continue_from:
        package = ckpt.load(args.continue_from)
        labels_str = package["labels"]
        audio_conf = AudioConf.from_dict(package["audio_conf"])
        say(f"Resuming from {args.continue_from} "
            f"(epoch {package.get('epoch', 0)})")
    else:
        labels_str = load_labels(_labels_path(args.labels_path))
        audio_conf = audio_conf_from_args(args, train=True)
    labels = Labels(labels_str)
    # augs zeroed for the eval datasets (reference train.py:912-915)
    test_conf = AudioConf.from_dict({**audio_conf.to_dict(),
                                     "noise_dir": None, "noise_prob": 0,
                                     "aug_prob_8khz": 0,
                                     "aug_prob_spect": 0})
    adam = {"beta2": args.adam_beta2, "eps": args.adam_eps}
    if package is not None:
        meta = {k: package[k] for k in META_KEYS if k in package}
        if meta.get("rnn_type") == "conformer" and args.mesh_model > 1:
            raise SystemExit("a conformer checkpoint trains data parallel "
                             "only: --mesh-model must be 1")
        model, meta = build_model(**meta, compute_dtype=args.compute_dtype,
                                  device=dev)
        if not args.finetune:
            adam = {k: package.get(f"adam_{k}", v) for k, v in adam.items()}
    else:
        model, meta = build_model(
            rnn_type=args.rnn_type, num_classes=len(labels.labels),
            hidden_size=args.hidden_size, hidden_layers=args.hidden_layers,
            bidirectional=args.bidirectional, bnm=args.batch_norm_momentum,
            cnn_width=args.cnn_width, dropout=args.dropout,
            compute_dtype=args.compute_dtype, device=dev,
            d_model=args.conformer_d_model, heads=args.conformer_heads,
            layers=args.conformer_layers, ff=args.conformer_ff,
            conv_kernel=args.conformer_kernel,
            n_mels=args.conformer_n_mels)
    optimizer = build_optimizer(args.optimizer, lr=args.lr,
                                momentum=args.momentum,
                                weight_decay=args.weight_decay,
                                max_norm=args.max_norm, **adam)
    if optimizer.kind == "adam" and (optimizer.beta2, optimizer.eps) != (
            ADAM_B2, ADAM_EPS):  # checkpointed with the optimizer
        meta = {**meta, "adam_beta2": optimizer.beta2,
                "adam_eps": optimizer.eps}
    state = TrainState.create(model, optimizer)
    start_epoch = start_iter = checkpoint_id = 0
    best_quality = None
    if package is not None:
        if args.finetune:
            state = ckpt.restore_params_only(package, state)
        else:
            state = ckpt.restore_state(package, state)
            start_epoch = max(package.get("epoch", 1) - 1, 0)
            start_iter = package.get("iteration") or 0
            checkpoint_id = package.get("checkpoint") or 0
            if start_iter == 0 and package.get("epoch") is not None:
                # an epoch-boundary checkpoint: that epoch is complete;
                # mid-epoch ones carry iteration >= 1 and restart inside
                # their epoch (reference train.py:846-853)
                start_epoch += 1
    if mesh is not None:
        # the whole state loads first, then each rank keeps its slices
        state = shard_state(state, mesh)
        say(f"mesh: data={mesh.data} x model={mesh.model} "
            f"({torch.distributed.get_backend()})")

    # -- data ----------------------------------------------------------------
    max_items = args.max_items or None
    train_dataset = AudioDataset(
        audio_conf, args.train_manifest, labels, max_items,
        args.curriculum or None, normalize=args.norm, augment=args.augment,
        seed=args.seed, aug_type=args.aug_type)
    val_dataset = AudioDataset(test_conf, args.val_manifest, labels,
                               max_items, normalize=args.norm)
    trainval_dataset = None
    if args.train_val_manifest:
        trainval_dataset = AudioDataset(test_conf, args.train_val_manifest,
                                        labels, max_items,
                                        normalize=args.norm)
    bucket = BucketSpec(
        audio_step=int(audio_conf.sample_rate * args.bucket_audio_seconds),
        reflect_tail=audio_conf.n_fft // 2, wire_dtype=args.wire_dtype)

    def eval_loader(dataset):
        return AudioDataLoader(
            dataset, sampler_for(len(dataset), args.val_batch_size, mesh),
            args.val_batch_size, bucket, args.num_workers)

    val_loader = eval_loader(val_dataset)
    trainval_loader = (eval_loader(trainval_dataset)
                       if trainval_dataset is not None else None)

    noise_extra = {}  # the device noise bank, uploaded once
    cfg = StepConfig(
        audio_conf=audio_conf, normalize=args.norm,
        device_noise_prob=(args.noise_prob
                           if args.device_noise and args.noise_dir else 0.0),
        device_noise_limit=args.device_noise_limit)
    if cfg.device_noise_prob > 0:
        n_clips, noise_extra = noise_bank(args, train_dataset, audio_conf,
                                          bucket, dev)
        say(f"device noise bank: {n_clips} clips, "
            f"{noise_extra['noise_bank'].numel() * 4 / 1e6:.1f} MB on "
            "device")

    def to_device(batch):
        out = {k: torch.from_numpy(v).to(dev, non_blocking=True)
               for k, v in batch.items() if k != "paths"}
        out.update(noise_extra)
        return local_batch_to_global(out, mesh)

    spd = args.steps_per_dispatch
    train_step = make_train_step(model, optimizer, cfg, mesh)
    multi_step = make_multi_train_step(model, optimizer, cfg, mesh) \
        if spd > 1 else None
    if multi_step is not None and dev.type == "cuda":
        say(f"steps per dispatch {spd}: " + (
            "each shape's step captured as a CUDA graph, collectives "
            "included" if multi_step.captured else
            "lanes run eagerly: gloo stages each collective through the "
            "host, which a CUDA graph cannot capture"))
    eval_step = make_eval_step(model, StepConfig(audio_conf=test_conf,
                                                 normalize=args.norm))
    decoder = GreedyDecoder(labels.labels, blank_index=labels.blank_index)
    obs = ObserverList(observers if is_leader else ())
    logger = MetricsLogger(args.log_dir, run_id=args.id.replace(" ", "_"),
                           tensorboard=args.tensorboard, enabled=is_leader,
                           live_html=args.live_html)
    if is_leader:
        os.makedirs(args.save_folder, exist_ok=True)
    # on resume too, the step's draws start from --seed (JAX :468)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    history = {k: list(package.get(k) or []) if package else []
               for k in HIST_KEYS}
    # completed checkpoint writes, reported at the JAX loop's drain points
    # so that the log and the observers see them in its order
    ckpt_done: list = []

    def drain_ckpt_events():
        while ckpt_done:
            path_, ep_, it_ = ckpt_done.pop(0)
            logger.log("checkpoint", path=path_, epoch=ep_, iteration=it_)
            obs.emit("on_checkpoint", ep_ or 0, it_ or 0, path_)
            say(f"  saved {path_}")

    def save_package(path, epoch=None, iteration=None, avg_loss=None):
        # every rank enters the gather of the sharded tensors; rank 0 writes
        sd, opt = (None, state.opt_state) if mesh is None else \
            gather_state(state, mesh)
        if not is_leader:
            return
        drain_ckpt_events()
        ckpt.save(path, ckpt.package_from_model(
            model, meta, labels.labels, audio_conf.to_dict(),
            step=int(state.step), epoch=epoch, iteration=iteration,
            avg_loss=avg_loss, history=history, opt_state=opt,
            checkpoint=checkpoint_id, state_dict=sd))
        train_dataset.save_curriculum(path + ".curriculum.csv")
        # validation curriculum sidecars (reference
        # save_validation_curriculums, train.py:515-532)
        val_dataset.save_curriculum(path + ".val.curriculum.csv")
        if trainval_dataset is not None:
            trainval_dataset.save_curriculum(path + ".trainval.curriculum.csv")
        ckpt_done.append((path, epoch, iteration))

    def run_validation(epoch, tag="val"):
        summary = evaluate(val_loader, eval_step, decoder, labels, to_device,
                           dataset=val_dataset, update_curriculum=True,
                           all_reduce=mesh)
        say(f"[{tag}] epoch {epoch + 1}: loss {summary['loss']:.3f} "
            f"WER {summary['wer']:.2f} CER {summary['cer']:.2f} "
            f"(utt-avg {summary['utt_wer']:.2f}/{summary['utt_cer']:.2f})")
        logger.log(tag, step=epoch, **summary)
        if tag == "val_checkpoint":
            for k in ("loss", "wer", "cer"):
                history[f"checkpoint_{k}_results"].append(float(summary[k]))
        if trainval_loader is not None:
            tv = evaluate(trainval_loader, eval_step, decoder, labels,
                          to_device, dataset=trainval_dataset,
                          update_curriculum=True, all_reduce=mesh)
            say(f"[trainval] epoch {epoch + 1}: WER {tv['wer']:.2f} "
                f"CER {tv['cer']:.2f}")
            logger.log("trainval", step=epoch, **tv)
            if tag == "val_checkpoint":
                for k in ("loss", "wer", "cer"):
                    history[f"trainval_checkpoint_{k}_results"].append(
                        float(tv[k]))
        return summary

    profiler = Profiler(args.profile_dir if is_leader else "",
                        args.profile_start, args.profile_steps, dev, say,
                        mesh=mesh, multi_step=multi_step)
    samples_since_ckpt = 0
    global_step = 0
    last_wer = 0.0
    for epoch in range(start_epoch, args.epochs):
        loader = epoch_loader(train_dataset, epoch, args, bucket, mesh)
        loss_meter = AverageMeter()
        watch = StopWatch()
        epoch_t0 = time.perf_counter()
        it = start_iter
        start_iter = 0
        obs.emit("on_epoch_start", epoch)
        pending = None  # group N-1's metrics, read after group N is queued

        def account_step(m, pbatch, pit, n_valid, grads=None):
            """Account one step (JAX ``account_step``) from its metrics on
            the host: meters (weighted by the global batch's ``n_valid``
            rows), the greedy decode of this rank's rows into its train
            curriculum, the hooks and logs; ``grads``, with
            ``--log-params``, the step's gradients, else its grad norm is
            logged (JAX :669-672)."""
            nonlocal last_wer
            m = metrics_to_local(m, mesh)
            loss = float(m["loss"])
            if not np.isfinite(loss):
                loss = 1000.0  # reporting clamp (reference train.py:609-611)
            loss_meter.update(loss, n_valid)
            # every batch's greedy decode feeds the train curriculum store
            results = decode_batch_greedy(decoder, m, pbatch, labels)
            for i, (tr, ref, w, c, wr, cr) in enumerate(results):
                train_dataset.update_curriculum(pbatch["paths"][i], ref, tr,
                                                None, c / cr, w / wr)
            if results:
                last_wer = float(np.mean([w / wr for _, _, w, _, wr, _
                                          in results]))
            obs.emit("on_batch_end", epoch, pit, loss=loss)
            watch.mark_batch()
            lr = get_lr(state.opt_state)
            if pit % 10 == 0:
                drain_ckpt_events()
                say(f"epoch {epoch + 1} iter {pit + 1}/{len(loader)} "
                    f"loss {loss:.3f} (avg {loss_meter.avg:.3f}) "
                    f"wer {100 * last_wer:.1f} "
                    f"batch {watch.batch_time.avg:.2f}s "
                    f"data {watch.data_time.avg:.2f}s lr {lr:.2e}")
                logger.log("train", step=epoch * len(loader) + pit,
                           loss=loss, avg_loss=loss_meter.avg, lr=lr,
                           skipped=bool(m["step_skipped"]))
            if args.log_params and pit % 100 == 0:
                sd = (dict(model.state_dict()) if mesh is None
                      else gather_state(state, mesh)[0])
                if grads is not None:
                    names = [n for n, _ in model.named_parameters()]
                    full = dict(sd)
                    dims = shard_dims(model)
                    full.update((n, unshard(g, mesh, dims[n]) if n in dims
                                 else g) for n, g in zip(names, grads))
                    grads = torch_to_jax(full)[0]
                else:
                    grads = float(m["grad_norm"])
                logger.log_params(torch_to_jax(sd)[0], grads,
                                  epoch * len(loader) + pit)

        def process_pending():
            """Account the group queued before the last one: its stacked
            metrics read back at once, then microbatch by microbatch."""
            nonlocal pending
            if pending is None:
                return
            m, group, pit, grads = pending
            pending = None
            m = {k: v.cpu() for k, v in m.items()}
            for j, (b, n_valid) in enumerate(group):
                account_step({k: v[j] for k, v in m.items()}, b, pit + j,
                             n_valid, grads)

        def maybe_sample_checkpoint():
            nonlocal checkpoint_id, samples_since_ckpt
            if not (args.checkpoint_per_samples
                    and samples_since_ckpt >= args.checkpoint_per_samples):
                return
            # flush the pipeline so the checkpoint's curriculum sidecars
            # and loss average include every step up to this one
            process_pending()
            checkpoint_id += 1
            save_package(os.path.join(
                args.save_folder,
                f"deepspeech_checkpoint_{checkpoint_id:04d}.ckpt"),
                epoch=epoch, iteration=it, avg_loss=loss_meter.avg)
            run_validation(epoch, tag="val_checkpoint")
            samples_since_ckpt = 0
            if args.checkpoint_anneal != 1.0:
                old_lr = get_lr(state.opt_state)
                new_lr = old_lr / args.checkpoint_anneal
                set_lr(state.opt_state, new_lr)
                say(f"  checkpoint anneal -> lr {new_lr:.2e}")
                # the LR-finder stream (reference train.py:254-314)
                logger.log("lr_find", step=checkpoint_id, lr=old_lr,
                           loss=loss_meter.avg)

        batches = loader.iter_from(it)
        held: list = []  # the batch that switched the shape

        def pull_group():
            """Up to k host batches of one shape (JAX ``pull_group``; one
            at k=1): a batch of another shape closes the group and opens
            the next. On a mesh each batch's shards are padded alike
            before its shape is compared, so that every rank closes its
            groups at the same batches. The group is stacked on the host
            (``stack_microbatches``) and copied to the device as one
            superbatch, queued behind the steps before it -> ([(batch,
            real rows of the global batch)], superbatch, live lanes)."""
            group = []
            while len(group) < spd:
                if held:
                    item = held.pop()
                else:
                    b = next(batches, None)
                    if b is None:
                        break
                    if mesh is not None and mesh.spans("data"):
                        item = equalize_batch_padding(b, mesh)
                    else:
                        item = (b, int(np.asarray(b["valid"]).sum()))
                if group and any(item[0][k].shape != group[0][0][k].shape
                                 for k in ("audio", "targets")):
                    held.append(item)
                    break
                watch.mark_data()
                group.append(item)
            if not group:
                return None
            stacked, live = stack_microbatches([b for b, _ in group], spd)
            return group, {k: torch.from_numpy(v).to(dev, non_blocking=True)
                           for k, v in stacked.items()}, live

        nxt = pull_group()
        while nxt is not None:
            group, stacked, live = nxt
            profiler.step(global_step, len(group))
            for j in range(len(group)):
                obs.emit("on_batch_start", epoch, it + j)
            grads = None
            if spd == 1:
                lane = local_batch_to_global(
                    {**{k: v[0] for k, v in stacked.items()}, **noise_extra},
                    mesh)
                m = train_step(state, lane, generator=generator,
                               return_grads=args.log_params and it % 100 == 0)
                grads = m.pop("grads", None)
                m = {k: v[None] for k, v in m.items()}
            else:
                m = multi_step(state, stacked, generator, live, noise_extra)
            nxt = pull_group()  # group N+1 loads while group N runs
            process_pending()  # account group N-1 while group N runs
            pending = (m, group, it, grads)
            it += len(group)
            global_step += len(group)
            samples_since_ckpt += sum(n for _, n in group)
            maybe_sample_checkpoint()
        process_pending()
        graphs = getattr(multi_step, "graphs", None)
        if graphs is not None:
            g = graphs.stats()
            say(f"  step graphs: {g['graphs']} held, {len(g['capture_s'])} "
                f"captures in {sum(g['capture_s']):.2f}s, "
                f"{g['evictions']} evictions, {g['eager_steps']} eager "
                f"steps, {g['replays']} replays")
            logger.log("step_graphs", step=epoch, **g)

        epoch_time = time.perf_counter() - epoch_t0
        say(f"epoch {epoch + 1} done in {epoch_time:.1f}s "
            f"avg loss {loss_meter.avg:.3f}")
        logger.log("epoch", step=epoch, loss=loss_meter.avg,
                   seconds=epoch_time)
        obs.emit("on_epoch_end", epoch, loss=loss_meter.avg,
                 seconds=epoch_time)
        summary = run_validation(epoch)
        history["loss_results"].append(float(loss_meter.avg))
        history["wer_results"].append(float(summary["wer"]))
        history["cer_results"].append(float(summary["cer"]))
        if args.checkpoint:
            save_package(os.path.join(
                args.save_folder, f"deepspeech_epoch_{epoch + 1:03d}.ckpt"),
                epoch=epoch, iteration=0, avg_loss=loss_meter.avg)
        new_lr = get_lr(state.opt_state) / args.learning_anneal
        set_lr(state.opt_state, new_lr)
        say(f"  learning rate annealed -> {new_lr:.2e}")
        # best model by WER + CER (reference train.py:769-787)
        quality = summary["wer"] + summary["cer"]
        if best_quality is None or quality < best_quality:
            best_quality = quality
            save_package(os.path.join(args.save_folder, "best_model.ckpt"),
                         epoch=epoch, iteration=0, avg_loss=loss_meter.avg)

    profiler.close()
    save_package(os.path.join(args.save_folder, "deepspeech_final.ckpt"),
                 epoch=args.epochs - 1, iteration=0)
    drain_ckpt_events()
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
