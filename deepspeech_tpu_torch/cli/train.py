"""Training CLI: the default single-device path of the JAX package's
``cli/train.py`` on the card.

    python -m deepspeech_tpu_torch.cli.train --train-manifest train.csv \\
        --val-manifest val.csv [--epochs 70 --batch-size 20 --device cuda]

Epochs over the train manifest: before each, the dataset's epoch list is
set (all rows, or with ``--use-curriculum`` the rows drawn by curriculum
probability, at least ``--curriculum-ratio`` of the manifest) and
shuffled by the epoch, as the JAX CLI does; then SortaGrad order on epoch
0 and shuffled bins after. One ``train_step`` per batch (featurize ->
forward -> CTC -> backward -> clip -> NaN guard -> SGD/Adam); every
batch's greedy ids are decoded on the host and their CER and WER go into
the train curriculum store (``--curriculum`` preloads it from a CSV
sidecar). A log line every 10 iterations, greedy validation loss/WER/CER
at each epoch's end (which updates the val store), the LR annealed by
``--learning-anneal``, ``best_model.ckpt`` by WER + CER and
``deepspeech_final.ckpt`` in ``--save-folder``; every checkpoint writes
the ``<ckpt>.curriculum.csv`` and ``<ckpt>.val.curriculum.csv`` sidecars.
Checkpoints are the JAX package's zip container: both packages'
``transcribe`` load them.

Not ported yet (each raises SystemExit naming ROADMAP.md): augmentation,
``--steps-per-dispatch`` > 1, ``--mesh-model`` > 1,
resuming (``--continue-from``, ``--finetune``), ``--profile-dir``,
``--tensorboard``, ``--visdom``, ``--log-params``, ``--train-val-manifest``,
``--checkpoint-per-samples`` and the multi-host rendezvous (``--dist-url``,
``--dist-init``, ``--dist-rank``, ``--dist-world-size``), each at any value
but its default. Every other flag of the JAX CLI parses: ``--enorm`` is a
no-op there too, the flags that act only with a refused one are accepted
as they are, and ``--id``/``--log-dir`` name the JSONL metric log, which
is not written yet.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from deepspeech_tpu_torch.cli.args import add_reference_noop_args


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DeepSpeech training "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--train-manifest", default="data/train_manifest.csv")
    p.add_argument("--val-manifest", default="data/val_manifest.csv")
    p.add_argument("--train-val-manifest", default="",
                   help="not ported yet")
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
                   help="gru, lstm or rnn (the CNN models are not ported "
                        "yet)")
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
    p.add_argument("--max-norm", default=100, type=float,
                   help="gradient norm clip")
    p.add_argument("--learning-anneal", default=1.1, type=float)
    p.add_argument("--checkpoint-anneal", default=1.0, type=float,
                   help="LR anneal at each mid-epoch checkpoint (acts with "
                        "--checkpoint-per-samples, not ported yet)")
    p.add_argument("--silent", action="store_true")
    # checkpointing
    p.add_argument("--checkpoint", action="store_true",
                   help="save a checkpoint every epoch")
    p.add_argument("--checkpoint-per-samples", default=0, type=int,
                   help="not ported yet")
    p.add_argument("--save-folder", default="models/")
    p.add_argument("--continue-from", default="", help="not ported yet")
    p.add_argument("--finetune", action="store_true", help="not ported yet")
    # augmentation (not ported yet)
    p.add_argument("--augment", action="store_true")
    p.add_argument("--noise-dir", default=None)
    p.add_argument("--noise-prob", default=0.4, type=float,
                   help="acts with --noise-dir or --device-noise")
    p.add_argument("--noise-min", default=0.0, type=float)
    p.add_argument("--noise-max", default=0.5, type=float)
    p.add_argument("--device-noise", action="store_true")
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
                   help="not ported yet")
    p.add_argument("--visdom", dest="live_html", action="store_true",
                   help="not ported yet")
    p.add_argument("--enorm", action="store_true",
                   help="accepted for reference-flag parity; no-op")
    p.add_argument("--log-dir", default="visualize/deepspeech_final",
                   help="directory of the JSONL metric log (not written "
                        "yet)")
    p.add_argument("--log-params", action="store_true",
                   help="not ported yet")
    p.add_argument("--id", default="Deepspeech training",
                   help="name of the JSONL metric log (not written yet)")
    p.add_argument("--profile-dir", default="", help="not ported yet")
    p.add_argument("--profile-start", default=10, type=int,
                   help="acts with --profile-dir")
    p.add_argument("--profile-steps", default=5, type=int,
                   help="acts with --profile-dir")
    p.add_argument("--seed", default=123456, type=int)
    # device / batching
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda)")
    p.add_argument("--mesh-model", default=1, type=int,
                   help="tensor-parallel width; only 1 is ported")
    p.add_argument("--steps-per-dispatch", default=1, type=int,
                   help="only 1 is ported")
    p.add_argument("--bucket-audio-seconds", default=1.0, type=float,
                   help="audio padding granularity")
    p.add_argument("--wire-dtype", default="int16",
                   choices=["int16", "float32", "mulaw8"],
                   help="host->device waveform format")
    p.add_argument("--max-items", default=0, type=int,
                   help="truncate manifests (debug)")
    # multi-host rendezvous (not ported yet)
    p.add_argument("--dist-url", default="")
    p.add_argument("--dist-rank", "--rank", dest="dist_rank", default=-1,
                   type=int)
    p.add_argument("--dist-world-size", "--world-size",
                   dest="dist_world_size", default=0, type=int)
    p.add_argument("--dist-init", action="store_true")
    add_reference_noop_args(p)
    return p


# (attribute, flag, what is not ported): refused at any value other than
# the parser's default (``--dist-rank`` defaults to -1, so no truthiness)
_NOT_PORTED = (
    ("augment", "--augment", "augmentation"),
    ("noise_dir", "--noise-dir", "augmentation"),
    ("device_noise", "--device-noise", "augmentation"),
    ("aug_prob_8khz", "--aug-prob-8khz", "augmentation"),
    ("aug_prob_spect", "--aug-prob-spect", "augmentation"),
    ("continue_from", "--continue-from", "resuming"),
    ("finetune", "--finetune", "resuming"),
    ("profile_dir", "--profile-dir", "profiling"),
    ("tensorboard", "--tensorboard", "logging"),
    ("live_html", "--visdom", "logging"),
    ("log_params", "--log-params", "logging"),
    ("train_val_manifest", "--train-val-manifest", "train-val evaluation"),
    ("checkpoint_per_samples", "--checkpoint-per-samples",
     "mid-epoch checkpoints"),
    ("dist_url", "--dist-url", "multi-host training"),
    ("dist_init", "--dist-init", "multi-host training"),
    ("dist_rank", "--dist-rank", "multi-host training"),
    ("dist_world_size", "--dist-world-size", "multi-host training"),
)


def check_ported(args) -> None:
    """Refuse the flags whose paths the port has not ported yet. The flags
    that only act together with one of them (``--noise-prob``,
    ``--aug-type``, ``--profile-start``, ...) are accepted as they are."""
    parser = build_parser()
    for attr, flag, what in _NOT_PORTED:
        if getattr(args, attr) != parser.get_default(attr):
            raise SystemExit(f"{flag}: {what} is not ported to PyTorch yet "
                             "(see ROADMAP.md)")
    if args.steps_per_dispatch > 1:
        raise SystemExit("--steps-per-dispatch > 1: the CUDA-graph replay "
                         "is not ported yet (see ROADMAP.md)")
    if args.mesh_model > 1:
        raise SystemExit("--mesh-model > 1: multi-GPU training is not "
                         "ported yet (see ROADMAP.md)")


def _labels_path(path: str) -> str:
    """The cwd-relative default falls back to the copy at the repo root."""
    if path == "labels.json" and not os.path.exists(path):
        shipped = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), "labels.json")
        if os.path.exists(shipped):
            return shipped
    return path


def epoch_loader(dataset, epoch: int, args, bucket):
    """The train loader of one epoch (JAX ``cli/train.py:612-633``): the
    dataset's epoch list first, then SortaGrad (no shuffle on epoch 0,
    reference train.py:89-94) or the bins shuffled by the epoch."""
    from deepspeech_tpu_torch.data import AudioDataLoader, BucketingSampler

    dataset.set_curriculum_epoch(epoch, sample=args.use_curriculum,
                                 sample_size=args.curriculum_ratio)
    sampler = BucketingSampler(len(dataset), args.batch_size)
    if not args.no_shuffle and (epoch > 0 or args.no_sorta_grad):
        sampler.shuffle(epoch)
    elif args.reverse_sort:
        sampler.reverse()
    return AudioDataLoader(dataset, sampler, args.batch_size, bucket,
                           args.num_workers)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_ported(args)
    if not args.silent:
        print(f"--id {args.id!r}, --log-dir {args.log_dir!r}: the JSONL "
              "metric log is not written yet (see ROADMAP.md)", flush=True)
    from deepspeech_tpu_torch.audio.features import AudioConf
    from deepspeech_tpu_torch.data import (AudioDataLoader, AudioDataset,
                                           BucketingSampler, BucketSpec)
    from deepspeech_tpu_torch.decoders import GreedyDecoder
    from deepspeech_tpu_torch.device import resolve_device
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.text.labels import Labels, load_labels
    from deepspeech_tpu_torch.train import checkpoint as ckpt
    from deepspeech_tpu_torch.train.evaluate import (decode_batch_greedy,
                                                     evaluate)
    from deepspeech_tpu_torch.train.optim import (build_optimizer, get_lr,
                                                  set_lr)
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_eval_step,
                                                 make_train_step)

    def say(*a):
        if not args.silent:
            print(*a, flush=True)

    dev = resolve_device(args.device)
    torch.manual_seed(args.seed)
    labels = Labels(load_labels(_labels_path(args.labels_path)))
    audio_conf = AudioConf(sample_rate=args.sample_rate,
                           window_size=args.window_size,
                           window_stride=args.window_stride,
                           window=args.window)
    model, meta = build_model(
        rnn_type=args.rnn_type, num_classes=len(labels.labels),
        hidden_size=args.hidden_size, hidden_layers=args.hidden_layers,
        bidirectional=args.bidirectional, bnm=args.batch_norm_momentum,
        cnn_width=args.cnn_width, dropout=args.dropout,
        compute_dtype=args.compute_dtype, device=dev)
    optimizer = build_optimizer(args.optimizer, lr=args.lr,
                                momentum=args.momentum,
                                weight_decay=args.weight_decay,
                                max_norm=args.max_norm)
    state = TrainState.create(model, optimizer)
    cfg = StepConfig(audio_conf=audio_conf, normalize=args.norm)
    train_step = make_train_step(model, optimizer, cfg)
    eval_step = make_eval_step(model, cfg)
    decoder = GreedyDecoder(labels.labels, blank_index=labels.blank_index)
    generator = torch.Generator(device=dev).manual_seed(args.seed)

    max_items = args.max_items or None
    train_dataset = AudioDataset(audio_conf, args.train_manifest, labels,
                                 max_items, args.curriculum or None)
    val_dataset = AudioDataset(audio_conf, args.val_manifest, labels,
                               max_items)
    bucket = BucketSpec(
        audio_step=int(audio_conf.sample_rate * args.bucket_audio_seconds),
        reflect_tail=audio_conf.n_fft // 2, wire_dtype=args.wire_dtype)
    val_loader = AudioDataLoader(
        val_dataset, BucketingSampler(len(val_dataset), args.val_batch_size),
        args.val_batch_size, bucket, args.num_workers)

    def to_device(batch):
        return {k: torch.from_numpy(v).to(dev, non_blocking=True)
                for k, v in batch.items() if k != "paths"}

    os.makedirs(args.save_folder, exist_ok=True)
    history = {"loss_results": [], "wer_results": [], "cer_results": []}
    best_quality = None

    def save(name, epoch, avg_loss=None):
        path = os.path.join(args.save_folder, name)
        ckpt.save(path, ckpt.package_from_model(
            model, meta, labels.labels, audio_conf.to_dict(),
            step=int(state.step), epoch=epoch, iteration=0,
            avg_loss=avg_loss, history=history))
        train_dataset.save_curriculum(path + ".curriculum.csv")
        val_dataset.save_curriculum(path + ".val.curriculum.csv")
        say(f"  saved {path}")

    for epoch in range(args.epochs):
        loader = epoch_loader(train_dataset, epoch, args, bucket)
        loss_sum = loss_count = 0.0
        t0 = time.perf_counter()
        for it, batch in enumerate(loader):
            m = train_step(state, to_device(batch), generator=generator)
            loss = float(m["loss"])
            if not np.isfinite(loss):
                loss = 1000.0  # reporting clamp (reference train.py:609-611)
            n_valid = float(batch["valid"].sum())
            loss_sum += loss * n_valid
            loss_count += n_valid
            # every batch's greedy decode feeds the train curriculum store
            # (JAX cli/train.py:581-589)
            results = decode_batch_greedy(decoder, m, batch, labels)
            for i, (tr, ref, w, c, wr, cr) in enumerate(results):
                train_dataset.update_curriculum(batch["paths"][i], ref, tr,
                                                None, c / cr, w / wr)
            if it % 10 == 0:
                wer = np.mean([w / wr for _, _, w, _, wr, _ in results])
                say(f"epoch {epoch + 1} iter {it + 1}/{len(loader)} "
                    f"loss {loss:.3f} (avg {loss_sum / loss_count:.3f}) "
                    f"wer {100 * wer:.1f} grad_norm "
                    f"{float(m['grad_norm']):.2f} "
                    f"skipped {bool(m['step_skipped'])} "
                    f"lr {get_lr(state.opt_state):.2e}")
        avg_loss = loss_sum / max(loss_count, 1.0)
        say(f"epoch {epoch + 1} done in {time.perf_counter() - t0:.1f}s "
            f"avg loss {avg_loss:.3f}")
        summary = evaluate(val_loader, eval_step, decoder, labels, to_device,
                           dataset=val_dataset, update_curriculum=True)
        say(f"[val] epoch {epoch + 1}: loss {summary['loss']:.3f} "
            f"WER {summary['wer']:.2f} CER {summary['cer']:.2f} "
            f"(utt-avg {summary['utt_wer']:.2f}/{summary['utt_cer']:.2f})")
        history["loss_results"].append(avg_loss)
        history["wer_results"].append(summary["wer"])
        history["cer_results"].append(summary["cer"])
        if args.checkpoint:
            save(f"deepspeech_epoch_{epoch + 1:03d}.ckpt", epoch, avg_loss)
        new_lr = get_lr(state.opt_state) / args.learning_anneal
        set_lr(state.opt_state, new_lr)
        say(f"  learning rate annealed -> {new_lr:.2e}")
        quality = summary["wer"] + summary["cer"]
        if best_quality is None or quality < best_quality:
            best_quality = quality
            save("best_model.ckpt", epoch, avg_loss)
    save("deepspeech_final.ckpt", args.epochs - 1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
