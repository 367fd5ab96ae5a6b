"""Batch evaluation CLI (the JAX package's ``cli/test.py``; reference
test.py:16-214), on one device or on several cards.

    python -m deepspeech_tpu_torch.cli.test --model-path m.ckpt \\
        --test-manifest test.csv [--decoder greedy|beam|device_beam] \\
        [--lm-path lm.arpa] [--device cuda]
    torchrun --nproc-per-node 8 -m deepspeech_tpu_torch.cli.test \\
        --model-path m.ckpt --test-manifest test.csv --batch-size 64

Loads a checkpoint (model + labels + front-end config all self-described),
runs a manifest through the eval step, decodes greedy, host beam or device
beam, prints per-utterance triage (--verbose/--errors/--best), writes a CSV
report and optional per-utterance posterior dumps, and prints both summary
averaging modes (reference test.py:197-209). The posteriors leave the
device only for the host beam or ``--output-path``.

Under torchrun (``WORLD_SIZE`` above 1) each process joins the group
(``env://``, ``--dist-backend``: NCCL on the card, gloo on the CPU) on
``cuda:$LOCAL_RANK``, and the ranks shard every batch as the JAX CLI
shards it over its devices (``cli/test.py:73-90``): where ``--batch-size``
divides among them, each rank loads its rows of every bin of the same
``BucketingSampler``, pads them as the whole batch pads (the padding
exchange on the host over gloo, ``equalize_batch_padding``), runs the eval
step and the decoder on its card (the device beam's K10 there too) and
writes its rows' ``--output-path`` dumps; rank 0 gathers the scored rows
(over gloo) and prints and writes everything in the one-process order, so
the report and the summaries equal one process's. Otherwise rank 0
evaluates alone, says why on stderr, and the other ranks exit 0.
"""

from __future__ import annotations

import argparse
import csv
import os
import pickle
import sys

import torch

from deepspeech_tpu_torch.cli.args import (add_decoder_args,
                                           add_inference_args,
                                           add_reference_noop_args)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DeepSpeech evaluation "
                                            "(PyTorch/CUDA port)")
    add_inference_args(p)
    p.add_argument("--test-manifest", default="data/test_manifest.csv")
    p.add_argument("--cache-dir", default="data/cache/",
                   help="accepted for flag parity; the reference's npy "
                        "spectrogram cache is disabled there too "
                        "(data_loader_aug.py:140-161)")
    p.add_argument("--batch-size", default=20, type=int)
    p.add_argument("--num-workers", default=4, type=int)
    p.add_argument("--verbose", action="store_true",
                   help="print decoded output and error of each sample")
    p.add_argument("--errors", action="store_true",
                   help="print samples with CER > 50%%")
    p.add_argument("--best", action="store_true",
                   help="print samples with CER < 15%%")
    p.add_argument("--norm", default="max_frame")
    p.add_argument("--report-file", default=None,
                   help="write a per-utterance CSV report to this path")
    p.add_argument("--output-path", default=None, type=str,
                   help="dump per-utterance probs pickles next to wavs")
    p.add_argument("--max-items", default=0, type=int)
    add_decoder_args(p)
    add_reference_noop_args(p)
    return p


def join(args):
    """torchrun's world for this process (``WORLD_SIZE`` above 1: the
    ``env://`` rendezvous, the rank's device, a data-only mesh) -> (device,
    mesh), mesh None on one process."""
    from deepspeech_tpu_torch.cli.common import join_world, rendezvous
    from deepspeech_tpu_torch.device import resolve_device

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return resolve_device(args.device), None
    joined = rendezvous(argparse.Namespace(
        dist_init=True, dist_url="", dist_rank=-1, dist_world_size=0))
    return join_world(joined, args.device, args.dist_backend)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev, mesh = join(args)
    try:
        return run(args, dev, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def run(args, dev, mesh) -> int:
    """The run of ``main`` on this rank's device (module docstring)."""
    from deepspeech_tpu_torch.cli.common import (build_decoder,
                                                 load_inference_model)
    from deepspeech_tpu_torch.data import (AudioDataLoader, AudioDataset,
                                           BucketingSampler, BucketSpec)
    from deepspeech_tpu_torch.decoders import BeamCTCDecoder, GreedyDecoder
    from deepspeech_tpu_torch.metrics import get_cer_wer
    from deepspeech_tpu_torch.parallel import equalize_batch_padding
    from deepspeech_tpu_torch.train.step import StepConfig, make_eval_step

    world = 1 if mesh is None else mesh.data
    if world > 1 and args.batch_size % world:
        # JAX cli/test.py:82-84: shard only a batch the devices divide
        if not mesh.is_leader:
            return 0
        print(f"test: --batch-size {args.batch_size} does not divide among "
              f"{world} ranks: rank 0 evaluates alone", file=sys.stderr)
        mesh, world = None, 1
    rank = 0 if mesh is None else mesh.data_index
    args.device = str(dev)  # the device beam searches on this rank's card
    model, labels, audio_conf, _ = load_inference_model(args.continue_from,
                                                        device=dev)
    decoder = build_decoder(args, labels)
    dataset = AudioDataset(audio_conf, args.test_manifest, labels,
                           max_items=args.max_items or None)
    # this rank's rows of every bin of the one-process sampler
    rows = args.batch_size // world
    bins = [ids[rank * rows:(rank + 1) * rows]
            for ids in BucketingSampler(len(dataset), args.batch_size)]
    # each row's reflect tail at least the front's half window
    tail = max(BucketSpec.reflect_tail, audio_conf.n_fft // 2)
    loader = AudioDataLoader(dataset, bins, rows,
                             BucketSpec(reflect_tail=tail),
                             num_workers=args.num_workers)
    eval_step = make_eval_step(
        model, StepConfig(audio_conf=audio_conf, normalize=args.norm))

    need_probs = bool(args.output_path) or isinstance(decoder, BeamCTCDecoder)
    scored = []  # (batch, rank, path, reference, transcript, w, c, wr, cr)

    def process(metrics, batch, paths, index):
        out_lens = metrics["out_lens"].cpu().numpy()
        targets, target_lengths = batch["targets"], batch["target_lengths"]
        valid = batch["valid"]
        # the (B, T, C) posteriors come to the host only when a consumer
        # needs them (host beam decode or --output-path dumps)
        probs = metrics["probs"].float().cpu().numpy() if need_probs else None

        if isinstance(decoder, GreedyDecoder):
            decoded, _ = decoder.decode_ids(metrics["greedy"], out_lens)
        elif isinstance(decoder, BeamCTCDecoder):
            decoded, _ = decoder.decode(probs, out_lens)
        else:  # the device beam reads the posteriors where they are
            decoded, _ = decoder.decode(metrics["probs"], metrics["out_lens"])

        for x in range(len(paths)):
            if valid[x] <= 0:
                continue
            transcript = decoded[x][0]
            reference = labels.render_transcript(
                targets[x, : int(target_lengths[x])])
            # decode-time truncation guard (reference test.py:129)
            w, c, wr, cr = get_cer_wer(transcript[:2000], reference[:2000])
            if args.output_path:
                with open(paths[x] + ".ts", "wb") as f:
                    pickle.dump({
                        "probs": probs[x, : out_lens[x]],
                        "len": int(out_lens[x]),
                        "transcript": transcript,
                        "reference": reference,
                        "filename": paths[x],
                        "wer": w / wr, "cer": c / cr,
                    }, f, protocol=4)
            scored.append((index, rank, paths[x], reference, transcript, w, c,
                           wr, cr))

    # pipelined eval: batch N+1's step is queued on the device before batch
    # N's host-side decode, so the device does not wait on the host
    pending = None
    for index, batch in enumerate(loader):
        if mesh is not None:  # pad as the one-process batch is padded
            batch, _ = equalize_batch_padding(batch, mesh)
        paths = batch.pop("paths")
        metrics = eval_step({k: torch.from_numpy(v).to(dev)
                             for k, v in batch.items()})
        if pending is not None:
            process(*pending)
        pending = (metrics, batch, paths, index)
    if pending is not None:
        process(*pending)
    if isinstance(decoder, BeamCTCDecoder):
        decoder.close()
    if mesh is not None:
        parts = mesh.gather_object(scored, tag="test_rows")
        if not mesh.is_leader:
            return 0
        # the one-process order: bin by bin, each rank's rows in turn
        scored = sorted((row for part in parts for row in part),
                        key=lambda row: row[:2])
    report(args, scored)
    return 0


def report(args, scored: list) -> None:
    """Rank 0's output from the scored rows in the one-process order:
    the --verbose/--errors/--best prints, the CSV report, the list of the
    --output-path dumps and both summary lines."""
    total_wer = total_cer = total_wer_ref = total_cer_ref = 0.0
    utt_wer_sum = utt_cer_sum = 0.0
    report_rows, processed_files = [], []
    for _, _, path, reference, transcript, w, c, wr, cr in scored:
        total_wer += w
        total_cer += c
        total_wer_ref += wr
        total_cer_ref += cr
        utt_wer_sum += w / wr
        utt_cer_sum += c / cr
        if args.output_path:
            processed_files.append(path + ".ts")
        show = (args.verbose
                or (args.errors and c / cr > 0.5 and transcript.strip())
                or (args.best and c / cr < 0.15))
        if show:
            print("Ref:", reference)
            print("Hyp:", transcript)
            print("Wav:", path)
            print(f"WER: {100 * w / wr:.2f} CER: {100 * c / cr:.2f}\n")
        report_rows.append([path, reference, transcript,
                            round(100 * c / cr, 2), round(100 * w / wr, 2)])
    n_utts = len(scored)

    if args.report_file:
        os.makedirs(os.path.dirname(os.path.abspath(args.report_file)),
                    exist_ok=True)
        with open(args.report_file, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["wav", "text", "transcript", "CER", "WER"])
            writer.writerows(report_rows)

    if args.output_path:
        with open(args.output_path, "wb") as f:
            pickle.dump(processed_files, f, protocol=4)

    # both averaging modes (reference test.py:197-209)
    wer_avg = 100.0 * total_wer / max(total_wer_ref, 1.0)
    cer_avg = 100.0 * total_cer / max(total_cer_ref, 1.0)
    print("Summary (token-weighted)    "
          f"WER {wer_avg:.3f}  CER {cer_avg:.3f}")
    print("Summary (per-utt averaged)  "
          f"WER {100.0 * utt_wer_sum / max(n_utts, 1):.3f}  "
          f"CER {100.0 * utt_cer_sum / max(n_utts, 1):.3f}  "
          f"({n_utts} utterances)")


if __name__ == "__main__":
    raise SystemExit(main())
