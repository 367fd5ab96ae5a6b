"""Batch-serving CLI: continuous-batching transcription over a manifest
(the JAX package's ``cli/serve.py``).

    python -m deepspeech_tpu_torch.cli.serve --model-path m.ckpt \\
        --manifest m.csv [--slots 8] [--chunk-seconds 0.96] \\
        [--decoder greedy|beam|device_beam [--lm-path lm.arpa]] \\
        [--output out.jsonl] [--device cuda]

Drives ``serve.StreamPool`` as a streaming ASR service would: N slots
advance in one chunk step per tick; utterances join as slots free up and
leave when their pipeline drains. Writes one JSON line per utterance
(``wav``, ``transcription``, ``chunks``) and a throughput summary on
stderr. It serves a unidirectional DS2 (lookahead head) or any CNN stack;
``beam`` and ``device_beam`` both select the streaming device beam search.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from deepspeech_tpu_torch.cli.args import add_decoder_args, add_inference_args


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="DeepSpeech continuous-batching transcription server "
                    "(PyTorch/CUDA port)")
    add_inference_args(p)
    p.add_argument("--manifest", required=True,
                   help="CSV manifest (wav[,txt[,duration]] rows) or a "
                        "plain list of wav paths")
    p.add_argument("--slots", default=8, type=int,
                   help="concurrent stream lanes riding the batch dimension")
    p.add_argument("--chunk-seconds", default=0.96, type=float)
    p.add_argument("--norm", default="max_frame")
    p.add_argument("--output", default="-",
                   help="JSONL output path ('-' = stdout)")
    p.add_argument("--max-items", default=0, type=int)
    add_decoder_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from deepspeech_tpu_torch.audio.dsp import resample
    from deepspeech_tpu_torch.audio.io import load_audio_norm
    from deepspeech_tpu_torch.cli.common import (load_inference_model,
                                                 refuse_conformer)
    from deepspeech_tpu_torch.serve import StreamPool

    model, labels, audio_conf, _ = load_inference_model(args.continue_from,
                                                        device=args.device)
    refuse_conformer(model, "serve")
    if getattr(model, "bidirectional", False):
        raise SystemExit("serve requires a streamable model: a "
                         "unidirectional DS2 (lookahead head) or any CNN "
                         "stack (chunked overlap-save); this checkpoint is "
                         "bidirectional — use test.py for offline batches")

    wavs = []
    with open(args.manifest) as f:
        for line in f:
            line = line.strip()
            if line:
                wavs.append(line.split(",")[0])
    if args.max_items:
        wavs = wavs[: args.max_items]
    if not wavs:
        raise SystemExit("empty manifest")

    chunk_frames = max(4, 2 * round(args.chunk_seconds
                                    * audio_conf.sample_rate
                                    / audio_conf.hop / 2))
    use_beam = args.decoder in ("beam", "device_beam")
    pool = StreamPool(model, labels, audio_conf, normalize=args.norm,
                      chunk_frames=chunk_frames, slots=args.slots,
                      decoder="beam" if use_beam else "greedy",
                      beam_width=args.beam_width,
                      cutoff_top_n=args.cutoff_top_n,
                      cutoff_prob=args.cutoff_prob,
                      lm_path=args.lm_path if use_beam else None,
                      lm_alpha=args.alpha, lm_beta=args.beta)

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    pending = list(wavs)
    slot_wav: dict[int, str] = {}
    slot_ticks: dict[int, int] = {}
    done = 0
    audio_seconds = 0.0
    t0 = time.perf_counter()
    ticks = 0
    try:
        while pending or pool.busy():
            while pending:  # fill the free slots
                try:
                    s = pool.open()
                except RuntimeError:
                    break
                wav = pending.pop(0)
                y, sr = load_audio_norm(wav)
                if sr != audio_conf.sample_rate:
                    y = resample(y, sr, audio_conf.sample_rate)
                audio_seconds += len(y) / audio_conf.sample_rate
                pool.write(s, np.asarray(y, np.float32))
                pool.close(s)
                slot_wav[s] = wav
                slot_ticks[s] = 0
            pool.tick()
            ticks += 1
            for s in list(slot_wav):
                slot_ticks[s] += 1
                if pool.done(s):
                    rec = {"wav": slot_wav.pop(s),
                           "transcription": (pool.beam_text(s) if use_beam
                                             else pool.text(s)),
                           "chunks": slot_ticks.pop(s)}
                    out.write(json.dumps(rec, ensure_ascii=False) + "\n")
                    out.flush()
                    done += 1
    finally:
        if out is not sys.stdout:
            out.close()
    dt = time.perf_counter() - t0
    print(f"served {done} utterances ({audio_seconds:.1f} audio-s) in "
          f"{dt:.1f}s over {ticks} ticks on {args.slots} slots = "
          f"{audio_seconds / dt:.0f} audio-s/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
