"""Single-file transcription CLI: wav -> JSON transcript on stdout.

    python -m deepspeech_tpu_torch.cli.transcribe --model-path m.ckpt \\
        --audio-path a.wav [--device cuda]

Same flags and JSON as the JAX package's ``transcribe``: ``--decoder
greedy``, ``beam`` (host search) or ``device_beam`` (the search on
``--device``, reading the posteriors where the model left them), each
with ``--lm-path`` (ARPA or DSLM). ``--chunk-seconds > 0`` streams the
audio through the chunked runtime (``serve/``; a unidirectional DS2 or a
CNN stack, ``--se-mode`` for the SE stacks), echoing each fragment to
stderr; ``beam`` and ``device_beam`` then select the streaming device beam.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from deepspeech_tpu_torch.cli.args import (add_decoder_args,
                                           add_inference_args,
                                           add_reference_noop_args)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DeepSpeech transcription "
                                            "(PyTorch/CUDA port)")
    add_inference_args(p)
    p.add_argument("--audio-path", default="audio.wav")
    p.add_argument("--offsets", action="store_true",
                   help="include per-character frame offsets")
    p.add_argument("--channel", default=-1, type=int,
                   help="stereo channel (0=left, 1=right, -1=average)")
    p.add_argument("--meta", action="store_true",
                   help="include model/decoder metadata")
    p.add_argument("--norm", default="max_frame")
    p.add_argument("--se-mode", default="running",
                   choices=["running", "two_pass", "error"],
                   help="squeeze-excitation handling for streamed CNN "
                        "stacks: 'running' = causal running-mean gate "
                        "(live approximation), 'two_pass' = provisional "
                        "fragments + an exact batch recompute at end of "
                        "stream (final JSON equals the batch model "
                        "exactly), 'error' = refuse SE stacks")
    p.add_argument("--chunk-seconds", default=0.0, type=float,
                   help="stream the audio through the low-latency chunked "
                        "runtime (unidirectional models only), emitting "
                        "text incrementally to stderr")
    add_decoder_args(p)
    add_reference_noop_args(p)
    return p


@torch.inference_mode()
def transcribe(audio_path, audio_conf, model, decoder, norm="max_frame",
               channel=-1, device: str | torch.device = "cuda"):
    """wav path -> (strings, offsets), front-end and model on ``device``."""
    from deepspeech_tpu_torch.audio.dsp import resample
    from deepspeech_tpu_torch.audio.features import featurize_batch
    from deepspeech_tpu_torch.audio.io import load_audio_norm
    from deepspeech_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    y, sr = load_audio_norm(audio_path, channel=channel)
    if sr != audio_conf.sample_rate:
        y = resample(y, sr, audio_conf.sample_rate)
    audio = torch.from_numpy(np.ascontiguousarray(y[None, :])).to(dev)
    lengths = torch.tensor([len(y)], device=dev)
    spect, spect_lengths = featurize_batch(audio, lengths, audio_conf, norm)
    _, probs, out_lens = model(spect, spect_lengths)
    return decoder.decode(probs, out_lens)


def transcribe_streaming(audio_path, audio_conf, model, labels,
                         chunk_seconds, norm="max_frame", channel=-1,
                         echo=None, decoder="greedy", beam_width=16,
                         cutoff_top_n=40, cutoff_prob=1.0, top_paths=1,
                         lm_path=None, alpha=0.8, beta=1.0,
                         se_mode="running"):
    """The chunked path (``serve/``): feeds the wav through the streaming
    runtime in ``chunk_seconds`` pieces on the model's device, reporting
    each incremental greedy fragment through ``echo``, and returns the
    final transcript as (strings, offsets), the shape ``transcribe``
    returns. With ``decoder`` beam or device_beam the streaming beam search
    rides the same emission and the transcript is its best beam."""
    from deepspeech_tpu_torch.audio.dsp import resample
    from deepspeech_tpu_torch.audio.io import load_audio_norm
    from deepspeech_tpu_torch.models.cnn import ConvStack
    from deepspeech_tpu_torch.serve import (CNNStreamingTranscriber,
                                            StreamingTranscriber)
    from deepspeech_tpu_torch.serve.streaming_cnn import conv_stack_geometry

    y, sr = load_audio_norm(audio_path, channel=channel)
    if sr != audio_conf.sample_rate:
        y = resample(y, sr, audio_conf.sample_rate)
    extra = {}
    if isinstance(model, ConvStack):
        # chunked overlap-save: a multiple of the stack's total stride
        stride = conv_stack_geometry(model.specs)[-1][0]
        cls, extra = CNNStreamingTranscriber, {"se_mode": se_mode}
    else:
        stride, cls = 2, StreamingTranscriber
    quantum = stride * 2 if stride % 2 else stride  # DS2 also needs even
    chunk_frames = max(
        4, quantum * max(1, round(chunk_seconds * audio_conf.sample_rate
                                  / audio_conf.hop / quantum)))
    use_beam = decoder in ("beam", "device_beam")
    st = cls(model, labels, audio_conf, normalize=norm, **extra,
             chunk_frames=chunk_frames,
             decoder="beam" if use_beam else "greedy",
             beam_width=beam_width, cutoff_top_n=cutoff_top_n,
             cutoff_prob=cutoff_prob, lm_path=lm_path if use_beam else None,
             lm_alpha=alpha, lm_beta=beta)
    step = chunk_frames * audio_conf.hop
    for pos in range(0, len(y), step):
        for frag in st.feed(y[pos:pos + step]):
            if frag and echo:
                echo(frag)
    for frag in st.finish():
        if frag and echo:
            echo(frag)
    if use_beam:
        return ([st.beam_texts(top_paths=top_paths)[0]],
                [[np.zeros(0, np.int32)] * top_paths])
    return [[st.texts[0]]], [[np.zeros(0, np.int32)]]


def decode_results(decoded_output, decoded_offsets, args, package):
    """JSON assembly (reference transcribe.py:33-60)."""
    results = {"output": []}
    if args.meta:
        results["_meta"] = {
            "acoustic_model": {
                "name": os.path.basename(args.continue_from),
                **{k: package.get(k) for k in
                   ("version", "rnn_type", "hidden_size", "hidden_layers")},
            },
            "language_model": {
                "name": os.path.basename(args.lm_path) if args.lm_path else None,
            },
            "decoder": {
                "lm": args.lm_path is not None,
                "alpha": args.alpha if args.lm_path is not None else None,
                "beta": args.beta if args.lm_path is not None else None,
                "type": args.decoder,
            },
        }
    for b in range(len(decoded_output)):
        for pi in range(min(args.top_paths, len(decoded_output[b]))):
            result = {"transcription": decoded_output[b][pi]}
            if args.offsets:
                result["offsets"] = np.asarray(
                    decoded_offsets[b][pi]).tolist()
            results["output"].append(result)
    return results


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from deepspeech_tpu_torch.cli.common import (build_decoder,
                                                 load_inference_model,
                                                 refuse_conformer)

    model, labels, audio_conf, package = load_inference_model(
        args.continue_from, device=args.device)
    decoder = build_decoder(args, labels)
    if args.chunk_seconds > 0:
        import sys

        refuse_conformer(model, "transcribe --chunk-seconds")

        def echo(frag):
            print(frag, end="", file=sys.stderr, flush=True)

        decoded_output, decoded_offsets = transcribe_streaming(
            args.audio_path, audio_conf, model, labels, args.chunk_seconds,
            norm=args.norm, channel=args.channel, echo=echo,
            decoder=args.decoder, beam_width=args.beam_width,
            cutoff_top_n=args.cutoff_top_n, cutoff_prob=args.cutoff_prob,
            top_paths=args.top_paths, lm_path=args.lm_path,
            alpha=args.alpha, beta=args.beta, se_mode=args.se_mode)
        print(file=sys.stderr)
    else:
        decoded_output, decoded_offsets = transcribe(
            args.audio_path, audio_conf, model, decoder, norm=args.norm,
            channel=args.channel, device=args.device)
    output = decode_results(decoded_output, decoded_offsets, args, package)
    output["input"] = {"channel": args.channel, "source": args.audio_path}
    output["model"] = {"model": args.continue_from}
    print(json.dumps(output, ensure_ascii=False))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
