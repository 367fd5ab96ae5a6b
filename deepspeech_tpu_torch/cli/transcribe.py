"""Single-file transcription CLI: wav -> JSON transcript on stdout.

    python -m deepspeech_tpu_torch.cli.transcribe --model-path m.ckpt \\
        --audio-path a.wav [--device cuda]

Same flags and JSON as the JAX package's ``transcribe``: ``--decoder
greedy``, ``beam`` (host search) or ``device_beam`` (the search on
``--device``, reading the posteriors where the model left them), each
with ``--lm-path`` (ARPA or DSLM). Not ported yet (raises SystemExit naming
the later slice): ``--chunk-seconds > 0`` (streaming).
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
                   help="squeeze-excitation handling for streamed CNN stacks "
                        "(streaming is not ported yet)")
    p.add_argument("--chunk-seconds", default=0.0, type=float,
                   help="streaming; not ported yet")
    add_decoder_args(p)
    add_reference_noop_args(p)
    return p


def check_ported(args) -> None:
    """Refuse the flags whose paths this package has not ported yet."""
    if args.chunk_seconds > 0:
        raise SystemExit("--chunk-seconds: streaming is not ported to "
                         "PyTorch yet (the streaming/serve slice, "
                         "ROADMAP.md)")


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
    check_ported(args)
    from deepspeech_tpu_torch.cli.common import (build_decoder,
                                                 load_inference_model)

    model, labels, audio_conf, package = load_inference_model(
        args.continue_from, device=args.device)
    decoder = build_decoder(args, labels)
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
