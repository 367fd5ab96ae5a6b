"""Noise-mix audition CLI (reference noise_inject.py:1-23; the port's twin
of the root ``noise_inject.py``): mix a noise file into an input wav at a
given noise level and save the result.

    python -m deepspeech_tpu_torch.cli.noise_inject --input-path in.wav \\
        --noise-path noise.wav --output-path out.wav --noise-level 0.5
"""

from __future__ import annotations

import argparse

from deepspeech_tpu_torch.audio.io import load_audio, save_wav
from deepspeech_tpu_torch.augment.noise import NoiseInjection


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input-path", default="input.wav",
                        help="The input audio to inject noise into")
    parser.add_argument("--noise-path", default="noise.wav",
                        help="The noise file to mix in")
    parser.add_argument("--output-path", default="output.wav",
                        help="Where to save the mixed audio")
    parser.add_argument("--sample-rate", default=16000, type=int)
    parser.add_argument("--noise-level", type=float, default=1.0,
                        help="noise-to-signal ratio (higher = more noise)")
    args = parser.parse_args(argv)

    injector = NoiseInjection(sample_rate=args.sample_rate)
    data, sample_rate = load_audio(args.input_path)
    assert sample_rate == args.sample_rate, (sample_rate, args.sample_rate)
    mixed = injector.inject_noise_sample(data, args.noise_path,
                                         args.noise_level)
    save_wav(args.output_path, mixed, args.sample_rate)
    print(f"Saved mixed file to {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
