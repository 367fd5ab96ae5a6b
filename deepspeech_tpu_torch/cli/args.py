"""Shared argparse groups, flag for flag with the JAX package's CLIs."""

from __future__ import annotations

import argparse


def add_decoder_args(parser: argparse.ArgumentParser):
    beam_args = parser.add_argument_group("Beam Decode Options")
    beam_args.add_argument("--top-paths", default=1, type=int,
                           help="number of beams to return")
    beam_args.add_argument("--beam-width", default=10, type=int,
                           help="Beam width to use")
    beam_args.add_argument("--lm-path", default=None, type=str,
                           help="Path to an (optional) kenlm-format arpa/binary n-gram "
                                "language model for use with beam search")
    beam_args.add_argument("--alpha", default=0.8, type=float,
                           help="Language model weight")
    beam_args.add_argument("--beta", default=1, type=float,
                           help="Language model word bonus (all words)")
    beam_args.add_argument("--cutoff-top-n", default=40, type=int,
                           help="Keep only the top cutoff_top_n characters "
                                "by probability in beam search")
    beam_args.add_argument("--cutoff-prob", default=1.0, type=float,
                           help="Cumulative probability cutoff in beam search")
    beam_args.add_argument("--lm-workers", default=1, type=int,
                           help="Parallel beam-search workers over the "
                                "batch: threads for the native C++ backend "
                                "(its search call releases the GIL), "
                                "spawned processes for the pure-Python "
                                "backend; no effect on --decoder "
                                "device_beam (already batch-parallel on "
                                "device)")
    beam_args.add_argument("--blank-collapse", default=1.0, type=float,
                           help="Drop frames with p(blank) >= this before "
                                "beam search (arXiv:2210.17017); 1.0 = off")
    return parser


def add_reference_noop_args(parser: argparse.ArgumentParser):
    """Accept the reference's CUDA/DDP flags so reference command lines
    run unmodified; the device is chosen with ``--device``."""
    g = parser.add_argument_group("Reference compatibility (accepted)")
    g.add_argument("--cuda", action="store_true",
                   help="no-op: the device is --device (cuda by default)")
    g.add_argument("--data-parallel", action="store_true",
                   help="no-op: multi-GPU is not ported yet")
    g.add_argument("--gpu-rank", default=None,
                   help="no-op: use --device cuda:N")
    g.add_argument("--dist-backend", default="gloo",
                   help="no-op: multi-GPU is not ported yet")
    return parser


def add_inference_args(parser: argparse.ArgumentParser):
    parser.add_argument("--decoder", default="greedy",
                        choices=["greedy", "beam", "device_beam"],
                        help="Decoder to use: greedy, beam (the host prefix "
                             "search) or device_beam (the search on "
                             "--device; with --lm-path the n-gram LM is "
                             "fused there too)")
    parser.add_argument("--continue-from", "--model-path",
                        dest="continue_from", required=True,
                        help="Path to model checkpoint")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser
