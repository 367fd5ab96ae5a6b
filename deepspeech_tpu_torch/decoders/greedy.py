"""Greedy (best-path) CTC decoder.

The argmax runs on the device; the id -> string collapse is host string
work: drop blanks, drop repeats when asked, record per-character frame
offsets (reference decoder.py:146-197).
"""

from __future__ import annotations

import numpy as np
import torch

from deepspeech_tpu_torch.decoders.base import Decoder
from deepspeech_tpu_torch.utils import trace


def greedy_ids(probs_or_logits: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B, T) int32 argmax ids, on the input's device."""
    return probs_or_logits.argmax(dim=-1).to(torch.int32)


class GreedyDecoder(Decoder):
    def convert_to_strings(self, sequences, sizes=None,
                           remove_repetitions=False, return_offsets=False):
        strings, offsets = [], []
        for i, seq in enumerate(sequences):
            size = int(sizes[i]) if sizes is not None else len(seq)
            string, string_offsets = self.process_string(
                seq, size, remove_repetitions)
            strings.append([string])  # one path per utterance
            offsets.append([string_offsets])
        if return_offsets:
            return strings, offsets
        return strings

    def process_string(self, sequence, size, remove_repetitions=False):
        chars, offs = [], []
        prev = None
        for i in range(size):
            idx = int(sequence[i])
            char = self.int_to_char[idx]
            if idx != self.blank_index:
                if remove_repetitions and i != 0 and prev is not None \
                        and char == self.int_to_char[prev]:
                    pass
                elif idx == self.space_index:
                    chars.append(" ")
                    offs.append(i)
                else:
                    chars.append(char)
                    offs.append(i)
            prev = idx
        return "".join(chars), np.array(offs, dtype=np.int32)

    def decode_ids(self, ids, sizes=None):
        """Decode argmax ids computed on the device (the train and eval
        steps return them) -> (strings, offsets), repeats collapsed.
        Spans: ``decode``, and within it ``decode.readback`` over the
        copies to the host, which wait for the device."""
        with trace.span("decode"):
            with trace.span("decode.readback"):
                if isinstance(ids, torch.Tensor):
                    ids = ids.cpu().numpy()
                if isinstance(sizes, torch.Tensor):
                    sizes = sizes.cpu().numpy()
            return self.convert_to_strings(np.asarray(ids), sizes,
                                           remove_repetitions=True,
                                           return_offsets=True)

    def decode(self, probs, sizes=None):
        """probs: (B, T, C) tensor. -> (strings, offsets), repeats
        collapsed."""
        ids = greedy_ids(torch.as_tensor(probs)).cpu().numpy()
        if isinstance(sizes, torch.Tensor):
            sizes = sizes.cpu().numpy()
        return self.convert_to_strings(ids, sizes, remove_repetitions=True,
                                       return_offsets=True)
