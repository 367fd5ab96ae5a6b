"""Decoder base class: id -> string conversion + WER/CER helpers
(reference decoder.py:23-87 API)."""

from __future__ import annotations

from deepspeech_tpu_torch.metrics import cer as _cer
from deepspeech_tpu_torch.metrics import wer as _wer


class Decoder:
    def __init__(self, labels: str, blank_index: int = 0):
        self.labels = labels
        self.int_to_char = dict(enumerate(labels))
        self.blank_index = blank_index
        self.space_index = labels.index(" ") if " " in labels else len(labels)

    def wer(self, s1: str, s2: str) -> int:
        return _wer(s1, s2)

    def cer(self, s1: str, s2: str) -> int:
        return _cer(s1, s2)

    def decode(self, probs, sizes=None):
        raise NotImplementedError
