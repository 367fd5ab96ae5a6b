"""Decoder base class: id -> string conversion (reference decoder.py API)."""

from __future__ import annotations


class Decoder:
    def __init__(self, labels: str, blank_index: int = 0):
        self.labels = labels
        self.int_to_char = dict(enumerate(labels))
        self.blank_index = blank_index
        self.space_index = labels.index(" ") if " " in labels else len(labels)

    def decode(self, probs, sizes=None):
        raise NotImplementedError
