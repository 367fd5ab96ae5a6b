"""CER-driven curriculum sampling (the JAX package's ``data/curriculum.py``,
copied: the port imports nothing of that package).

Exact math of the reference (reference data/curriculum.py:4-31): per-epoch
probabilistic resampling favoring utterances whose running CER is near
CL_POINT=0.2 (ramp up from 0, down to 0.51), plus a 2% base probability and
a short-text bonus. The per-utterance CER/WER history lives in
:class:`CurriculumStore` and persists as CSV sidecars next to every
checkpoint (``<ckpt>.curriculum.csv``, ``<ckpt>.val.curriculum.csv``), in
the same bytes as the JAX package writes them, so either package reads the
other's.
"""

from __future__ import annotations

import csv
import random


class Curriculum:
    BASE_PROB = 0.02
    SHORT_PROB = 0.00  # 0.05 in some reference experiments
    CL_PROB = 0.2
    CL_POINT = 0.2

    @classmethod
    def sample(cls, items, getter, epoch, min=1):
        """Yield items with per-item probability from get_prob until at least
        ``min`` have been yielded; epoch-seeded (reference
        curriculum.py:10-21). An empty item list raises instead of spinning
        (the reference loops forever there)."""
        items = list(items)
        if not items and min > 0:
            raise ValueError(
                "Curriculum.sample: no items to sample from (empty or "
                "fully filtered manifest)")
        rng = random.Random(epoch)
        total = 0
        while total < min:
            for item in items:
                text, cer = getter(item)
                if rng.random() < cls.get_prob(text, cer):
                    yield item
                    total += 1

    @classmethod
    def get_prob(cls, text, cer):
        """Reference curriculum.py:23-31."""
        length_bonus = cls.SHORT_PROB * 3 / (3 + len(text))
        cl_prob = 0.0
        if cer < cls.CL_POINT:
            cl_prob = cer / cls.CL_POINT
        elif cer < 0.51:
            cl_prob = (0.51 - cer) / (0.51 - cls.CL_POINT)
        return cls.BASE_PROB + length_bonus + cls.CL_PROB * cl_prob


CURRICULUM_FIELDS = ["wav", "text", "transcript", "offsets", "times_used",
                     "cer", "wer"]


class CurriculumStore:
    """Per-utterance running decode quality, keyed by wav path."""

    def __init__(self, wav_paths=(), default_cer: float = 0.999):
        self.rows = {wav: {"wav": wav, "text": "", "transcript": "",
                           "offsets": None, "times_used": 0,
                           "cer": default_cer, "wer": default_cer}
                     for wav in wav_paths}

    def update(self, wav, reference, transcript, offsets, cer, wer,
               times_used=None):
        """Reference update_curriculum (data_loader_aug.py:487-497);
        ``times_used=None`` increments the stored counter."""
        if times_used is None:
            prev = self.rows.get(wav)
            times_used = (prev["times_used"] if prev else 0) + 1
        self.rows[wav] = {"wav": wav, "text": reference,
                          "transcript": transcript, "offsets": offsets,
                          "times_used": times_used, "cer": cer, "wer": wer}

    def get(self, wav):
        return self.rows.get(wav)

    def save(self, path: str):
        """CSV sidecar (reference save_curriculum,
        data_loader_aug.py:499-505)."""
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, CURRICULUM_FIELDS)
            writer.writeheader()
            for row in self.rows.values():
                writer.writerow(row)

    @classmethod
    def load(cls, path: str) -> "CurriculumStore":
        """Reference curriculum_filepath load (data_loader_aug.py:437-445)."""
        store = cls()
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                row["cer"] = float(row["cer"])
                row["wer"] = float(row["wer"])
                row["times_used"] = int(row.get("times_used") or 0)
                store.rows[row["wav"]] = row
        return store

    def __len__(self):
        return len(self.rows)
