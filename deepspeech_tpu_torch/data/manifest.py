"""Manifest files: CSV rows ``wav,txt[,duration]`` (the JAX package's
``data/manifest.py``, reading and writing; building a manifest from a
directory of wavs is not ported yet)."""

from __future__ import annotations

import csv
import os


def read_manifest(path: str, max_items: int | None = None):
    """-> list of (wav_path, txt_path, duration_or_0) (reference
    data_loader_aug.py:342-345)."""
    with open(path, newline="") as f:
        rows = [(r[0], r[1], float(r[2]) if len(r) > 2 else 0.0)
                for r in csv.reader(f) if r]
    return rows[:max_items] if max_items else rows


def write_manifest(path: str, rows):
    """rows: iterable of (wav, txt) or (wav, txt, duration)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        for row in rows:
            writer.writerow(row)
