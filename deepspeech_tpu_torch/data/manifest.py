"""Manifest files: CSV rows ``wav,txt[,duration]`` (the JAX package's
``data/manifest.py``, copied).

Replaces the reference's manifest plumbing (reference data/utils.py:11-37
create_manifest/order_and_prune_files, data/merge_manifests.py) with no
shell-outs: durations come from the wav headers directly instead of ``soxi``
(reference data/utils.py:26-27).
"""

from __future__ import annotations

import csv
import os

from deepspeech_tpu_torch.audio.io import duration_seconds


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


def order_and_prune_files(file_paths, min_duration=None, max_duration=None,
                          with_durations: bool = False):
    """Duration-sort wav paths, pruning outside [min, max] seconds
    (reference data/utils.py:24-37; header probe instead of soxi)."""
    pairs = [(p, duration_seconds(p)) for p in file_paths]
    if min_duration is not None and max_duration is not None:
        pairs = [(p, d) for p, d in pairs if min_duration <= d <= max_duration]
    pairs.sort(key=lambda x: x[1])
    if with_durations:
        return pairs
    return [p for p, _ in pairs]


def txt_for_wav(wav_path: str) -> str:
    """The reference's path convention: .../wav/x.wav -> .../txt/x.txt
    (reference data/utils.py:18)."""
    return wav_path.replace("/wav/", "/txt/").replace(".wav", ".txt")


def _write_sorted(wavs, output_path: str, min_duration, max_duration) -> int:
    pairs = order_and_prune_files(wavs, min_duration, max_duration,
                                  with_durations=True)
    write_manifest(output_path,
                   [(os.path.abspath(w), os.path.abspath(txt_for_wav(w)),
                     round(d, 3)) for w, d in pairs])
    return len(pairs)


def create_manifest(data_path: str, output_path: str, min_duration=None,
                    max_duration=None) -> int:
    """Walk ``data_path`` for wavs, duration-sort/prune, write a manifest
    with durations (reference data/utils.py:11-21 + duration column)."""
    wavs = [os.path.join(dirpath, f)
            for dirpath, _, files in os.walk(data_path)
            for f in files if f.endswith(".wav")]
    return _write_sorted(wavs, output_path, min_duration, max_duration)


def merge_manifests(manifest_paths, output_path: str, min_duration=1,
                    max_duration=15) -> int:
    """Merge manifests, re-sort and re-prune by duration
    (reference data/merge_manifests.py:20-31)."""
    wavs = [row[0] for path in manifest_paths for row in read_manifest(path)]
    return _write_sorted(wavs, output_path, min_duration, max_duration)
