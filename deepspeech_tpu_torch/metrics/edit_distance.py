"""Edit distance + WER/CER (the JAX package's ``metrics/edit_distance.py``,
copied; the numpy dynamic program only, without the native C++ module).

Semantics match the reference exactly:
* ``wer(s1, s2)`` maps words to token ids before the distance so multi-char
  words cost 1 edit (reference decoder.py:44-62).
* ``cer(s1, s2)`` strips spaces then takes character distance
  (reference decoder.py:64-73).
* ``get_cer_wer`` returns (wer, cer, wer_ref_len, cer_ref_len) with the
  reference's strip + or-1 denominators and the equal-string shortcut
  (reference data/utils.py:47-57).
"""

from __future__ import annotations

import numpy as np


def edit_distance(a, b) -> int:
    """Levenshtein distance between two token sequences."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    na, nb = len(a), len(b)
    if na == 0:
        return nb
    if nb == 0:
        return na
    prev = np.arange(nb + 1, dtype=np.int64)
    pos = np.arange(nb + 1, dtype=np.int64)
    for i in range(1, na + 1):
        # candidate cost before resolving the left-to-right insertion chain
        cand = np.empty(nb + 1, dtype=np.int64)
        cand[0] = i
        cand[1:] = np.minimum(prev[:-1] + (b != a[i - 1]), prev[1:] + 1)
        # cur[j] = min_{k<=j} cand[k] + (j-k): a prefix-min over cand[k]-k
        prev = np.minimum.accumulate(cand - pos) + pos
    return int(prev[nb])


def string_distance(s1: str, s2: str) -> int:
    return edit_distance(np.frombuffer(s1.encode("utf-32-le"), dtype=np.uint32),
                         np.frombuffer(s2.encode("utf-32-le"), dtype=np.uint32))


def wer(s1: str, s2: str) -> int:
    """Word-level edit distance (unnormalized), reference decoder.py:44-62."""
    vocab = {w: i for i, w in enumerate(set(s1.split() + s2.split()))}
    return edit_distance([vocab[w] for w in s1.split()],
                         [vocab[w] for w in s2.split()])


def cer(s1: str, s2: str) -> int:
    """Char-level edit distance ignoring spaces, reference decoder.py:64-73."""
    return string_distance(s1.replace(" ", ""), s2.replace(" ", ""))


def get_cer_wer(transcript: str, reference: str):
    """(wer, cer, wer_ref, cer_ref) with reference data/utils.py:47-57
    semantics."""
    reference = reference.strip()
    transcript = transcript.strip()
    wer_ref = float(len(reference.split()) or 1)
    cer_ref = float(len(reference.replace(" ", "")) or 1)
    if reference == transcript:
        return 0, 0, wer_ref, cer_ref
    return (wer(transcript, reference), cer(transcript, reference), wer_ref,
            cer_ref)
