"""The general generator of the benchmark's traffic, read from a mix's file.

A mix (``traffic/<name>.json``) fixes the work; the seed draws only what
does not change it:

* ``bins`` bins of ``batch`` utterances each, from a split of
  ``split_utterances`` sorted by duration: bin k is the split's own bin
  (``batch`` consecutive ranks, as the port's ``BucketingSampler`` cuts
  the whole split) at the middle of the split's k-th ``1/bins`` slice,
  so each bin pads as much as the split's bins there do. A rank r
  lasts the duration at quantile (r + 0.5) / ``split_utterances`` of the
  mix's distribution (``duration_quantiles``: [[p, seconds], ...], linear
  between knots). Every seed carries the same audio;
* a transcript of ``round(chars_per_second x duration)`` characters each:
  words of 1 to 10 uppercase letters drawn by the seed, one space between
  words, none made of I, V and X alone (the label codec spells Roman
  numerals out, which would change the length);
* waveforms drawn by the seed (a chirp under a slow amplitude swing, plus
  noise: speech-like in level), written as 16-bit wav files at the
  configuration's sample rate with a ``wav,txt,duration`` manifest, the
  rows sorted by duration;
* the bins visited in one fixed cycle (a shuffle of the bins drawn once,
  the same for every mix and seed) from a place in it that the seed
  draws; every pass follows the cycle from there. So each run's passes
  hold the same neighbours: which bin's host work overlaps which bin's
  device work is the same in every run, as the work is.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import wavfile

LETTERS = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
WORD_LETTERS = (1, 10)  # a word's fewest and most letters
ENVELOPE_STEP = 160


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [seed % 2 ** 64, *stream]))


def ranks(mix: dict) -> np.ndarray:
    """(bins x batch,) the split's ranks the mix keeps, ascending: for
    each bin the split's own bin (its ranks cut into groups of ``batch``
    from the shortest, as ``BucketingSampler`` cuts them) at the middle
    of the bin's slice of the split."""
    n, k, b = mix["split_utterances"], mix["bins"], mix["batch"]
    whole = -(-n // b)  # the split's bins
    middles = (2 * np.arange(k, dtype=np.int64) + 1) * whole // (2 * k)
    starts = np.minimum(middles * b, n - b)
    return (starts[:, None] + np.arange(b)[None, :]).reshape(-1)


def durations(mix: dict) -> np.ndarray:
    """(bins x batch,) seconds, ascending, the same for every seed."""
    knots = np.asarray(mix["duration_quantiles"], np.float64)
    p = (ranks(mix) + 0.5) / mix["split_utterances"]
    return np.interp(p, knots[:, 0], knots[:, 1])


def sample_counts(mix: dict, sample_rate: int) -> np.ndarray:
    return np.rint(durations(mix) * sample_rate).astype(np.int64)


def transcript_lengths(mix: dict) -> np.ndarray:
    return np.maximum(1, np.rint(durations(mix) * mix["chars_per_second"])
                      ).astype(np.int64)


def bins(mix: dict) -> list:
    """Consecutive groups of ``batch`` rows of the duration-sorted rows."""
    b = mix["batch"]
    return [list(range(i * b, (i + 1) * b)) for i in range(mix["bins"])]


def pass_order(mix: dict, seed: int) -> list:
    """A pass's order of the bins: the one fixed cycle (the same shuffle
    for every seed) from the seed's place."""
    n = len(bins(mix))
    cycle = [int(i) for i in rng(0, 1).permutation(n)]
    at = int(rng(seed, 1).integers(n))
    return cycle[at:] + cycle[:at]


def stream(mix: dict, seed: int, passes: int) -> list:
    """The bins of ``passes`` passes, in order."""
    groups = bins(mix)
    return [groups[i] for i in pass_order(mix, seed)] * passes


def transcript(r: np.random.Generator, n: int) -> str:
    """``n`` characters: words of ``WORD_LETTERS`` [least, most] letters
    with one space between them, no space at either end."""
    lo, hi = WORD_LETTERS
    words, left = [], n
    while left > 0:
        k = min(int(r.integers(lo, hi + 1)), left)
        if 0 < left - k <= lo:  # no room for a space and a whole word
            k = left
        word = "".join(r.choice(LETTERS, k))
        if not word.strip("IVX"):  # a Roman numeral would be spelled out
            word = "A" + word[1:]
        words.append(word)
        left -= k + 1
    return " ".join(words)


def waveform(r: np.random.Generator, n: int, sr: int) -> np.ndarray:
    """Peak-normalized chirp with a slow swing plus uniform noise (the shape
    of ``chip_smoke.py:450 synthetic_audio``), in float32."""
    t = np.arange(n, dtype=np.float32) / np.float32(sr)
    f0, fm = np.float32(r.uniform(100, 300)), np.float32(r.uniform(2, 5))
    y = np.sin(np.float32(2 * np.pi) * (f0 + np.float32(400) * t / t[-1]) * t)
    # the swing, held for 10 ms at a time
    swing = np.sin(np.float32(2 * np.pi) * fm * t[::ENVELOPE_STEP])
    y *= np.repeat(np.float32(0.5) + np.float32(0.5) * swing,
                   ENVELOPE_STEP)[:n]
    y += np.float32(0.1) * (r.random(n, dtype=np.float32) - np.float32(0.5))
    return y / np.abs(y).max()


def write_inputs(mix: dict, sr: int, seed: int, directory: str) -> str:
    """Write the mix's wavs (at ``sr`` samples a second), transcripts and
    manifest under ``directory`` -> the manifest's path."""
    r = rng(seed, 0)
    rows = []
    for i, (n, chars, dur) in enumerate(zip(sample_counts(mix, sr),
                                            transcript_lengths(mix),
                                            durations(mix))):
        wav = os.path.join(directory, f"{i:05d}.wav")
        txt = os.path.join(directory, f"{i:05d}.txt")
        y = waveform(r, int(n), sr)
        wavfile.write(wav, sr, np.rint(y * np.float32(32767)).astype(
            np.int16))
        with open(txt, "w", encoding="utf8") as f:
            f.write(transcript(r, int(chars)))
        rows.append(f"{wav},{txt},{dur:.6f}\n")
    manifest = os.path.join(directory, "manifest.csv")
    with open(manifest, "w", encoding="utf8") as f:
        f.writelines(rows)
    return manifest
