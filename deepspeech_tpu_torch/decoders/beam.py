"""CTC prefix beam search on the host with optional n-gram LM fusion (the
JAX package's ``decoders/beam.py``, pure-Python backend).

The standard CTC prefix beam search (Hannun et al. 2014):

* per step, each surviving prefix tracks p_blank / p_non_blank; extensions
  merge probabilities of identical prefixes exactly;
* ``cutoff_top_n`` / ``cutoff_prob`` prune the per-step character candidates
  (the ctcdecode knobs);
* LM fusion at word boundaries: emitting the space character adds
  ``alpha * log10 P(word | context) + beta`` (KenLM-style shallow fusion);
* returns (strings, offsets) with ``top_paths`` hypotheses per utterance.

The batch fans out over ``num_processes`` spawned worker processes: Python
threads cannot speed up the pure-Python search. The JAX package's native
C++ backend is not ported yet (``backend="native"`` raises); it gives
bit-identical hypotheses to this one.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import torch

from deepspeech_tpu_torch.decoders.base import Decoder
from deepspeech_tpu_torch.decoders.lm import LOG10, load_lm

NEG_INF = -math.inf


def blank_collapse(log_probs: np.ndarray, threshold: float,
                   blank: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Compress CTC emissions by dropping high-confidence blank frames
    (arXiv:2210.17017 "Blank Collapse"): frames with p(blank) >= threshold
    carry (almost) no label mass, and a run of them is equivalent to a
    single blank for the hypothesis set, so each run keeps one
    representative frame.

    Returns (compressed (T', C) log_probs, frame_index (T',) mapping each
    kept frame back to its original time index, used to restore offsets).
    """
    t = log_probs.shape[0]
    if threshold >= 1.0 or t == 0:
        return log_probs, np.arange(t)
    blankish = log_probs[:, blank] >= math.log(threshold)
    keep = ~blankish
    # keep the first frame of every blank run (preserves the blank's role
    # as a repeat-character separator)
    first_of_run = blankish & ~np.concatenate([[False], blankish[:-1]])
    keep |= first_of_run
    idx = np.nonzero(keep)[0]
    return log_probs[idx], idx


def _logaddexp(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = a if a > b else b
    return m + math.log1p(math.exp(-abs(a - b)))


def ctc_beam_search(log_probs: np.ndarray, beam_width: int = 10,
                    blank: int = 0, cutoff_top_n: int = 40,
                    cutoff_prob: float = 1.0, space_index: int | None = None,
                    lm=None, alpha: float = 0.8, beta: float = 1.0,
                    labels: str | None = None, top_paths: int = 1):
    """Decode one utterance.

    log_probs: (T, C) log posteriors. Returns list of up to ``top_paths``
    (ids tuple, offsets tuple, total_log_prob) sorted best-first.
    """
    t_max, _ = log_probs.shape
    # beams: prefix(tuple ids) -> [p_b, p_nb, offsets(tuple), lm_state]
    # lm_state = (words tuple so far, current partial word string)
    init_lm = ((), "") if lm is not None else None
    beams = {(): [0.0, NEG_INF, (), init_lm]}

    def lm_word_bonus(lm_state):
        """alpha*log10 P(word|ctx) + beta when a word completes."""
        words, partial = lm_state
        if not partial:
            return 0.0, (words, "")
        s = alpha * lm.score_word(("<s>",) + words, partial) * LOG10 + beta
        return s, (words + (partial,), "")

    def extend_lm(lm_state, c):
        """(bonus, new lm_state) of appending char c."""
        if lm is None:
            return 0.0, lm_state
        if c == space_index:
            return lm_word_bonus(lm_state)
        return 0.0, (lm_state[0], lm_state[1] + labels[c])

    for t in range(t_max):
        lp = log_probs[t]
        # candidate character pruning (ctcdecode cutoff_top_n/cutoff_prob)
        order = np.argsort(lp)[::-1]
        if cutoff_prob < 1.0:
            cum = np.cumsum(np.exp(lp[order]))
            keep = int(np.searchsorted(cum, cutoff_prob) + 1)
            order = order[:keep]
        cand = order[: cutoff_top_n]

        next_beams: dict = {}

        def bump(prefix, which, value, offsets, lm_state):
            entry = next_beams.get(prefix)
            if entry is None:
                entry = [NEG_INF, NEG_INF, offsets, lm_state]
                next_beams[prefix] = entry
            entry[which] = _logaddexp(entry[which], value)

        for prefix, (p_b, p_nb, offsets, lm_state) in beams.items():
            total = _logaddexp(p_b, p_nb)
            last = prefix[-1] if prefix else None
            for c in cand:
                p_c = float(lp[c])
                if c == blank:
                    bump(prefix, 0, total + p_c, offsets, lm_state)
                elif c == last:
                    # repeat collapses into the same prefix...
                    bump(prefix, 1, p_nb + p_c, offsets, lm_state)
                    # ...or extends it if a blank intervened
                    if p_b != NEG_INF:
                        bonus, new_state = extend_lm(lm_state, c)
                        bump(prefix + (int(c),), 1, p_b + p_c + bonus,
                             offsets + (t,), new_state)
                else:
                    bonus, new_state = extend_lm(lm_state, c)
                    bump(prefix + (int(c),), 1, total + p_c + bonus,
                         offsets + (t,), new_state)

        # keep top beam_width prefixes by merged probability
        scored = sorted(next_beams.items(),
                        key=lambda kv: _logaddexp(kv[1][0], kv[1][1]),
                        reverse=True)
        beams = dict(scored[:beam_width])

    final = []
    for prefix, (p_b, p_nb, offsets, lm_state) in beams.items():
        score = _logaddexp(p_b, p_nb)
        if lm is not None and lm_state and lm_state[1]:
            bonus, _ = lm_word_bonus(lm_state)
            score += bonus
        final.append((prefix, offsets, score))
    final.sort(key=lambda x: x[2], reverse=True)
    return final[:top_paths]


class BeamCTCDecoder(Decoder):
    """Host beam decoder (reference decoder.py:90-143 API).

    ``backend``: ``"python"`` (this module's search) or ``"auto"`` (python
    here); ``"native"`` raises until the native C++ search is ported.
    """

    def __init__(self, labels, lm_path=None, alpha=0.8, beta=1.0,
                 cutoff_top_n=40, cutoff_prob=1.0, beam_width=10,
                 num_processes=4, blank_index=0, top_paths=1,
                 backend="auto", blank_collapse_threshold=1.0):
        super().__init__(labels, blank_index=blank_index)
        if backend == "native":
            raise RuntimeError("the native C++ beam backend is not ported to "
                               "PyTorch yet (ROADMAP.md); use backend='auto' "
                               "or 'python', which give the same hypotheses")
        if backend not in ("auto", "python"):
            raise ValueError(f"unknown beam backend {backend!r}")
        self.backend = "python"
        # enough to rebuild this decoder inside a spawned worker process
        # (single-process there; the parent owns the fan-out)
        self._ctor_kwargs = dict(
            labels=labels, lm_path=lm_path, alpha=alpha, beta=beta,
            cutoff_top_n=cutoff_top_n, cutoff_prob=cutoff_prob,
            beam_width=beam_width, num_processes=1, blank_index=blank_index,
            top_paths=top_paths, backend="python",
            blank_collapse_threshold=blank_collapse_threshold)
        self._pool = None
        self.beam_width = beam_width
        self.cutoff_top_n = cutoff_top_n
        self.cutoff_prob = cutoff_prob
        self.top_paths = top_paths
        self.alpha = alpha
        self.beta = beta
        self.blank_collapse_threshold = float(blank_collapse_threshold)
        self.num_processes = max(1, num_processes)
        self.lm = load_lm(lm_path)

    def _decode_one(self, log_probs: np.ndarray):
        frame_map = None
        if self.blank_collapse_threshold < 1.0:
            log_probs, frame_map = blank_collapse(
                log_probs, self.blank_collapse_threshold, self.blank_index)
        hyps = ctc_beam_search(
            log_probs, beam_width=self.beam_width, blank=self.blank_index,
            cutoff_top_n=self.cutoff_top_n, cutoff_prob=self.cutoff_prob,
            space_index=self.space_index if self.lm is not None else None,
            lm=self.lm, alpha=self.alpha, beta=self.beta,
            labels=self.labels, top_paths=self.top_paths)
        strings = ["".join(self.int_to_char[i] for i in prefix)
                   for prefix, _, _ in hyps]
        offsets = [np.asarray(offs, dtype=np.int32) for _, offs, _ in hyps]
        if frame_map is not None:
            offsets = [frame_map[o] if len(o) else o for o in offsets]
        return strings, offsets

    def decode(self, probs, sizes=None):
        """probs: (B, T, C) posteriors (softmax output), a tensor on any
        device or an array. Returns (strings, offsets) where strings[b][k]
        is the k-th best hypothesis."""
        if isinstance(probs, torch.Tensor):
            probs = probs.detach().cpu().numpy()
        if isinstance(sizes, torch.Tensor):
            sizes = sizes.cpu().numpy()
        probs = np.asarray(probs, dtype=np.float64)
        log_probs = np.log(np.clip(probs, 1e-30, 1.0))
        items = []
        for b in range(log_probs.shape[0]):
            t = int(sizes[b]) if sizes is not None else log_probs.shape[1]
            items.append(log_probs[b, :t])
        if self.num_processes > 1 and len(items) > 1:
            # the pure-Python search never leaves the GIL; real parallelism
            # needs processes (workers are spawned once and reused across
            # decode() calls; each rebuilds this decoder, its LM included,
            # from _ctor_kwargs)
            results = self._decode_in_processes(items)
        else:
            results = [self._decode_one(x) for x in items]
        return [r[0] for r in results], [r[1] for r in results]

    def _decode_in_processes(self, items):
        """Spawned-process fan-out with a serial fallback.

        ``spawn`` re-imports the parent's ``__main__`` from its file path;
        from a REPL / ``python -c`` / stdin there is no such file and the
        workers die at startup (BrokenProcessPool). Detect that up front,
        catch the broken-pool case, and run serially instead."""
        main = sys.modules.get("__main__")
        main_file = getattr(main, "__file__", None)
        if main_file is not None and not os.path.exists(main_file):
            main_file = None
        if main_file is None and main is not None \
                and getattr(main, "__spec__", None) is None:
            # interactive / -c / stdin parent: spawn cannot bootstrap
            return [self._decode_one(x) for x in items]
        try:
            return list(self._process_pool().map(_worker_decode, items))
        except BrokenProcessPool:
            self.close()
            return [self._decode_one(x) for x in items]

    def _process_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            self._pool = ProcessPoolExecutor(
                self.num_processes,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init, initargs=(self._ctor_kwargs,))
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __del__(self):  # interpreter-shutdown best effort
        try:
            self.close()
        except Exception:
            pass


# spawned-worker state for the process fan-out
_WORKER_DECODER = None


def _worker_init(ctor_kwargs):
    global _WORKER_DECODER
    _WORKER_DECODER = BeamCTCDecoder(**ctor_kwargs)


def _worker_decode(log_probs):
    return _WORKER_DECODER._decode_one(log_probs)
