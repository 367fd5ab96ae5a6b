"""ctypes front-end for the native C++ CTC beam search
(``native/beam_search.cpp``; the JAX package's ``decoders/beam_native.py``,
copied).

This is the host fast path standing in for the reference's
``ctcdecode.CTCBeamDecoder`` + KenLM C++ stack (reference decoder.py:90-143);
it returns bit-identical results to the pure-Python ``ctc_beam_search``
(decoders/beam.py) and is far faster, which matters because the reference
decodes with beam widths up to 128 (BASELINE config 3).
"""

from __future__ import annotations

import ctypes
import gzip

import numpy as np

from deepspeech_tpu_torch.native import load_native

_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)


class NativeArpaLM:
    """ARPA n-gram LM parsed and scored in C++ (parity with decoders/lm.py)."""

    def __init__(self, path: str):
        lib = load_native()
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            data = f.read()
        self._lib = lib
        self._handle = lib.bs_lm_load(data, len(data))
        if not self._handle:
            raise RuntimeError(f"failed to parse ARPA LM: {path}")

    @property
    def order(self) -> int:
        return int(self._lib.bs_lm_order(self._handle))

    def score_word(self, context, word: str) -> float:
        """log10 P(word | context); context is a sequence of words."""
        ctx = " ".join(context).encode("utf8")
        return float(self._lib.bs_lm_score_word(
            self._handle, ctx, word.encode("utf8")))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.bs_lm_free(handle)
            self._handle = None


def ctc_beam_search_native(log_probs: np.ndarray, beam_width: int = 10,
                           blank: int = 0, cutoff_top_n: int = 40,
                           cutoff_prob: float = 1.0,
                           space_index: int | None = None,
                           lm: NativeArpaLM | None = None,
                           alpha: float = 0.8, beta: float = 1.0,
                           labels: str | None = None, top_paths: int = 1):
    """Decode one utterance; same signature and return convention as
    decoders/beam.py:ctc_beam_search — list of (ids tuple, offsets tuple,
    score) sorted best-first."""
    lib = load_native()
    lp = np.ascontiguousarray(log_probs, dtype=np.float64)
    t_max, n_classes = lp.shape
    labels_blob = None
    if lm is not None:
        if labels is None:
            raise ValueError("labels required for LM fusion")
        labels_blob = "\n".join(labels[i] for i in range(n_classes)).encode("utf8")
    cap = max(t_max, 1)
    out_ids = np.empty((top_paths, cap), dtype=np.int32)
    out_offs = np.empty((top_paths, cap), dtype=np.int32)
    out_lens = np.empty(top_paths, dtype=np.int32)
    out_scores = np.empty(top_paths, dtype=np.float64)
    n = lib.bs_decode(
        lp.ctypes.data_as(_F64P), t_max, n_classes,
        blank, -1 if space_index is None else int(space_index),
        beam_width, cutoff_top_n, float(cutoff_prob),
        getattr(lm, "_handle", None), float(alpha), float(beta),
        labels_blob, top_paths,
        out_ids.ctypes.data_as(_I32P), out_offs.ctypes.data_as(_I32P),
        out_lens.ctypes.data_as(_I32P), out_scores.ctypes.data_as(_F64P))
    return [(tuple(int(i) for i in out_ids[k, :out_lens[k]]),
             tuple(int(o) for o in out_offs[k, :out_lens[k]]),
             float(out_scores[k]))
            for k in range(n)]
