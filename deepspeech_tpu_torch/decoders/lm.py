"""Word n-gram language model (ARPA format) with Katz backoff scoring
(the JAX package's ``decoders/lm.py``, copied).

Reads textual ARPA files; scores are log10 like ARPA/KenLM, used by the
beam decoders as ``alpha * log_p(word | context) + beta`` at word
boundaries. ``load_lm`` also opens DSLM binaries (``decoders/lm_binary.py``);
KenLM binaries are not ported yet and raise.
"""

from __future__ import annotations

import gzip
import math

# KenLM's binary header (the JAX package's decoders/lm_kenlm.py MAGIC)
KENLM_MAGIC = b"mmap lm http://kheafield.com/code format version 5\n\x00"


class ArpaLM:
    def __init__(self, path: str, max_order: int | None = None):
        self.ngrams: dict[tuple, tuple] = {}  # words-tuple -> (logp, backoff)
        self.order = 0
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf8", errors="replace") as f:
            section = 0
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\") and "-grams:" in line:
                    section = int(line[1:line.index("-")])
                    if max_order and section > max_order:
                        break
                    self.order = max(self.order, section)
                    continue
                if line.startswith("\\") or line.startswith("ngram "):
                    continue
                parts = line.split("\t")
                if len(parts) < 2 or section == 0:
                    continue
                logp = float(parts[0])
                words = tuple(parts[1].split())
                backoff = float(parts[2]) if len(parts) > 2 else 0.0
                self.ngrams[words] = (logp, backoff)

    def score_word(self, context: tuple, word: str) -> float:
        """log10 P(word | context) with Katz backoff; unknown words get the
        <unk> score or a -inf-ish floor. Backoff weights ACCUMULATE across
        successive context shortenings (standard ARPA/KenLM semantics:
        p(w|c) = backoff(c) + p(w|c[1:]) applied recursively)."""
        context = tuple(context[-(self.order - 1):]) if self.order > 1 else ()
        penalty = 0.0
        while True:
            entry = self.ngrams.get(context + (word,))
            if entry is not None:
                return penalty + entry[0]
            if not context:
                unk = self.ngrams.get(("<unk>",))
                return penalty + (unk[0] if unk is not None else -10.0)
            # back off: add the context's backoff weight, shorten context
            bo = self.ngrams.get(context)
            penalty += bo[1] if bo is not None else 0.0
            context = context[1:]

    def score_sentence(self, words, bos: bool = True) -> float:
        context = ("<s>",) if bos else ()
        total = 0.0
        for w in words:
            total += self.score_word(context, w)
            context = context + (w,)
        return total


def is_kenlm(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(KENLM_MAGIC)) == KENLM_MAGIC
    except OSError:
        return False


def refuse_kenlm(path: str) -> None:
    """Raise for a KenLM binary: its readers are not ported yet."""
    if is_kenlm(path):
        raise ValueError(
            f"{path}: KenLM binaries are not ported to PyTorch yet (the "
            "KenLM-reader slice, ROADMAP.md); convert the source ARPA with "
            "python -m deepspeech_tpu_torch.decoders.lm_binary")


def load_lm(path: str | None):
    """Textual ARPA(.gz) -> in-memory ArpaLM; DSLM binary (from
    decoders/lm_binary.py convert_arpa) -> mmap-backed BinaryLM with O(vocab)
    resident memory; a KenLM binary raises."""
    if not path:
        return None
    from deepspeech_tpu_torch.decoders.lm_binary import BinaryLM, is_dslm
    if is_dslm(path):
        return BinaryLM(path)
    refuse_kenlm(path)
    return ArpaLM(path)


LOG10 = math.log(10.0)
