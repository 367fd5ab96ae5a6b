"""KenLM ``.binary`` (probing format) reader (the JAX package's
``decoders/lm_kenlm.py``, copied).

Reference deployments pass KenLM binaries straight to ctcdecode
(reference opts.py:5-7 ``--lm-path``); this module lets the SAME artifact
class feed our host beam decoder without external tooling. It memory-maps
the file and answers ``score_word`` queries with ArpaLM-compatible Katz
backoff (log10), by reimplementing KenLM's probing lookup:

* header: the ``Sanity`` struct (magic "mmap lm … format version 5",
  float/int reference values — a wrong layout can never misparse silently,
  the reference values would mismatch), ``FixedWidthParameters``
  (order, probing multiplier, model type, search version), counts;
* vocabulary: MurmurHash64A(word) -> id probing table, plus the
  null-delimited word-strings section when the binary carries one;
* unigrams: dense (prob, backoff) float array indexed by word id;
* orders 2..N-1: linear-probing hash tables of chained-word-hash ->
  (prob, backoff); top order maps to prob only.

This module reads the PROBING model type; KenLM TRIE binaries load
through the sibling reader ``decoders/lm_trie.py`` (``load_lm``
dispatches on the model-type field automatically). Conversion of a
probing binary into the
DSLM trie (decoders/lm_binary.py) is *information-theoretically impossible*
— probing stores only one-way hashes of the n-grams, never the word
tuples — so this reader QUERIES the artifact rather than converting it;
``load_lm`` (decoders/lm.py) dispatches here automatically.

Caveat: the repository holds no real KenLM binary, so the byte layout is
implemented from the public KenLM format spec and validated against an
independent in-test writer of the same spec (tests/test_lm_kenlm.py) plus
ArpaLM score parity.
"""

from __future__ import annotations

import mmap

import numpy as np

MAGIC = b"mmap lm http://kheafield.com/code format version 5\n\x00"
_MASK = (1 << 64) - 1
# lm/search_hashed.hh CombineWordHash constants
_C1 = 8978948897894561157
_C2 = 17894857484156487943

MODEL_PROBING = 0


def _align8(n: int) -> int:
    return (n + 7) // 8 * 8


def sanity_size() -> int:
    """sizeof(Sanity): char magic[sizeof(kMagicBytes)] (+1 for the C
    literal's implicit NUL), 3 floats, 2 uint32, then an 8-aligned u64."""
    off = len(MAGIC) + 1
    off = (off + 3) // 4 * 4   # float alignment
    off += 3 * 4 + 2 * 4       # zero/one/minus_half + one/max word index
    off = _align8(off)
    off += 8                   # one_uint64
    return _align8(off)


_FIXED_PARAMS_SIZE = 20  # uchar order (+3 pad), float, int32, bool (+3), u32


def murmur_hash64a(data: bytes, seed: int = 0) -> int:
    """util::MurmurHash64A — KenLM's vocab string hash."""
    m = 0xC6A4A7935BD1E995
    r = 47
    h = (seed ^ ((len(data) * m) & _MASK)) & _MASK
    n8 = len(data) // 8
    for i in range(n8):
        k = int.from_bytes(data[8 * i: 8 * i + 8], "little")
        k = (k * m) & _MASK
        k ^= k >> r
        k = (k * m) & _MASK
        h = ((h ^ k) * m) & _MASK
    tail = data[8 * n8:]
    if tail:
        h ^= int.from_bytes(tail, "little")
        h = (h * m) & _MASK
    h ^= h >> r
    h = (h * m) & _MASK
    h ^= h >> r
    return h


def combine_word_hash(current: int, next_id: int) -> int:
    """lm/search_hashed.hh detail::CombineWordHash."""
    return ((current * _C1) ^ (((1 + next_id) * _C2) & _MASK)) & _MASK


def ngram_hash(ids) -> int:
    """Key of an n-gram (oldest..newest): KenLM scores by starting from the
    NEWEST word's id and chaining backwards through the history."""
    h = ids[-1] & _MASK
    for w in reversed(ids[:-1]):
        h = combine_word_hash(h, w)
    return h


def probing_buckets(entries: int, multiplier: float) -> int:
    """util::ProbingHashTable bucket count (float math like the C++)."""
    return max(entries + 1,
               int(np.float32(multiplier) * np.float32(entries)))


def is_kenlm(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC)) == MAGIC
    except OSError:
        return False


class KenLMProbing:
    """mmap-backed query reader with ArpaLM-compatible ``score_word``.

    OOV words map to ``<unk>`` (id 0) exactly like KenLM's own scorer; for
    in-vocabulary queries the Katz-backoff walk returns the same values as
    ``ArpaLM.score_word`` on the source ARPA.
    """

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        mm = self._mm
        if mm[: len(MAGIC)] != MAGIC:
            raise ValueError(f"{path}: not a KenLM binary")
        ss = sanity_size()
        # reference values pin the struct layout: any mismatch = reject
        floats = np.frombuffer(mm, np.float32, 3, (len(MAGIC) + 1 + 3) // 4 * 4)
        if not (floats[0] == 0.0 and floats[1] == 1.0 and floats[2] == -0.5):
            raise ValueError(
                f"{path}: KenLM sanity header mismatch (incompatible "
                "format revision); regenerate as textual ARPA and use the "
                "DSLM converter (decoders/lm_binary.py)")
        order = mm[ss]
        self.order = order
        mult = float(np.frombuffer(mm, np.float32, 1, ss + 4)[0])
        model_type = int(np.frombuffer(mm, np.int32, 1, ss + 8)[0])
        has_vocab = mm[ss + 12] != 0
        if model_type != MODEL_PROBING:
            raise ValueError(
                f"{path}: KenLM model type {model_type} is not the probing "
                "format; trie binaries load via decoders/lm_trie.KenLMTrie "
                "(load_lm dispatches automatically)")
        counts = [int(c) for c in
                  np.frombuffer(mm, np.uint64, order,
                                ss + _FIXED_PARAMS_SIZE)]
        self.counts = counts
        off = _align8(ss + _FIXED_PARAMS_SIZE + 8 * order)

        # vocabulary probing table: u64 hash -> u32 id (16-byte entries)
        off += 16  # ProbingVocabularyHeader {u32 version; pad; u64 bound}
        self._vocab_buckets = probing_buckets(counts[0], mult)
        raw = np.frombuffer(mm, np.uint8, self._vocab_buckets * 16, off)
        self._vocab_keys = raw.view(np.uint64).reshape(-1, 2)[:, 0].copy()
        self._vocab_vals = raw.view(np.uint32).reshape(-1, 4)[:, 2].copy()
        off += self._vocab_buckets * 16

        # unigram dense array: (counts[0] + 1) ProbBackoff pairs
        self._unigram = np.frombuffer(mm, np.float32,
                                      2 * (counts[0] + 1), off
                                      ).reshape(-1, 2)
        off += 8 * (counts[0] + 1)

        # middle orders: u64 -> (prob, backoff); top: u64 -> prob
        self._mid = []
        for k in range(2, order):
            b = probing_buckets(counts[k - 1], mult)
            raw = np.frombuffer(mm, np.uint8, b * 16, off)
            self._mid.append((raw.view(np.uint64).reshape(-1, 2)[:, 0],
                              raw.view(np.float32).reshape(-1, 4)[:, 2],
                              raw.view(np.float32).reshape(-1, 4)[:, 3]))
            off += b * 16
        if order > 1:
            b = probing_buckets(counts[order - 1], mult)
            raw = np.frombuffer(mm, np.uint8, b * 16, off)
            self._top = (raw.view(np.uint64).reshape(-1, 2)[:, 0],
                         raw.view(np.float32).reshape(-1, 4)[:, 2])
            off += b * 16
        else:
            self._top = None

        # trailing null-delimited word strings (id order), when present
        self._wid = {"<unk>": 0}
        if has_vocab and off < len(mm):
            words = bytes(mm[off:]).split(b"\x00")
            for i, w in enumerate(words):
                if i >= counts[0]:
                    break
                self._wid[w.decode("utf8", "replace")] = i
        self.vocab_size = counts[0]
        if len(self._wid) > 1:
            self._verify_vocab_layout(path)

    def _verify_vocab_layout(self, path: str):
        """Cross-check sampled word-string ids against the hash-probing
        table so a byte-layout/bucket-count mismatch with a real KenLM
        artifact fails loudly at load time instead of silently mapping
        every query to ``<unk>`` (id 0) via probe misses."""
        items = [(w, i) for w, i in self._wid.items() if w != "<unk>"]
        sample = (items[:2] + items[len(items) // 2:len(items) // 2 + 1]
                  + items[-2:])
        for w, i in sample:
            h = murmur_hash64a(w.encode("utf8"))
            j = self._probe(self._vocab_keys, h)
            if j is None or int(self._vocab_vals[j]) != i:
                raise ValueError(
                    f"{path}: vocab hash-table layout mismatch (word {w!r} "
                    f"id {i} not recoverable by probing); the file likely "
                    "uses an incompatible KenLM format revision")

    def close(self):
        self._unigram = None
        self._mid = []
        self._top = None
        self._mm.close()
        self._f.close()

    # -- lookups -----------------------------------------------------------

    def _probe(self, keys: np.ndarray, key: int):
        b = keys.shape[0]
        i = key % b
        for _ in range(b):
            k = int(keys[i])
            if k == key:
                return int(i)
            if k == 0:
                return None
            i = (i + 1) % b
        return None

    def word_id(self, word: str) -> int:
        wid = self._wid.get(word)
        if wid is not None:
            return wid
        h = murmur_hash64a(word.encode("utf8"))
        i = self._probe(self._vocab_keys, h)
        return 0 if i is None else int(self._vocab_vals[i])

    def _lookup(self, ids) -> tuple | None:
        """(logp, backoff) of an exact id tuple, or None."""
        n = len(ids)
        if n == 1:
            pb = self._unigram[ids[0]]
            return float(pb[0]), float(pb[1])
        key = ngram_hash(ids)
        if n == self.order:
            keys, probs = self._top
            i = self._probe(keys, key)
            return None if i is None else (float(probs[i]), 0.0)
        keys, probs, backs = self._mid[n - 2]
        i = self._probe(keys, key)
        return None if i is None else (float(probs[i]), float(backs[i]))

    # -- ArpaLM-compatible API --------------------------------------------

    def score_word(self, context, word: str) -> float:
        """log10 P(word | context), Katz backoff — the ArpaLM.score_word
        walk (decoders/lm.py:42-59) over the hashed tables. OOV words map
        to <unk> (KenLM semantics)."""
        wi = self.word_id(word)
        ctx = [self.word_id(w) for w in context[-(self.order - 1):]] \
            if self.order > 1 else []
        penalty = 0.0
        while True:
            hit = self._lookup(ctx + [wi])
            if hit is not None:  # the unigram level always hits (dense)
                return penalty + hit[0]
            bo = self._lookup(ctx)
            if bo is not None:
                penalty += bo[1]
            ctx = ctx[1:]

    def score_sentence(self, words, bos: bool = True) -> float:
        context = ("<s>",) if bos else ()
        total = 0.0
        for w in words:
            total += self.score_word(context, w)
            context = context + (w,)
        return total
