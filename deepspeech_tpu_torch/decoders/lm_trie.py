"""KenLM ``.binary`` TRIE-format reader (model type 2; the JAX package's
``decoders/lm_trie.py``, copied).

Completes the KenLM artifact coverage started by ``lm_kenlm.py`` (probing,
type 0): reference deployments pass either format straight to ctcdecode
(reference decoder.py:95-99, opts.py:5-7), and ``build_binary trie`` is
the documented memory-saving default for big models.  Like the probing
reader this QUERIES the artifact in place (mmap) — conversion to the DSLM
trie is not attempted — and answers ``score_word`` with ArpaLM-compatible
Katz backoff (log10).

Layout read (format version 5, unquantized, no Bhiksha array compression):

* header: ``Sanity`` + ``FixedWidthParameters`` + counts (as probing);
* vocabulary: SortedVocabulary — a leading entry-count u64, then the
  sorted MurmurHash64A values of every word EXCEPT ``<unk>``; a word's id
  is its sorted position + 1, ``<unk>`` = 0;
* unigram: dense ``{float prob; float backoff; u64 next}`` records
  (ids 0..V-1 plus a terminator whose ``next`` ends the last range);
* middle orders 2..N-1: bit-packed entries of
  ``[word | prob(31) | backoff(32) | next]`` — KenLM stores non-positive
  floats in 31 bits (sign dropped) and bit-streams LSB-first; ``word``
  uses enough bits for the vocab bound and ``next`` for the next level's
  entry count; entries are sorted by word id within each parent's
  ``[next[i], next[i+1])`` range, terminated by one extra entry;
* longest order: ``[word | prob(31)]`` entries, no children;
* trailing null-delimited word strings when the binary carries them.

Quantized tries (model type 3, ``build_binary -q P -b B trie`` — the
artifacts practitioners actually ship) are read too: a quantization
section sits between the vocabulary hashes and the unigram table —
an 8-byte header (version byte 2, prob_bits, backoff_bits), then per
middle order a ``2^prob_bits``-float prob table and a
``2^backoff_bits``-float backoff table, and one final prob table for the
longest order (quantize.hh SeparatelyQuantize; unigrams stay unquantized).
Entries then pack ``[word | backoff_idx(B) | prob_idx(P) | next]`` —
KenLM writes ``(prob_idx << backoff_bits) | backoff_idx`` as one LSB-first
field, so the backoff index occupies the lower bits — and the longest
order packs ``[word | prob_idx(P)]``. Decoding is one table load; the
tables' first two backoff entries are KenLM's reserved -0.0/0.0
(no-extension/extension markers), read like any other center.

The trie stores n-grams in SUFFIX order: the n-gram (a b c) with c newest
lives on the path c -> b -> a, so a lookup walks unigram[c], finds b among
c's children, then a.  Nodes inserted only to carry children (the ARPA
had no such n-gram) hold prob = -inf and behave as lookup misses, exactly
like ArpaLM's absent entries.

Bhiksha-array variants (types 4, 5) are rejected with guidance; plain
and quantized tries (types 2, 3) are both read in place.

Caveat (same as the probing reader): the repository holds no real KenLM
binary; the byte layout is implemented
from the public format and validated against an independent in-test
writer (tests/test_lm_trie.py) plus ArpaLM score parity.  Structural
invariants (every level's terminator pointer must equal the next level's
entry count, ranges monotone, section offsets landing exactly on the
word-strings table) are checked at load time and raise on any mismatch —
a real-world layout difference fails loudly, never silently as <unk>.
"""

from __future__ import annotations

import mmap

import numpy as np

from deepspeech_tpu_torch.decoders.lm_kenlm import (
    _FIXED_PARAMS_SIZE,
    MAGIC,
    _align8,
    murmur_hash64a,
    sanity_size,
)

MODEL_TRIE = 2
MODEL_QUANT_TRIE = 3
MODEL_ARRAY_TRIE = 4
MODEL_QUANT_ARRAY_TRIE = 5
TRIE_TYPES = (MODEL_TRIE, MODEL_QUANT_TRIE, MODEL_ARRAY_TRIE,
              MODEL_QUANT_ARRAY_TRIE)

_NEG_INF = float("-inf")


def required_bits(max_value: int) -> int:
    """Bits needed to store values in [0, max_value]."""
    return max(int(max_value).bit_length(), 1)


def kenlm_model_type(path: str):
    """Model type of a KenLM binary, or None if not one."""
    try:
        with open(path, "rb") as f:
            head = f.read(sanity_size() + 16)
    except OSError:
        return None
    if head[: len(MAGIC)] != MAGIC:
        return None
    ss = sanity_size()
    return int(np.frombuffer(head, np.int32, 1, ss + 8)[0])


def is_kenlm_trie(path: str) -> bool:
    return kenlm_model_type(path) in TRIE_TYPES


class _BitArray:
    """LSB-first bit stream over a byte buffer (util/bit_packing.hh
    semantics: an 8-byte little-endian load at bit>>3, shifted by bit&7).

    Holds the caller's buffer as a ZERO-COPY view (an mmap-backed
    ``np.frombuffer`` for real files) so loading a multi-GB trie stays at
    mmap residency — the format's whole point for big models. Only reads
    whose 9-byte load would overrun the view (possible within the final
    few bits when the level ends flush with EOF) go through a small
    zero-padded copy of the tail."""

    def __init__(self, buf: np.ndarray):
        self._b = buf
        n = len(buf)
        k = min(9, n)
        tail = np.zeros(k + 9, np.uint8)
        if k:
            tail[:k] = buf[n - k:]
        self._tail = tail
        self._tail_start = n - k

    def read(self, bit: int, n: int) -> int:
        byte = bit >> 3
        buf = self._b
        if byte + 9 <= len(buf):
            word = int.from_bytes(buf[byte: byte + 9].tobytes(), "little")
        else:
            o = byte - self._tail_start
            word = int.from_bytes(self._tail[o: o + 9].tobytes(), "little")
        return (word >> (bit & 7)) & ((1 << n) - 1)


def _float_from_np31(bits31: int) -> float:
    """Inverse of KenLM WriteNonPositiveFloat31: restore the sign bit."""
    return float(np.uint32(bits31 | 0x80000000).view(np.float32))


def _float_from_bits(bits32: int) -> float:
    return float(np.uint32(bits32).view(np.float32))


class KenLMTrie:
    """mmap-backed TRIE query reader with ArpaLM-compatible scoring."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        mm = self._mm
        if mm[: len(MAGIC)] != MAGIC:
            raise ValueError(f"{path}: not a KenLM binary")
        ss = sanity_size()
        floats = np.frombuffer(mm, np.float32, 3, (len(MAGIC) + 1 + 3) // 4 * 4)
        if not (floats[0] == 0.0 and floats[1] == 1.0 and floats[2] == -0.5):
            raise ValueError(f"{path}: KenLM sanity header mismatch "
                             "(incompatible format revision)")
        order = int(mm[ss])
        self.order = order
        model_type = int(np.frombuffer(mm, np.int32, 1, ss + 8)[0])
        if model_type in (MODEL_ARRAY_TRIE, MODEL_QUANT_ARRAY_TRIE):
            raise ValueError(
                f"{path}: Bhiksha-array trie (type {model_type}) is not "
                "supported; rebuild without -a (plain or -q trie) or pass "
                "the textual ARPA")
        if model_type not in (MODEL_TRIE, MODEL_QUANT_TRIE):
            raise ValueError(f"{path}: not a trie-format binary "
                             f"(model type {model_type}); use KenLMProbing")
        self.quantized = model_type == MODEL_QUANT_TRIE
        has_vocab = mm[ss + 12] != 0
        counts = [int(c) for c in
                  np.frombuffer(mm, np.uint64, order,
                                ss + _FIXED_PARAMS_SIZE)]
        self.counts = counts
        self.vocab_size = counts[0]
        off = _align8(ss + _FIXED_PARAMS_SIZE + 8 * order)

        # -- SortedVocabulary: [u64 count][sorted hashes (no <unk>)] --------
        n_vocab = int(np.frombuffer(mm, np.uint64, 1, off)[0])
        if n_vocab != counts[0] - 1:
            raise ValueError(
                f"{path}: vocab entry count {n_vocab} != unigrams-1 "
                f"({counts[0] - 1}); incompatible trie layout")
        off += 8
        self._vocab_hashes = np.frombuffer(mm, np.uint64, n_vocab, off)
        if n_vocab and np.any(self._vocab_hashes[1:]
                              <= self._vocab_hashes[:-1]):
            raise ValueError(f"{path}: vocab hash array not sorted; "
                             "incompatible trie layout")
        off += 8 * n_vocab

        # -- quantization tables (type 3 only): an 8-byte header (version,
        # prob_bits, backoff_bits) then per middle order a prob + backoff
        # center table and one final longest-order prob table (quantize.hh
        # SeparatelyQuantize layout; sits between vocab and unigram) -------
        self._quant = None
        if self.quantized and order > 1:
            version = mm[off]
            if version != 2:
                raise ValueError(
                    f"{path}: quantization version {version} (expected 2); "
                    "incompatible KenLM revision")
            pb, bb = int(mm[off + 1]), int(mm[off + 2])
            if not (1 <= pb <= 30 and 1 <= bb <= 30):
                raise ValueError(
                    f"{path}: implausible quantization bits prob={pb} "
                    f"backoff={bb}; incompatible trie layout")
            pos = off + 8
            mid_tables = []
            for o in range(2, order):
                qp = np.frombuffer(mm, np.float32, 1 << pb, pos)
                pos += 4 << pb
                qb = np.frombuffer(mm, np.float32, 1 << bb, pos)
                pos += 4 << bb
                mid_tables.append((qp, qb))
            q_long = np.frombuffer(mm, np.float32, 1 << pb, pos)
            pos += 4 << pb
            self._quant = dict(prob_bits=pb, back_bits=bb,
                               middles=mid_tables, longest=q_long)
            off = pos

        # -- unigram: (V + 2) x {f32 prob, f32 backoff, u64 next} ----------
        v = counts[0]
        raw = np.frombuffer(mm, np.uint8, 16 * (v + 1), off)
        self._uni_pb = raw.view(np.float32).reshape(-1, 4)[:, :2]
        self._uni_next = raw.view(np.uint64).reshape(-1, 2)[:, 1]
        off += 16 * (v + 2)  # one terminator + one padding record
        if order > 1:
            nxt = self._uni_next.astype(np.int64)
            if int(nxt[v]) != counts[1] or np.any(np.diff(nxt) < 0):
                raise ValueError(
                    f"{path}: unigram child ranges inconsistent (terminator "
                    f"{int(nxt[v])} != bigram count {counts[1]}); "
                    "incompatible trie layout")

        # -- middle levels 2..order-1 --------------------------------------
        word_bits = required_bits(counts[0])  # ids < bound = V (+1 safety)
        self._middles = []
        for o in range(2, order):
            entries = counts[o - 1]
            next_bits = required_bits(counts[o])
            if self._quant is not None:
                # packed as (prob_idx << backoff_bits) | backoff_idx, one
                # LSB-first field -> backoff index sits in the lower bits
                pb, bb = self._quant["prob_bits"], self._quant["back_bits"]
                qp, qb = self._quant["middles"][o - 2]
                total = word_bits + pb + bb + next_bits
                layout = dict(back_off=word_bits, back_bits=bb,
                              prob_off=word_bits + bb, prob_bits=pb,
                              next_off=word_bits + bb + pb,
                              qprob=qp, qback=qb)
            else:
                total = word_bits + 31 + 32 + next_bits
                layout = dict(prob_off=word_bits, prob_bits=31,
                              back_off=word_bits + 31, back_bits=32,
                              next_off=word_bits + 63,
                              qprob=None, qback=None)
            nbytes = ((entries + 1) * total + 7) // 8 + 8
            # the +8 slack is layout (KenLM pads each bit array); the VIEW
            # clamps to the file so a level flush with EOF still maps
            bits = _BitArray(np.frombuffer(
                mm, np.uint8, min(nbytes, len(mm) - off), off))
            level = dict(bits=bits, entries=entries, total=total,
                         word_bits=word_bits, next_bits=next_bits, **layout)
            self._middles.append(level)
            off += nbytes
            term_next = bits.read(entries * total + level["next_off"],
                                  next_bits)
            if term_next != counts[o]:
                raise ValueError(
                    f"{path}: order-{o} terminator pointer {term_next} != "
                    f"order-{o + 1} count {counts[o]}; incompatible trie "
                    "layout")

        # -- longest level --------------------------------------------------
        if order > 1:
            entries = counts[order - 1]
            if self._quant is not None:
                pb = self._quant["prob_bits"]
                q_long = self._quant["longest"]
            else:
                pb, q_long = 31, None
            total = word_bits + pb
            nbytes = (entries * total + 7) // 8 + 8
            self._longest = dict(
                bits=_BitArray(np.frombuffer(
                    mm, np.uint8, min(nbytes, len(mm) - off), off)),
                entries=entries, total=total, word_bits=word_bits,
                prob_bits=pb, qprob=q_long)
            off += nbytes
        else:
            self._longest = None

        # -- trailing word strings -----------------------------------------
        self._wid = {"<unk>": 0}
        if has_vocab:
            if off > len(mm):
                raise ValueError(f"{path}: sections overrun the file; "
                                 "incompatible trie layout")
            words = bytes(mm[off:]).split(b"\x00")
            for i, w in enumerate(words):
                if i >= counts[0]:
                    break
                self._wid[w.decode("utf8", "replace")] = i
            if len(self._wid) > 1:
                self._verify_vocab_layout(path)

    def _verify_vocab_layout(self, path: str):
        """Sampled word-string ids must be recoverable through the sorted
        hash array (mirrors lm_kenlm._verify_vocab_layout)."""
        items = [(w, i) for w, i in self._wid.items() if w != "<unk>"]
        sample = (items[:2] + items[len(items) // 2:len(items) // 2 + 1]
                  + items[-2:])
        for w, i in sample:
            if self._hash_id(w) != i:
                raise ValueError(
                    f"{path}: vocab layout mismatch (word {w!r} id {i} not "
                    f"recoverable from the sorted hash array); the file "
                    "likely uses an incompatible KenLM format revision")

    def close(self):
        self._uni_pb = None
        self._uni_next = None
        self._quant = None
        self._vocab_hashes = None
        self._middles = []
        self._longest = None
        self._mm.close()
        self._f.close()

    # -- lookups -----------------------------------------------------------

    def _hash_id(self, word: str) -> int:
        h = np.uint64(murmur_hash64a(word.encode("utf8")))
        i = int(np.searchsorted(self._vocab_hashes, h))
        if i < len(self._vocab_hashes) and self._vocab_hashes[i] == h:
            return i + 1
        return 0

    def word_id(self, word: str) -> int:
        wid = self._wid.get(word)
        if wid is not None:
            return wid
        return self._hash_id(word)

    @staticmethod
    def _mid_prob_back(lvl, base: int):
        """(log10 prob, backoff) of a middle-level entry at bit ``base``;
        one table load per value when quantized."""
        bits = lvl["bits"]
        if lvl["qprob"] is not None:
            p = float(lvl["qprob"][bits.read(base + lvl["prob_off"],
                                             lvl["prob_bits"])])
            b = float(lvl["qback"][bits.read(base + lvl["back_off"],
                                             lvl["back_bits"])])
            return p, b
        return (_float_from_np31(bits.read(base + lvl["prob_off"], 31)),
                _float_from_bits(bits.read(base + lvl["back_off"], 32)))

    @staticmethod
    def _longest_prob(lvl, i: int):
        raw = lvl["bits"].read(i * lvl["total"] + lvl["word_bits"],
                               lvl["prob_bits"])
        if lvl["qprob"] is not None:
            return float(lvl["qprob"][raw])
        return _float_from_np31(raw)

    def _find_in_level(self, level, begin: int, end: int, wid: int):
        """Binary search for ``wid`` in the entry range [begin, end)."""
        bits, total, wb = level["bits"], level["total"], level["word_bits"]
        lo, hi = begin, end
        while lo < hi:
            mid = (lo + hi) // 2
            w = bits.read(mid * total, wb)
            if w == wid:
                return mid
            if w < wid:
                lo = mid + 1
            else:
                hi = mid
        return None

    def _lookup(self, ids):
        """(log10 prob, backoff) of the n-gram ``ids`` (oldest..newest), or
        None. Walks the suffix trie from the newest word."""
        n = len(ids)
        wid = ids[-1]
        prob = float(self._uni_pb[wid, 0])
        backoff = float(self._uni_pb[wid, 1])
        if n == 1:
            return None if prob == _NEG_INF else (prob, backoff)
        begin = int(self._uni_next[wid])
        end = int(self._uni_next[wid + 1])
        for depth, w in zip(range(2, n + 1), reversed(ids[:-1])):
            if begin >= end:
                return None
            if depth == self.order:
                lvl = self._longest
                i = self._find_in_level(lvl, begin, end, w)
                if i is None:
                    return None
                prob = self._longest_prob(lvl, i)
                backoff = 0.0
                break
            lvl = self._middles[depth - 2]
            i = self._find_in_level(lvl, begin, end, w)
            if i is None:
                return None
            base = i * lvl["total"]
            prob, backoff = self._mid_prob_back(lvl, base)
            begin = lvl["bits"].read(base + lvl["next_off"],
                                     lvl["next_bits"])
            end = lvl["bits"].read(base + lvl["total"] + lvl["next_off"],
                                   lvl["next_bits"])
        return None if prob == _NEG_INF else (prob, backoff)

    # -- ArpaLM-compatible API ---------------------------------------------

    def score_word(self, context, word: str) -> float:
        """log10 P(word | context), Katz backoff (the ArpaLM.score_word
        walk, decoders/lm.py:42-59). OOV maps to <unk> (KenLM semantics)."""
        wi = self.word_id(word)
        ctx = [self.word_id(w) for w in context[-(self.order - 1):]] \
            if self.order > 1 else []
        penalty = 0.0
        while True:
            hit = self._lookup(ctx + [wi])
            if hit is not None:
                return penalty + hit[0]
            if not ctx:
                # dense unigrams can only miss via a -inf blank; treat as
                # the floor ArpaLM would produce for an absent word
                return penalty + _NEG_INF
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

    # -- enumeration (trie binaries ARE invertible: explicit ids + word
    # strings, unlike the probing format's one-way hashes) ------------------

    def id_to_word(self) -> list:
        """Dense id -> word-string table from the trailing vocab section."""
        if len(self._wid) <= 1:
            raise ValueError(
                "this trie binary was built without word strings "
                "(build_binary -v drops them); ids cannot be inverted — "
                "pass the textual ARPA instead")
        inv = [None] * self.counts[0]
        for w, i in self._wid.items():
            inv[i] = w
        missing = [i for i, w in enumerate(inv) if w is None]
        if missing:
            raise ValueError(
                f"trie vocab table incomplete (no string for ids "
                f"{missing[:5]}...); incompatible trie layout")
        return inv

    def _iter_children(self, depth: int, path: tuple, begin: int, end: int):
        """DFS below the suffix-trie ``path`` (natural word order). Yields
        (order, ids natural order, log10 prob or None for nodes KenLM
        inserted only to carry children, backoff)."""
        if depth == self.order:
            lvl = self._longest
            bits, total, wb = lvl["bits"], lvl["total"], lvl["word_bits"]
            for i in range(begin, end):
                w = bits.read(i * total, wb)
                prob = self._longest_prob(lvl, i)
                yield (depth, (w,) + path,
                       None if prob == _NEG_INF else prob, 0.0)
            return
        lvl = self._middles[depth - 2]
        bits, total = lvl["bits"], lvl["total"]
        for i in range(begin, end):
            base = i * total
            w = bits.read(base, lvl["word_bits"])
            prob, bo = self._mid_prob_back(lvl, base)
            b2 = bits.read(base + lvl["next_off"], lvl["next_bits"])
            e2 = bits.read(base + total + lvl["next_off"], lvl["next_bits"])
            ids = (w,) + path
            yield depth, ids, (None if prob == _NEG_INF else prob), bo
            yield from self._iter_children(depth + 1, ids, b2, e2)

    def iter_ngrams(self):
        """Yield (order, word-id tuple in NATURAL order oldest..newest,
        log10 prob or None for carrier nodes, backoff) for every stored
        entry — the inverse of the build: the suffix path c -> b -> a is
        re-emitted as the n-gram (a b c)."""
        v = self.counts[0]
        for wid in range(v):
            p = float(self._uni_pb[wid, 0])
            yield (1, (wid,), None if p == _NEG_INF else p,
                   float(self._uni_pb[wid, 1]))
        if self.order == 1:
            return
        for wid in range(v):
            yield from self._iter_children(
                2, (wid,), int(self._uni_next[wid]),
                int(self._uni_next[wid + 1]))

    def dump_arpa(self, out_path: str, carrier_logp: float = -99.0):
        """Write the model back out as textual ARPA.

        Nodes KenLM inserted only to carry children (no such n-gram in the
        source ARPA) are emitted with ``carrier_logp`` — the DSLM
        converter's SENTINEL (-99.0), which its readers treat as
        absent-but-traversable, reproducing the trie's own semantics.
        """
        words = self.id_to_word()
        per_order: list[list[str]] = [[] for _ in range(self.order)]
        for order, ids, prob, bo in self.iter_ngrams():
            lp = carrier_logp if prob is None else prob
            gram = " ".join(words[i] for i in ids)
            if order < self.order and bo != 0.0:
                per_order[order - 1].append(f"{lp:.7g}\t{gram}\t{bo:.7g}")
            else:
                per_order[order - 1].append(f"{lp:.7g}\t{gram}")
        with open(out_path, "w", encoding="utf8") as f:
            f.write("\\data\\\n")
            for o, rows in enumerate(per_order, start=1):
                f.write(f"ngram {o}={len(rows)}\n")
            for o, rows in enumerate(per_order, start=1):
                f.write(f"\n\\{o}-grams:\n")
                f.write("\n".join(rows))
                f.write("\n")
            f.write("\n\\end\\\n")
