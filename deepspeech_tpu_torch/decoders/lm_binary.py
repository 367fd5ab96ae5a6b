"""Compact mmap-able n-gram language model store ("DSLM"), the JAX
package's ``decoders/lm_binary.py`` copied; both write the same bytes.

Replaces holding GB-scale ARPA tables in a Python dict
(decoders/lm.py ArpaLM) the way the reference relied on KenLM's binary
format through ctcdecode (reference decoder.py:95-99, opts.py:5-7):

* ``convert_arpa(arpa, out)`` — one-shot offline converter, ARPA(.gz) text
  -> a single binary file;
* ``BinaryLM(path)`` — reader whose n-gram tables stay **memory-mapped**:
  resident memory is O(vocab) for the word index, not O(n-grams); queries
  binary-search the mapped arrays.

File layout (little-endian)::

    magic  b"DSLM0001"
    u64    header_len
    bytes  header JSON: {order, counts, vocab_size,
                         arrays: {name: [dtype, shape, offset]}}
    bytes  vocab: '\\n'-joined UTF-8 words, sorted (id == sorted rank)
    ...    64-byte-aligned raw arrays

Trie structure (first token = level 1, dense over vocab):

* level 1: ``logp_1``/``backoff_1`` (f32, dense over vocab ids; absent
  unigrams get SENTINEL), ``child_start_1`` (u64, len vocab+1);
* level k>1: ``words_k`` (u32 last-token id, sorted within each parent's
  child range), ``logp_k`` (f32), ``backoff_k`` (f32, absent for the top
  order), ``child_start_k`` (u64, len count_k+1, absent for the top order).

Scores are log10 with Katz backoff — identical semantics to
``ArpaLM.score_word`` (asserted in tests/test_torch_lm.py).
"""

from __future__ import annotations

import gzip
import json
import mmap
import os

import numpy as np

MAGIC = b"DSLM0001"
SENTINEL = np.float32(-99.0)  # "absent" unigram logp, like ARPA convention


# ---------------------------------------------------------------------------
# converter
# ---------------------------------------------------------------------------

def _iter_arpa(path):
    """Yields (order, logp, words_tuple, backoff) for every n-gram row."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf8", errors="replace") as f:
        section = 0
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("\\") and "-grams:" in line:
                section = int(line[1:line.index("-")])
                continue
            if line.startswith("\\") or line.startswith("ngram "):
                continue
            if section == 0:
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                continue
            yield (section, float(parts[0]), tuple(parts[1].split()),
                   float(parts[2]) if len(parts) > 2 else 0.0)


def convert_arpa(arpa_path: str, out_path: str) -> dict:
    """ARPA(.gz) text -> DSLM binary. Returns the header dict.

    Converter memory is O(n-grams) (id maps during the build); the point of
    the format is the READER, whose steady-state memory is O(vocab)."""
    # pass 1: vocab + per-order rows (keep ids small: u32)
    vocab = set()
    order = 0
    for sec, _, words, _ in _iter_arpa(arpa_path):
        order = max(order, sec)
        if sec == 1:
            vocab.add(words[0])
        else:
            vocab.update(words)
    if order == 0:
        raise ValueError(
            f"{arpa_path}: no \\data\\ n-gram sections found — not a "
            "textual ARPA file (and not DSLM/KenLM binary)")
    words_sorted = sorted(vocab)
    wid = {w: i for i, w in enumerate(words_sorted)}
    v = len(words_sorted)

    # pass 2: collect rows per order as numpy-ready columns
    rows = {k: [] for k in range(1, order + 1)}  # (prefix ids..., w, lp, bo)
    for sec, lp, words, bo in _iter_arpa(arpa_path):
        try:
            ids = tuple(wid[w] for w in words)
        except KeyError:
            continue  # n-gram over a word with no unigram entry: drop
        rows[sec].append(ids + (lp, bo))

    arrays: dict[str, np.ndarray] = {}
    counts = {}

    # level 1: dense over vocab
    logp1 = np.full(v, SENTINEL, np.float32)
    bo1 = np.zeros(v, np.float32)
    for (w, lp, bo) in rows[1]:
        logp1[w], bo1[w] = lp, bo
    arrays["logp_1"], arrays["backoff_1"] = logp1, bo1
    counts[1] = len(rows[1])

    # higher levels: sort rows by full id tuple so each parent's children are
    # contiguous and sorted by last token; parent node ids come from the
    # previous level's sorted order.
    node_id = {(w,): w for w in range(v)}  # level-1 node id == word id
    prev_count = v
    for k in range(2, order + 1):
        rws = sorted(rows[k], key=lambda r: r[:k])
        words_k = np.empty(len(rws), np.uint32)
        logp_k = np.empty(len(rws), np.float32)
        bo_k = np.empty(len(rws), np.float32) if k < order else None
        child_start_prev = np.zeros(prev_count + 1, np.uint64)
        next_node_id = {}
        for i, r in enumerate(rws):
            prefix, w, lp, bo = r[: k - 1], r[k - 1], r[k], r[k + 1]
            parent = node_id.get(prefix)
            if parent is None:
                # ARPA guarantees prefix n-grams exist; tolerate gaps by
                # skipping (cannot be reached via the trie walk anyway)
                words_k[i] = 0
                logp_k[i] = SENTINEL
                if bo_k is not None:
                    bo_k[i] = 0.0
                continue
            words_k[i] = w
            logp_k[i] = lp
            if bo_k is not None:
                bo_k[i] = bo
            child_start_prev[parent + 1] += 1
            next_node_id[r[:k]] = i
        arrays[f"words_{k}"] = words_k
        arrays[f"logp_{k}"] = logp_k
        if bo_k is not None:
            arrays[f"backoff_{k}"] = bo_k
        arrays[f"child_start_{k - 1}"] = np.cumsum(child_start_prev,
                                                   dtype=np.uint64)
        counts[k] = len(rws)
        node_id = next_node_id
        prev_count = len(rws)

    # write
    vocab_bytes = "\n".join(words_sorted).encode("utf8")
    table = {}
    offset = 0

    def aligned(n):
        return (n + 63) // 64 * 64

    payload_parts = []
    pos = 0
    for name, arr in arrays.items():
        pos = aligned(pos)
        table[name] = [str(arr.dtype), list(arr.shape), pos]
        payload_parts.append((pos, arr.tobytes()))
        pos += arr.nbytes
    header = {"order": order, "counts": counts, "vocab_size": v,
              "vocab_bytes": len(vocab_bytes), "arrays": table}
    hj = json.dumps(header).encode("utf8")

    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint64(len(hj)).tobytes())
        f.write(hj)
        f.write(np.uint64(len(vocab_bytes)).tobytes())
        f.write(vocab_bytes)
        data_start = aligned(f.tell())
        f.write(b"\0" * (data_start - f.tell()))
        for pos, blob in payload_parts:
            f.seek(data_start + pos)
            f.write(blob)
    os.replace(tmp, out_path)
    return header


def is_dslm(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC)) == MAGIC
    except OSError:
        return False


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class BinaryLM:
    """mmap-backed n-gram LM with ArpaLM-compatible scoring."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[: len(MAGIC)] != MAGIC:
            self._mm.close()
            self._f.close()
            raise ValueError(f"{path}: not a DSLM file")
        off = len(MAGIC)
        hlen = int(np.frombuffer(self._mm, np.uint64, 1, off)[0])
        off += 8
        header = json.loads(self._mm[off: off + hlen].decode("utf8"))
        off += hlen
        vlen = int(np.frombuffer(self._mm, np.uint64, 1, off)[0])
        off += 8
        vocab = self._mm[off: off + vlen].decode("utf8")
        off += vlen
        data_start = (off + 63) // 64 * 64

        self.order = header["order"]
        self.vocab_size = header["vocab_size"]
        self.counts = {int(k): v for k, v in header["counts"].items()}
        # O(vocab) resident index; everything else stays on the map
        self.vocab = vocab.split("\n") if vocab else []
        self._wid = {w: i for i, w in enumerate(self.vocab)}
        self._a = {}
        for name, (dt, shape, pos) in header["arrays"].items():
            n = int(np.prod(shape)) if shape else 1
            self._a[name] = np.frombuffer(self._mm, np.dtype(dt), n,
                                          data_start + pos).reshape(shape)

    def close(self):
        self._a = {}
        self._mm.close()
        self._f.close()

    # -- trie walk ----------------------------------------------------------

    def _find(self, ids) -> tuple | None:
        """node handle (level, index) for an exact id tuple, or None."""
        if not ids:
            return None
        w0 = ids[0]
        if w0 >= self.vocab_size:
            return None
        level, idx = 1, w0
        for k, w in enumerate(ids[1:], start=2):
            cs = self._a.get(f"child_start_{level}")
            if cs is None:
                return None
            lo, hi = int(cs[idx]), int(cs[idx + 1])
            words = self._a[f"words_{k}"]
            j = lo + int(np.searchsorted(words[lo:hi], np.uint32(w)))
            if j >= hi or words[j] != w:
                return None
            level, idx = k, j
        return level, idx

    def _logp(self, node) -> float:
        level, idx = node
        return float(self._a[f"logp_{level}"][idx])

    def _backoff(self, node) -> float:
        level, idx = node
        bo = self._a.get(f"backoff_{level}")
        return float(bo[idx]) if bo is not None else 0.0

    def _ids(self, words) -> list:
        return [self._wid.get(w, -1) for w in words]

    # -- ArpaLM-compatible API -----------------------------------------------

    def score_word(self, context, word: str) -> float:
        """log10 P(word | context) with Katz backoff; same semantics as
        decoders.lm.ArpaLM.score_word."""
        wi = self._wid.get(word, -1)
        unk = self._wid.get("<unk>", -1)
        ctx = [i for i in self._ids(context)[-(self.order - 1):]
               ] if self.order > 1 else []
        penalty = 0.0
        while True:
            if wi >= 0 and all(i >= 0 for i in ctx):
                node = self._find(tuple(ctx) + (wi,))
                if node is not None and self._a[
                        f"logp_{node[0]}"][node[1]] != SENTINEL:
                    return penalty + self._logp(node)
            if not ctx:
                if unk >= 0:
                    n = self._find((unk,))
                    if n is not None:
                        return penalty + self._logp(n)
                return penalty - 10.0
            if all(i >= 0 for i in ctx):
                bo = self._find(tuple(ctx))
                if bo is not None:
                    penalty += self._backoff(bo)
            ctx = ctx[1:]

    def score_sentence(self, words, bos: bool = True) -> float:
        context = ("<s>",) if bos else ()
        total = 0.0
        for w in words:
            total += self.score_word(context, w)
            context = context + (w,)
        return total


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Convert a textual ARPA LM to the compact mmap-able "
                    "DSLM binary format")
    p.add_argument("arpa", help="input .arpa or .arpa.gz")
    p.add_argument("out", help="output .dslm path")
    args = p.parse_args(argv)
    header = convert_arpa(args.arpa, args.out)
    size = os.path.getsize(args.out)
    print(f"wrote {args.out}: order {header['order']}, "
          f"{sum(header['counts'].values())} n-grams, "
          f"{header['vocab_size']} words, {size / 1e6:.1f} MB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
