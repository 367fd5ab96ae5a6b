"""Device-resident n-gram LM: DSLM tables as tensors + batched scoring
(the JAX package's ``decoders/lm_device.py``).

The on-device beam search (:mod:`deepspeech_tpu_torch.decoders.beam_device`)
applies ``alpha * log10 P(word | context) + beta`` at word boundaries with
these tables on the search's device, scoring every beam of every utterance
at once.

Layout (one flat dict):

* the DSLM trie levels verbatim (``decoders/lm_binary.py``): dense
  ``logp_1``/``backoff_1`` over vocab ids, and per level k>=2 ``words_k``
  (sorted within each parent's ``child_start_{k-1}`` range), ``logp_k``,
  ``backoff_k``, all int32 / float32 tensors, plus ``key_k`` (int64),
  ``parent * vocab_size + word`` of each row, which is globally sorted;
* a character trie over the vocabulary (edges keyed ``node * C + char_id``,
  globally sorted) that maps each beam's current partial word, a sequence of
  label ids, to its vocab id: one int32 node per beam;
* ``unk_id`` / ``bos_id`` / ``trie_c`` as Python ints.

The queries take int32 tensors of any one shape (the search passes (B, K))
and answer elementwise. Each lookup is one ``torch.searchsorted``: over the
sorted edge keys for the char trie, and over ``key_k`` for a child
``wid`` of ``node``, clamped to the parent's range ``[cs[node],
cs[node + 1]]``. That is the position the JAX package's branchless binary
search (``_lower_bound``) finds inside the parent's range, in one op
instead of ~13 dependent steps of ~8 ops: rows of earlier parents have
keys below ``node * V``, rows of later ones at or above ``(node + 1) * V``
(an OOV ``wid`` of -1 is the one key that can tie an earlier parent's row,
and the clamp returns ``cs[node]`` for it, as the binary search does). The
n-gram walk and the backoff loop are unrolled over the LM order,
replicating ``BinaryLM.score_word`` / ``ArpaLM.score_word`` (asserted in
tests/test_torch_lm.py). LMs beyond 2^31 n-grams per level, and levels not
sorted within their parents' ranges, are rejected at build time.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from deepspeech_tpu_torch.device import resolve_device

SENTINEL = -99.0  # absent-unigram marker, == lm_binary.SENTINEL
_I32_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# build (host side)
# ---------------------------------------------------------------------------


def _build_char_trie(vocab, labels: str):
    """Char trie over ``vocab`` using ``labels``' character->id mapping.

    Words containing characters outside the label set can never be produced
    by the beam and are skipped (the host decoder reaches the same outcome:
    its partial-word string simply never equals such a word).
    Returns (edge_key int32 sorted, edge_child int32, node_word int32).
    """
    cmap = {ch: i for i, ch in enumerate(labels)}
    children: list[dict] = [{}]
    word_at = [-1]
    for wid, w in enumerate(vocab):
        ids = [cmap.get(ch) for ch in w]
        if not ids or any(i is None for i in ids):
            continue
        node = 0
        for ci in ids:
            nxt = children[node].get(ci)
            if nxt is None:
                nxt = len(children)
                children.append({})
                word_at.append(-1)
                children[node][ci] = nxt
            node = nxt
        word_at[node] = wid
    c = len(labels)
    keys, childs = [], []
    for node, ch in enumerate(children):
        for ci, nxt in ch.items():
            keys.append(node * c + ci)
            childs.append(nxt)
    if keys and max(keys) >= 2**31:
        raise ValueError("LM vocabulary trie too large for int32 edge keys")
    if not keys:  # degenerate vocab: one unmatchable sentinel edge
        keys, childs = [_I32_MAX], [-1]
    keys = np.asarray(keys, np.int64)
    order = np.argsort(keys, kind="stable")
    return (keys[order].astype(np.int32),
            np.asarray(childs, np.int32)[order],
            np.asarray(word_at, np.int32))


def build_device_lm(blm, labels: str, device: str | torch.device = "cuda"
                    ) -> dict:
    """BinaryLM (decoders/lm_binary.py) -> flat dict of tensors on
    ``device``."""
    dev = resolve_device(device)
    a = {}

    def as_i32(x, name):
        x = np.asarray(x)
        if x.size and int(x.max(initial=0)) >= 2**31:
            raise ValueError(f"{name}: LM too large for int32 device indices")
        return x.astype(np.int32, copy=True)

    def as_f32(x):  # copy=True: never alias the (possibly mmap'd) source
        return np.asarray(x).astype(np.float32, copy=True)

    a["logp_1"] = as_f32(blm._a["logp_1"])
    a["backoff_1"] = as_f32(blm._a["backoff_1"])
    for k in range(2, blm.order + 1):
        a[f"words_{k}"] = as_i32(blm._a[f"words_{k}"], f"words_{k}")
        a[f"logp_{k}"] = as_f32(blm._a[f"logp_{k}"])
        bo = blm._a.get(f"backoff_{k}")
        if bo is not None:
            a[f"backoff_{k}"] = as_f32(bo)
    for k in range(1, blm.order):
        a[f"child_start_{k}"] = as_i32(blm._a[f"child_start_{k}"],
                                       f"child_start_{k}")
    for k in range(2, blm.order + 1):
        # row i belongs to the parent whose [cs[p], cs[p + 1]) holds it
        cs, words = a[f"child_start_{k - 1}"], a[f"words_{k}"]
        parent = np.searchsorted(cs, np.arange(len(words)), side="right") - 1
        key = parent.astype(np.int64) * blm.vocab_size + words
        if np.any(np.diff(key) < 0):
            raise ValueError(f"words_{k}: not sorted within each parent's "
                             "range")
        a[f"key_{k}"] = key
    ek, ec, nw = _build_char_trie(blm.vocab, labels)
    a["trie_edge_key"], a["trie_edge_child"], a["trie_node_word"] = ek, ec, nw
    lm = {k_: torch.from_numpy(v_).to(dev) for k_, v_ in a.items()}
    lm["unk_id"] = int(blm._wid.get("<unk>", -1))
    lm["bos_id"] = int(blm._wid.get("<s>", -1))
    lm["trie_c"] = len(labels)
    return lm


def load_device_lm(path: str, labels: str,
                   device: str | torch.device = "cuda") -> dict:
    """ARPA(.gz) or DSLM file -> device LM tensors; a KenLM binary raises.

    Textual ARPA goes through the DSLM converter into a temp file first
    (one-time cost; ship a .dslm for production, see lm_binary.main)."""
    from deepspeech_tpu_torch.decoders.lm import refuse_kenlm
    from deepspeech_tpu_torch.decoders.lm_binary import (BinaryLM,
                                                         convert_arpa,
                                                         is_dslm)
    refuse_kenlm(path)
    if is_dslm(path):
        blm = BinaryLM(path)
    else:
        fd, tmp = tempfile.mkstemp(suffix=".dslm")
        os.close(fd)
        try:
            convert_arpa(path, tmp)
            blm = BinaryLM(tmp)
        finally:
            os.unlink(tmp)  # the mmap keeps the inode alive while open
    try:
        return build_device_lm(blm, labels, device)
    finally:
        blm.close()


def lm_order(lm: dict) -> int:
    """LM order from the dict's keys."""
    order = 1
    while f"logp_{order + 1}" in lm:
        order += 1
    return order


# ---------------------------------------------------------------------------
# queries, elementwise over int32 tensors of one shape
# ---------------------------------------------------------------------------


def _find(lm: dict, ids, valid):
    """Trie node for an exact id tuple (list of int32 tensors, length >= 1).
    Returns (found, logp, backoff), the twin of ``BinaryLM._find`` +
    ``_logp``/``_backoff``."""
    v = lm["logp_1"].shape[0]
    found = valid & (ids[0] >= 0) & (ids[0] < v)
    node = torch.clamp(ids[0], 0, v - 1)
    level = 1
    for j, wid in enumerate(ids[1:], start=2):
        cs = lm.get(f"child_start_{j - 1}")
        words = lm.get(f"words_{j}")
        if cs is None or words is None or words.shape[0] == 0:
            zero = torch.zeros(valid.shape, device=valid.device)
            return torch.zeros_like(valid), zero, zero
        size = words.shape[0]
        lo = cs[node]
        hi = cs[torch.clamp(node + 1, max=cs.shape[0] - 1)]
        # the first row of node's range whose word is not below wid
        pos = torch.searchsorted(lm[f"key_{j}"], node.long() * v + wid)
        pos = torch.minimum(torch.maximum(pos, lo), hi)
        pos_c = torch.clamp(pos, max=size - 1)
        found = found & (pos < hi) & (words[pos_c] == wid) & (wid >= 0)
        node = pos_c
        level = j
    logp = lm[f"logp_{level}"][node]
    bo_arr = lm.get(f"backoff_{level}")
    bo = bo_arr[node] if bo_arr is not None else torch.zeros_like(logp)
    return found, logp, bo


def lm_score_word(lm: dict, ctx, ctx_len, wi):
    """log10 P(word wi | ctx) with Katz backoff, the replication of
    ``BinaryLM.score_word`` elementwise.

    ctx: (..., order-1) int32 word ids, most recent LAST, the first
    ``order-1 - ctx_len`` slots unused; ids are -1 for OOV words. ctx_len,
    wi: (...) int32 (wi -1 = OOV). Returns (...) f32 log10 probs (finite)."""
    om1 = lm_order(lm) - 1
    penalty = torch.zeros(wi.shape, device=wi.device)
    res = torch.zeros(wi.shape, device=wi.device)
    done = torch.zeros(wi.shape, dtype=torch.bool, device=wi.device)
    v = lm["logp_1"].shape[0]

    for n in range(om1, -1, -1):
        active = ~done & (n <= ctx_len)
        ctx_n = [ctx[..., om1 - n + i] for i in range(n)]
        ctx_known = active
        for t in ctx_n:
            ctx_known = ctx_known & (t >= 0)
        # exact (ctx_n..., wi) lookup
        found, logp, _ = _find(lm, ctx_n + [wi], ctx_known & (wi >= 0))
        hit = found & (logp != SENTINEL)
        res = torch.where(hit, penalty + logp, res)
        done = done | hit
        if n > 0:
            # back off: accumulate the abandoned context's backoff weight
            bo_found, _, bo = _find(lm, ctx_n, ctx_known & ~done)
            penalty = penalty + torch.where(bo_found & ~done & active, bo,
                                            0.0)
        else:
            # <unk> fallback (no SENTINEL check, as the host reader)
            unk = lm["unk_id"]
            fallback = (penalty + lm["logp_1"][min(max(unk, 0), v - 1)]
                        if unk >= 0 else penalty - 10.0)
            res = torch.where(done | ~active, res, fallback)
            done = done | active
    return res


def trie_advance(lm: dict, node, char):
    """Append label ``char`` to each beam's partial word: walk one char-trie
    edge. node: int32 (0 = root/empty partial, -1 = dead = not a vocab
    prefix); returns the child node or -1."""
    ek, ec = lm["trie_edge_key"], lm["trie_edge_child"]
    size = ek.shape[0]
    key = node * lm["trie_c"] + char
    pos = torch.searchsorted(ek, key)  # the edge keys are globally sorted
    pos_c = torch.clamp(pos, max=size - 1)
    ok = (node >= 0) & (pos < size) & (ek[pos_c] == key)
    return torch.where(ok, ec[pos_c], -1)


def trie_word_id(lm: dict, node):
    """Vocab id of the partial word at ``node`` (-1 = OOV/dead/empty)."""
    nw = lm["trie_node_word"]
    return torch.where(node > 0, nw[torch.clamp(node, 0, nw.shape[0] - 1)],
                       -1)


def lm_state_init(lm: dict, batch: int, beam_width: int):
    """Fresh per-beam LM carry on the LM's device: (ctx (B, K, order-1),
    ctx_len (B, K), trie (B, K)), int32. Context starts as [<s>] like the
    host's ``("<s>",) + words`` (decoders/beam.py lm_word_bonus)."""
    om1 = lm_order(lm) - 1
    dev = lm["logp_1"].device
    shape = (batch, beam_width)
    ctx = torch.full(shape + (om1,), -1, dtype=torch.int32, device=dev)
    if om1 > 0:
        ctx[..., -1] = lm["bos_id"]
    ctx_len = torch.full(shape, min(1, om1), dtype=torch.int32, device=dev)
    trie = torch.zeros(shape, dtype=torch.int32, device=dev)
    return ctx, ctx_len, trie
