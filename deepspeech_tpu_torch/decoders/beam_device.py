"""On-device CTC prefix beam search (the JAX package's
``decoders/beam_device.py``), batched over utterances.

The search runs on the device of its inputs: a host loop over time steps,
each step a fixed set of PyTorch ops on (B, K) and (B, K, C) tensors, and
one launch of the total-order top-k (K10, ``ops/cuda/topk.py``) per step.

Design (fixed shapes, as the JAX package's):

* beams are ``beam_width`` rows per utterance with per-beam ``p_blank`` /
  ``p_non_blank`` log masses (Hannun et al. 2014);
* each step scores the full candidate grid: K stays (blank, or a repeat of
  the last char) and K x C extends, from the pruned per-step log
  posteriors;
* the only merge, an extend of one beam equal to the stay of another, is
  found exactly by a pair of int32 rolling hashes and their modular inverses
  (every hash op wraps mod 2^32, so every hash tensor is int32), and merged
  by a masked log-sum-exp;
* K10 keeps the best ``beam_width`` merged candidates in ``lax.top_k``'s
  order, and the selected payloads are rebuilt from (parent, char) with the
  same expressions in the same order, so that they are bit-equal to the
  candidates' own values;
* padded steps (``t >= length``) substitute a one-hot-blank posterior,
  which leaves every merged beam score unchanged.

The one-shot search (``ctc_beam_search_device``) carries only the K
per-beam scalars and records a (parent, char, emit) backpointer row per
step; the prefixes and frame offsets are rebuilt once at the end, on the
host (``_backtrace``). The streaming continuation (``beam_state_init``,
``ctc_beam_continue``, ``beam_state_best``) carries packed prefix rows
instead, so a search can be advanced chunk by chunk; it equals the one-shot
search over the concatenated frames. Word-LM shallow fusion
(``alpha * log10 P(word|ctx) + beta`` on space extensions) runs on the
device too, through :mod:`deepspeech_tpu_torch.decoders.lm_device`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from deepspeech_tpu_torch.decoders.base import Decoder
from deepspeech_tpu_torch.decoders.lm_device import (lm_score_word,
                                                     lm_state_init,
                                                     load_device_lm,
                                                     trie_advance,
                                                     trie_word_id)
from deepspeech_tpu_torch.device import resolve_device
from deepspeech_tpu_torch.ops.cuda import topk

NEG_INF = -math.inf
_HASH_M1 = 1000003
_HASH_M2 = 69069
# modular inverses of the (odd) hash multipliers mod 2^32, as signed int32:
# h_parent = (h_child - char - 1) * M^-1 exactly undoes one hash roll
_HASH_M1_INV = int(np.uint32(pow(_HASH_M1, -1, 2**32)).astype(np.int32))
_HASH_M2_INV = int(np.uint32(pow(_HASH_M2, -1, 2**32)).astype(np.int32))
_LOG10 = float(np.log(10.0))
# each beam's chars + frame offsets share one packed int32 row in the
# streaming carry: slot = (frame + 1) * _PACK + char_id (0 = empty). Caps
# num_classes at 64 and frame indices at 2^25.
_PACK = 64
_PACK_BITS = 6
_I32 = torch.int32


def unpack_prefix(pox, lens):
    """Packed (..., L) rows -> (chars, frame_offsets), -1 beyond each
    length."""
    ar = torch.arange(pox.shape[-1], dtype=_I32, device=pox.device)
    valid = ar < lens[..., None]
    chars = torch.where(valid, pox & (_PACK - 1), -1)
    offs = torch.where(valid, (pox >> _PACK_BITS) - 1, -1)
    return chars, offs


def logaddexp(a, b):
    """log(e^a + e^b) by JAX's formula, -inf safe: max + log1p(exp(-|a-b|)),
    and a + b where a - b is NaN (two infinities of one sign)."""
    delta = a - b
    return torch.where(torch.isnan(delta), a + b,
                       torch.maximum(a, b)
                       + torch.log1p(torch.exp(-delta.abs())))


def _masked_lse(x, mask, dim: int):
    """log-sum-exp of ``x`` where ``mask``, -inf on empty groups, NaN-free."""
    x = torch.where(mask, x, NEG_INF)
    m = x.amax(dim, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.where(mask, torch.exp(x - m_safe), 0.0).sum(dim)
    m = m.squeeze(dim)
    return torch.where(m > NEG_INF, torch.log(s) + m, NEG_INF)


def _prune_step(lp, cutoff_top_n: int, cutoff_prob: float):
    """ctcdecode per-step candidate pruning over (B, C) rows: keep the top
    ``cutoff_top_n`` chars, and if ``cutoff_prob < 1`` only as many
    (probability-sorted) as needed to cover ``cutoff_prob`` mass. Pruned
    chars get -inf."""
    c = lp.shape[-1]
    if cutoff_top_n >= c and cutoff_prob >= 1.0:
        return lp  # pruning is a no-op at these knobs
    order = torch.argsort(-lp, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    keep = rank < min(cutoff_top_n, c)
    if cutoff_prob < 1.0:
        cum = torch.cumsum(torch.exp(lp.gather(-1, order)), -1)
        # sorted rank r survives iff mass of ranks < r is still < cutoff_prob
        kept_sorted = torch.cat([torch.ones_like(keep[:, :1]),
                                 cum[:, :-1] < cutoff_prob], -1)
        keep = keep & kept_sorted.gather(-1, rank)
    return torch.where(keep, lp, NEG_INF)


def _consts(k: int, c: int, l: int, blank: int, space: int, device):
    """The step's index rows, made once per search."""
    ar_k = torch.arange(k, dtype=_I32, device=device)
    ar_c = torch.arange(c, dtype=_I32, device=device)
    return dict(k=ar_k, c=ar_c, l=torch.arange(l, dtype=_I32, device=device),
                onehot_blank=torch.where(ar_c == blank, 0.0, NEG_INF),
                not_blank=ar_c != blank, is_space=ar_c == space,
                sent=-(ar_k + 2))


def _beam_step(state, lp, t, t_valid, consts, *, blank: int,
               cutoff_top_n: int, cutoff_prob: float, max_len: int, lm=None,
               space: int = -1, alpha: float = 0.0, beta: float = 0.0,
               trace: bool = False):
    """One search step of every utterance. lp (B, C) log posteriors, t (B,)
    int32 frame index, t_valid (B,) bool. Two carry layouts share all the
    candidate and merge math:

    * ``trace=False`` (streaming continuation): packed (B, K, L) prefix
      rows ride the carry, a resumable state;
    * ``trace=True`` (one-shot search): the carry holds only the per-beam
      scalars and each step returns a (parent, char, emit) backpointer row;
      the prefixes are rebuilt once at the end (``_backtrace``).
    """
    n_scalar = 6 if trace else 7
    pox = None if trace else state[0]
    lens, last, h1, h2, p_b, p_nb = state[n_scalar - 6:n_scalar]
    b, k = lens.shape
    c = lp.shape[-1]
    ar_k, ar_c = consts["k"], consts["c"]

    # Padded steps decode a certain blank: every beam keeps its score.
    lp = torch.where(t_valid[:, None],
                     _prune_step(lp, cutoff_top_n, cutoff_prob),
                     consts["onehot_blank"])

    total = logaddexp(p_b, p_nb)  # (B, K)
    parent_ok = total > NEG_INF

    # --- candidates: K stays + (K, C) extends ---
    last_c = torch.clamp(last, 0, c - 1)
    lp_last = lp.gather(1, last_c.long())  # (B, K)
    stay_pb = total + lp[:, blank:blank + 1]
    stay_pnb = torch.where(lens > 0, p_nb + lp_last, NEG_INF)

    ext = torch.where(ar_c == last[:, :, None], p_b[:, :, None],
                      total[:, :, None]) + lp[:, None, :]  # (B, K, C)
    if lm is not None:
        # shallow fusion: extending with the space char completes the
        # beam's partial word; score it against the parent's word context
        # as the host decoder's lm_word_bonus does (beam.py)
        lm_ctx, lm_len, lm_trie = state[n_scalar:]
        wid_cur = trie_word_id(lm, lm_trie)
        lm_sc = lm_score_word(lm, lm_ctx, lm_len, wid_cur)
        bonus = torch.where(lm_trie != 0, alpha * lm_sc * _LOG10 + beta,
                            0.0)  # (B, K)
        ext = ext + bonus[:, :, None] * consts["is_space"]
    ext_ok = (parent_ok[:, :, None] & consts["not_blank"]
              & (lens[:, :, None] < max_len) & (ext > NEG_INF))

    # --- exact merge. Beam prefixes are pairwise distinct, so the ONLY
    # merge is extend(i, c) == stay(j), whose char is the stay's last char.
    # The rolling hash is an invertible affine map mod 2^32 (odd
    # multiplier), so each stay's PARENT hash is recovered exactly,
    # hp = (h - last - 1) * M^-1, and the merge is a (K, K) comparison:
    # hp[j] == h[i] on both lanes.
    hp1 = (h1 - (last + 1)) * _HASH_M1_INV  # (B, K) parent hash of a stay
    hp2 = (h2 - (last + 1)) * _HASH_M2_INV
    # ext value at (parent i, char = last[j]) rebuilt bit-exactly from the
    # same terms as ext[i, ch] (sel + lp[ch] [+ space bonus])
    sel_ij = torch.where(last[:, None, :] == last[:, :, None],
                         p_b[:, :, None], total[:, :, None])  # (B, Ki, Kj)
    ext_at = sel_ij + lp_last[:, None, :]
    if lm is not None:
        ext_at = ext_at + torch.where(last[:, None, :] == space,
                                      bonus[:, :, None], 0.0)
    match_ij = ((hp1[:, None, :] == h1[:, :, None])
                & (hp2[:, None, :] == h2[:, :, None])
                & (lens[:, None, :] > 0) & parent_ok[:, :, None]
                & (lens[:, :, None] < max_len) & (ext_at > NEG_INF))
    # mass of absorbed extends joins the matching stay's non-blank prob
    add_pnb = _masked_lse(ext_at, match_ij, 1)  # (B, K)
    stay_pnb = logaddexp(stay_pnb, add_pnb)
    # absorbed extends: (i, ch) with a matching stay j whose last == ch,
    # counted into (B, K, C) at each stay's char (integer sums: exact)
    absorb = match_ij & ((lens > 0) & (last >= 0))[:, None, :]
    ext_absorbed = torch.zeros((b, k, c), dtype=_I32,
                               device=lp.device).scatter_add_(
        2, last_c.long()[:, None, :].expand(b, k, k), absorb.to(_I32)) > 0

    stay_score = torch.where(parent_ok, logaddexp(stay_pb, stay_pnb),
                             NEG_INF)
    ext_score = torch.where(ext_ok & ~ext_absorbed, ext,
                            NEG_INF).reshape(b, k * c)

    # Offsets parity with the host decoder's first-insert-wins rule: when an
    # absorbed extend's parent row i ranks above the stay row j, the merged
    # beam carries the EXTEND's offsets (char stamped at this frame).
    i_first = torch.where(match_ij, ar_k[:, None], k).amin(1)
    has_ext = i_first < k
    i_min = torch.where(has_ext, i_first, 0)
    use_ext_off = has_ext & (i_min < ar_k)
    if not trace:
        width = pox.shape[-1]
        i_min_rows = i_min.long()[:, :, None].expand(-1, -1, width)
        pos_i = lens.gather(1, i_min.long())
        write_i = consts["l"] == pos_i[:, :, None]
        pack_j = (t[:, None] + 1) * _PACK + last_c  # the stay's own char
        off_from_ext = torch.where(write_i, pack_j[:, :, None],
                                   pox.gather(1, i_min_rows))
        stay_pox = torch.where(use_ext_off[:, :, None], off_from_ext, pox)

    # --- select beams (layout: [stays | extends]) through K10 ---
    score = torch.cat([stay_score, ext_score], 1)
    top_scores, idx = topk.topk_total_order(score, k)
    is_ext = idx >= k
    eidx = torch.clamp(idx - k, min=0)
    parent = torch.where(is_ext, eidx // c, idx)
    char = torch.where(is_ext, eidx % c, 0)
    sel_ok = top_scores > NEG_INF

    # Selected-candidate payloads are RECOMPUTED from (parent, char) with
    # the same expressions (same operands, same op order -> bit-identical);
    # every selected extend has ext_ok & ~absorbed, so the un-masked
    # formulas apply, and sel_ok masks the rest.
    par = parent.long()

    def at_parent(x):
        return x.gather(1, par)

    pb_p, total_p, last_p = at_parent(p_b), at_parent(total), at_parent(last)
    h1_p, h2_p = at_parent(h1), at_parent(h2)
    lp_ch = lp.gather(1, char.long())
    ext_val = torch.where(char == last_p, pb_p, total_p) + lp_ch
    if lm is not None:
        ext_val = ext_val + at_parent(bonus) * (char == space)
    sel_pb = torch.where(is_ext, NEG_INF, at_parent(stay_pb))
    sel_pnb = torch.where(is_ext, ext_val, at_parent(stay_pnb))
    char1 = char + 1
    sel_h1 = torch.where(is_ext, h1_p * _HASH_M1 + char1, h1_p)
    sel_h2 = torch.where(is_ext, h2_p * _HASH_M2 + char1, h2_p)

    pos = at_parent(lens)  # (B, K)
    new_lens = pos + is_ext.to(_I32)
    new_last = torch.where(is_ext, char, last_p)

    ys = None
    if trace:
        # backpointer row: selected stays whose offsets the first-insert
        # rule re-parents become (i_min, own last char, emit); the chain
        # through i_min reproduces both chars and stamped frames exactly
        j_sel = torch.clamp(idx, max=k - 1).long()
        reparent = ~is_ext & use_ext_off.gather(1, j_sel)
        tr_parent = torch.where(reparent, i_min.gather(1, j_sel), parent)
        tr_char = torch.where(is_ext, char, last_c.gather(1, j_sel))
        tr_emit = (is_ext | reparent) & sel_ok
        tr_parent = torch.where(sel_ok, tr_parent, ar_k)
        ys = (tr_parent, tr_char, tr_emit)
    else:
        rows = par[:, :, None].expand(-1, -1, pox.shape[-1])
        write = is_ext[:, :, None] & (consts["l"] == pos[:, :, None])
        base = torch.where(is_ext[:, :, None], pox.gather(1, rows),
                           stay_pox.gather(1, rows))
        new_pox = torch.where(write, ((t[:, None] + 1) * _PACK
                                      + char)[:, :, None], base)

    sent = consts["sent"]
    new_state = (() if trace else (new_pox,)) + (
        new_lens,
        torch.where(sel_ok, new_last, -1),
        torch.where(sel_ok, sel_h1, sent),
        torch.where(sel_ok, sel_h2, sent),
        torch.where(sel_ok, sel_pb, NEG_INF),
        torch.where(sel_ok, sel_pnb, NEG_INF),
    )
    if lm is not None:
        # per-beam LM carry: a space extend completes the parent's partial
        # word (context gains its vocab id, partial resets); any other
        # extend walks one char-trie edge; stays inherit the parent's state
        om1 = lm_ctx.shape[2]
        ctx_p = lm_ctx.gather(1, par[:, :, None].expand(-1, -1, om1))
        len_p, trie_p = at_parent(lm_len), at_parent(lm_trie)
        adv = trie_advance(lm, trie_p, char)
        is_space_ext = is_ext & (char == space)
        completes = is_space_ext & (trie_p != 0)
        if om1 > 0:
            shifted = torch.cat([ctx_p[:, :, 1:],
                                 at_parent(wid_cur)[:, :, None]], 2)
            new_ctx = torch.where(completes[:, :, None], shifted, ctx_p)
        else:
            new_ctx = ctx_p
        new_clen = torch.where(completes, torch.clamp(len_p + 1, max=om1),
                               len_p)
        new_trie = torch.where(is_space_ext, 0,
                               torch.where(is_ext, adv, trie_p))
        new_state = new_state + (new_ctx, new_clen, new_trie)
    return new_state, ys


def _init_scalars(batch: int, k: int, device):
    """(lens, last, h1, h2, p_b, p_nb) of a fresh search: beam 0 is the
    empty prefix, the others start invalid with sentinel hashes."""
    ar_k = torch.arange(k, dtype=_I32, device=device)
    h0 = torch.where(ar_k == 0, 1, -(ar_k + 2)).expand(batch, k)
    return (torch.zeros((batch, k), dtype=_I32, device=device),
            torch.full((batch, k), -1, dtype=_I32, device=device),
            h0.clone(), h0.clone(),
            torch.where(ar_k == 0, 0.0, NEG_INF).expand(batch, k).clone(),
            torch.full((batch, k), NEG_INF, device=device))


def _final_scores(p_b, p_nb, lm_state, lm, alpha: float, beta: float):
    """Merged beam scores; with ``lm`` the pending partial word completes,
    like the host decoder's end-of-utterance bonus."""
    score = logaddexp(p_b, p_nb)
    if lm is not None:
        lm_ctx, lm_len, lm_trie = lm_state
        sc = lm_score_word(lm, lm_ctx, lm_len, trie_word_id(lm, lm_trie))
        score = score + torch.where(lm_trie != 0,
                                    alpha * sc * _LOG10 + beta, 0.0)
    return score


def _backtrace(parents, chars, emits, ts, lens_final, rows, l: int):
    """Rebuild (prefix, offsets) rows from the per-step backpointer trace,
    on the host with numpy (exact integer work).

    parents/chars/emits: (T, B, K); ts: (T,) frame stamps; lens_final
    (B, K); rows: (B, P) final beam rows to walk. Each row's parent chain is
    followed backwards; every emitting step writes one (char, frame) at its
    position. -> (prefix, offsets) (B, P, l) int32, -1 where unwritten."""
    t_max, b, _ = parents.shape
    bi = np.arange(b)[:, None]
    cur = rows.astype(np.int64)
    pos = lens_final[bi, cur].astype(np.int64)
    prefix = np.full(rows.shape + (l,), -1, np.int32)
    offs = np.full(rows.shape + (l,), -1, np.int32)
    for t in range(t_max - 1, -1, -1):
        e = emits[t][bi, cur]
        p_new = pos - e
        w = e & (p_new >= 0) & (p_new < l)
        wb, wp = np.nonzero(w)
        prefix[wb, wp, p_new[w]] = chars[t][bi, cur][w]
        offs[wb, wp, p_new[w]] = ts[t]
        cur = parents[t][bi, cur].astype(np.int64)
        pos = p_new
    return prefix, offs


def ctc_beam_search_device(log_probs, lengths, beam_width: int = 10,
                           blank: int = 0, cutoff_top_n: int = 40,
                           cutoff_prob: float = 1.0, top_paths: int = 1,
                           max_len: int | None = None, lm: dict | None = None,
                           space: int = -1, alpha: float = 0.0,
                           beta: float = 0.0):
    """Batched CTC prefix beam search on the device of ``log_probs``.

    Args:
      log_probs: (B, T, C) f32 log posteriors.
      lengths:   (B,) valid frame counts.
      lm: optional device LM tensors (decoders/lm_device.py), on the same
        device, for word-level shallow fusion at ``space`` emissions with
        weights alpha/beta.
    Returns, on the device of ``log_probs``:
      prefixes (B, top_paths, L) int32 padded with -1 beyond each length,
      lens (B, top_paths), offsets (B, top_paths, L) frame indices,
      scores (B, top_paths) merged log probabilities (LM bonuses included).
    """
    b, t_max, c = log_probs.shape
    if c > _PACK:
        raise ValueError(f"beam search supports up to {_PACK} classes")
    k = beam_width
    l = t_max if max_len is None else min(max_len, t_max)
    dev = log_probs.device
    log_probs = log_probs.float()
    lengths = torch.as_tensor(lengths).to(dev, _I32)
    state = _init_scalars(b, k, dev)
    if lm is not None:
        state = state + lm_state_init(lm, b, k)
    consts = _consts(k, c, l, blank, space, dev)
    ts = torch.arange(t_max, dtype=_I32, device=dev)
    valid = ts < lengths[:, None]  # (B, T)
    trace = []
    for t in range(t_max):
        state, ys = _beam_step(
            state, log_probs[:, t], ts[t].expand(b), valid[:, t], consts,
            blank=blank, cutoff_top_n=cutoff_top_n, cutoff_prob=cutoff_prob,
            max_len=l, lm=lm, space=space, alpha=alpha, beta=beta,
            trace=True)
        trace.append(torch.stack([ys[0], ys[1], ys[2].to(_I32)]))
    lens = state[0]
    score = _final_scores(state[4], state[5], state[6:], lm, alpha, beta)
    order = torch.argsort(-score, dim=1, stable=True)[:, :top_paths]
    if t_max:  # (3, T, B, K): parent, char, emit rows
        parents, chars, emits = torch.stack(trace, 1).cpu().numpy()
    else:
        parents = chars = emits = np.zeros((0, b, k), np.int32)
    prefix, offs = _backtrace(parents, chars, emits.astype(bool),
                              np.arange(t_max, dtype=np.int32),
                              lens.cpu().numpy(), order.cpu().numpy(), l)
    return (torch.from_numpy(prefix).to(dev), lens.gather(1, order),
            torch.from_numpy(offs).to(dev), score.gather(1, order))


# ---------------------------------------------------------------------------
# streaming continuation API: the beam state is an explicit carry, so a
# search can be advanced chunk by chunk and finalized at any time. Padded
# steps (valid=False) decode a certain blank and leave every merged beam
# unchanged, so a chunked run equals the one-shot search over the
# concatenated valid frames.
# ---------------------------------------------------------------------------

def beam_state_init(batch: int, beam_width: int, max_len: int, lm=None,
                    device: str | torch.device = "cuda"):
    """Fresh batched beam state on ``device`` (the LM's, when given): beam
    0 = the empty prefix per utterance. With ``lm`` the per-beam
    word-context / char-trie carry is appended."""
    dev = lm["logp_1"].device if lm is not None else resolve_device(device)
    st = (torch.zeros((batch, beam_width, max_len), dtype=_I32,
                      device=dev),) + _init_scalars(batch, beam_width, dev)
    if lm is not None:
        st = st + lm_state_init(lm, batch, beam_width)
    return st


def ctc_beam_continue(state, logits, ts, valid, blank: int = 0,
                      cutoff_top_n: int = 40, cutoff_prob: float = 1.0,
                      lm: dict | None = None, space: int = -1,
                      alpha: float = 0.0, beta: float = 0.0):
    """Advance a batched beam state by one chunk.

    logits: (B, T, C) raw logits (log-softmax applied here); ts: (B, T)
    int32 global frame index per step (stamped into offsets); valid:
    (B, T) bool, False steps are no-ops (certain blank). ``lm`` must match
    ``beam_state_init``'s (the state carries its shape)."""
    if logits.shape[-1] > _PACK:
        raise ValueError(f"beam search supports up to {_PACK} classes")
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    b, t_max, c = log_probs.shape
    k, l = state[0].shape[1:]
    consts = _consts(k, c, l, blank, space, log_probs.device)
    ts = ts.to(_I32)
    for t in range(t_max):
        state, _ = _beam_step(
            state, log_probs[:, t], ts[:, t], valid[:, t], consts,
            blank=blank, cutoff_top_n=cutoff_top_n, cutoff_prob=cutoff_prob,
            max_len=l, lm=lm, space=space, alpha=alpha, beta=beta)
    return state


def beam_state_best(state, top_paths: int = 1, lm: dict | None = None,
                    space: int = -1, alpha: float = 0.0, beta: float = 0.0):
    """(prefixes (B,P,L), lens (B,P), offsets (B,P,L), scores (B,P)) of the
    current best beams, callable mid-stream or at the end. With ``lm`` the
    pending partial word's completion bonus is applied to the ranking, like
    the one-shot search's finalization."""
    pox, lens = state[0], state[1]
    score = _final_scores(state[5], state[6], state[7:], lm, alpha, beta)
    order = torch.argsort(-score, dim=1, stable=True)[:, :top_paths]
    rows = order[:, :, None].expand(-1, -1, pox.shape[-1])
    lens_o = lens.gather(1, order)
    prefixes, offsets = unpack_prefix(pox.gather(1, rows), lens_o)
    return prefixes, lens_o, offsets, score.gather(1, order)


class DeviceBeamCTCDecoder(Decoder):
    """Beam decoder running the search on ``device``.

    Same call convention as :class:`~.beam.BeamCTCDecoder`:
    ``decode(probs, sizes)`` returns (strings, offsets) nested
    [batch][path]. With ``lm_path`` the word n-gram LM is on the device
    too: shallow fusion ``alpha * log10 P(word|ctx) + beta`` at space
    emissions inside the search."""

    def __init__(self, labels, beam_width=10, cutoff_top_n=40,
                 cutoff_prob=1.0, top_paths=1, blank_index=0,
                 max_len: int | None = None, lm_path: str | None = None,
                 alpha: float = 0.8, beta: float = 1.0,
                 device: str | torch.device = "cuda"):
        super().__init__(labels, blank_index)
        self.beam_width = beam_width
        self.cutoff_top_n = cutoff_top_n
        self.cutoff_prob = float(cutoff_prob)
        self.top_paths = top_paths
        self.max_len = max_len
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.device = resolve_device(device)
        self.lm = (load_device_lm(lm_path, labels, self.device) if lm_path
                   else None)

    def decode(self, probs, sizes=None):
        """probs: (B, T, C) posteriors, a tensor (moved to the decoder's
        device when elsewhere) or an array. -> (strings, offsets)."""
        probs = torch.as_tensor(probs).to(self.device, torch.float32)
        b, t_max, _ = probs.shape
        sizes = (torch.full((b,), t_max, dtype=_I32, device=self.device)
                 if sizes is None else torch.as_tensor(sizes))
        log_probs = torch.log(torch.clamp(probs, 1e-30, 1.0))
        prefixes, lens, offsets, _ = ctc_beam_search_device(
            log_probs, sizes, beam_width=self.beam_width,
            blank=self.blank_index, cutoff_top_n=self.cutoff_top_n,
            cutoff_prob=self.cutoff_prob, top_paths=self.top_paths,
            max_len=self.max_len, lm=self.lm,
            space=(self.space_index if self.lm is not None else -1),
            alpha=self.alpha, beta=self.beta)
        prefixes = prefixes.cpu().numpy()
        lens = lens.cpu().numpy()
        offsets = offsets.cpu().numpy()

        strings, offs = [], []
        for i in range(b):
            utt_s, utt_o = [], []
            for p in range(self.top_paths):
                n = int(lens[i, p])
                utt_s.append("".join(self.int_to_char[int(x)]
                                     for x in prefixes[i, p, :n]))
                utt_o.append(offsets[i, p, :n].astype(np.int32))
            strings.append(utt_s)
            offs.append(utt_o)
        return strings, offs
