"""PyTorch port: the n-gram LM readers, the device LM tables and the host
beam decoder against the JAX package.

* DSLM files written by the two converters are byte-identical, and each
  package's reader loads the other's.
* ``lm_score_word``, ``trie_advance`` and ``trie_word_id`` of the port,
  batched over every case at once, equal the JAX package's scalar versions
  and ``BinaryLM.score_word`` within 1e-6, on the bigram and trigram ARPAs
  of tests/test_lm_device.py and on a seeded trigram LM of ~1,400
  n-grams (2,000 queries, ~800 of them exact hits).
* The host ``BeamCTCDecoder`` (python backend) gives the JAX package's
  strings and offsets, with and without the LM and blank collapse, and in
  spawned worker processes.
"""

import gzip

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeech_tpu.decoders import lm_device as jax_lm_device
from deepspeech_tpu.decoders.beam import BeamCTCDecoder as JaxBeamDecoder
from deepspeech_tpu.decoders.lm import ArpaLM as JaxArpaLM
from deepspeech_tpu.decoders.lm_binary import BinaryLM as JaxBinaryLM
from deepspeech_tpu.decoders.lm_binary import convert_arpa as jax_convert
from deepspeech_tpu_torch.decoders import lm_device
from deepspeech_tpu_torch.decoders.beam import BeamCTCDecoder
from deepspeech_tpu_torch.decoders.lm import ArpaLM, KENLM_MAGIC, load_lm
from deepspeech_tpu_torch.decoders.lm_binary import (BinaryLM, convert_arpa,
                                                     is_dslm)
from deepspeech_tpu_torch.decoders.lm_binary import main as convert_main
from tests.test_beam import ARPA
from tests.test_lm_device import TRIGRAM_ARPA, TestScoreParity

LABELS = "_AB "
ARPAS = {"bigram": ARPA, "trigram": TRIGRAM_ARPA}
CASES = {"bigram": TestScoreParity.CASES, "trigram": TestScoreParity.TRI_CASES}


@pytest.fixture(params=sorted(ARPAS))
def arpa(request, tmp_path):
    p = tmp_path / f"{request.param}.arpa"
    p.write_text(ARPAS[request.param])
    return request.param, str(p)


def test_dslm_bytes_identical_and_cross_readable(arpa, tmp_path):
    _, path = arpa
    ours, theirs = str(tmp_path / "port.dslm"), str(tmp_path / "jax.dslm")
    assert convert_arpa(path, ours) == jax_convert(path, theirs)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    gz = str(tmp_path / "lm.arpa.gz")
    with open(path, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    assert convert_main([gz, str(tmp_path / "gz.dslm")]) == 0
    with open(ours, "rb") as f, open(tmp_path / "gz.dslm", "rb") as g:
        assert f.read() == g.read()
    assert is_dslm(ours) and not is_dslm(path)
    host, jax_host = BinaryLM(theirs), JaxBinaryLM(ours)
    arpa_lm = ArpaLM(path)
    for context, word in CASES[arpa[0]]:
        want = JaxArpaLM(path).score_word(context, word)
        assert host.score_word(context, word) == jax_host.score_word(
            context, word)
        assert arpa_lm.score_word(context, word) == want
        assert host.score_word(context, word) == pytest.approx(want,
                                                               abs=1e-5)
    host.close()
    jax_host.close()


def _ctx_ids(vocab, context, order):
    ids = [vocab.index(w) if w in vocab else -1 for w in context]
    ids = ids[-(order - 1):] if order > 1 else []
    ctx = np.full(order - 1, -1, np.int32)
    if ids:
        ctx[order - 1 - len(ids):] = ids
    return ctx, len(ids)


def test_device_scores_match_jax_and_host(arpa):
    """All cases in one batched call against the JAX scalar function and
    BinaryLM.score_word."""
    name, path = arpa
    dev = lm_device.load_device_lm(path, LABELS, "cpu")
    jdev = jax_lm_device.load_device_lm(path, LABELS)
    blm = load_lm(path)
    vocab = sorted({w for gram in blm.ngrams for w in gram})
    order = blm.order
    cases = CASES[name]
    ctx, clen = zip(*(_ctx_ids(vocab, c, order) for c, _ in cases))
    wi = [vocab.index(w) if w in vocab else -1 for _, w in cases]
    ctx, clen, wi = np.stack(ctx), np.asarray(clen, np.int32), np.asarray(
        wi, np.int32)
    # (2, N): the batch shape of the beam search, (B, K)
    got = lm_device.lm_score_word(
        dev, torch.from_numpy(np.stack([ctx, ctx])),
        torch.from_numpy(np.stack([clen, clen])),
        torch.from_numpy(np.stack([wi, wi]))).numpy()
    assert np.array_equal(got[0], got[1])
    for i, (context, word) in enumerate(cases):
        ref = float(jax_lm_device.lm_score_word(
            jdev, jnp.asarray(ctx[i]), jnp.int32(clen[i]), jnp.int32(wi[i])))
        assert got[0, i] == pytest.approx(ref, abs=1e-6)
        assert got[0, i] == pytest.approx(blm.score_word(context, word),
                                          abs=1e-6)
    assert lm_device.lm_order(dev) == order


def test_char_trie_walk_matches_jax(arpa):
    _, path = arpa
    dev = lm_device.load_device_lm(path, LABELS, "cpu")
    jdev = jax_lm_device.load_device_lm(path, LABELS)
    for key in ("trie_edge_key", "trie_edge_child", "trie_node_word"):
        assert np.array_equal(dev[key].numpy(), np.asarray(jdev[key]))
    n_nodes = dev["trie_node_word"].shape[0]
    nodes = np.repeat(np.arange(-1, n_nodes + 1, dtype=np.int32), 4)
    chars = np.tile(np.arange(4, dtype=np.int32), n_nodes + 2)
    got = lm_device.trie_advance(dev, torch.from_numpy(nodes),
                                 torch.from_numpy(chars)).numpy()
    wid = lm_device.trie_word_id(dev, torch.from_numpy(nodes)).numpy()
    for i, (nd, ch) in enumerate(zip(nodes, chars)):
        assert got[i] == int(jax_lm_device.trie_advance(
            jdev, jnp.int32(nd), jnp.int32(ch)))
        assert wid[i] == int(jax_lm_device.trie_word_id(jdev, jnp.int32(nd)))
    # the word AB: root -A-> -B-> its vocab id; ABB is not a prefix
    a, b = LABELS.index("A"), LABELS.index("B")
    n_ab = lm_device.trie_advance(dev, lm_device.trie_advance(
        dev, torch.tensor([0], dtype=torch.int32), torch.tensor([a])),
        torch.tensor([b]))
    blm = load_lm(path)
    vocab = sorted({w for gram in blm.ngrams for w in gram})
    assert int(lm_device.trie_word_id(dev, n_ab)) == vocab.index("AB")
    assert int(lm_device.trie_advance(dev, n_ab, torch.tensor([b]))) == -1


def test_state_init_matches_jax(arpa):
    _, path = arpa
    dev = lm_device.load_device_lm(path, LABELS, "cpu")
    jdev = jax_lm_device.load_device_lm(path, LABELS)
    ctx, clen, trie = lm_device.lm_state_init(dev, 3, 4)
    jctx, jlen, jtrie = jax_lm_device.lm_state_init(jdev, 4)
    assert ctx.shape == (3, 4) + tuple(jctx.shape[1:])
    for got, ref in ((ctx, jctx), (clen, jlen), (trie, jtrie)):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.broadcast_to(
            np.asarray(ref), got.shape))


def test_kenlm_binaries_refused(tmp_path):
    p = tmp_path / "lm.binary"
    p.write_bytes(KENLM_MAGIC + b"\0" * 64)
    with pytest.raises(ValueError, match="KenLM"):
        load_lm(str(p))
    with pytest.raises(ValueError, match="KenLM"):
        lm_device.load_device_lm(str(p), LABELS, "cpu")
    with pytest.raises(RuntimeError, match="native"):
        BeamCTCDecoder(LABELS, backend="native")


def _probs(seed, b=3, t=14, c=len(LABELS)):
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.ones(c), size=(b, t))


@pytest.mark.parametrize("lm,collapse,top_paths", [
    (None, 1.0, 1), (None, 0.4, 3), ("bigram", 1.0, 2), ("trigram", 1.0, 1),
    ("trigram", 0.4, 3)])
def test_host_beam_matches_jax(tmp_path, lm, collapse, top_paths):
    path = None
    if lm is not None:
        path = str(tmp_path / "lm.arpa")
        with open(path, "w") as f:
            f.write(ARPAS[lm])
    probs = _probs(len(str(lm)) + top_paths)
    probs[:, ::3, 0] += 2.0  # runs of confident blanks for the collapse
    probs /= probs.sum(-1, keepdims=True)
    sizes = np.array([14, 11, 9])
    kw = dict(lm_path=path, alpha=1.2, beta=0.4, beam_width=12,
              top_paths=top_paths, blank_collapse_threshold=collapse,
              num_processes=1)
    got_s, got_o = BeamCTCDecoder(LABELS, backend="python", **kw).decode(
        torch.from_numpy(probs), torch.from_numpy(sizes))
    ref_s, ref_o = JaxBeamDecoder(LABELS, backend="python", **kw).decode(
        probs, sizes)
    assert got_s == ref_s
    for g, r in zip(got_o, ref_o):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)


def test_host_beam_process_pool_matches_serial(tmp_path):
    path = str(tmp_path / "lm.arpa")
    with open(path, "w") as f:
        f.write(TRIGRAM_ARPA)
    probs = _probs(5, b=4)
    serial = BeamCTCDecoder(LABELS, lm_path=path, beam_width=8,
                            num_processes=1).decode(probs)
    pooled = BeamCTCDecoder(LABELS, lm_path=path, beam_width=8,
                            num_processes=2)
    try:
        got = pooled.decode(probs)
    finally:
        pooled.close()
    assert got[0] == serial[0]
    for g, r in zip(got[1], serial[1]):
        np.testing.assert_array_equal(g[0], r[0])


def _random_arpa(rng, n_words=300):
    """A trigram ARPA over A-Z words: every bigram's head and every
    trigram's prefix bigram exist, as in a real ARPA."""
    letters = list("ABCDEFGHIJKLMNOPQRSTUVWXYZ")
    words = sorted({"".join(rng.choice(letters, int(rng.integers(1, 5))))
                    for _ in range(n_words)})
    bi = sorted({(str(rng.choice(["<s>"] + words)), str(rng.choice(words)))
                 for _ in range(3 * len(words))})
    tri = sorted({bi[int(rng.integers(len(bi)))] + (str(rng.choice(words)),)
                  for _ in range(2 * len(words))})
    lines = ["\\data\\", f"ngram 1={len(words) + 2}", f"ngram 2={len(bi)}",
             f"ngram 3={len(tri)}", "", "\\1-grams:", "-99\t<s>\t-0.3",
             "-3.5\t<unk>\t0"]
    lines += [f"{rng.uniform(-5, -1):.4f}\t{w}\t{rng.uniform(-1, 0):.4f}"
              for w in words]
    lines += ["", "\\2-grams:"] + [
        f"{rng.uniform(-3, -0.2):.4f}\t{a} {b}\t{rng.uniform(-0.6, 0):.4f}"
        for a, b in bi]
    lines += ["", "\\3-grams:"] + [f"{rng.uniform(-2, -0.1):.4f}\t"
                                   f"{' '.join(g)}" for g in tri]
    return "\n".join(lines + ["", "\\end\\", ""]), words, bi, tri


def test_lookups_on_a_larger_lm_match_jax_and_host(tmp_path):
    """2,000 queries, half of them n-grams the LM holds (exact hits at every
    level), the rest random contexts and OOV words, against the JAX
    package's vmapped lm_score_word and BinaryLM.score_word; the char-trie
    walk of every node and char against the JAX package's."""
    rng = np.random.default_rng(3)
    text, words, bi, tri = _random_arpa(rng)
    path = tmp_path / "lm.arpa"
    path.write_text(text)
    labels = "_ABCDEFGHIJKLMNOPQRSTUVWXYZ "
    dev = lm_device.load_device_lm(str(path), labels, "cpu")
    jdev = jax_lm_device.load_device_lm(str(path), labels)
    blm = load_lm(str(path))
    dslm = str(tmp_path / "lm.dslm")
    convert_arpa(str(path), dslm)
    host = BinaryLM(dslm)
    pool = words + ["<s>", "ZZZZZ"]
    queries = [((g[0], g[1]), g[2]) for g in tri[:500]]
    queries += [((g[0],), g[1]) for g in bi[:300]]
    n_hits = len(queries)
    queries += [((str(rng.choice(pool)), str(rng.choice(pool))),
                 str(rng.choice(pool))) for _ in range(1200)]
    order = blm.order
    ctx, clen = zip(*(_ctx_ids(host.vocab, c, order) for c, _ in queries))
    wi = np.asarray([host._wid.get(w, -1) for _, w in queries], np.int32)
    ctx, clen = np.stack(ctx), np.asarray(clen, np.int32)
    got = lm_device.lm_score_word(dev, torch.from_numpy(ctx),
                                  torch.from_numpy(clen),
                                  torch.from_numpy(wi)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(
        lambda c, n, w: jax_lm_device.lm_score_word(jdev, c, n, w)))(
            jnp.asarray(ctx), jnp.asarray(clen), jnp.asarray(wi)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    want = np.asarray([host.score_word(c, w) for c, w in queries])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    exact = np.asarray([blm.ngrams[tuple(c) + (w,)][0]
                        for c, w in queries[:n_hits]])
    np.testing.assert_allclose(got[:n_hits], exact, atol=1e-6)  # all hits
    assert not np.isnan(got).any()
    host.close()

    n_nodes = dev["trie_node_word"].shape[0]
    nodes = np.repeat(np.arange(-1, n_nodes, dtype=np.int32), len(labels))
    chars = np.tile(np.arange(len(labels), dtype=np.int32), n_nodes + 1)
    adv = lm_device.trie_advance(dev, torch.from_numpy(nodes),
                                 torch.from_numpy(chars)).numpy()
    jadv = np.asarray(jax.jit(jax.vmap(
        lambda n, c: jax_lm_device.trie_advance(jdev, n, c)))(
            jnp.asarray(nodes), jnp.asarray(chars)))
    np.testing.assert_array_equal(adv, jadv)
    assert (adv > 0).sum() == n_nodes - 1  # every node but the root reached
