"""PyTorch port: the KenLM binary readers and where they feed, against the
JAX package.

Fixture binaries come from the JAX tests' own writers
(``tests/test_lm_kenlm.py:write_probing_binary``,
``tests/test_lm_trie.py:write_trie_binary``) over the bigram, trigram and
gappy ARPAs, plain and quantized (5 prob bits, 4 backoff bits).

* ``KenLMProbing`` and ``KenLMTrie``: headers, ``score_word`` over every
  context and word of the fixture (and OOV), ``score_sentence``,
  ``iter_ngrams`` and ``dump_arpa`` equal the JAX readers' exactly (the
  same arithmetic in both packages); the trie-type probing file, the
  Bhiksha and fake-quantized tries and a corrupt terminator are refused
  with the JAX messages.
* ``load_lm`` dispatches both formats; the host beam (the Python search,
  where ``auto`` sends a binary) gives the JAX strings and offsets.
* ``load_device_lm`` on a trie binary equals the JAX arrays exactly; a
  probing binary raises with the JAX message, which ``build_decoder``
  turns into the JAX hint; the device beam over the trie gives the JAX
  ``DeviceBeamCTCDecoder``'s texts and those of the DSLM of the source
  ARPA.
"""

import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deepspeech_tpu.decoders import lm_device as jax_lm_device
from deepspeech_tpu.decoders.beam import BeamCTCDecoder as JaxBeamDecoder
from deepspeech_tpu.decoders.beam_device import \
    DeviceBeamCTCDecoder as JaxDeviceBeam
from deepspeech_tpu.decoders.lm import ArpaLM as JaxArpaLM
from deepspeech_tpu.decoders.lm_kenlm import KenLMProbing as JaxProbing
from deepspeech_tpu.decoders.lm_trie import KenLMTrie as JaxTrie
from deepspeech_tpu_torch.cli.common import build_decoder
from deepspeech_tpu_torch.decoders import lm_device
from deepspeech_tpu_torch.decoders.beam import BeamCTCDecoder
from deepspeech_tpu_torch.decoders.beam_device import DeviceBeamCTCDecoder
from deepspeech_tpu_torch.decoders.lm import KENLM_MAGIC, load_lm
from deepspeech_tpu_torch.decoders.lm_binary import convert_arpa
from deepspeech_tpu_torch.decoders.lm_kenlm import (_FIXED_PARAMS_SIZE, MAGIC,
                                                    KenLMProbing, is_kenlm,
                                                    murmur_hash64a,
                                                    ngram_hash, sanity_size)
from deepspeech_tpu_torch.decoders.lm_trie import (KenLMTrie, is_kenlm_trie,
                                                   kenlm_model_type)
from deepspeech_tpu_torch.text.labels import Labels
from tests.test_beam import ARPA
from tests.test_lm_device import TRIGRAM_ARPA
from tests.test_lm_kenlm import write_probing_binary
from tests.test_lm_trie import GAPPY_ARPA, _align8, write_trie_binary

ARPAS = {"bigram": ARPA, "trigram": TRIGRAM_ARPA, "gappy": GAPPY_ARPA}
LABELS = "_AB "


def _arpa(tmp_path, name):
    p = tmp_path / f"{name}.arpa"
    p.write_text(ARPAS[name])
    return str(p)


@pytest.fixture(params=["bigram", "trigram"])
def probing(request, tmp_path):
    arpa = _arpa(tmp_path, request.param)
    binp = str(tmp_path / "lm.binary")
    write_probing_binary(binp, JaxArpaLM(arpa))
    return arpa, binp


@pytest.fixture(params=["bigram", "trigram", "gappy", "trigram-q",
                        "gappy-q"])
def trie(request, tmp_path):
    name = request.param.removesuffix("-q")
    arpa = _arpa(tmp_path, name)
    binp = str(tmp_path / "lm.trie.binary")
    quant = (5, 4) if request.param.endswith("-q") else None
    write_trie_binary(binp, JaxArpaLM(arpa), quant=quant)
    return arpa, binp, 2 if quant is None else 3


def _queries(arpa: str):
    ref = JaxArpaLM(arpa)
    words = sorted({w for g in ref.ngrams for w in g}) + ["ZZZUNSEEN"]
    ctxs = [()] + [(w,) for w in words]
    if ref.order > 2:
        ctxs += [(a, b) for a in words for b in words]
    return [(c, w) for c in ctxs for w in words]


def test_magic_is_one_definition():
    assert KENLM_MAGIC is MAGIC


def test_hashes_match_jax():
    from deepspeech_tpu.decoders import lm_kenlm as jax_kenlm
    for s in (b"", b"a", b"12345678", b"123456789", b"<unk>", b"ABBA" * 5):
        assert murmur_hash64a(s) == jax_kenlm.murmur_hash64a(s)
    for ids in ([3], [1, 2], [7, 1, 2], [2**20, 5, 9]):
        assert ngram_hash(ids) == jax_kenlm.ngram_hash(ids)


def test_probing_matches_jax(probing):
    arpa, binp = probing
    lm, ref = KenLMProbing(binp), JaxProbing(binp)
    assert is_kenlm(binp) and not is_kenlm(arpa)
    assert kenlm_model_type(binp) == 0 and not is_kenlm_trie(binp)
    assert (lm.order, lm.counts, lm.vocab_size) == (ref.order, ref.counts,
                                                    ref.vocab_size)
    for ctx, w in _queries(arpa):
        assert lm.score_word(ctx, w) == ref.score_word(ctx, w), (ctx, w)
        assert lm.score_word(ctx, w) == pytest.approx(
            JaxArpaLM(arpa).score_word(ctx, w) if w != "ZZZUNSEEN" else
            JaxArpaLM(arpa).score_word(ctx, "<unk>"), abs=1e-5)
    s = ["AB", "AB", "BA", "ZZZUNSEEN"]
    assert lm.score_sentence(s) == ref.score_sentence(s)
    assert isinstance(load_lm(binp), KenLMProbing)
    lm.close()
    ref.close()


def test_probing_refuses_a_trie_type(probing, tmp_path):
    _, binp = probing
    data = bytearray(open(binp, "rb").read())
    struct.pack_into("<i", data, sanity_size() + 8, 1)
    p = tmp_path / "t1.binary"
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="trie"):
        KenLMProbing(str(p))


def test_trie_matches_jax(trie):
    arpa, binp, model_type = trie
    lm, ref = KenLMTrie(binp), JaxTrie(binp)
    assert is_kenlm_trie(binp)
    assert kenlm_model_type(binp) == model_type
    assert (lm.order, lm.counts) == (ref.order, ref.counts)
    for ctx, w in _queries(arpa):
        assert lm.score_word(ctx, w) == ref.score_word(ctx, w), (ctx, w)
    s = ["A", "B", "A", "ZZZUNSEEN"]
    assert lm.score_sentence(s) == ref.score_sentence(s)
    assert list(lm.iter_ngrams()) == list(ref.iter_ngrams())
    assert isinstance(load_lm(binp), KenLMTrie)
    lm.close()
    ref.close()


def test_trie_dump_arpa_matches_jax(trie, tmp_path):
    _, binp, _ = trie
    ours, theirs = tmp_path / "ours.arpa", tmp_path / "theirs.arpa"
    lm, ref = KenLMTrie(binp), JaxTrie(binp)
    lm.dump_arpa(str(ours))
    ref.dump_arpa(str(theirs))
    assert ours.read_text() == theirs.read_text()
    lm.close()
    ref.close()


def _trie_bytes(tmp_path):
    arpa = _arpa(tmp_path, "trigram")
    binp = tmp_path / "t.binary"
    write_trie_binary(str(binp), JaxArpaLM(arpa))
    return bytearray(binp.read_bytes())


def test_bhiksha_and_fake_quant_refused(tmp_path):
    data = _trie_bytes(tmp_path)
    q = tmp_path / "q.binary"
    struct.pack_into("<i", data, sanity_size() + 8, 4)  # ARRAY_TRIE
    q.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="Bhiksha"):
        KenLMTrie(str(q))
    struct.pack_into("<i", data, sanity_size() + 8, 3)  # QUANT, no tables
    q.write_bytes(bytes(data))
    with pytest.raises(ValueError,
                       match="quantization version|implausible"):
        KenLMTrie(str(q))


def test_corrupt_terminator_refused(tmp_path):
    data = _trie_bytes(tmp_path)
    off = _align8(sanity_size() + _FIXED_PARAMS_SIZE + 8 * 3)
    n_vocab = struct.unpack_from("<Q", data, off)[0]
    term_off = off + 8 + 8 * n_vocab + 16 * (n_vocab + 1) + 8
    struct.pack_into("<Q", data, term_off, 9999)
    bad = tmp_path / "bad.binary"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="inconsistent|incompatible"):
        KenLMTrie(str(bad))
    with pytest.raises(ValueError, match="inconsistent|incompatible"):
        JaxTrie(str(bad))


def _probs(seed, b=3, t=12, c=len(LABELS)):
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.ones(c), size=(b, t))


@pytest.mark.parametrize("kind", ["probing", "trie"])
@pytest.mark.parametrize("name", ["bigram", "trigram"])
def test_host_beam_with_binary_matches_jax(tmp_path, kind, name):
    arpa = _arpa(tmp_path, name)
    binp = str(tmp_path / "lm.binary")
    (write_probing_binary if kind == "probing" else write_trie_binary)(
        binp, JaxArpaLM(arpa))
    probs = _probs(len(name))
    sizes = np.array([12, 9, 7])
    kw = dict(lm_path=binp, alpha=1.5, beta=0.5, beam_width=8, top_paths=2,
              num_processes=1)
    dec = BeamCTCDecoder(LABELS, **kw)
    assert dec.backend == "python"
    got = dec.decode(torch.from_numpy(probs), torch.from_numpy(sizes))
    want = JaxBeamDecoder(LABELS, backend="python", **kw).decode(probs,
                                                                 sizes)
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_device_lm_from_trie_matches_jax(trie):
    _, binp, _ = trie
    dev = lm_device.load_device_lm(binp, LABELS, "cpu")
    jdev = jax_lm_device.load_device_lm(binp, LABELS)
    assert set(jdev) <= set(dev)
    for k, v in jdev.items():
        got = dev[k]
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert np.array_equal(np.asarray(got), np.asarray(v)), k


def test_device_lm_refuses_probing_and_cli_hint(probing):
    _, binp = probing
    with pytest.raises(ValueError, match="probing binaries cannot feed"):
        lm_device.load_device_lm(binp, LABELS, "cpu")
    args = SimpleNamespace(decoder="device_beam", beam_width=4,
                           cutoff_top_n=40, cutoff_prob=1.0, top_paths=1,
                           lm_path=binp, alpha=0.8, beta=1.0, device="cpu")
    with pytest.raises(SystemExit, match="host-only; use --decoder beam"):
        build_decoder(args, Labels(LABELS))


@pytest.mark.parametrize("name", ["bigram", "trigram"])
def test_device_beam_over_trie_matches_jax_and_dslm(tmp_path, name):
    arpa = _arpa(tmp_path, name)
    binp = str(tmp_path / "lm.trie.binary")
    write_trie_binary(binp, JaxArpaLM(arpa))
    dslm = str(tmp_path / "lm.dslm")
    convert_arpa(arpa, dslm)
    probs = _probs(7 + len(name), t=20)
    sizes = np.array([20, 14, 9])
    kw = dict(beam_width=8, top_paths=2, alpha=1.0, beta=0.5)
    got = DeviceBeamCTCDecoder(LABELS, lm_path=binp, device="cpu",
                               **kw).decode(probs, sizes)
    want = JaxDeviceBeam(LABELS, lm_path=binp, **kw).decode(probs, sizes)
    via_dslm = DeviceBeamCTCDecoder(LABELS, lm_path=dslm, device="cpu",
                                    **kw).decode(probs, sizes)
    assert got[0] == want[0] == via_dslm[0]
    for g, w in zip(got[1], want[1]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
