"""PyTorch port: the device beam search against the JAX package's.

``ctc_beam_search_device`` of the port (batched over utterances, K10's
plain version as its top-k on the CPU) against the JAX package's (a
``lax.scan`` vmapped over utterances, ``lax.top_k``) on the same log
posteriors: B 3 with padded lengths, T 40-60, C 30, widths 4/8/16,
``top_paths`` 1 and 3, ``cutoff_top_n`` / ``cutoff_prob`` pruning, with and
without a word LM. Prefixes, lengths and offsets must be equal; scores
within 1e-4 relative (the two frameworks' exp/log differ in the last
bits). The chunked streaming continuation must equal the one-shot search
exactly, and the JAX package's continuation; the decoder class must give
the JAX decoder's strings and offsets.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeech_tpu.decoders import beam_device as jax_beam
from deepspeech_tpu.decoders import lm_device as jax_lm_device
from deepspeech_tpu_torch.decoders import beam_device, lm_device
from tests.test_beam import ARPA
from tests.test_lm_device import TRIGRAM_ARPA

torch.set_num_threads(2)

LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 "
SPACE = LABELS.index(" ")
# the JAX tests' LMs with their words spelled in this alphabet
WORDS = {"AB": "HI", "BA": "ME"}


def _arpa(text):
    for a, b in WORDS.items():
        text = text.replace(a, b)
    return text


def _log_probs(seed, b=3, t=50, c=len(LABELS)):
    """Peaked log posteriors that favour blank, space and the LM's words'
    letters, so that the search meets word boundaries and LM words."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, c)) * 2.5
    for ch in "_ HIME":
        logits[..., LABELS.index(ch)] += 1.5
    return np.array(jax.nn.log_softmax(jnp.asarray(logits, jnp.float32),
                                       -1))


def _lms(tmp_path, kind):
    if kind is None:
        return None, None
    p = tmp_path / f"{kind}.arpa"
    p.write_text(_arpa(ARPA if kind == "bigram" else TRIGRAM_ARPA))
    return (lm_device.load_device_lm(str(p), LABELS, "cpu"),
            jax_lm_device.load_device_lm(str(p), LABELS))


def _assert_search_equal(got, ref):
    gp, gl, go, gs = (x.numpy() for x in got)
    rp, rl, ro, rs = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(gl, rl)
    np.testing.assert_array_equal(gp, rp)
    np.testing.assert_array_equal(go, ro)
    np.testing.assert_allclose(gs, rs, rtol=1e-4)


@pytest.mark.parametrize("width,top_paths,cutoff_top_n,cutoff_prob,lm", [
    (4, 1, 40, 1.0, None),
    (8, 3, 40, 1.0, None),
    (16, 3, 40, 1.0, None),
    (8, 1, 5, 1.0, None),
    (16, 3, 40, 0.95, None),
    (4, 3, 40, 1.0, "bigram"),
    (8, 1, 40, 1.0, "trigram"),
    (16, 3, 12, 0.99, "trigram"),
])
def test_matches_jax(tmp_path, width, top_paths, cutoff_top_n, cutoff_prob,
                     lm):
    t = 40 + width + 2 * top_paths
    lp = _log_probs(width * 10 + top_paths + (lm is not None), t=t)
    lengths = np.array([t, t - 9, t - 23], np.int32)
    lp[1, t - 9:] = np.nan  # past its length a row's values are never read
    tlm, jlm = _lms(tmp_path, lm)
    kw = dict(beam_width=width, top_paths=top_paths,
              cutoff_top_n=cutoff_top_n, cutoff_prob=cutoff_prob,
              space=SPACE if lm else -1, alpha=1.3, beta=0.6)
    got = beam_device.ctc_beam_search_device(
        torch.from_numpy(lp), torch.from_numpy(lengths), lm=tlm, **kw)
    ref = jax_beam.ctc_beam_search_device(
        jnp.asarray(lp), jnp.asarray(lengths), lm=jlm, **kw)
    _assert_search_equal(got, ref)
    lens = got[1].numpy()
    assert (lens[:, 0] > 0).all()
    prefixes = got[0].numpy()
    for b in range(3):  # -1 past each length
        assert (prefixes[b, 0, lens[b, 0]:] == -1).all()
    if lm is not None:  # the LM changed something
        plain = beam_device.ctc_beam_search_device(
            torch.from_numpy(lp), torch.from_numpy(lengths),
            **{**kw, "space": -1})
        assert not torch.equal(plain[3], got[3])


def test_max_len_and_short_rows():
    lp = _log_probs(3, b=2, t=30)
    lengths = np.array([30, 1], np.int32)
    kw = dict(beam_width=6, top_paths=2, max_len=5)
    got = beam_device.ctc_beam_search_device(
        torch.from_numpy(lp), torch.from_numpy(lengths), **kw)
    ref = jax_beam.ctc_beam_search_device(jnp.asarray(lp),
                                          jnp.asarray(lengths), **kw)
    _assert_search_equal(got, ref)
    assert got[0].shape == (2, 2, 5)


@pytest.mark.parametrize("lm", [None, "trigram"])
def test_streaming_chunks_equal_one_shot(tmp_path, lm):
    """ctc_beam_continue over uneven chunks + beam_state_best == the
    one-shot search, bit for bit, and == the JAX package's continuation."""
    b, t, k = 3, 45, 8
    rng = np.random.default_rng(9)
    logits = (rng.standard_normal((b, t, len(LABELS))) * 2.5).astype(
        np.float32)
    lengths = np.array([45, 37, 20], np.int32)
    tlm, jlm = _lms(tmp_path, lm)
    kw = dict(lm=tlm, space=SPACE if lm else -1, alpha=1.1, beta=0.3)
    jkw = {**kw, "lm": jlm}
    ts = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    valid = ts < lengths[:, None]
    state = beam_device.beam_state_init(b, k, t, lm=tlm, device="cpu")
    jstate = jax_beam.beam_state_init(b, k, t, lm=jlm)
    for lo, hi in ((0, 7), (7, 26), (26, 45)):
        state = beam_device.ctc_beam_continue(
            state, torch.from_numpy(logits[:, lo:hi]),
            torch.from_numpy(ts[:, lo:hi].copy()),
            torch.from_numpy(valid[:, lo:hi].copy()), **kw)
        jstate = jax_beam.ctc_beam_continue(
            jstate, jnp.asarray(logits[:, lo:hi]), jnp.asarray(ts[:, lo:hi]),
            jnp.asarray(valid[:, lo:hi]), **jkw)
    best = beam_device.beam_state_best(state, 3, **kw)
    one_shot = beam_device.ctc_beam_search_device(
        torch.log_softmax(torch.from_numpy(logits), -1),
        torch.from_numpy(lengths), beam_width=k, top_paths=3, **kw)
    for got, ref in zip(best, one_shot):
        assert torch.equal(got, ref)
    _assert_search_equal(best, jax_beam.beam_state_best(jstate, 3, **jkw))


@pytest.mark.parametrize("lm", [None, "bigram"])
def test_decoder_class_matches_jax(tmp_path, lm):
    path = None
    if lm is not None:
        path = str(tmp_path / "lm.arpa")
        with open(path, "w") as f:
            f.write(_arpa(ARPA))
    probs = np.exp(_log_probs(21, t=44)).astype(np.float64)
    sizes = np.array([44, 30, 12])
    kw = dict(beam_width=10, top_paths=2, lm_path=path, alpha=1.0, beta=0.5)
    got = beam_device.DeviceBeamCTCDecoder(LABELS, device="cpu",
                                           **kw).decode(probs, sizes)
    ref = jax_beam.DeviceBeamCTCDecoder(LABELS, **kw).decode(probs, sizes)
    assert got[0] == ref[0]
    for g, r in zip(got[1], ref[1]):
        for a, c in zip(g, r):
            np.testing.assert_array_equal(a, c)
    assert any(s[0] for s in got[0])


def test_hash_arithmetic_is_int32():
    """The merge needs every hash op to wrap mod 2^32 and >> to be an
    arithmetic shift."""
    h = torch.tensor([1, -7, 2**31 - 1], dtype=torch.int32)
    rolled = h * beam_device._HASH_M1 + 5
    assert rolled.dtype == torch.int32
    back = (rolled - 5) * beam_device._HASH_M1_INV
    assert torch.equal(back, h)
    back2 = ((h * beam_device._HASH_M2 + 5) - 5) * beam_device._HASH_M2_INV
    assert torch.equal(back2, h)
    assert (torch.tensor([-8], dtype=torch.int32) >> 1).item() == -4
    state = beam_device.beam_state_init(2, 4, 9, device="cpu")
    assert all(x.dtype == torch.int32 for x in state[:5])


def test_too_many_classes_raise():
    lp = torch.zeros(1, 3, 65)
    with pytest.raises(ValueError, match="64 classes"):
        beam_device.ctc_beam_search_device(lp, torch.tensor([3]))
    state = beam_device.beam_state_init(1, 2, 3, device="cpu")
    with pytest.raises(ValueError, match="64 classes"):
        beam_device.ctc_beam_continue(state, lp, torch.zeros(1, 3),
                                      torch.ones(1, 3, dtype=torch.bool))
