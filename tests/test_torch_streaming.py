"""PyTorch port: the DS2 streaming runtime (``serve/streaming.py``) against
the JAX package's ``StreamingTranscriber`` and the port's batch forward.

A unidirectional DS2 (H 32, 2 layers, context 20) starts from a JAX init
with randomized BatchNorm statistics and reaches the port through
``convert.py``. Tolerances:

* the port's chunk logits against the JAX stream's, both on the CPU: the
  convs and the STFT run the same f32 algorithm with sums in other orders,
  the precedent of tests/test_torch_model.py (rtol 1e-3 / atol 2e-3);
* ``frozen_norm`` against the port's own batch forward of the utterance
  (featurize -> model): the same ops over the same operands but for the
  window's conv and the chunk STFT's framing, atol 2e-4 + rtol 2e-4, the
  JAX package's own streaming-vs-batch tolerance (tests/test_streaming.py);
* chunk-size invariance, 2e-4 likewise;
* the streamed beam (and the LM-fused beam) text equals the port's
  one-shot device beam over the batch logits exactly.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeech_tpu.audio import AudioConf as JaxAudioConf
from deepspeech_tpu.models import DeepSpeech2 as JaxDeepSpeech2
from deepspeech_tpu.serve import StreamingTranscriber as JaxStreaming
from deepspeech_tpu.text import Labels as JaxLabels
from deepspeech_tpu_torch.audio.features import AudioConf, featurize_batch
from deepspeech_tpu_torch.convert import jax_to_torch
from deepspeech_tpu_torch.models import build_model
from deepspeech_tpu_torch.serve import StreamingTranscriber
from deepspeech_tpu_torch.text.labels import Labels

torch.set_num_threads(2)

LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 "
HIDDEN, LAYERS = 32, 2
JAX_TOL = dict(rtol=1e-3, atol=2e-3)
BATCH_TOL = dict(rtol=2e-4, atol=2e-4)


def audio(seconds=2.3, seed=0):
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


@functools.cache
def jax_model(cell="gru", seed=0):
    """A unidirectional JAX DS2 and its variables (random BN stats)."""
    model = JaxDeepSpeech2(num_classes=len(LABELS), hidden_size=HIDDEN,
                           hidden_layers=LAYERS, cell=cell,
                           bidirectional=False)
    variables = jax.jit(model.init, static_argnums=3)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 161, 51)), jnp.asarray([51]),
        False)
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
        np.float32), variables["batch_stats"])
    params = jax.tree.map(np.asarray, variables["params"])
    return model, {"params": params, "batch_stats": stats}


def port_model(cell="gru", seed=0):
    _, variables = jax_model(cell, seed)
    model, _ = build_model(cell, len(LABELS), HIDDEN, LAYERS,
                           bidirectional=False, device="cpu")
    model.load_state_dict(jax_to_torch(variables["params"],
                                       variables["batch_stats"]))
    return model.eval()


def batch_logits(model, y, normalize):
    with torch.no_grad():
        spect, lens = featurize_batch(torch.from_numpy(y[None]),
                                      torch.tensor([len(y)]), AudioConf(),
                                      normalize)
        logits, _, out_lens = model(spect, lens)
    n = int(out_lens[0])
    return logits[0, :n].numpy(), n


def stream(model, y, chunk_frames, feeds=None, **kw):
    st = StreamingTranscriber(model, Labels(LABELS), AudioConf(),
                              chunk_frames=chunk_frames, **kw)
    pos = 0
    for size in feeds or [len(y)]:
        st.feed(y[pos:pos + size])
        pos += size
    st.finish()
    return st


@pytest.mark.parametrize("normalize", ["none", "max_frame"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_chunk_logits_match_jax(cell, normalize):
    """The same chunks through both runtimes: every emitted logit, the
    running normalization included, and the greedy text."""
    y = audio(seed=1)
    jm, variables = jax_model(cell)
    ref = JaxStreaming(jm, variables, JaxLabels(LABELS), JaxAudioConf(),
                       normalize=normalize, chunk_frames=40)
    ref.feed(y)
    ref.finish()
    got = stream(port_model(cell), y, 40, normalize=normalize)
    r, g = ref.collected_logits(), got.collected_logits()
    assert g.shape == r.shape
    np.testing.assert_allclose(g, r, **JAX_TOL)
    assert got.texts == ref.texts


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_frozen_norm_matches_batch_forward(cell):
    """Pinned normalization scalars: the stream's logits and text are the
    port's batch forward's."""
    model = port_model(cell)
    y = audio(seconds=1.7, seed=3)
    ref, t_out = batch_logits(model, y, "max_frame")
    from deepspeech_tpu_torch.audio.features import audio_to_stft_np
    lg = np.log1p(np.abs(audio_to_stft_np(y, AudioConf())) * 1048576.0)
    st = stream(model, y, 64, normalize="max_frame",
                frozen_norm=(np.array([lg.mean()], np.float32),
                             np.array([1.0], np.float32)))
    got = st.collected_logits()[0]
    assert got.shape[0] == t_out
    np.testing.assert_allclose(got, ref, **BATCH_TOL)
    from deepspeech_tpu_torch.decoders import GreedyDecoder
    dec = GreedyDecoder(LABELS, blank_index=0)
    assert st.texts[0] == dec.decode_ids(ref.argmax(-1)[None],
                                         [t_out])[0][0][0]


def test_chunk_size_invariance():
    """The emitted logits do not depend on the chunk size or on how the
    audio is cut into feeds."""
    model = port_model()
    y = audio(seconds=1.1, seed=11)
    a = stream(model, y, 40, normalize="none").collected_logits()
    feeds = [1000] * (len(y) // 1000) + [len(y) % 1000]
    b = stream(model, y, 16, feeds, normalize="none").collected_logits()
    np.testing.assert_allclose(a, b, **BATCH_TOL)


def _one_shot(model, y, **kw):
    from deepspeech_tpu_torch.decoders.beam_device import \
        ctc_beam_search_device
    logits, t_out = batch_logits(model, y, "none")
    lp = torch.log_softmax(torch.from_numpy(logits)[None], -1)
    prefixes, lens, _, _ = ctc_beam_search_device(
        lp, torch.tensor([t_out]), beam_width=8, blank=0, **kw)
    return "".join(LABELS[int(x)] for x in prefixes[0, 0, :int(lens[0, 0])])


def test_beam_matches_one_shot():
    model = port_model()
    y = audio(seconds=1.2, seed=21)
    st = stream(model, y, 32, normalize="none", decoder="beam",
                beam_width=8)
    assert st.beam_texts()[0][0] == _one_shot(model, y)


def test_lm_beam_matches_one_shot(tmp_path):
    """The LM-fused streaming beam equals the one-shot LM-fused device
    beam, and the LM moves the scores."""
    from deepspeech_tpu_torch.decoders.beam_device import beam_state_best
    from deepspeech_tpu_torch.decoders.lm_device import load_device_lm
    from tests.test_beam import ARPA
    p = tmp_path / "t.arpa"
    p.write_text(ARPA.replace("AB", "HI").replace("BA", "ME"))
    model = port_model()
    y = audio(seconds=1.2, seed=33)
    lm = load_device_lm(str(p), LABELS, "cpu")
    ref = _one_shot(model, y, lm=lm, space=LABELS.index(" "), alpha=1.2,
                    beta=0.4)
    st = stream(model, y, 32, normalize="none", decoder="beam",
                beam_width=8, lm_path=str(p), lm_alpha=1.2, lm_beta=0.4)
    assert st.beam_texts()[0][0] == ref
    plain = stream(model, y, 32, normalize="none", decoder="beam",
                   beam_width=8)
    _, _, _, fused = beam_state_best(st._beam_state, 4, lm=st.lm,
                                     space=st._lm_space, alpha=1.2, beta=0.4)
    _, _, _, unfused = beam_state_best(plain._beam_state, 4)
    assert not torch.allclose(fused, unfused)


def test_refuses_bidirectional_and_cnn():
    model, _ = build_model("gru", len(LABELS), HIDDEN, 1, device="cpu")
    with pytest.raises(ValueError, match="unidirectional"):
        StreamingTranscriber(model, Labels(LABELS))
    cnn, _ = build_model("cnn", len(LABELS), 16, 1, cnn_width=8,
                         device="cpu")
    with pytest.raises(ValueError, match="CNNStreamingTranscriber"):
        StreamingTranscriber(cnn, Labels(LABELS))
