"""PyTorch port: CNN streaming (``serve/streaming_cnn.py``) against the JAX
package's ``CNNStreamingTranscriber`` and the port's batch forward.

Weights come from a JAX init through ``convert.py``. The port's stream is
held to the JAX stream on the same audio at atol 2e-4 + rtol 2e-4 (f32
convs and STFTs with sums in other orders; the JAX package's own
streaming tolerance), for ``se_mode="running"`` (a stack without SE, a
stride-1 GLU stack and a squeeze-excitation stack) and ``"two_pass"``;
``two_pass`` is also held to the port's batch forward at 1e-5 (the same
function on the same operands), and ``"error"`` refuses SE stacks with the
JAX message. The wide Jasper stack runs on a cut table (its prolog, one
SE + skip group and the dilated epilog at width 24).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeech_tpu.audio import AudioConf as JaxAudioConf
from deepspeech_tpu.models import cnn as jax_cnn
from deepspeech_tpu.serve import CNNStreamingTranscriber as JaxCNNStreaming
from deepspeech_tpu.text import Labels as JaxLabels
from deepspeech_tpu_torch.audio.features import AudioConf, featurize_batch
from deepspeech_tpu_torch.convert import jax_to_torch
from deepspeech_tpu_torch.models import cnn
from deepspeech_tpu_torch.models.cnn import conv1d_out_length
from deepspeech_tpu_torch.serve import CNNStreamingTranscriber
from deepspeech_tpu_torch.serve.streaming_cnn import conv_stack_geometry
from deepspeech_tpu_torch.text.labels import Labels

torch.set_num_threads(2)

LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 "
TOL = dict(rtol=2e-4, atol=2e-4)


def audio(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


def specs(name):
    if name == "cnn":
        return jax_cnn.wav2letter_blocks(48, 32, 1, 13, False, 0.0, 0.1)
    if name == "glu_small":
        return jax_cnn.glu_blocks(jax_cnn._SMALL_GLU, 3, 0.0, 0.1)
    if name == "cnn_residual":
        return jax_cnn.residual_wav2letter_blocks(32, 24, 2, 0.0, 0.1)
    if name == "cnn_jasper":
        table = jax_cnn.jasper_blocks(0.0, 0.0)
        return [dict(table[i], out=min(table[i]["out"], 24), dropout=0.0)
                for i in (0, 1, 2, 3, 16, 17)]
    raise KeyError(name)


@functools.cache
def models(name, seed=0):
    """(JAX ConvStack, its variables with random BN stats, port model)."""
    jm = jax_cnn.ConvStack(blocks=tuple(specs(name)), num_classes=30)
    variables = jax.jit(jm.init, static_argnums=3)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 161, 51)), jnp.asarray([51]),
        False)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
        np.float32), variables["batch_stats"])
    port = cnn.ConvStack(specs(name), 30)
    port.load_state_dict(jax_to_torch(params, stats))
    return jm, {"params": params, "batch_stats": stats}, port.eval()


def run_both(name, y, chunk_frames, **kw):
    jm, variables, port = models(name)
    ref = JaxCNNStreaming(jm, variables, JaxLabels(LABELS),
                          audio_conf=JaxAudioConf(), normalize="none",
                          chunk_frames=chunk_frames, **kw)
    ref.feed(y)
    ref.finish()
    got = CNNStreamingTranscriber(port, Labels(LABELS), AudioConf(),
                                  normalize="none", chunk_frames=chunk_frames,
                                  **kw)
    got.feed(y)
    got.finish()
    return ref, got


def batch_logits(port, y):
    with torch.no_grad():
        spect, lens = featurize_batch(torch.from_numpy(y[None]),
                                      torch.tensor([len(y)]), AudioConf(),
                                      "none")
        logits, _, out_lens = port(spect, lens)
    n = int(out_lens[0])
    return logits[0, :n].numpy(), n


@pytest.mark.parametrize("name,chunk_frames", [
    ("cnn", 40), ("cnn", 96), ("glu_small", 50), ("cnn_residual", 48),
    ("cnn_jasper", 48)])
def test_running_matches_jax(name, chunk_frames):
    y = audio(1.7, 5)
    ref, got = run_both(name, y, chunk_frames)
    r, g = ref.collected_logits(), got.collected_logits()
    assert g.shape == r.shape
    np.testing.assert_allclose(g, r, **TOL)
    assert got.texts == ref.texts
    # running SE counts: every valid frame of each SE layer, exactly once
    n = 1 + len(y) // AudioConf().hop
    for i, spec in enumerate(got.model.specs):
        n = conv1d_out_length(n, spec["kernel"], spec.get("stride", 1),
                              spec.get("padding", 0), spec.get("dilation", 1))
        if f"se_cnt{i}" in got._carry:
            assert int(got._carry[f"se_cnt{i}"][0]) == n


def test_no_se_stream_matches_batch():
    """Without SE the stream emits the batch forward's logits."""
    y = audio(2.3, 0)
    _, _, port = models("cnn")
    ref, t_out = batch_logits(port, y)
    _, got = run_both("cnn", y, 40)
    np.testing.assert_allclose(got.collected_logits()[0], ref, **TOL)
    assert got.collected_logits().shape[1] == t_out


@pytest.mark.parametrize("name", ["cnn_residual", "cnn_jasper"])
def test_two_pass_matches_jax_and_batch(name):
    y = audio(1.3, 9)
    ref, got = run_both(name, y, 48, se_mode="two_pass")
    _, _, port = models(name)
    want, t_out = batch_logits(port, y)
    g = got.collected_logits()[0]
    assert g.shape[0] == t_out
    np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g, ref.collected_logits()[0], **TOL)
    assert got.texts == ref.texts


def test_two_pass_beam_matches_one_shot():
    """two_pass with the beam: after finish, beam_texts are the one-shot
    device beam's over the batch posteriors."""
    from deepspeech_tpu_torch.decoders import DeviceBeamCTCDecoder
    _, _, port = models("cnn_residual")
    y = audio(1.3, 13)
    st = CNNStreamingTranscriber(port, Labels(LABELS), AudioConf(),
                                 normalize="none", chunk_frames=48,
                                 se_mode="two_pass", decoder="beam",
                                 beam_width=6)
    st.feed(y)
    st.finish()
    logits, t_out = batch_logits(port, y)
    dec = DeviceBeamCTCDecoder(LABELS, beam_width=6, top_paths=2,
                               device="cpu")
    want, _ = dec.decode(torch.softmax(torch.from_numpy(logits)[None], -1),
                         torch.tensor([t_out]))
    assert st.beam_texts(top_paths=2)[0] == list(want[0])


def test_stream_beam_matches_one_shot():
    """The streaming beam over a CNN stack equals the one-shot device beam
    over the streamed logits."""
    from deepspeech_tpu_torch.decoders.beam_device import \
        ctc_beam_search_device
    _, _, port = models("cnn")
    y = audio(1.2, 21)
    st = CNNStreamingTranscriber(port, Labels(LABELS), AudioConf(),
                                 normalize="none", chunk_frames=40,
                                 decoder="beam", beam_width=8)
    st.feed(y)
    st.finish()
    streamed = torch.from_numpy(st.collected_logits())
    prefixes, lens, _, _ = ctc_beam_search_device(
        torch.log_softmax(streamed, -1), torch.tensor([streamed.shape[1]]),
        beam_width=8, blank=0)
    text = "".join(LABELS[int(x)] for x in prefixes[0, 0, :int(lens[0, 0])])
    assert st.beam_texts()[0][0] == text


def test_error_mode_and_family_checks():
    jm, variables, port = models("cnn_residual")
    with pytest.raises(ValueError, match="squeeze-excitation") as ref:
        JaxCNNStreaming(jm, variables, JaxLabels(LABELS), se_mode="error")
    with pytest.raises(ValueError, match="squeeze-excitation") as got:
        CNNStreamingTranscriber(port, Labels(LABELS), se_mode="error")
    assert str(got.value) == str(ref.value)
    # a stack without SE streams under "error"
    CNNStreamingTranscriber(models("cnn")[2], Labels(LABELS),
                            se_mode="error")
    from deepspeech_tpu_torch.models import build_model
    ds2, _ = build_model("gru", 30, 16, 1, bidirectional=False,
                         device="cpu")
    with pytest.raises(ValueError, match="StreamingTranscriber"):
        CNNStreamingTranscriber(ds2, Labels(LABELS))


def test_geometry_fold_matches_jax():
    from deepspeech_tpu.serve.streaming_cnn import \
        conv_stack_geometry as jax_geometry
    for name in ("cnn", "glu_small", "cnn_residual", "cnn_jasper"):
        assert conv_stack_geometry(specs(name)) == jax_geometry(specs(name))
    for variant in ("glu_large", "large_cnn", "cnn_jasper"):
        table = cnn.cnn_blocks(variant)
        assert conv_stack_geometry(table) == jax_geometry(table)
