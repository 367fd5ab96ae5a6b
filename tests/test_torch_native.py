"""PyTorch port: the host native library and what stands on it, against the
JAX package's pure-Python pieces.

Nothing here goes through ``deepspeech_tpu.native`` (the JAX loader builds
its library in place, unguarded across processes): the JAX references are
``_edit_distance_py``, ``get_cer_wer`` with the native library switched
off, ``audio/flac_encode.py``, the WAV readers and the pure-Python
``ctc_beam_search``.

* The port's loader: four processes loading it at once from an empty build
  directory all get a working library; a compile error raises with g++'s
  output.
* The native edit distance and ``batch_edit_distance`` equal the JAX numpy
  dynamic program and ``get_cer_wer`` exactly, empty strings included.
* ``encode_flac`` is a byte-for-byte copy of the JAX encoder (8/16/24-bit,
  mono and stereo, several block sizes), and the port's FLAC decoder
  returns exactly the encoded samples, for those files and for the
  ``tests/test_flac.py`` fixture kinds (verbatim, constant, fixed order-1
  Rice, stereo, an odd tail block; not-FLAC raises).
* ``load_audio_norm`` on a FLAC equals the JAX function on a WAV of the
  same samples within one float32 rounding (the FLAC path divides by
  2^(bits-1) first); ``load_audio`` differs by the scale 32767/32768, the
  WAV path dividing by the int16 maximum and the FLAC path by 2^15.
* The native beam search gives the JAX Python search's hypotheses and
  offsets exactly, its scores within 1e-12 (1e-10 with an LM), the JAX
  tests' own tolerances; ``backend="auto"`` resolves as the JAX rule does.
"""

import gzip
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from deepspeech_tpu.audio import flac_encode as jax_flac_encode
from deepspeech_tpu.audio.io import load_audio as jax_load_audio
from deepspeech_tpu.audio.io import load_audio_norm as jax_load_audio_norm
from deepspeech_tpu.decoders.beam import BeamCTCDecoder as JaxBeamDecoder
from deepspeech_tpu.decoders.beam import ctc_beam_search as jax_beam_search
from deepspeech_tpu.decoders.lm import ArpaLM as JaxArpaLM
from deepspeech_tpu_torch import native
from deepspeech_tpu_torch.audio import flac_encode
from deepspeech_tpu_torch.audio.io import (load_audio, load_audio_norm,
                                           read_flac)
from deepspeech_tpu_torch.decoders import beam_native
from deepspeech_tpu_torch.decoders.beam import BeamCTCDecoder
from deepspeech_tpu_torch.decoders.lm_binary import convert_arpa
from deepspeech_tpu_torch.metrics import (batch_edit_distance, edit_distance,
                                          get_cer_wer)
from tests.test_beam import ARPA
from tests.test_flac import BitWriter
from tests.test_flac import encode_flac as fixture_encode
from tests.test_lm_device import TRIGRAM_ARPA
from tests.test_lm_kenlm import write_probing_binary
from tests.test_lm_trie import write_trie_binary

# the module, not the function the package exports under the same name
jax_ed = importlib.import_module("deepspeech_tpu.metrics.edit_distance")

LABELS = "_AB "
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def jax_metrics_py(monkeypatch):
    """The JAX metrics with their native library switched off."""
    monkeypatch.setattr(jax_ed, "load_native", lambda: None)
    return jax_ed


# --- the loader ------------------------------------------------------------

_CHILD = """
import ctypes, sys
import numpy as np
from deepspeech_tpu_torch import native
lib = native.load_native(sys.argv[1])
a = np.array([3, 1, 4, 1, 5], np.uint32)
b = np.array([3, 4, 1, 6], np.uint32)
p = ctypes.POINTER(ctypes.c_uint32)
print(native.library_path(sys.argv[1]),
      lib.edit_distance_u32(a.ctypes.data_as(p), 5, b.ctypes.data_as(p), 4))
"""


def test_four_processes_load_the_library_at_once(tmp_path):
    """Four processes, started together, load the library from an empty
    build directory: each gets a complete, working library."""
    build_dir = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, build_dir],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    want = jax_ed._edit_distance_py(np.array([3, 1, 4, 1, 5], np.uint32),
                                    np.array([3, 4, 1, 6], np.uint32))
    lines = [out.split() for out, _ in outs]
    assert [int(d) for _, d in lines] == [want] * 4
    assert len({path for path, _ in lines}) == 1
    files = sorted(os.listdir(build_dir))
    assert [f for f in files if f.endswith(".so")] == [
        os.path.basename(lines[0][0])]
    assert not [f for f in files if f.endswith(".tmp")]


def test_compile_error_raises_with_gxx_output(tmp_path, monkeypatch):
    bad = tmp_path / "src"
    bad.mkdir()
    for name in native.SOURCES:
        (bad / name).write_text("int broken( {\n")
    monkeypatch.setattr(native, "_DIR", str(bad))
    native._source_hash.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
            native.load_native(str(tmp_path / "build"))
        assert "error: expected" in str(e.value)
    finally:
        native._source_hash.cache_clear()
    assert not [f for f in os.listdir(tmp_path / "build")
                if not f.endswith(".lock")]


def test_library_is_built_once_and_named_by_its_sources(tmp_path):
    d = str(tmp_path / "b")
    lib = native.load_native(d)
    assert native.load_native(d) is lib
    assert os.path.basename(native.library_path(d)).startswith(
        "libdeepspeech_native-")
    assert native.library_path(d) != native.library_path(str(tmp_path))


# --- edit distance ---------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_edit_distance_matches_jax_dp(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        a = rng.integers(0, 5, int(rng.integers(0, 30))).astype(np.uint32)
        b = rng.integers(0, 5, int(rng.integers(0, 30))).astype(np.uint32)
        assert edit_distance(a, b) == jax_ed._edit_distance_py(a, b)


STRINGS = [("", ""), ("", "a b"), ("a b", ""), ("hello world", "hello word"),
           ("the cat sat", "the cat sat"), ("  spaced  ", "spaced"),
           ("abc def ghi", "abd ef gh i"), ("ab ab ab", "ba ba"),
           ("unicode é ü", "unicode e u")]


@pytest.mark.parametrize("hyp,ref", STRINGS)
def test_get_cer_wer_matches_jax(jax_metrics_py, hyp, ref):
    assert get_cer_wer(hyp, ref) == jax_metrics_py.get_cer_wer(hyp, ref)


def test_batch_edit_distance_matches_jax(jax_metrics_py):
    rng = np.random.default_rng(9)
    seqs_a = [rng.integers(0, 7, int(n)) for n in rng.integers(0, 40, 50)]
    seqs_b = [rng.integers(0, 7, int(n)) for n in rng.integers(0, 40, 50)]
    seqs_a[3], seqs_b[7] = [], []
    got = batch_edit_distance(seqs_a, seqs_b)
    want = jax_metrics_py.batch_edit_distance(seqs_a, seqs_b)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, [jax_ed._edit_distance_py(np.asarray(a, np.uint32),
                                       np.asarray(b, np.uint32))
              for a, b in zip(seqs_a, seqs_b)])
    assert batch_edit_distance([[], []], [[], []]).tolist() == [0, 0]
    with pytest.raises(ValueError):
        batch_edit_distance([[1]], [])


# --- FLAC ------------------------------------------------------------------

FLAC_CASES = [((50_000,), 16, 4096), ((1_000, 2), 16, 256), ((700,), 24, 128),
              ((300,), 8, 64), ((900, 2), 24, 192), ((4_000,), 8, 1024)]


def _ints(shape, bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-(1 << (bits - 1)), (1 << (bits - 1)) - 1,
                     size=shape).astype(np.int64)
    x.reshape(-1)[:40] = 7  # a flat head: a constant subframe
    return x


@pytest.mark.parametrize("shape,bits,block", FLAC_CASES)
def test_encode_flac_bytes_match_jax_and_decode_exactly(tmp_path, shape, bits,
                                                        block):
    x = _ints(shape, bits, bits + block)
    got = flac_encode.encode_flac(x, 22050, bits=bits, block_size=block)
    assert got == jax_flac_encode.encode_flac(x, 22050, bits=bits,
                                              block_size=block)
    path = tmp_path / "t.flac"
    path.write_bytes(got)
    data, sr, b = read_flac(str(path))
    assert (sr, b) == (22050, bits) and data.dtype == np.int32
    np.testing.assert_array_equal(data.astype(np.int64).reshape(x.shape), x)


def test_save_flac_bytes_match_jax(tmp_path):
    y = (0.4 * np.sin(np.arange(16_000) / 7.0)).astype(np.float32)
    flac_encode.save_flac(str(tmp_path / "p.flac"), y, 16000)
    jax_flac_encode.save_flac(str(tmp_path / "j.flac"), y, 16000)
    assert ((tmp_path / "p.flac").read_bytes()
            == (tmp_path / "j.flac").read_bytes())


def _fixed_order1_rice(n=256):
    """tests/test_flac.py's fixed order-1 subframe with Rice residuals."""
    sig = np.cumsum(np.random.default_rng(0).integers(-40, 41, n)) \
        .astype(np.int32) + 5000
    out = bytearray(b"fLaC")
    si = BitWriter()
    for v, n_bits in ((n, 16), (n, 16), (0, 24), (0, 24), (16000, 20),
                      (0, 3), (15, 5), (n, 36)):
        si.write(v, n_bits)
    body = si.tobytes() + b"\x00" * 16
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body
    w = BitWriter()
    for v, n_bits in ((0x3FFE, 14), (0, 1), (0, 1), (7, 4), (0, 4), (0, 4),
                      (4, 3), (0, 1), (0, 8), (n - 1, 16), (0, 8), (0, 1),
                      (0b001001, 6), (0, 1)):
        w.write(v, n_bits)
    w.write_signed(int(sig[0]), 16)
    w.write(0, 2)
    w.write(0, 4)
    param = 7
    w.write(param, 4)
    for r in np.diff(sig):
        u = 2 * int(r) if r >= 0 else -2 * int(r) - 1
        w.write(0, u >> param)
        w.write(1, 1)
        w.write(u & ((1 << param) - 1), param)
    w.align()
    w.write(0, 16)
    return bytes(out + w.tobytes()), sig


def _tone():
    t = np.arange(1000)
    return (np.sin(2 * np.pi * 440 * t / 16000) * 20000).astype(np.int32)


def _fixture(kind):
    """(bytes, samples) of each tests/test_flac.py fixture kind."""
    if kind == "verbatim":
        return fixture_encode(_tone()), _tone()
    if kind == "odd_tail":
        sig = np.arange(-300, 301, dtype=np.int32) * 30
        return fixture_encode(sig, block_size=256), sig
    if kind == "stereo":
        st = np.stack([_tone(), -_tone() // 2], axis=1)
        return fixture_encode(st), st
    if kind == "constant":
        return (fixture_encode(np.full(512, 777, np.int32),
                               constant_value=777), np.full(512, 777))
    return _fixed_order1_rice()


@pytest.mark.parametrize("kind", ["verbatim", "odd_tail", "stereo",
                                  "constant", "fixed_rice"])
def test_decoder_on_fixture_kinds(tmp_path, kind):
    raw, want = _fixture(kind)
    p = tmp_path / f"{kind}.flac"
    p.write_bytes(raw)
    data, sr, bits = read_flac(str(p))
    assert (sr, bits) == (16000, 16)
    np.testing.assert_array_equal(data, want)


def test_not_flac_raises(tmp_path):
    p = tmp_path / "x.flac"
    p.write_bytes(b"RIFFxxxx")
    with pytest.raises(ValueError):
        read_flac(str(p))


@pytest.mark.parametrize("stereo", [False, True])
def test_loaders_on_flac_against_jax_on_wav(tmp_path, stereo):
    rng = np.random.default_rng(int(stereo))
    x = rng.integers(-20000, 20000, (3000, 2) if stereo else 3000) \
        .astype(np.int16)
    flac, wav = str(tmp_path / "a.flac"), str(tmp_path / "a.wav")
    with open(flac, "wb") as f:
        f.write(flac_encode.encode_flac(x.astype(np.int64), 16000, bits=16))
    wavfile.write(wav, 16000, x)
    got, sr = load_audio_norm(flac)
    want, jsr = jax_load_audio_norm(wav)
    assert sr == jsr == 16000 and got.dtype == want.dtype == np.float32
    # the FLAC path scales by 2^-15 before the peak normalization: one
    # float32 rounding apart
    np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -23)
    got, _ = load_audio(flac)
    want, _ = jax_load_audio(wav)
    # the WAV path divides by the int16 maximum, 32767, the FLAC path by
    # 2^15: the JAX package's own two scales (a channel mean adds one
    # float32 rounding of the channels' size)
    np.testing.assert_allclose(got, want * np.float32(32767 / 32768),
                               rtol=2 ** -22, atol=2 ** -23)
    assert got.shape == want.shape == (3000,)


# --- the native beam -------------------------------------------------------

def _logprobs(seed, t=40, c=30):
    rng = np.random.default_rng(seed)
    return np.log(rng.dirichlet(np.ones(c), size=t))


def _assert_same(got, want, tol):
    assert len(got) == len(want)
    for (gp, go, gs), (wp, wo, ws) in zip(got, want):
        assert gp == wp
        assert go == wo
        assert gs == pytest.approx(ws, abs=tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [
    dict(beam_width=16),
    dict(beam_width=8, cutoff_top_n=5),
    dict(beam_width=32, cutoff_prob=0.95, top_paths=3),
    dict(beam_width=4, top_paths=3),
])
def test_native_beam_matches_jax_python(seed, kw):
    lp = _logprobs(seed)
    _assert_same(beam_native.ctc_beam_search_native(lp, **kw),
                 jax_beam_search(lp, **kw), 1e-12)


@pytest.fixture(params=["arpa", "arpa.gz", "trigram"])
def arpa_path(request, tmp_path):
    text = TRIGRAM_ARPA if request.param == "trigram" else ARPA
    p = tmp_path / "lm.arpa"
    p.write_text(text)
    if request.param == "arpa.gz":
        gz = tmp_path / "lm.arpa.gz"
        with gzip.open(gz, "wt") as f:
            f.write(text)
        return str(gz), str(p)
    return str(p), str(p)


def test_native_arpa_scores_match_jax(arpa_path):
    path, plain = arpa_path
    lm, ref = beam_native.NativeArpaLM(path), JaxArpaLM(plain)
    assert lm.order == ref.order
    words = sorted({w for g in ref.ngrams for w in g}) + ["ZZZ"]
    for ctx in [(), ("<s>",)] + [(w,) for w in words] + [("X", "AB")]:
        for w in words:
            assert lm.score_word(ctx, w) == pytest.approx(
                ref.score_word(ctx, w), abs=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_beam_with_lm_matches_jax_python(arpa_path, seed):
    path, plain = arpa_path
    labels = LABELS if "trigram" not in plain else None
    if labels is None:
        ref = JaxArpaLM(plain)
        labels = "_" + "".join(sorted({c for g in ref.ngrams for w in g
                                       for c in w if not w.startswith("<")}
                                      )) + " "
    lp = _logprobs(seed, t=25, c=len(labels))
    kw = dict(beam_width=16, space_index=len(labels) - 1, alpha=2.0,
              beta=0.5, labels=labels, top_paths=3)
    got = beam_native.ctc_beam_search_native(
        lp, lm=beam_native.NativeArpaLM(path), **kw)
    _assert_same(got, jax_beam_search(lp, lm=JaxArpaLM(plain), **kw), 1e-10)


@pytest.mark.parametrize("lm,collapse,workers", [
    (None, 1.0, 1), (None, 0.4, 3), ("arpa", 1.0, 2), ("arpa", 0.4, 1)])
def test_decoder_native_matches_jax_python(tmp_path, lm, collapse, workers):
    """The decoder class: blank collapse, the thread fan-out, the LM."""
    path = None
    if lm:
        path = str(tmp_path / "lm.arpa")
        with open(path, "w") as f:
            f.write(ARPA)
    rng = np.random.default_rng(3)
    probs = rng.dirichlet(np.ones(len(LABELS)), size=(4, 16))
    probs[:, ::3, 0] += 2.0  # runs of confident blanks for the collapse
    probs /= probs.sum(-1, keepdims=True)
    sizes = np.array([16, 12, 9, 16])
    kw = dict(lm_path=path, alpha=1.5, beta=0.3, beam_width=12, top_paths=2,
              blank_collapse_threshold=collapse, num_processes=workers)
    dec = BeamCTCDecoder(LABELS, backend="native", **kw)
    assert dec.backend == "native"
    got = dec.decode(torch.from_numpy(probs), torch.from_numpy(sizes))
    want = JaxBeamDecoder(LABELS, backend="python", **kw).decode(probs, sizes)
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def _lm_file(tmp_path, kind):
    arpa = tmp_path / "lm.arpa"
    arpa.write_text(ARPA)
    if kind == "arpa":
        return str(arpa)
    out = str(tmp_path / f"lm.{kind}")
    if kind == "dslm":
        convert_arpa(str(arpa), out)
    elif kind == "probing":
        write_probing_binary(out, JaxArpaLM(str(arpa)))
    else:
        write_trie_binary(out, JaxArpaLM(str(arpa)))
    return out


@pytest.mark.parametrize("kind,want", [(None, "native"), ("arpa", "native"),
                                       ("dslm", "python"),
                                       ("probing", "python"),
                                       ("trie", "python")])
def test_auto_resolves_as_jax(tmp_path, kind, want):
    path = _lm_file(tmp_path, kind) if kind else None
    dec = BeamCTCDecoder(LABELS, lm_path=path, beam_width=16, alpha=2.0,
                         beta=0.0)
    assert dec.backend == want
    assert dec._ctor_kwargs["backend"] == want  # workers pinned to it
    if want == "python" and kind:
        with pytest.raises(RuntimeError, match="textual ARPA"):
            BeamCTCDecoder(LABELS, lm_path=path, backend="native")
    probs = np.full((1, 3, 4), 0.01)
    probs[0, 0] = [0.02, 0.47, 0.51, 0.0]
    probs[0, 1] = [0.02, 0.51, 0.47, 0.0]
    probs[0, 2] = [0.04, 0.02, 0.02, 0.92]
    strings, _ = dec.decode(probs)
    # the LM steers the search from BA to AB (tests/test_native_beam.py)
    assert strings[0][0].strip() == ("AB" if kind else "BA")


def test_auto_falls_back_without_gxx(monkeypatch, tmp_path):
    """No g++ and no library: auto takes the Python search, native
    raises."""
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "none"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert BeamCTCDecoder(LABELS, beam_width=4).backend == "python"
    with pytest.raises(RuntimeError, match="unavailable"):
        BeamCTCDecoder(LABELS, backend="native")
    assert edit_distance([1, 2, 3], [1, 3]) == 1  # the numpy fallback
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load_native()


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        BeamCTCDecoder(LABELS, backend="cuda")
