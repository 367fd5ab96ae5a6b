"""PyTorch port: |STFT| and featurize_batch against the JAX package.

The port's plain STFT (the CPU side of the CUDA kernel's wrapper) is held
to the Pallas STFT kernel run in interpret mode and to the JAX matmul
lowering at rtol = atol = 1e-4, the tolerance of tests/test_pallas_stft.py.
featurize_batch is held to the JAX batch front-end in all five normalize
modes, at 16 kHz and at 8 kHz (mirror-fill to 161 bins), at the same
tolerance.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeech_tpu.audio.features import AudioConf as JaxAudioConf
from deepspeech_tpu.audio.features import featurize_batch as jax_featurize
from deepspeech_tpu.ops.pallas.stft_kernel import stft_magnitude_pallas
from deepspeech_tpu.ops.stft import stft_magnitude as jax_stft
from deepspeech_tpu_torch.audio.features import AudioConf, featurize_batch
from deepspeech_tpu_torch.audio.features import make_window
from deepspeech_tpu_torch.ops.cuda.stft import plain as stft_plain

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _batch(seed, sr, seconds=(0.5, 0.31, 0.2)):
    """Zero-padded (B, S) waveforms of unequal lengths, peak ~1."""
    rng = np.random.default_rng(seed)
    lens = np.array([int(sr * s) + 7 * i for i, s in enumerate(seconds)])
    audio = np.zeros((len(lens), lens.max()), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n) / sr
        y = (0.5 * np.sin(2 * np.pi * (200 + 150 * i) * t)
             + 0.1 * rng.standard_normal(n))
        audio[i, :n] = y / np.abs(y).max()
    return audio, lens


@pytest.mark.parametrize("seconds", [0.2, 0.47])
def test_plain_stft_matches_pallas_and_matmul(seconds):
    rng = np.random.default_rng(0)
    y = rng.standard_normal((3, int(16000 * seconds))).astype(np.float32)
    win = make_window("hamming", 320)
    got = stft_plain(torch.from_numpy(y), 320, 160, win).numpy()
    pal = np.asarray(stft_magnitude_pallas(jnp.asarray(y), 320, 160, win,
                                           interpret=True))
    ref = np.asarray(jax_stft(jnp.asarray(y), 320, 160, win,
                              method="matmul"))
    assert got.shape == ref.shape == pal.shape
    np.testing.assert_allclose(got, pal, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("sr", [16000, 8000])
@pytest.mark.parametrize("mode", ["max_frame", "frame", "mean", "norm",
                                  "none"])
def test_featurize_matches_jax(sr, mode):
    audio, lens = _batch(seed=sr + len(mode), sr=sr)
    ref, ref_len = jax_featurize(jnp.asarray(audio), jnp.asarray(lens),
                                 JaxAudioConf(sample_rate=sr), mode)
    got, got_len = featurize_batch(torch.from_numpy(audio),
                                   torch.from_numpy(lens),
                                   AudioConf(sample_rate=sr), mode)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    assert got.shape == ref.shape == (3, 161, ref.shape[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_featurize_8khz_mirror_fill():
    """At 8 kHz the 81 bins are mirror-filled to 161: row 81 + i = row 80 - i."""
    audio, lens = _batch(seed=5, sr=8000)
    spect, _ = featurize_batch(torch.from_numpy(audio),
                               torch.from_numpy(lens),
                               AudioConf(sample_rate=8000), "none")
    assert spect[:, 80].abs().sum() > 0
    torch.testing.assert_close(spect[:, 81:], spect[:, 1:81].flip(1),
                               rtol=0, atol=0)
