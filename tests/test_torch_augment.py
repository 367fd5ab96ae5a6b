"""PyTorch port: augmentation against the JAX package.

Host augmentation draws with numpy from the same SeedSequence in both
packages, so it is held bit for bit: the waveform pipelines of aug_type
0-3, the host spectrogram masks and their combinators, a dataset item with
``augment=True`` (both emits), and the ``noise_inject`` CLI's wav.

The device masks and the noise mix draw with ``jax.random`` there and a
``torch.Generator`` here, so the port holds:

- the same function from the same draws: the JAX key chain's draws,
  recomputed in the test with ``jax.random``, go through the port's
  ``apply_*`` and give the JAX functions' outputs (exactly for the masks,
  to 1e-6 for the mix's f32 arithmetic; ``featurize_batch`` with the
  masks to the JAX featurizer at tests/test_torch_train_cli.py's 1e-3);
- the same distribution of draws: over 1,000-1,500 rows each, the share
  of rows masked by frequency and by time, the zeroed share, the 8 kHz
  share, and the mix's untouched share and perturbation moments, in the
  manner of tests/test_noise_device.py:74;
- the edges: probability 0 is the identity, the time cap uses each row's
  valid length, the reflect tail is rewritten from the mixed samples, a
  pool clip shorter than the utterance skips both passes; and the train
  step draws jitter, masks and noise in the JAX step's key order.
"""

import functools
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from deepspeech_tpu.audio import AudioConf as JaxAudioConf
from deepspeech_tpu.audio.features import featurize_batch as jax_featurize
from deepspeech_tpu.augment import noise_device as jax_noise
from deepspeech_tpu.augment import spectrogram as jax_spec
from deepspeech_tpu.augment import waveform as jax_wave
from deepspeech_tpu.data import AudioDataset as JaxDataset
from deepspeech_tpu_torch.audio.features import AudioConf, featurize_batch
from deepspeech_tpu_torch.augment import noise_device, spectrogram, waveform
from deepspeech_tpu_torch.data import AudioDataset
from deepspeech_tpu_torch.train.step import StepConfig, draw_augment

torch.set_num_threads(2)

SR = 16000
LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ "


def _wav(path, y):
    wavfile.write(str(path), SR, (np.clip(y, -1, 1) * 32767).astype(np.int16))


def _sig(n, f=440.0):
    return (0.3 * np.sin(2 * np.pi * f * np.arange(n) / SR)).astype(
        np.float32)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_augment")
    noise = d / "hum.wav"
    _wav(noise, 0.5 * np.sin(2 * np.pi * 60 * np.arange(SR) / SR))
    rows = []
    for i, txt in enumerate(("AB", "BA C", "ABC")):
        n = int(SR * (0.4 + 0.1 * i))
        _wav(d / f"u{i}.wav", _sig(n, 300 + 90 * i)
             + 0.01 * np.random.default_rng(i).standard_normal(n))
        (d / f"u{i}.txt").write_text(txt)
        rows.append(f"{d / f'u{i}.wav'},{d / f'u{i}.txt'},{n / SR}")
    (d / "m.csv").write_text("\n".join(rows) + "\n")
    return dict(d=d, noise=str(noise), manifest=str(d / "m.csv"))


def _rng(seed, epoch, index):
    return np.random.default_rng(np.random.SeedSequence([seed, epoch,
                                                         index]))


# ---- host augmentation, bit for bit ----

@pytest.mark.parametrize("aug_type", [0, 1, 2, 3])
def test_waveform_pipelines_bit_equal(data, aug_type):
    y = _sig(SR // 2) + 0.05 * np.random.default_rng(9).standard_normal(
        SR // 2).astype(np.float32)
    ours = waveform.build_waveform_pipeline(0.9, [data["noise"]], SR,
                                            aug_type)
    theirs = jax_wave.build_waveform_pipeline(0.9, [data["noise"]], SR,
                                              aug_type)
    for index in range(6):
        got, _ = ours(y.copy(), SR, _rng(7, 1, index))
        want, _ = theirs(y.copy(), SR, _rng(7, 1, index))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_host_spectrogram_masks_bit_equal():
    spect = np.random.default_rng(0).random((161, 120)).astype(np.float32)

    def build(mod):
        f = mod.FrequencyMask(bands=2, prob=0.6, dropout_width=20)
        t = mod.TimeMask(bands=2, prob=0.6, dropout_length=50)
        return [f, t, mod.SOneOf([mod.FrequencyMask(), mod.TimeMask()], 0.9),
                mod.SCompose([mod.FrequencyMask(prob=0.7),
                              mod.TimeMask(prob=0.7)]),
                mod.SComposePipelines([[mod.FrequencyMask(prob=1.0)],
                                       [mod.TimeMask(prob=1.0)]]),
                mod.SOneOrOther(mod.FrequencyMask(), mod.TimeMask(), 0.5)]

    for ours, theirs in zip(build(spectrogram), build(jax_spec)):
        for index in range(5):
            got = ours(spect.copy(), _rng(1, 0, index))
            want = theirs(spect.copy(), _rng(1, 0, index))
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("emit", ["audio", "spect"])
def test_dataset_item_with_augment_bit_equal(data, emit):
    kw = dict(noise_dir=data["noise"], noise_prob=0.8, aug_prob_spect=0.7)
    ours = AudioDataset(AudioConf(**kw), data["manifest"], LABELS,
                        augment=True, seed=11, aug_type=0, emit=emit)
    theirs = JaxDataset(JaxAudioConf(**kw), data["manifest"], LABELS,
                        augment=True, seed=11, aug_type=0, emit=emit)
    for epoch in (0, 3):
        ours.set_curriculum_epoch(epoch)
        theirs.set_curriculum_epoch(epoch)
        for i in range(len(ours)):
            got, want = ours[i], theirs[i]
            assert got["path"] == want["path"]
            np.testing.assert_array_equal(got["target"], want["target"])
            np.testing.assert_array_equal(got[emit], want[emit])
    # the augmentation does act: another seed gives another waveform
    other = AudioDataset(AudioConf(**kw), data["manifest"], LABELS,
                         augment=True, seed=12, emit=emit)
    assert any(not np.array_equal(other[i][emit], ours[i][emit])
               for i in range(len(ours)))


def test_noise_inject_cli_writes_the_root_clis_wav(data, tmp_path):
    import noise_inject as root_cli

    from deepspeech_tpu_torch.cli import noise_inject

    n = SR // 2
    _wav(tmp_path / "in.wav", _sig(n))
    # a noise clip of half the input: tiled to exactly its length, so the
    # window's random start is 0 in both
    _wav(tmp_path / "noise.wav", 0.4 * np.sin(np.arange(n // 2) / 7.0))
    args = ["--input-path", str(tmp_path / "in.wav"), "--noise-path",
            str(tmp_path / "noise.wav"), "--noise-level", "0.5"]
    assert root_cli.main(args + ["--output-path",
                                 str(tmp_path / "root.wav")]) == 0
    assert noise_inject.main(args + ["--output-path",
                                     str(tmp_path / "port.wav")]) == 0
    assert ((tmp_path / "port.wav").read_bytes()
            == (tmp_path / "root.wav").read_bytes())


# ---- device augmentation: the same function from the same draws ----
# The JAX functions run under jit, as the JAX train step runs them, which
# also compiles each once instead of op by op.

_spec_augment = jax.jit(jax_spec.spec_augment, static_argnums=3)
_band_zero = jax.jit(jax_spec.band_zero_8khz, static_argnums=2)


@functools.partial(jax.jit, static_argnames=("prob", "limit", "reflect_pad"))
def _add_noise(audio, lens, key, bank, bank_lens, prob, limit,
               reflect_pad=0):
    return jax_noise.add_noise_batch(audio, lens, key, bank, bank_lens, prob,
                                     limit, reflect_pad=reflect_pad)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_spec_keys(key, b, t):
    def row(k):
        k_sel, k_freq, k_time = jax.random.split(k, 3)
        out = {"u": jax.random.uniform(k_sel)}
        for name, kk, width, size in (("freq", k_freq, 20, 161),
                                      ("time", k_time, 50, t)):
            _, k_width, k_center = jax.random.split(kk, 3)
            out[f"{name}_width"] = jax.random.randint(k_width, (2,), 0,
                                                      width + 1)
            out[f"{name}_center"] = jax.random.randint(k_center, (2,), 0,
                                                       size + 1)
        return out

    return jax.vmap(row)(jax.random.split(key, b))


def _jax_spec_draws(key, b, t):
    """The draws jax spec_augment makes from ``key`` (its split chain)."""
    return {k: torch.tensor(np.asarray(v))
            for k, v in _jax_spec_keys(key, b, t).items()}


def _mags(b, t, seed=0):
    rng = np.random.default_rng(seed)
    mag = rng.random((b, 161, t)).astype(np.float32) + 0.1
    lens = rng.integers(t // 4, t + 1, b).astype(np.int32)
    lens[0] = t
    return mag, lens


@pytest.mark.parametrize("prob", [0.5, 1.0])
def test_spec_augment_from_the_jax_draws(prob):
    b, t = 12, 90
    mag, lens = _mags(b, t)
    key = jax.random.PRNGKey(3)
    want = np.asarray(_spec_augment(jnp.asarray(mag), jnp.asarray(lens), key,
                                    prob))
    draws = _jax_spec_draws(key, b, t)
    got = spectrogram.apply_spec_augment(torch.from_numpy(mag),
                                         torch.from_numpy(lens), draws, prob)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()


def test_band_zero_from_the_jax_draws():
    mag, _ = _mags(16, 20)
    key = jax.random.PRNGKey(4)
    want = np.asarray(_band_zero(jnp.asarray(mag), key, 0.4))
    u = torch.tensor(np.asarray(jax.random.uniform(key, (16,))))
    got = spectrogram.apply_band_zero_8khz(torch.from_numpy(mag), u, 0.4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want[:, 100] == 0).all(-1).sum() < 16


def _jax_noise_draws(key, b, s, n_clips):
    k_pool, k_gauss = jax.random.split(key)
    kp = jax.random.split(k_pool, 4)
    kg = jax.random.split(k_gauss, 3)
    draws = {"clip": jax.random.randint(kp[0], (b,), 0, n_clips),
             "roll0": jax.random.uniform(kp[1], (b,)),
             "pos": jax.random.uniform(kp[2], (b,)),
             "alpha0": jax.random.uniform(kp[3], (b,)),
             "roll1": jax.random.uniform(kg[0], (b,)),
             "gauss": jax.random.normal(kg[1], (b, s)),
             "alpha1": jax.random.uniform(kg[2], (b,))}
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _noise_batch(data, tmp_path, b=6, s=12000):
    _wav(tmp_path / "short.wav", 0.3 * np.ones(400))  # 10 reads: 4000
    paths = [data["noise"], str(tmp_path / "short.wav")]
    bank, lens = noise_device.build_noise_bank(paths, SR, s, pad=160)
    jbank, jlens = jax_noise.build_noise_bank(paths, SR, s, pad=160)
    np.testing.assert_array_equal(bank, jbank)
    np.testing.assert_array_equal(lens, jlens)
    rng = np.random.default_rng(5)
    audio = np.zeros((b, s), np.float32)
    alens = rng.integers(3000, s - 200, b).astype(np.int32)
    for i, n in enumerate(alens):
        audio[i, :n] = _sig(n, 200 + 50 * i)
        audio[i, n:n + 160] = audio[i, n - 2 - np.arange(160)]
    return audio, alens, bank, lens


@pytest.mark.parametrize("prob", [0.6, 1.0])
def test_noise_mix_from_the_jax_draws(data, tmp_path, prob):
    audio, alens, bank, lens = _noise_batch(data, tmp_path)
    key = jax.random.PRNGKey(8)
    want = np.asarray(_add_noise(
        jnp.asarray(audio), jnp.asarray(alens), key, jnp.asarray(bank),
        jnp.asarray(lens), prob=prob, limit=0.3, reflect_pad=160))
    draws = _jax_noise_draws(key, *audio.shape, bank.shape[0])
    got = noise_device.apply_noise(
        torch.from_numpy(audio), torch.from_numpy(alens), draws,
        torch.from_numpy(bank), torch.from_numpy(lens), prob, 0.3,
        reflect_pad=160)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert np.abs(want - audio).max() > 1e-3


def test_featurize_with_masks_matches_jax():
    """The featurizer applies SpecAugment, then the band zero, to the
    magnitudes before normalizing, as the JAX featurizer's aug_key split
    does."""
    rng = np.random.default_rng(2)
    b, s = 5, 9000
    audio = (0.3 * rng.standard_normal((b, s))).astype(np.float32)
    lens = np.asarray([9000, 8000, 6100, 7000, 4000], np.int32)
    conf = dict(aug_prob_spect=0.8, aug_prob_8khz=0.5)
    key = jax.random.PRNGKey(6)
    want, want_lens = jax.jit(lambda a, n, k: jax_featurize(
        a, n, JaxAudioConf(**conf), aug_key=k))(jnp.asarray(audio),
                                                jnp.asarray(lens), key)
    k_spec, k_8k = jax.random.split(key)
    t = 1 + s // 160
    masks = {"spec": _jax_spec_draws(k_spec, b, t),
             "band": torch.tensor(np.asarray(jax.random.uniform(k_8k, (b,))))}
    got, got_lens = featurize_batch(torch.from_numpy(audio),
                                    torch.from_numpy(lens), AudioConf(**conf),
                                    masks=masks)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


# ---- device augmentation: the same distribution of draws ----

def test_spec_augment_draws_match_jax_in_distribution():
    b, t, prob = 1000, 40, 0.6
    ones = np.ones((b, 161, t), np.float32)
    lens = np.full(b, t, np.int32)
    want = np.asarray(_spec_augment(jnp.asarray(ones), jnp.asarray(lens),
                                    jax.random.PRNGKey(0), prob))
    gen = torch.Generator().manual_seed(0)
    got = spectrogram.spec_augment(torch.from_numpy(ones),
                                   torch.from_numpy(lens), gen, prob).numpy()

    def shares(x):
        freq = (x == 0).all(-1).any(-1)  # a whole bin zeroed
        time = (x == 0).all(-2).any(-1)  # a whole frame zeroed
        return freq.mean(), time.mean(), (x == 0).mean()

    (fw, tw, zw), (fg, tg, zg) = shares(want), shares(got)
    assert fw == pytest.approx(prob / 2 * 0.95, abs=0.06)
    assert fg == pytest.approx(fw, abs=0.05)
    assert tg == pytest.approx(tw, abs=0.05)
    assert zg == pytest.approx(zw, rel=0.15)

    u = spectrogram.draw_band_zero(20000, torch.Generator().manual_seed(1))
    assert float((u < 0.3).float().mean()) == pytest.approx(0.3, abs=0.015)


def test_noise_mix_draws_match_jax_in_distribution(data):
    n, trials = SR // 2, 1500
    y = _sig(n)
    bank, lens = jax_noise.build_noise_bank([data["noise"]], SR, n)
    audio = np.tile(y, (trials, 1))
    alens = np.full(trials, n, np.int32)
    want = np.asarray(_add_noise(
        jnp.asarray(audio), jnp.asarray(alens), jax.random.PRNGKey(7),
        jnp.asarray(bank), jnp.asarray(lens), prob=0.7, limit=0.5))
    got = noise_device.add_noise_batch(
        torch.from_numpy(audio), torch.from_numpy(alens),
        torch.Generator().manual_seed(7), torch.from_numpy(bank),
        torch.from_numpy(lens), prob=0.7, limit=0.5).numpy()
    dw, dg = want - y[None], got - y[None]
    untouched_w = (np.abs(dw).max(1) < 1e-7).mean()
    untouched_g = (np.abs(dg).max(1) < 1e-7).mean()
    assert untouched_w == pytest.approx(0.09, abs=0.03)  # (1 - p)^2
    assert untouched_g == pytest.approx(untouched_w, abs=0.035)
    assert dg.mean() == pytest.approx(dw.mean(), abs=5e-3)
    assert dg.std() == pytest.approx(dw.std(), rel=0.1)


# ---- the edges ----

def test_probability_zero_is_the_identity(data, tmp_path):
    mag, lens = _mags(4, 30)
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(mag)
    assert spectrogram.spec_augment(x, torch.from_numpy(lens), gen, 0.0) is x
    assert spectrogram.band_zero_8khz(x, gen, 0.0) is x
    audio, alens, bank, blens = _noise_batch(data, tmp_path, b=3)
    draws = noise_device.draw_noise(3, audio.shape[1], 2, gen)
    out = noise_device.apply_noise(torch.from_numpy(audio),
                                   torch.from_numpy(alens), draws,
                                   torch.from_numpy(bank),
                                   torch.from_numpy(blens), 0.0, 0.5)
    np.testing.assert_array_equal(out.numpy(), audio)
    assert draw_augment({"audio": torch.zeros(3, 1600)},
                        StepConfig(max_frame_jitter=False),
                        gen) == {"jitter": None, "masks": None,
                                 "noise": None}


def test_time_cap_uses_each_rows_valid_length():
    """Both rows draw a 50-frame time band at frame 40; the cap is 15% of
    each row's valid frames: 3 of 20 (2 frames zeroed) and 30 of 200 (30
    frames), the JAX vmap's own per-row length."""
    t = 200
    mag = np.ones((2, 161, t), np.float32)
    lens = torch.tensor([20, 200], dtype=torch.int32)
    draws = {"u": torch.tensor([0.9, 0.9]),
             "freq_width": torch.zeros(2, 2, dtype=torch.int64),
             "freq_center": torch.zeros(2, 2, dtype=torch.int64),
             "time_width": torch.full((2, 2), 50),
             "time_center": torch.full((2, 2), 40)}
    out = spectrogram.apply_spec_augment(torch.from_numpy(mag), lens, draws,
                                         prob=1.0).numpy()
    zeroed = (out == 0).all(1).sum(-1)
    assert zeroed.tolist() == [2, 30]


def test_reflect_tail_rewritten_and_short_clip_skips(data, tmp_path):
    audio, alens, bank, blens = _noise_batch(data, tmp_path, b=4)
    gen = torch.Generator().manual_seed(2)
    draws = noise_device.draw_noise(4, audio.shape[1], 2, gen)
    draws["clip"] = torch.tensor([0, 0, 1, 1])  # rows 2, 3: the short clip
    draws["roll0"] = torch.zeros(4)             # every pool pass rolls in
    out = noise_device.apply_noise(
        torch.from_numpy(audio), torch.from_numpy(alens), draws,
        torch.from_numpy(bank), torch.from_numpy(blens), 1.0, 0.5,
        reflect_pad=160).numpy()
    for i, n in enumerate(alens):
        np.testing.assert_array_equal(out[i, n:n + 160],
                                      out[i, n - 2 - np.arange(160)])
        assert np.all(out[i, n + 160:] == 0.0)
        if blens[draws["clip"][i]] < n:  # the short clip: both passes off
            np.testing.assert_array_equal(out[i], audio[i])
        else:
            assert np.abs(out[i, :n] - audio[i, :n]).max() > 1e-4


def test_step_draws_in_the_jax_key_order(data, tmp_path):
    """jitter, then SpecAugment's and the band zero's draws, then the
    mix's, each from the step's generator in that order."""
    audio, alens, bank, blens = _noise_batch(data, tmp_path, b=3)
    batch = {"audio": torch.from_numpy(audio),
             "noise_bank": torch.from_numpy(bank)}
    cfg = StepConfig(audio_conf=AudioConf(aug_prob_spect=0.5,
                                          aug_prob_8khz=0.2),
                     device_noise_prob=0.4)
    got = draw_augment(batch, cfg, torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    jitter = torch.rand(3, generator=gen) - 0.5
    spec = spectrogram.draw_spec_augment(3, 161, 1 + audio.shape[1] // 160,
                                         gen)
    band = spectrogram.draw_band_zero(3, gen)
    noise = noise_device.draw_noise(3, audio.shape[1], 2, gen)
    assert torch.equal(got["jitter"], jitter)
    assert torch.equal(got["masks"]["band"], band)
    for key in spec:
        assert torch.equal(got["masks"]["spec"][key], spec[key])
    for key in noise:
        assert torch.equal(got["noise"][key], noise[key])


def test_train_step_with_device_augmentation(data, tmp_path):
    from deepspeech_tpu_torch.data import BucketSpec, collate_batch
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.train.optim import build_optimizer
    from deepspeech_tpu_torch.train.step import TrainState, make_train_step

    audio, alens, bank, blens = _noise_batch(data, tmp_path, b=2)
    samples = [{"audio": audio[i, :n], "target": np.array([3, 4], np.int32),
                "path": f"p{i}"} for i, n in enumerate(alens)]
    batch = collate_batch(samples, 2, BucketSpec(wire_dtype="int16"))
    batch.pop("paths")
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    batch.update(noise_bank=torch.from_numpy(bank),
                 noise_bank_lengths=torch.from_numpy(blens))
    losses = []
    for cfg in (StepConfig(),
                StepConfig(audio_conf=AudioConf(aug_prob_spect=1.0,
                                                aug_prob_8khz=1.0),
                           device_noise_prob=1.0, device_noise_limit=0.5)):
        torch.manual_seed(0)
        model, _ = build_model("gru", 29, 16, 1, device="cpu")
        opt = build_optimizer("sgd", lr=1e-3)
        m = make_train_step(model, opt, cfg)(
            TrainState.create(model, opt), batch,
            generator=torch.Generator().manual_seed(1))
        assert not bool(m["step_skipped"])
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[0] != losses[1]
