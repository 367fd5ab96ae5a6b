"""PyTorch port: the CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and nvcc; elsewhere they skip. They cover the
edge shapes chip_smoke.py does not: 8 kHz framing, ``center=False``, one
direction, one row, hidden sizes that do not fill a block, and a batch
of 70 rows (the step kernel's shared memory does not grow with B). Run
them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: the STFT as tests/test_pallas_stft.py (1e-4); the GRU layer
1e-4 in f32 (sums in another order) and 5e-3 in bf16 (a state on a bf16
rounding boundary may round the other way); small-model logits 2e-2.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("sr", [16000, 8000])
def test_stft_kernel_matches_plain(dev, sr, center):
    from deepspeech_tpu_torch.audio.features import AudioConf, make_window
    from deepspeech_tpu_torch.ops.cuda import stft

    conf = AudioConf(sample_rate=sr)
    rng = np.random.default_rng(sr)
    y = torch.from_numpy(rng.standard_normal((3, int(0.37 * sr))).astype(
        np.float32)).to(dev)
    win = make_window("hamming", conf.n_fft)
    before = stft.launches
    got = stft.stft_mag(y, conf.n_fft, conf.hop, win, center=center)
    assert stft.launches == before + 1
    ref = stft.plain(y, conf.n_fft, conf.hop, win, center=center)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("t,b,f,h", [(7, 1, 40, 32), (29, 3, 96, 50),
                                     (64, 20, 1312, 800), (9, 70, 64, 800)])
def test_gru_kernel_matches_plain(dev, dtype, tol, ndir, t, b, f, h):
    from deepspeech_tpu_torch.ops.cuda import gru

    rng = np.random.default_rng(t + b)
    s = 1.0 / np.sqrt(h)

    def u(*shape, lo=-s, hi=s):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32)).to(dev)

    x, w_ih, w_hh = u(t, b, f, lo=0, hi=1), u(ndir, f, 3 * h), \
        u(ndir, h, 3 * h)
    b_ih, b_hh = u(ndir, 3 * h), u(ndir, 3 * h)
    lens = torch.from_numpy(np.linspace(t, max(1, t // 3), b).astype(
        np.int64)).to(dev)
    args = (x.to(dtype), w_ih.to(dtype), b_ih, w_hh.to(dtype), b_hh, lens)
    before = gru.launches
    got = gru.gru_layer(*args)
    assert gru.launches == before + 1
    ref = gru.plain(*args)
    torch.testing.assert_close(got, ref, rtol=0, atol=tol)
    pad = torch.arange(t, device=dev)[:, None] >= lens[None, :]
    assert not got[:, pad].any()


@pytest.mark.parametrize("bidirectional", [True, False])
def test_small_model_forward_kernel_matches_plain(dev, bidirectional):
    from deepspeech_tpu_torch.audio.features import AudioConf, featurize_batch
    from deepspeech_tpu_torch.models import build_model

    model, _ = build_model("gru", 30, 64, 3, bidirectional=bidirectional,
                           compute_dtype="bfloat16", device=dev)
    model.eval()
    rng = np.random.default_rng(1)
    audio = torch.from_numpy(rng.uniform(-1, 1, (2, 16000)).astype(
        np.float32))
    audio[1, 9000:] = 0
    lens = torch.tensor([16000, 9000])
    with torch.inference_mode():
        spect, frames = featurize_batch(audio.to(dev), lens.to(dev),
                                        AudioConf())
        got = model(spect, frames)
        model.cpu()
        ref = model(*featurize_batch(audio, lens, AudioConf()))
    torch.testing.assert_close(got[2].cpu(), ref[2])
    scale = max(1.0, ref[0].abs().max().item())
    for i, n in enumerate(ref[2].tolist()):
        torch.testing.assert_close(got[0][i, :n].cpu(), ref[0][i, :n],
                                   rtol=0, atol=2e-2 * scale)
