"""On-device additive noise injection (the JAX package's
``augment/noise_device.py``), in PyTorch on the batch's device.

The reference mixes noise-pool clips and gaussian noise into the waveform on
the HOST data-loader path (reference data/audio_aug.py:79-107 ``AddNoise``:
two passes, each w.p. ``prob``: pick a noise source, draw ``a ~
U(0, limit)``, mix ``(wav + a*noise) / (1 + a)``). Here the mixing runs in
the train step, against a noise bank uploaded once (``build_noise_bank``,
numpy, copied).

``add_noise_batch`` is split in two: ``draw_noise`` makes every random
choice from an explicit ``torch.Generator`` (where the JAX package splits
``jax.random`` keys), and ``apply_noise`` mixes from those draws. The JAX
function's draws, recomputed from its key chain, give its output through
``apply_noise``; the generator's draws have the same distribution.

Host twin: :class:`deepspeech_tpu_torch.augment.waveform.AddNoise`.

Known bounded divergence vs. the host (PARITY.md #11), kept: the slice
start is capped at ``bank_width - batch_width`` (a fixed-width slice), so
noise files longer than ``2 * max_duration`` offer fewer distinct offsets
than host mixing would allow. The mix math and the per-pass
probabilities are exact.
"""

from __future__ import annotations

import numpy as np
import torch


def build_noise_bank(noise_paths, sample_rate: int, width: int,
                     pad: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Load + stack the noise pool into one (N, 2*width) f32 host array.

    Each row holds one noise source stacked (repeated reads, reference
    audio_aug.py:110-134 intent) to up to ``2*width`` samples; rows shorter
    than an utterance make that utterance skip the pool pass, like the host
    AddNoise's early return. ``pad`` reserves headroom so the batch's
    reflect tail can also be mixed.
    Returns (bank (N, 2*width), bank_lengths (N,) int32).
    """
    from deepspeech_tpu_torch.augment.waveform import get_stacked_noise
    w2 = 2 * (width + pad)
    rows, lens = [], []
    for p in noise_paths:
        clip = get_stacked_noise(p, w2, sample_rate)
        n = min(clip.shape[0], w2)
        row = np.zeros(w2, np.float32)
        row[:n] = clip[:n]
        rows.append(row)
        lens.append(n)
    if not rows:
        rows, lens = [np.zeros(w2, np.float32)], [0]
    return np.stack(rows), np.asarray(lens, np.int32)


def _rewrite_reflect_tail(audio: torch.Tensor, lengths: torch.Tensor,
                          pad: int) -> torch.Tensor:
    """Re-derive each row's reflect end-pad from its (now noised) samples.

    Batches pre-write the CLEAN waveform's reflect tail into the pad region
    (data/loader.py BucketSpec.reflect_tail) so the centered STFT's final
    frame matches host featurization; after the mix the tail must reflect
    the MIXED signal: tail[j] = audio[len - 2 - j], with the loader's
    truncation rule (min(pad, row slack, len - 1)).
    """
    b, s = audio.shape
    ar = torch.arange(s, device=audio.device)[None, :]
    n = lengths.to(audio.device).long()[:, None]
    tail_eff = torch.minimum(torch.clamp(s - n, max=pad), n - 1)
    in_tail = (ar >= n) & (ar < n + tail_eff)
    src = torch.clamp(2 * n - 2 - ar, 0, s - 1)
    refl = torch.gather(audio, 1, src)
    return torch.where(in_tail, refl, audio)


def draw_noise(batch: int, width: int, n_clips: int,
               generator: torch.Generator) -> dict:
    """Every random choice of :func:`add_noise_batch` for a (batch, width)
    batch over ``n_clips`` bank rows, on the generator's device: ``clip``
    (B,) ~ U{0..n_clips-1}; the rolls ``roll0``, ``roll1``, the slice
    fraction ``pos``, the strengths ``alpha0``, ``alpha1`` (B,) ~ U[0, 1);
    ``gauss`` (B, width) ~ N(0, 1)."""
    dev = generator.device

    def u():
        return torch.rand(batch, generator=generator, device=dev)

    out = {"clip": torch.randint(0, n_clips, (batch,), generator=generator,
                                 device=dev)}
    out.update(roll0=u(), pos=u(), alpha0=u(), roll1=u())
    out["gauss"] = torch.randn(batch, width, generator=generator, device=dev)
    out["alpha1"] = u()
    return out


def apply_noise(audio: torch.Tensor, audio_lengths: torch.Tensor,
                draws: dict, bank: torch.Tensor, bank_lengths: torch.Tensor,
                prob: float, limit: float,
                reflect_pad: int = 0) -> torch.Tensor:
    """Reference AddNoise (audio_aug.py:79-107), batched, from ``draws``.

    audio: (B, S) padded waveforms; bank: (N, S2 >= S) noise pool. Two
    passes per row — pool clip then gaussian — each applied where its roll
    is below ``prob``, with a = limit x its strength draw; mixing touches
    only the valid samples and the reflect tail is re-derived afterwards.
    """
    b, s = audio.shape
    s2 = bank.shape[1]
    if s2 < s:
        raise ValueError(
            f"noise bank rows ({s2} samples) are narrower than the batch "
            f"({s}); build the bank with width >= the longest bucket "
            "(build_noise_bank width covers 2x the longest utterance)")
    dev = audio.device
    lengths = audio_lengths.to(dev)
    pos_cap = s2 - s
    valid = (torch.arange(s, device=dev)[None, :]
             < lengths[:, None]).to(audio.dtype)

    def mix(audio, noise, apply, alpha):
        alpha = torch.where(apply, alpha, 0.0)[:, None]
        return (audio + alpha * noise * valid) / (1.0 + alpha)

    # pass 0: a clip from the pool; rows whose chosen clip is shorter than
    # the utterance skip the pass (host AddNoise's early return)
    clip = draws["clip"].to(dev).long()
    clip_len = bank_lengths.to(dev)[clip]
    avail = clip_len - lengths
    roll0 = draws["roll0"].to(dev) < prob
    has = clip_len > 0
    apply0 = roll0 & has & (avail >= 0)
    # a too-short pool clip ends the WHOLE call on the host (AddNoise's
    # early return, audio_aug.py:94-96) — the gaussian pass is skipped too
    aborted = roll0 & has & (avail < 0)
    pos = torch.clamp((draws["pos"].to(dev)
                       * (avail + 1).to(torch.float32)).to(torch.int32),
                      max=pos_cap).clamp(min=0)
    idx = pos.long()[:, None] + torch.arange(s, device=dev)[None, :]
    noise0 = bank.to(dev)[clip[:, None], idx]
    audio = mix(audio, noise0, apply0, limit * draws["alpha0"].to(dev))

    # pass 1: gaussian noise (the host draws a 2L window and slices — iid,
    # so a fresh (B, S) draw is the same distribution)
    apply1 = (draws["roll1"].to(dev) < prob) & ~aborted
    audio = mix(audio, draws["gauss"].to(dev), apply1,
                limit * draws["alpha1"].to(dev))

    if reflect_pad > 0:
        audio = _rewrite_reflect_tail(audio, lengths, reflect_pad)
    return audio


def add_noise_batch(audio: torch.Tensor, audio_lengths: torch.Tensor,
                    generator: torch.Generator, bank: torch.Tensor,
                    bank_lengths: torch.Tensor, prob: float, limit: float,
                    reflect_pad: int = 0) -> torch.Tensor:
    """The two-pass mix of a (B, S) batch with draws from ``generator``."""
    draws = draw_noise(audio.shape[0], audio.shape[1], bank.shape[0],
                       generator)
    return apply_noise(audio, audio_lengths, draws, bank, bank_lengths,
                       prob, limit, reflect_pad)
