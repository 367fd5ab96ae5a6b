"""Operations and bytes of the DS2 model, and the H100's peaks.

The peaks are ``chip_smoke.py:294-296``'s (NVIDIA's data sheet for the
H100 SXM): dense bf16 989 TFLOP/s and HBM3 3.35 TB/s. Every share here is taken against the bf16 peak, the
highest rate at bf16 or wider, whatever precision a cell runs, so that no
sound change can read past 100%. A least time is the larger of the
operations over that peak and the bytes over the bandwidth
(``chip_smoke.py:444 bound``).

Operations are counted at each utterance's own length, not the padded
one: the products of the two convolutions, of each recurrent layer (x @
W_ih and h @ W_hh, both directions; ``chip_smoke.py:783``'s ``2 x 2 x
n_valid x (f_in + h) x gh``) and of the head. Training counts three times
the forward: the backward's two products a forward product, with nothing
recomputed. A recurrent layer's bytes count each input read once and each
output written once at the configuration's types (``chip_smoke.py:784``'s
``nbytes``, the valid frames in place of T x B): x and the weights in, the
layer's output out; training adds the backward's dout, x and the weights
in, dx and the weight gradients out (f32).
"""

from __future__ import annotations

from portbench.reference import ds2

PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def frames(n_samples: int, cfg: dict) -> int:
    """STFT frames of an utterance (centred): 1 + samples // hop."""
    hop = int(cfg["sample_rate"] * (cfg["window_stride"] + 1e-8))
    return 1 + n_samples // hop


def out_frames(n_samples: int, cfg: dict) -> int:
    """Frames after the conv front (time stride 2)."""
    return (frames(n_samples, cfg) - 1) // 2 + 1


def conv_rows() -> list:
    """[(cin, cout, kf, kt, frequency rows out)] of the conv front
    (``reference/ds2.py:CONVS``)."""
    f, cin, out = ds2.N_BINS, 1, []
    for cout, (kf, kt), (sf, _), (pf, _) in ds2.CONVS:
        f = (f + 2 * pf - kf) // sf + 1
        out.append((cin, cout, kf, kt, f))
        cin = cout
    return out


def rnn_inputs(cfg: dict) -> list:
    """Each recurrent layer's input features."""
    return [ds2.conv_features()] + [cfg["hidden_size"]] * (
        cfg["hidden_layers"] - 1)


def forward_flops(t: int, cfg: dict) -> dict:
    """{"conv", "recurrence", "head"}: a forward's operations for one
    utterance of ``t`` frames after the conv front."""
    conv = sum(2.0 * cout * f * t * cin * kf * kt
               for cin, cout, kf, kt, f in conv_rows())
    h = cfg["hidden_size"]
    d = 2 if cfg["bidirectional"] else 1
    gh = 3 * h
    rnn = sum(2.0 * d * t * (f_in + h) * gh for f_in in rnn_inputs(cfg))
    head = 2.0 * t * h * cfg["num_classes"]
    return {"conv": conv, "recurrence": rnn, "head": head}


def model_flops(n_samples, cfg: dict, train: bool) -> float:
    """The model's operations over utterances of ``n_samples`` samples
    each: the forward, times 3 for a train step."""
    total = sum(sum(forward_flops(out_frames(int(n), cfg), cfg).values())
                for n in n_samples)
    return total * (3 if train else 1)


def recurrence_work(n_samples, cfg: dict, train: bool) -> tuple:
    """(operations, bytes) of the recurrent layers over utterances of
    ``n_samples`` samples each."""
    esize = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    h = cfg["hidden_size"]
    d = 2 if cfg["bidirectional"] else 1
    gh = 3 * h
    valid = sum(out_frames(int(n), cfg) for n in n_samples)
    flops, nbytes = 0.0, 0.0
    for f_in in rnn_inputs(cfg):
        flops += 2.0 * d * valid * (f_in + h) * gh
        weights = d * (f_in + h) * gh
        nbytes += (esize * (valid * f_in + weights) + 4 * 2 * d * gh
                   + 4 * valid * h)
        if train:
            nbytes += (4 * valid * h + esize * (valid * f_in + weights)
                       + 4 * (valid * f_in + weights + 2 * d * gh))
    return flops * (3 if train else 1), nbytes


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES)
