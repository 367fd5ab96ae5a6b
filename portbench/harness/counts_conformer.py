"""Operations and bytes of the Conformer (``reference/conformer.py``), at
the peaks of ``harness/counts.py``.

Counted at each utterance's own length, not the padded one: its STFT
frames T (``counts.frames``), T1 = (T - 3) // 2 + 1 after the first
subsampling conv and T' = (T1 - 3) // 2 + 1 after the second. Two
operations a multiply-add, the products only:

* subsampling: conv0 (1 -> d, 3x3) over T1 x F1 outputs, conv1 (d -> d,
  3x3) over T' x F2, the linear layer d F2 -> d over T';
* a block: both feed-forward modules (d -> ff -> d, twice), the q, k, v
  and output projections (d -> d), the position projection over the
  2T' - 1 distances, the scores (q + u) . k over T' x T', the position
  scores (q + v) . p over T' x (2T' - 1), the probabilities times v over
  T' x T', the conv module's pointwise d -> 2d, depthwise k, pointwise
  d -> d;
* the head, d -> classes.

Training counts three times the forward. The attention's bytes
(``attention_work``): each of its products reads its two operands in
bf16 and writes its output in f32 once; training three times that.
"""

from __future__ import annotations

from portbench.harness import counts


def lengths(n_samples: int, cfg: dict) -> tuple:
    """(T1, T') of an utterance of ``n_samples`` samples."""
    t1 = (counts.frames(n_samples, cfg) - 3) // 2 + 1
    return t1, max((t1 - 3) // 2 + 1, 1)


def bands(cfg: dict) -> tuple:
    f1 = (cfg["n_mels"] - 3) // 2 + 1
    return f1, (f1 - 3) // 2 + 1


def attention_products(t: int, cfg: dict) -> list:
    """[(m, k, n)] of one block's attention at T' = ``t``: each product
    (m x k) @ (k x n), the heads' together."""
    d = cfg["d_model"]
    return ([(t, d, d)] * 4 + [(2 * t - 1, d, d)]
            + [(t, d, t), (t, d, 2 * t - 1)]
            + [(t * cfg["heads"], t, d // cfg["heads"])])


def forward_flops(n_samples: int, cfg: dict) -> dict:
    """{"subsample", "blocks", "attention", "head"} of one utterance's
    forward ("attention" is a part of "blocks")."""
    d, ff, k = cfg["d_model"], cfg["ff"], cfg["conv_kernel"]
    t1, t = lengths(n_samples, cfg)
    f1, f2 = bands(cfg)
    sub = 2.0 * (d * t1 * f1 * 9 + d * t * f2 * d * 9 + t * d * f2 * d)
    attention = sum(2.0 * m * kk * n
                    for m, kk, n in attention_products(t, cfg))
    block = (2 * 2 * 2.0 * t * d * ff + attention
             + 2.0 * t * (d * 2 * d + d * k + d * d))
    return {"subsample": sub, "blocks": cfg["layers"] * block,
            "attention": cfg["layers"] * attention,
            "head": 2.0 * t * d * cfg["num_classes"]}


def model_flops(n_samples, cfg: dict, train: bool) -> float:
    total = 0.0
    for n in n_samples:
        f = forward_flops(int(n), cfg)
        total += f["subsample"] + f["blocks"] + f["head"]
    return total * (3 if train else 1)


def attention_work(n_samples, cfg: dict, train: bool) -> tuple:
    """(operations, bytes) of the attention layers over utterances of
    ``n_samples`` samples each."""
    flops, nbytes = 0.0, 0.0
    for n in n_samples:
        t = lengths(int(n), cfg)[1]
        for m, k, p in attention_products(t, cfg):
            flops += 2.0 * m * k * p
            nbytes += 2.0 * (m * k + k * p) + 4.0 * m * p
    scale = (3 if train else 1) * cfg["layers"]
    return flops * scale, nbytes * scale
