"""Model factory keyed by the reference's ``rnn_type`` strings.

``build_model`` returns (module, meta), where ``meta`` is the
self-description embedded into checkpoints; ``model_from_meta`` rebuilds
the module from it. ``rnn``/``gru``/``lstm`` build a ``DeepSpeech2``, the
six CNN keys a ``ConvStack`` (``models/cnn.py``); ``glu_flexible`` raises
``NotImplementedError``, as in the JAX package.
"""

from __future__ import annotations

import torch

from deepspeech_tpu_torch.device import resolve_device
from deepspeech_tpu_torch.models.ds2 import DeepSpeech2

RNN_KEYS = ("rnn", "gru", "lstm")
CNN_KEYS = ("cnn", "cnn_residual", "glu_small", "glu_large", "large_cnn",
            "cnn_jasper")
SUPPORTED = RNN_KEYS + CNN_KEYS + ("conformer",)
# the Conformer's sizes in a checkpoint's meta
CONFORMER_KEYS = ("d_model", "heads", "layers", "ff", "conv_kernel",
                  "n_mels")
# every meta field ``build_model`` takes back
META_KEYS = ("rnn_type", "num_classes", "hidden_size", "hidden_layers",
             "bidirectional", "bnm", "cnn_width", "dropout", "context",
             *CONFORMER_KEYS)

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": None, "f32": None, None: None}


def build_model(rnn_type: str = "gru", num_classes: int = 29,
                hidden_size: int = 800, hidden_layers: int = 6,
                bidirectional: bool = True, bnm: float = 0.1,
                cnn_width: int = 256, dropout: float = 0.0,
                context: int = 20, compute_dtype=None,
                device: str | torch.device = "cuda", d_model: int = 512,
                heads: int = 8, layers: int = 17, ff: int = 2048,
                conv_kernel: int = 32, n_mels: int = 80):
    """-> (torch module on ``device``, meta dict for checkpoints).

    ``d_model`` ... ``n_mels`` are the Conformer's sizes (width, attention
    heads, blocks, feed-forward width, depthwise kernel, mel bands in);
    the other families ignore them, as the Conformer ignores the DS2 and
    CNN sizes but ``num_classes``, ``bnm`` and ``dropout``.

    ``compute_dtype``: matmul operand type ("bfloat16" / torch.bfloat16, or
    None for float32). A runtime choice: the weights are always float32 and
    the dtype is not part of the checkpoint meta. The CNN family ignores
    it and runs in f32, as the JAX factory builds it."""
    dev = resolve_device(device)
    if isinstance(compute_dtype, str) or compute_dtype is None:
        compute_dtype = _DTYPES[compute_dtype]
    rnn_type = rnn_type.lower()
    if rnn_type == "conformer":
        from deepspeech_tpu_torch.models.conformer import Conformer
        meta = {"rnn_type": rnn_type, "num_classes": num_classes,
                "bnm": bnm, "dropout": dropout, "d_model": d_model,
                "heads": heads, "layers": layers, "ff": ff,
                "conv_kernel": conv_kernel, "n_mels": n_mels}
        model = Conformer(num_classes, d_model, heads, layers, ff,
                          conv_kernel, n_mels, dropout, bnm, compute_dtype)
        return model.to(dev), meta
    meta = {
        "rnn_type": rnn_type, "num_classes": num_classes,
        "hidden_size": hidden_size, "hidden_layers": hidden_layers,
        "bidirectional": bidirectional, "bnm": bnm, "cnn_width": cnn_width,
        "dropout": dropout, "context": context,
    }
    if rnn_type in CNN_KEYS:
        from deepspeech_tpu_torch.models.cnn import build_cnn_model
        # bidirectional=False means "use GLU" for the cnn variant
        model = build_cnn_model(
            rnn_type, num_classes=num_classes, cnn_width=cnn_width,
            hidden_size=hidden_size, hidden_layers=hidden_layers,
            dropout=dropout, bnm=bnm, use_glu=not bidirectional)
        return model.to(dev), meta
    if rnn_type == "glu_flexible":
        raise NotImplementedError("glu_flexible is not implemented")
    if rnn_type not in RNN_KEYS:
        raise ValueError(
            f"unsupported rnn_type {rnn_type!r}; choose from {SUPPORTED}")
    model = DeepSpeech2(num_classes=num_classes, hidden_size=hidden_size,
                        hidden_layers=hidden_layers, cell=rnn_type,
                        bidirectional=bidirectional, context=context,
                        bnm=bnm, compute_dtype=compute_dtype)
    return model.to(dev), meta


def model_from_meta(meta: dict, device: str | torch.device = "cuda"):
    """Rebuild the f32 module from a checkpoint's meta fields."""
    kw = {k: meta[k] for k in META_KEYS if k in meta}
    return build_model(**kw, device=device)[0]
