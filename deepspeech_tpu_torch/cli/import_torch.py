"""Import a reference (torch) DeepSpeech checkpoint into the port (the JAX
package's ``cli/import_torch.py``, ported).

    python -m deepspeech_tpu_torch.cli.import_torch ref.pth out.ckpt

The reference saves a self-describing ``torch.save`` package (reference
model.py:426-468: hidden_size/hidden_layers/rnn_type/labels/audio_conf +
``state_dict``). Its weights map onto the port's own ``state_dict``
weight for weight; the model built from the package's meta takes them
with a strict ``load_state_dict``, and the checkpoint is written in the
shared container (``train/checkpoint.py``), which both packages'
``test``/``transcribe``/``train --continue-from`` load.

DS2 key mapping (rnn_type rnn|gru|lstm; reference model.py:183-380):
  conv.seq_module.0/.3 Conv2d (O,I,Kf,Kt)     -> conv.conv{0,1}.weight, as is
  conv.seq_module.1/.4 BatchNorm2d            -> conv.bn{0,1}.*
  rnns.{i}.rnn.weight_ih_l0[_reverse] (G*H,F) -> rnns.{i}.w_ih (D,F,G*H)
  rnns.{i}.rnn.weight_hh_l0[_reverse] (G*H,H) -> rnns.{i}.w_hh (D,H,G*H)
  rnns.{i}.rnn.bias_{ih,hh}_l0[_reverse]      -> rnns.{i}.b_{ih,hh} (D,G*H)
  rnns.{i}.batch_norm.module.* (i>0)          -> rnns.{i}.bn.*
  lookahead.0.weight (H,context+1)            -> lookahead.weight
  fc.0.module.0.* BatchNorm1d                 -> fc_bn.*
  fc.0.module.1.weight (C,H) Linear           -> fc.weight, as is

CNN branch (cnn, cnn_residual, glu_small, large_cnn): the torch keys are
walked in natural order (a 3-D ``.weight`` under ``rnns.`` is the next
block's Conv1d, a ``.running_mean`` its BatchNorm, ``_se_reduce``/
``_se_expand`` 1x1 convs its squeeze-excitation) onto
``blocks.{i}.conv``/``bn``/``se_reduce``/``se_expand``; ``fc.0`` (a k=1
Conv1d) is ``fc``. glu_large and cnn_jasper are dead code in the
reference, so no checkpoint of theirs exists and both are refused.
"""

from __future__ import annotations

import argparse

import numpy as np

BN = ("weight", "bias", "running_mean", "running_var")
CNN_IMPORT_KEYS = ("cnn", "cnn_residual", "glu_small", "large_cnn")


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t,
                      dtype=np.float32)


def convert_state_dict(sd: dict, hidden_layers: int,
                       bidirectional: bool) -> dict:
    """Reference DS2 state_dict -> the port's DeepSpeech2 state_dict
    (numpy arrays)."""
    out = {}

    def bn(dst, src):
        for k in BN:
            out[f"{dst}.{k}"] = _np(sd[f"{src}.{k}"])

    for j, (ci, bi) in enumerate([(0, 1), (3, 4)]):
        out[f"conv.conv{j}.weight"] = _np(sd[f"conv.seq_module.{ci}.weight"])
        out[f"conv.conv{j}.bias"] = _np(sd[f"conv.seq_module.{ci}.bias"])
        bn(f"conv.bn{j}", f"conv.seq_module.{bi}")
    dirs = ("", "_reverse") if bidirectional else ("",)
    for i in range(hidden_layers):
        pre = f"rnns.{i}.rnn."
        for dst, src, t in (("w_ih", "weight_ih", True),
                            ("w_hh", "weight_hh", True),
                            ("b_ih", "bias_ih", False),
                            ("b_hh", "bias_hh", False)):
            out[f"rnns.{i}.{dst}"] = np.stack(
                [_np(sd[f"{pre}{src}_l0{s}"]).T if t
                 else _np(sd[f"{pre}{src}_l0{s}"]) for s in dirs])
        if f"rnns.{i}.batch_norm.module.weight" in sd:
            bn(f"rnns.{i}.bn", f"rnns.{i}.batch_norm.module")
    if "lookahead.0.weight" in sd:
        out["lookahead.weight"] = _np(sd["lookahead.0.weight"])
    bn("fc_bn", "fc.0.module.0")
    out["fc.weight"] = _np(sd["fc.0.module.1.weight"])
    return out


def _natsort(key: str):
    return [int(t) if t.isdigit() else t for t in key.split(".")]


def convert_cnn_state_dict(sd: dict, n_blocks: int) -> dict:
    """Reference CNN-family state_dict -> the port's ConvStack state_dict
    (numpy arrays). The unused DS2 conv stack the reference always builds
    (``conv.seq_module``, model.py:208-215) is ignored."""
    sd = {k: _np(v) for k, v in sd.items()}
    convs, bns = [], []
    se: dict = {}
    for k in sorted((k for k in sd if k.startswith("rnns.")), key=_natsort):
        if k.endswith(".running_mean"):
            bns.append(k[: -len("running_mean")])
        elif k.endswith(".weight") and sd[k].ndim == 3:
            base = k[: -len("weight")]
            if "_se_reduce." in k or "_se_expand." in k:
                blockp = base.rsplit("_se_", 1)[0]
                which = "reduce" if "_se_reduce." in k else "expand"
                se.setdefault(blockp, {})[which] = (sd[k], sd[base + "bias"])
            else:
                blockp = base[: -len("conv.")] if base.endswith("conv.") \
                    else base
                convs.append((blockp, sd[k], sd.get(base + "bias")))
    if len(convs) != n_blocks or len(bns) != n_blocks:
        raise ValueError(
            f"checkpoint has {len(convs)} convs / {len(bns)} batchnorms but "
            f"the {n_blocks}-block architecture was expected")
    out = {}
    for i, (blockp, w, b) in enumerate(convs):
        t = f"blocks.{i}"
        out[f"{t}.conv.weight"] = w
        if b is not None:
            out[f"{t}.conv.bias"] = b
        for k in BN:
            out[f"{t}.bn.{k}"] = sd[bns[i] + k]
        for which in se.get(blockp, {}):
            w_se, b_se = se[blockp][which]
            # 1x1 Conv1d (out, in, 1) -> Linear (out, in)
            out[f"{t}.se_{which}.weight"] = np.ascontiguousarray(w_se[:, :, 0])
            out[f"{t}.se_{which}.bias"] = b_se
    out["fc.weight"] = sd["fc.0.weight"]
    out["fc.bias"] = sd["fc.0.bias"]
    return out


def convert_package(tpkg: dict) -> dict:
    """Reference torch package -> a checkpoint package of the port's
    model."""
    import torch

    from deepspeech_tpu_torch.models import model_from_meta
    from deepspeech_tpu_torch.models.factory import RNN_KEYS
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    rnn_type = tpkg["rnn_type"]
    if not isinstance(rnn_type, str):  # older saves stored the nn class
        rnn_type = rnn_type.__name__.lower()
    if rnn_type not in RNN_KEYS + CNN_IMPORT_KEYS:
        raise NotImplementedError(
            f"torch import supports {RNN_KEYS + CNN_IMPORT_KEYS}; "
            f"got rnn_type={rnn_type!r} (glu_large / cnn_jasper are dead "
            f"code in the reference — no real checkpoints exist)")
    labels = tpkg["labels"]
    bidirectional = bool(tpkg.get("bidirectional", True))
    hidden_layers = int(tpkg["hidden_layers"])
    cnn = rnn_type in CNN_IMPORT_KEYS
    meta = {
        "rnn_type": rnn_type, "num_classes": len(labels),
        "hidden_size": int(tpkg["hidden_size"]),
        "hidden_layers": hidden_layers, "bidirectional": bidirectional,
        "bnm": float(tpkg.get("bnm", 0.1)),
        "cnn_width": int(tpkg.get("cnn_width", 0) or 0),
        "dropout": float(tpkg.get("dropout", 0) or 0), "context": 20,
    }
    if cnn:
        # a CNN stack without a stored width has the reference's default
        # one; the meta records it, so that the checkpoint rebuilds the
        # same stack (bidirectional=False means "use GLU", reference
        # model.py:228)
        meta["cnn_width"] = meta["cnn_width"] or 256
    model = model_from_meta(meta, device="cpu")
    if cnn:
        sd = convert_cnn_state_dict(tpkg["state_dict"], len(model.blocks))
    else:
        sd = convert_state_dict(tpkg["state_dict"], hidden_layers,
                                bidirectional)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    history = {k: [float(x) for x in np.asarray(tpkg[k]).ravel()]
               for k in ("loss_results", "wer_results", "cer_results")
               if tpkg.get(k) is not None}
    epoch = tpkg.get("epoch")
    return ckpt.package_from_model(
        model, meta, labels, dict(tpkg.get("audio_conf") or {}),
        epoch=None if epoch is None else epoch - 1,
        iteration=tpkg.get("iteration"), avg_loss=tpkg.get("avg_loss"),
        history=history or None, checkpoint=tpkg.get("checkpoint"))


def main(argv=None):
    p = argparse.ArgumentParser(
        description="convert a reference torch DeepSpeech checkpoint to the "
                    "native format")
    p.add_argument("torch_checkpoint")
    p.add_argument("output")
    args = p.parse_args(argv)

    import torch

    from deepspeech_tpu_torch.train import checkpoint as ckpt

    tpkg = torch.load(args.torch_checkpoint, map_location="cpu",
                      weights_only=False)
    pkg = convert_package(tpkg)
    ckpt.save(args.output, pkg)
    print(f"wrote {args.output} (rnn_type={pkg['rnn_type']}, "
          f"hidden={pkg['hidden_size']}x{pkg['hidden_layers']}, "
          f"classes={pkg['num_classes']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
