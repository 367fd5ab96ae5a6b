"""Weight bridge between the JAX package's variable trees and the port.

The JAX model's ``params`` and ``batch_stats`` are nested dicts of numpy
arrays (as checkpoints hold them); the port's models take a torch
``state_dict``. The family is recognised from the keys (``block0`` in the
JAX params, ``blocks.0.conv.weight`` in the state_dict: a ``ConvStack``).
The DeepSpeech2 map:

* ``conv/conv{i}/kernel`` (kh, kw, in, out) <-> ``conv.conv{i}.weight``
  (out, in, kh, kw), i.e. transpose (3, 2, 0, 1); ``bias`` as is;
* ``conv/bn{i}``, ``rnn{i}/bn``, ``fc_bn``: ``scale``/``bias`` params and
  ``mean``/``var`` stats <-> ``weight``/``bias``/``running_mean``/
  ``running_var``;
* ``rnn{i}/{w_ih,b_ih,w_hh,b_hh}`` <-> ``rnns.{i}.{...}``, same layout;
* ``fc/kernel`` (H, C) <-> ``fc.weight`` (C, H);
* ``lookahead/weight`` <-> ``lookahead.weight``.

The ConvStack map (``models/cnn.py``):

* ``block{i}/conv/kernel`` (k, in, out) <-> ``blocks.{i}.conv.weight``
  (out, in, k); ``bias`` where the block has one;
* ``block{i}/bn``: as the BatchNorms above;
* ``block{i}/se_reduce``, ``se_expand``: Dense ``kernel`` (in, out) <->
  Linear ``weight`` (out, in), ``bias`` as is;
* ``fc/kernel`` (1, in, C) <-> ``fc.weight`` (C, in, 1); ``fc/bias``.

The Conformer (``models/conformer.py``; ``subsample`` in the trees) has no
JAX twin: its trees are its state_dict cut at the dots, every tensor in
the port's layout, the BatchNorms' running stats in ``batch_stats``.
"""

from __future__ import annotations

import numpy as np
import torch

_BN_PARAMS = (("scale", "weight"), ("bias", "bias"))
_BN_STATS = (("mean", "running_mean"), ("var", "running_var"))
_RNN = ("w_ih", "b_ih", "w_hh", "b_hh")


def _bn_paths(params: dict):
    """(path in the JAX trees, prefix in the state_dict) of every BN."""
    out = [(("conv", "bn0"), "conv.bn0"), (("conv", "bn1"), "conv.bn1")]
    i = 1
    while f"rnn{i}" in params:
        out.append(((f"rnn{i}", "bn"), f"rnns.{i}.bn"))
        i += 1
    out.append((("fc_bn",), "fc_bn"))
    return out


def _get(tree: dict, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: dict, path, key, value):
    for k in path:
        tree = tree.setdefault(k, {})
    tree[key] = value


def tree_items(tree: dict, prefix: tuple = ()):
    """(key path, leaf) of a nested dict of arrays, keys sorted at every
    level: the order ``jax.tree_util`` flattens the JAX trees in."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from tree_items(tree[key], prefix + (key,))
        else:
            yield prefix + (key,), tree[key]


def _f32(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def _cnn_to_torch(params: dict, batch_stats: dict) -> dict:
    sd = {}
    i = 0
    while f"block{i}" in params:
        p, t = params[f"block{i}"], f"blocks.{i}"
        sd[f"{t}.conv.weight"] = np.asarray(p["conv"]["kernel"]).transpose(
            2, 1, 0)
        if "bias" in p["conv"]:
            sd[f"{t}.conv.bias"] = p["conv"]["bias"]
        if "bn" in p:
            for jk, tk in _BN_PARAMS:
                sd[f"{t}.bn.{tk}"] = p["bn"][jk]
            for jk, tk in _BN_STATS:
                sd[f"{t}.bn.{tk}"] = batch_stats[f"block{i}"]["bn"][jk]
        for se in ("se_reduce", "se_expand"):
            if se in p:
                sd[f"{t}.{se}.weight"] = np.asarray(p[se]["kernel"]).T
                sd[f"{t}.{se}.bias"] = p[se]["bias"]
        i += 1
    sd["fc.weight"] = np.asarray(params["fc"]["kernel"]).transpose(2, 1, 0)
    sd["fc.bias"] = params["fc"]["bias"]
    return _f32(sd)


def _cnn_to_jax(sd: dict) -> tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    i = 0
    while f"blocks.{i}.conv.weight" in sd:
        t, j = f"blocks.{i}", f"block{i}"
        _set(params, (j, "conv"), "kernel",
             sd[f"{t}.conv.weight"].transpose(2, 1, 0).copy())
        if f"{t}.conv.bias" in sd:
            _set(params, (j, "conv"), "bias", sd[f"{t}.conv.bias"])
        if f"{t}.bn.weight" in sd:
            for jk, tk in _BN_PARAMS:
                _set(params, (j, "bn"), jk, sd[f"{t}.bn.{tk}"])
            for jk, tk in _BN_STATS:
                _set(stats, (j, "bn"), jk, sd[f"{t}.bn.{tk}"])
        for se in ("se_reduce", "se_expand"):
            if f"{t}.{se}.weight" in sd:
                _set(params, (j, se), "kernel",
                     sd[f"{t}.{se}.weight"].T.copy())
                _set(params, (j, se), "bias", sd[f"{t}.{se}.bias"])
        i += 1
    _set(params, ("fc",), "kernel", sd["fc.weight"].transpose(2, 1, 0).copy())
    _set(params, ("fc",), "bias", sd["fc.bias"])
    return params, stats


_STAT_LEAVES = ("running_mean", "running_var")


def _dotted_to_trees(sd: dict) -> tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    for name, v in sd.items():
        *path, leaf = name.split(".")
        _set(stats if leaf in _STAT_LEAVES else params, path, leaf, v)
    return params, stats


def _trees_to_dotted(params: dict, batch_stats: dict) -> dict:
    return _f32({".".join(path): leaf for tree in (params, batch_stats)
                 for path, leaf in tree_items(tree)})


def jax_to_torch(params: dict, batch_stats: dict) -> dict:
    """JAX variable trees (numpy leaves) -> the port's state_dict."""
    if "subsample" in params:
        return _trees_to_dotted(params, batch_stats)
    if "block0" in params:
        return _cnn_to_torch(params, batch_stats)
    sd = {}
    for i in (0, 1):
        conv = params["conv"][f"conv{i}"]
        sd[f"conv.conv{i}.weight"] = np.asarray(conv["kernel"]).transpose(
            3, 2, 0, 1)
        sd[f"conv.conv{i}.bias"] = conv["bias"]
    i = 0
    while f"rnn{i}" in params:
        for k in _RNN:
            sd[f"rnns.{i}.{k}"] = params[f"rnn{i}"][k]
        i += 1
    for path, prefix in _bn_paths(params):
        for jk, tk in _BN_PARAMS:
            sd[f"{prefix}.{tk}"] = _get(params, path)[jk]
        for jk, tk in _BN_STATS:
            sd[f"{prefix}.{tk}"] = _get(batch_stats, path)[jk]
    sd["fc.weight"] = np.asarray(params["fc"]["kernel"]).T
    if "lookahead" in params:
        sd["lookahead.weight"] = params["lookahead"]["weight"]
    return _f32(sd)


def torch_to_jax(state_dict: dict) -> tuple[dict, dict]:
    """The port's state_dict -> (params, batch_stats) JAX trees of numpy
    arrays."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}
    if "subsample.conv0.weight" in sd:
        return _dotted_to_trees(sd)
    if "blocks.0.conv.weight" in sd:
        return _cnn_to_jax(sd)
    params: dict = {}
    stats: dict = {}
    for i in (0, 1):
        _set(params, ("conv", f"conv{i}"), "kernel",
             sd[f"conv.conv{i}.weight"].transpose(2, 3, 1, 0).copy())
        _set(params, ("conv", f"conv{i}"), "bias", sd[f"conv.conv{i}.bias"])
    i = 0
    while f"rnns.{i}.w_ih" in sd:
        for k in _RNN:
            _set(params, (f"rnn{i}",), k, sd[f"rnns.{i}.{k}"])
        i += 1
    for path, prefix in _bn_paths(params):
        for jk, tk in _BN_PARAMS:
            _set(params, path, jk, sd[f"{prefix}.{tk}"])
        for jk, tk in _BN_STATS:
            _set(stats, path, jk, sd[f"{prefix}.{tk}"])
    _set(params, ("fc",), "kernel", sd["fc.weight"].T.copy())
    if "lookahead.weight" in sd:
        _set(params, ("lookahead",), "weight", sd["lookahead.weight"])
    return params, stats
