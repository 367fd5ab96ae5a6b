"""PyTorch port: the CNN model zoo against the JAX package's ``ConvStack``.

Weights come from a JAX ``model.init`` with randomized BatchNorm
statistics and reach the port through ``convert.py``. Both run f32 convs
with sums in other orders: logits agree to atol 1e-4 + rtol 1e-4 (seen:
~1e-6), out_lengths exactly, the train-mode BatchNorm running stats to
1e-4. Dropout is 0 in every parity case: the port draws its keep masks
from a ``torch.Generator``, which cannot reproduce flax's key bit for bit,
so the masks' keep rate is held on its own. The wide variants run on cut
tables (their first rows and their epilog's arithmetic at narrow widths);
their full tables are held equal to the JAX package's.

One train step's gradients come from both packages' train steps (SGD at
learning rate 1, no momentum, no clip: the update is the gradient) and
agree to atol 1e-4 + rtol 1e-3 of the largest gradient of each tensor.
"""

import functools
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeech_tpu.audio import AudioConf as JaxAudioConf
from deepspeech_tpu.cli.common import (
    load_inference_model as jax_load_inference_model)
from deepspeech_tpu.data.loader import BucketSpec as JaxBucketSpec
from deepspeech_tpu.data.loader import collate_batch as jax_collate
from deepspeech_tpu.models import build_model as jax_build_model
from deepspeech_tpu.models import cnn as jax_cnn
from deepspeech_tpu.train import StepConfig as JaxStepConfig
from deepspeech_tpu.train import TrainState as JaxTrainState
from deepspeech_tpu.train import build_optimizer as jax_build_optimizer
from deepspeech_tpu.train import checkpoint as jax_ckpt
from deepspeech_tpu.train import make_train_step as jax_make_train_step
from deepspeech_tpu_torch.cli.common import load_inference_model
from deepspeech_tpu_torch.convert import jax_to_torch, torch_to_jax
from deepspeech_tpu_torch.models import build_model
from deepspeech_tpu_torch.models import cnn
from deepspeech_tpu_torch.train import checkpoint as ckpt
from deepspeech_tpu_torch.train import optim
from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                             make_train_step)

torch.set_num_threads(2)

C = 30
LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 "
TOL = dict(rtol=1e-4, atol=1e-4)


def _cut(blocks, rows, width=None):
    """Rows ``rows`` of a table, dropout 0, ``out`` capped at ``width``."""
    out = []
    for i in rows:
        spec = dict(blocks[i], dropout=0.0)
        if width is not None:
            spec["out"] = min(spec["out"], width)
        out.append(spec)
    return out


def _specs(variant):
    """Small or cut block specs of each variant, dropout 0."""
    if variant == "cnn":
        return jax_cnn.wav2letter_blocks(32, 24, 2, 13, False, 0.0, 0.1)
    if variant == "cnn_glu":
        return jax_cnn.wav2letter_blocks(32, 24, 2, 13, True, 0.0, 0.1)
    if variant == "cnn_residual":
        return jax_cnn.residual_wav2letter_blocks(32, 24, 2, 0.0, 0.1)
    if variant == "glu_small":
        return jax_cnn.glu_blocks(jax_cnn._SMALL_GLU, 3, 0.0, 0.1)
    if variant == "glu_large":  # layer 1's padding of 170: lengths grow
        return _cut(jax_cnn.glu_blocks(jax_cnn._LARGE_GLU, 17, 0.0, 0.1),
                    (0, 1, 16), width=24)
    if variant == "large_cnn":
        return [dict(out=min(o, 24), kernel=k, stride=s, padding=p,
                     batch_norm=True, dropout=0.0, bnm=0.1)
                for o, k, s, p in jax_cnn._LARGE_CNN[:3]]
    if variant == "cnn_jasper":  # prolog, one SE+skip group, dilated epilog
        return _cut(jax_cnn.jasper_blocks(0.0, 0.0), (0, 1, 2, 3, 16, 17),
                    width=24)
    raise KeyError(variant)


VARIANTS = ["cnn", "cnn_glu", "cnn_residual", "glu_small", "glu_large",
            "large_cnn", "cnn_jasper"]


def _inputs(seed=0, t=100):
    rng = np.random.default_rng(seed)
    lengths = np.array([t, 61, 40], np.int32)
    x = rng.standard_normal((3, 161, t)).astype(np.float32) * 0.5
    for i, n in enumerate(lengths):
        x[i, :, n:] = 0
    return x, lengths


@functools.cache
def _jax_init(variant, seed=0):
    specs = _specs(variant)
    model = jax_cnn.ConvStack(blocks=tuple(specs), num_classes=C)
    variables = jax.jit(model.init, static_argnums=3)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 161, 51)),
        jnp.asarray([51]), False)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = {}
    for name, node in variables["batch_stats"].items():
        n = node["bn"]["mean"].shape
        stats[name] = {"bn": {
            "mean": rng.uniform(-0.2, 0.2, n).astype(np.float32),
            "var": rng.uniform(0.6, 1.4, n).astype(np.float32)}}
    return model, params, stats


def _port(variant, params, stats):
    model = cnn.ConvStack(_specs(variant), C)
    model.load_state_dict(jax_to_torch(params, stats))
    return model


@pytest.mark.parametrize("variant,kw", [
    ("cnn", {}), ("cnn", {"bidirectional": False}), ("cnn_residual", {}),
    ("glu_small", {"hidden_layers": 3}), ("glu_small", {}),
    ("glu_large", {}), ("large_cnn", {}), ("cnn_jasper", {})])
def test_block_tables_match_jax(variant, kw):
    """The factory's specs are the JAX factory's, at the default widths."""
    jm, jmeta = jax_build_model(variant, C, dropout=0.1, **kw)
    tm, tmeta = build_model(variant, C, dropout=0.1, device="cpu", **kw)
    assert tmeta == jmeta
    assert [dict(s) for s in jm.blocks] == list(tm.specs)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax(variant, train):
    model, params, stats = _jax_init(variant)
    x, lengths = _inputs()
    apply = jax.jit(functools.partial(model.apply, train=train,
                                      mutable=["batch_stats"] if train
                                      else False))
    out = apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                jnp.asarray(lengths))
    (rl, rp, ro), new_stats = out if train else (out, None)
    port = _port(variant, params, stats)
    port.train(train)
    with torch.no_grad():
        gl, gp, go = port(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(go.numpy(), np.asarray(ro))
    assert gl.shape == rl.shape
    np.testing.assert_allclose(gl.numpy(), np.asarray(rl), **TOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(rp), **TOL)
    if train:
        _, got = torch_to_jax(port.state_dict())
        ref = jax.tree.map(np.asarray, new_stats["batch_stats"])
        for name in ref:
            for k in ("mean", "var"):
                np.testing.assert_allclose(got[name]["bn"][k],
                                           ref[name]["bn"][k], **TOL)


def test_padding_does_not_leak():
    """In eval mode a row's valid logits do not depend on the padding its
    bucket adds: each row alone at its own length gives the same logits
    (every block re-masks its output; SE divides by the valid count)."""
    _, params, stats = _jax_init("cnn_jasper")
    port = _port("cnn_jasper", params, stats).eval()
    x, lengths = _inputs()
    with torch.no_grad():
        a, _, lens = port(torch.from_numpy(x), torch.from_numpy(lengths))
        for i, n in enumerate(lengths):
            b, _, lb = port(torch.from_numpy(x[i:i + 1, :, :n]),
                            torch.from_numpy(lengths[i:i + 1]))
            assert int(lb[0]) == int(lens[i]) == b.shape[1]
            np.testing.assert_allclose(a[i, :int(lens[i])].numpy(),
                                       b[0].numpy(), rtol=1e-5, atol=1e-5)


def test_dropout_keep_rate():
    """flax's dropout semantics from a torch.Generator: a share 1 - rate
    of the values kept (within 5 sigma), each scaled by 1 / (1 - rate),
    and the same draws from the same seed."""
    x = torch.ones(200_000)
    rate = 0.3
    g = torch.Generator().manual_seed(5)
    y = cnn.dropout(x, rate, g)
    kept = y != 0
    share = kept.float().mean().item()
    sigma = (rate * (1 - rate) / x.numel()) ** 0.5
    assert abs(share - (1 - rate)) < 5 * sigma
    np.testing.assert_allclose(y[kept].numpy(), 1 / (1 - rate), rtol=1e-6)
    again = cnn.dropout(x, rate, torch.Generator().manual_seed(5))
    assert torch.equal(y, again)
    # in train mode a block with dropout draws from the forward's generator
    block = cnn.ConvBlock(4, 8, 3, padding=1, dropout=0.5).train()
    inp, lens = torch.randn(2, 4, 20), torch.tensor([20, 11])
    o1, _ = block(inp, lens, torch.Generator().manual_seed(1))
    o2, _ = block(inp, lens, torch.Generator().manual_seed(1))
    o3, _ = block(inp, lens, torch.Generator().manual_seed(2))
    assert torch.equal(o1, o2) and not torch.equal(o1, o3)


def test_factory():
    """Every CNN key builds a ConvStack on the asked device; compute_dtype
    is ignored (the family runs in f32); glu_flexible raises."""
    for key in ("cnn", "cnn_residual", "glu_small"):
        m, _ = build_model(key, C, hidden_size=32, hidden_layers=1,
                           cnn_width=16, compute_dtype="bfloat16",
                           device="cpu")
        assert isinstance(m, cnn.ConvStack)
        assert all(p.dtype == torch.float32 for p in m.parameters())
    with pytest.raises(NotImplementedError):
        build_model("glu_flexible", C, device="cpu")


# ---- one train step's gradients ----

def _batch(b=3, classes=C):
    rng = np.random.default_rng(0)
    samples = []
    for i in range(b):
        n = int(16000 * (0.35 + 0.1 * i))
        t = np.arange(n) / 16000
        y = (np.sin(2 * np.pi * rng.uniform(150, 400) * t)
             + 0.1 * rng.standard_normal(n)).astype(np.float32)
        y /= np.abs(y).max()
        tgt = rng.integers(1, classes, rng.integers(2, 6))
        samples.append({"audio": y, "target": tgt.astype(np.int32),
                        "path": f"u{i}"})
    batch = jax_collate(samples, b, JaxBucketSpec(
        audio_step=1600, target_step=10, min_target=10, wire_dtype="int16"))
    batch.pop("paths")
    return batch


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.array(v)


@pytest.mark.parametrize("variant", ["cnn", "cnn_glu", "cnn_residual",
                                     "cnn_jasper"])
def test_train_step_grads_match_jax(variant):
    model, params, stats = _jax_init(variant)
    batch = _batch()
    tx = jax_build_optimizer("sgd", lr=1.0, momentum=0.0, max_norm=1e9)
    state = JaxTrainState.create({"params": params, "batch_stats": stats},
                                 tx)
    step = jax_make_train_step(model, tx, JaxStepConfig(
        audio_conf=JaxAudioConf()), donate=False)
    key = jax.random.PRNGKey(7)
    new_state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        key)
    jitter = np.asarray(jax.random.uniform(jax.random.split(key, 3)[0], (3,),
                                           minval=-0.5, maxval=0.5))
    ref_grads = {n: np.array(v) - np.array(dict(_flat(new_state.params))[n])
                 for n, v in _flat(params)}

    port = _port(variant, params, stats)
    opt = optim.build_optimizer("sgd", lr=1.0, momentum=0.0, max_norm=1e9)
    pstate = TrainState.create(port, opt)
    pm = make_train_step(port, opt, StepConfig())(
        pstate, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
        jitter=torch.tensor(jitter), return_grads=True)
    np.testing.assert_allclose(pm["loss"].numpy(), np.asarray(m["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(pm["grad_norm"].numpy(),
                               np.asarray(m["grad_norm"]), rtol=1e-3)
    names = [n for n, _ in port.named_parameters()]
    sd = dict(port.state_dict())
    sd.update(zip(names, [g.detach() for g in pm["grads"]]))
    got = dict(_flat(torch_to_jax(sd)[0]))
    assert sorted(got) == sorted(ref_grads)
    for name, ref in ref_grads.items():
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got[name], ref, rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=name)


# ---- checkpoints both ways ----

SMALL = dict(cnn_width=24, hidden_size=32, hidden_layers=2, dropout=0.0)
CKPT_META = {"cnn_residual": dict(rnn_type="cnn_residual", **SMALL),
             "cnn_glu": dict(rnn_type="cnn", bidirectional=False, **SMALL)}


@pytest.mark.parametrize("variant", sorted(CKPT_META))
def test_checkpoints_both_ways(variant, tmp_path):
    """A JAX checkpoint loads in the port with the same logits; the port's
    package, with its SGD state as optax's leaves, loads and restores in
    the JAX package leaf for leaf, and both inference loaders read it."""
    model, params, stats = _jax_init(variant)
    _, meta = jax_build_model(num_classes=C, **CKPT_META[variant])
    assert [dict(b) for b in model.blocks] == [
        dict(b) for b in jax_build_model(num_classes=C,
                                         **CKPT_META[variant])[0].blocks]
    jstate = types.SimpleNamespace(params=params, batch_stats=stats,
                                   opt_state={}, step=0)
    jax_path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save(jax_path, jax_ckpt.serialize(meta, jstate, LABELS,
                                               JaxAudioConf().to_dict()))
    loaded = ckpt.load(jax_path)
    port = _port(variant, params, stats).eval()
    port.load_state_dict(jax_to_torch(loaded["params"],
                                      loaded["batch_stats"]))
    x, lengths = _inputs()
    ref = jax.jit(functools.partial(model.apply, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        jnp.asarray(lengths))[0]
    with torch.no_grad():
        logits = port(torch.from_numpy(x), torch.from_numpy(lengths))[0]
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)

    opt = optim.build_optimizer("sgd", lr=0.01)
    state = TrainState.create(port, opt)
    rng = np.random.default_rng(3)
    grads = [torch.from_numpy(0.01 * rng.standard_normal(p.shape).astype(
        np.float32)) for p in port.parameters()]
    _, state.opt_state = opt.update(grads, state.opt_state,
                                    [p.detach() for p in port.parameters()])
    port_path = str(tmp_path / "port.ckpt")
    ckpt.save(port_path, ckpt.package_from_model(
        port, meta, LABELS, JaxAudioConf().to_dict(),
        opt_state=state.opt_state, step=1))
    package = jax_ckpt.load(port_path)
    for key, tree in (("params", params), ("batch_stats", stats)):
        assert (jax.tree_util.tree_structure(package[key])
                == jax.tree_util.tree_structure(tree))
        for u, v in zip(jax.tree_util.tree_leaves(package[key]),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(u, v)
    tx = jax_build_optimizer("sgd", lr=0.01)
    restored = jax_ckpt.restore_state(package, JaxTrainState.create(
        {"params": params, "batch_stats": stats}, tx))
    leaves = optim.to_optax_leaves(state.opt_state, port)
    got = jax.tree_util.tree_leaves(restored.opt_state)
    assert len(got) == len(leaves)
    for a, b in zip(got, leaves):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = optim.from_optax_leaves(package["optim_state"], port, opt)
    for x_, y_ in zip(state.opt_state["trace"], back["trace"]):
        assert torch.equal(x_, y_)
    # the inference loader of each package reads the port's file
    m2, _, _, _ = load_inference_model(port_path, device="cpu")
    with torch.no_grad():
        again = m2(torch.from_numpy(x), torch.from_numpy(lengths))[0]
    np.testing.assert_array_equal(again.numpy(), logits.numpy())
    jm, jst, _, _, _ = jax_load_inference_model(port_path)
    ref2 = jm.apply({"params": jst.params, "batch_stats": jst.batch_stats},
                    jnp.asarray(x), jnp.asarray(lengths), False)[0]
    np.testing.assert_allclose(np.asarray(ref2), np.asarray(ref), **TOL)
