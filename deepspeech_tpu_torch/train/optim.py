"""Optimizers with the JAX package's semantics (``train/optim.py``, optax).

``build_optimizer`` gives clip-by-global-norm (optax's: the grads are
scaled by ``max_norm / norm`` only when the norm reaches ``max_norm``, with
no eps) followed by SGD with Nesterov momentum (decayed weights added first
when ``weight_decay`` > 0) or Adam (optax's eps outside the square root). The
update is functional: ``update(grads, state, params)`` returns new
parameter tensors and a new state and changes nothing in place; the train
step then writes them over the old ones where the step is kept
(``assign_where``, a per-tensor where that needs no host sync), so every
tensor of the state keeps its storage and a captured CUDA graph of the
step (``train/graph.py``) reads and writes the live state.

The clip and the update move every list of tensors through multi-tensor
(``torch._foreach_*``) ops, a few launches for all of them rather than
one or more a tensor: each element takes the same operations in the same
order as the one-tensor formulas in the comments, so they give the bits
those formulas give. The global norm's squares are one multi-tensor
product; their sums and the sum over the tensors keep the one-tensor
order, so the norm's bits are those of a sum of per-tensor sums too.

The learning rate lives in the state, as optax's injected hyperparameter
does: ``lr``, a 0-d f32 tensor on the parameters' device that the update
reads and ``set_lr`` overwrites in place (a replayed graph sees the
anneal), and ``lr_host``, the same value as a Python float, which
``get_lr`` returns without a device read; beside them that wrapper's step
count (``inject_count``, a 0-d int32 that advances with every applied
update, as optax's does).

Checkpoints hold the state as optax's leaves (``to_optax_leaves``,
``from_optax_leaves``), so each package resumes the other's:

* SGD, with or without weight decay: [inject count int32, learning rate
  f32, the momentum traces];
* Adam: [inject count, learning rate, Adam's count int32, mu, nu];

each per-parameter list in the JAX params tree's leaf order (its dict
keys sorted at every level), in the JAX layouts (``convert.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    tensors = [t.float() for t in tensors]
    squares = torch._foreach_mul(tensors, tensors)
    return torch.sqrt(sum(torch.sum(q) for q in squares))


def clip_by_global_norm(grads: list, max_norm: float,
                        norm: torch.Tensor | None = None):
    """-> (clipped grads, the norm before clipping). ``norm``, when given,
    is the grads' global norm (a tensor-parallel step's, over shards that
    this rank does not hold)."""
    norm = global_norm(grads) if norm is None else norm
    clip = norm >= max_norm  # optax keeps the grads when norm < max_norm
    # g / norm * max_norm where clipping, else g / 1 * 1 (= g)
    one = torch.ones_like(norm)
    scaled = torch._foreach_div(grads, torch.where(clip, norm, one))
    return torch._foreach_mul(scaled, torch.where(clip, max_norm, one)), norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Clip + SGD-Nesterov or Adam over a list of parameter tensors."""

    kind: str = "sgd"
    lr: float = 3e-4
    momentum: float = 0.9
    weight_decay: float = 0.0
    max_norm: float = 100.0
    beta2: float = ADAM_B2  # Adam's second-moment decay
    eps: float = ADAM_EPS  # Adam's eps, outside the square root

    def init(self, params: list) -> dict:
        dev = params[0].device
        state = {"lr": torch.tensor(self.lr, dtype=torch.float32,
                                    device=dev),
                 "lr_host": float(self.lr),
                 "inject_count": torch.zeros((), dtype=torch.int32,
                                             device=dev)}
        if self.kind == "sgd":
            state["trace"] = [torch.zeros_like(p) for p in params]
        else:
            state["count"] = torch.zeros((), dtype=torch.int32, device=dev)
            state["mu"] = [torch.zeros_like(p) for p in params]
            state["nu"] = [torch.zeros_like(p) for p in params]
        return state

    def update(self, grads: list, state: dict, params: list,
               norm: torch.Tensor | None = None):
        """-> (new params, new state); nothing is changed in place. The
        clip takes ``norm`` as the grads' global norm where it is given."""
        if self.max_norm and self.max_norm > 0:
            grads, _ = clip_by_global_norm(grads, self.max_norm, norm)
        lr = state["lr"]
        new = {"lr": lr, "lr_host": state["lr_host"],
               "inject_count": state["inject_count"] + 1}
        add, mul, div = (torch._foreach_add, torch._foreach_mul,
                         torch._foreach_div)
        if self.kind == "sgd":
            if self.weight_decay > 0:  # g + wd p
                grads = add(grads, mul(params, self.weight_decay))
            # optax.trace(nesterov=True): t = g + m t; update = g + m t
            trace = add(grads, mul(state["trace"], self.momentum))
            updates = add(grads, mul(trace, self.momentum))
            new["trace"] = list(trace)
        else:
            count = state["count"] + 1
            b2 = self.beta2
            # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g g + b2 nu
            mu = add(mul(grads, 1 - ADAM_B1), mul(state["mu"], ADAM_B1))
            nu = add(mul(mul(grads, 1 - b2), grads), mul(state["nu"], b2))
            c1 = 1 - ADAM_B1 ** count.float()  # f32, as optax's bias
            c2 = 1 - b2 ** count.float()  # correction
            # (mu / c1) / (sqrt(nu / c2) + eps)
            updates = div(div(mu, c1),
                          add(torch._foreach_sqrt(div(nu, c2)), self.eps))
            new.update(count=count, mu=list(mu), nu=list(nu))
        # p - lr u
        return list(torch._foreach_sub(params, mul(updates, lr))), new


def assign_where(ok: torch.Tensor, new, old) -> None:
    """Write ``new`` over ``old`` where the 0-d bool ``ok`` holds (else
    keep ``old``), in place, tensor by tensor through lists and dicts;
    leaves that are ``old``'s own (the learning rate) and other values are
    left alone."""
    if isinstance(new, dict):
        for k in new:
            assign_where(ok, new[k], old[k])
    elif isinstance(new, list):
        for n, o in zip(new, old):
            assign_where(ok, n, o)
    elif isinstance(new, torch.Tensor) and new is not old:
        torch.where(ok, new, old, out=old)


def build_optimizer(optimizer: str = "sgd", lr: float = 3e-4,
                    momentum: float = 0.9, weight_decay: float = 0.0,
                    max_norm: float = 100.0, beta2: float = ADAM_B2,
                    eps: float = ADAM_EPS) -> Optimizer:
    """Gradient clip (reference train.py:622-623) + SGD/Adam; ``beta2``
    and ``eps`` act with Adam (optax's defaults unless given)."""
    if optimizer not in ("sgd", "adam"):
        raise ValueError(f"unknown optimizer: {optimizer}")
    return Optimizer(optimizer, lr, momentum, weight_decay, max_norm, beta2,
                     eps)


def get_lr(opt_state: dict) -> float:
    """Current learning rate (reference train.py:317-319), from the host
    copy: no device read."""
    return opt_state["lr_host"]


def set_lr(opt_state: dict, lr: float) -> dict:
    """opt_state with a new learning rate (reference train.py:322-326):
    the device tensor overwritten in place, so a captured step sees it."""
    opt_state["lr"].fill_(float(lr))
    opt_state["lr_host"] = float(lr)
    return opt_state


def tree_leaves(tree) -> list:
    """The leaves of a nested list / tuple / dict tree in the order
    ``jax.tree_util.tree_leaves`` gives: sequences in order, dict keys
    sorted, None holding no leaf (how a checkpoint's JSON structure holds
    optax's namedtuples and dicts)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _params_leaves(tensors: list, model) -> list:
    from deepspeech_tpu_torch.convert import torch_to_jax

    sd = dict(model.state_dict())
    names = [n for n, _ in model.named_parameters()]
    if len(names) != len(tensors):
        raise ValueError(f"{len(tensors)} tensors for {len(names)} "
                         "parameters")
    sd.update(zip(names, tensors))
    return tree_leaves(torch_to_jax(sd)[0])


def to_optax_leaves(opt_state: dict, model) -> list:
    """The optimizer state as optax's leaves (module docstring), numpy
    arrays on the host."""
    head = [np.asarray(opt_state["inject_count"].cpu(), np.int32),
            np.asarray(opt_state["lr_host"], np.float32)]
    if "trace" in opt_state:
        return head + _params_leaves(opt_state["trace"], model)
    return (head + [np.asarray(opt_state["count"].cpu(), np.int32)]
            + _params_leaves(opt_state["mu"], model)
            + _params_leaves(opt_state["nu"], model))


def from_optax_leaves(leaves: list, model, optimizer: Optimizer) -> dict:
    """optax's leaves (a flat list, or the nested tree a JAX checkpoint
    holds) -> the port's optimizer state for ``optimizer`` on the model's
    device. Asserts the leaf count and every leaf's shape, as the JAX
    ``restore_state`` does."""
    from deepspeech_tpu_torch.convert import (jax_to_torch, torch_to_jax,
                                              tree_items)

    leaves = [np.asarray(x) for x in tree_leaves(leaves)]
    params, stats = torch_to_jax(model.state_dict())
    items = list(tree_items(params))
    n = len(items)
    lists = 1 if optimizer.kind == "sgd" else 2
    head = 2 if optimizer.kind == "sgd" else 3
    if len(leaves) != head + lists * n:
        raise AssertionError(
            f"checkpoint/optimizer mismatch: {len(leaves)} stored leaves vs "
            f"{head + lists * n} expected")
    names = [name for name, _ in model.named_parameters()]
    dev = next(model.parameters()).device
    shapes = [()] * head + [leaf.shape for _, leaf in items] * lists
    for leaf, shape in zip(leaves, shapes):
        if leaf.shape != shape:
            raise AssertionError(f"checkpoint leaf shape {leaf.shape} != "
                                 f"expected {shape}")

    def per_param(flat):
        tree: dict = {}
        for (path, _), leaf in zip(items, flat):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        sd = jax_to_torch(tree, stats)
        return [sd[name].to(dev) for name in names]

    state = {"inject_count": torch.tensor(int(leaves[0]),
                                          dtype=torch.int32, device=dev),
             "lr": torch.tensor(float(leaves[1]), dtype=torch.float32,
                                device=dev),
             "lr_host": float(leaves[1])}
    if optimizer.kind == "sgd":
        state["trace"] = per_param(leaves[head:])
    else:
        state["count"] = torch.tensor(int(leaves[2]), dtype=torch.int32,
                                      device=dev)
        state["mu"] = per_param(leaves[head:head + n])
        state["nu"] = per_param(leaves[head + n:])
    return state
