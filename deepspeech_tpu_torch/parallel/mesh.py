"""The (data, model) mesh over torch.distributed and its sharding rules (the
JAX package's ``parallel/mesh.py``).

One process drives one card. ``world = data x model``: rank r sits at data
index ``r // model`` and model index ``r % model``, the row-major (data,
model) order of the JAX ``make_mesh``. ``make_mesh`` builds one data group
per model index (the ranks that hold the same parameters and different
rows) and one model group per data index (the ranks that hold the same
rows and, at model 2, the two directions of each bidirectional RNN layer).

Every collective goes through ``Mesh.all_reduce`` or ``Mesh.broadcast``, on
tensors of the rank's device (the ``host`` axis's below aside; the test
CLI's per-row results reach rank 0 through ``Mesh.gather_object``), so that
NCCL takes them on the card and gloo on the CPU (gloo also runs these two
on CUDA tensors, through the host).
Each call counts one under its tag in ``Mesh.counts``. An axis of one rank
has no group and its collectives are skipped, except in a world of one
rank, where every axis is that world and every collective runs, as
DistributedDataParallel's all-reduce does at world size 1 (so that a
one-card run measures what the collectives cost). The axis ``host`` is the
data group again over gloo, for values that live on the host (the
loader's padding): a CPU exchange there never waits for the card, where
one over NCCL would wait for the step queued before it.

The JAX package's ``local_batch_to_global`` and ``metrics_to_local``
assemble and split global arrays; here each rank keeps its own rows, so
both return their argument.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model", "world", "host")
RNN_WEIGHTS = ("w_ih", "b_ih", "w_hh", "b_hh")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(eq=False)
class Mesh:
    """A rank's place in the (data, model) mesh, its device (where the
    collectives' tensors live), the process group of each axis it spans
    (``groups``: axis -> group; an absent axis has one rank) and the count
    of collectives issued, by tag."""
    data: int
    model: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    groups: dict = dataclasses.field(default_factory=dict)
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def spans(self, axis: str) -> bool:
        """Whether collectives over ``axis`` run."""
        return self.groups.get(axis) is not None

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum",
                   tag: str | None = None) -> torch.Tensor:
        """``t`` reduced in place over ``axis`` (a no-op where the mesh
        does not span it); returns ``t``."""
        if self.spans(axis):
            self.counts[tag or axis] += 1
            dist.all_reduce(t, op=_OPS[op], group=self.groups[axis])
        return t

    def broadcast(self, t: torch.Tensor, tag: str = "broadcast"
                  ) -> torch.Tensor:
        """``t`` from rank 0 to the whole world, in place; returns ``t``."""
        if self.spans("world"):
            self.counts[tag] += 1
            dist.broadcast(t, src=0, group=self.groups["world"])
        return t

    def gather_object(self, obj, axis: str = "host",
                      tag: str = "gather_object"):
        """Every rank's picklable ``obj`` over ``axis`` on global rank 0
        (which the axis's group must hold), in rank order -> that list on
        rank 0, None on the others; ``[obj]`` where the mesh does not span
        the axis. On the ``host`` axis the objects travel over gloo."""
        if not self.spans(axis):
            return [obj]
        self.counts[tag] += 1
        group = self.groups[axis]
        out = [None] * dist.get_world_size(group) if self.rank == 0 \
            else None
        dist.gather_object(obj, out, dst=0, group=group)
        return out

    def data_rows(self, tree):
        """This data shard's rows of every tensor in a tree of dicts (None
        leaves kept): the leading axis cut into ``data`` equal blocks."""
        if isinstance(tree, dict):
            return {k: self.data_rows(v) for k, v in tree.items()}
        if tree is None:
            return None
        n = tree.shape[0] // self.data
        return tree[self.data_index * n:(self.data_index + 1) * n]


def make_mesh(data: int | None = None, model: int = 1,
              device: str | torch.device = "cpu") -> Mesh:
    """The mesh of this rank (on ``device``) over the initialized process
    group (a one-rank mesh with no groups when there is none). Every rank
    builds every group, in the same order, as
    ``torch.distributed.new_group`` requires."""
    on = dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if on else (1, 0)
    if data is None:
        data = world // model
    if model < 1 or data * model != world:
        raise ValueError(f"mesh {data} x {model} != {world} ranks")
    groups: dict = {}
    gloo = on and dist.get_backend() == "gloo"
    if on and world == 1:
        groups = dict.fromkeys(AXES, dist.group.WORLD)
        if not gloo:
            groups["host"] = dist.new_group([0], backend="gloo")
    elif on:
        groups["world"] = dist.group.WORLD
        members = {"data": [[d * model + m for d in range(data)]
                            for m in range(model)],
                   "model": [[d * model + m for m in range(model)]
                             for d in range(data)]}
        for axis, sets in members.items():
            for ranks in sets:
                if len(ranks) == 1:
                    continue
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = group
                if axis == "data":
                    host = group if gloo else dist.new_group(
                        ranks, backend="gloo")
                    if rank in ranks:
                        groups["host"] = host
    return Mesh(data, model, rank, torch.device(device), groups)


class _AllReduce(torch.autograd.Function):
    """Sum over an axis, whose gradient is summed over it too
    (``torch.distributed.nn.functional.all_reduce``), counted under
    ``tag`` forward and ``tag + "_grad"`` backward."""

    @staticmethod
    def forward(ctx, t, mesh, axis, tag):
        ctx.mesh, ctx.axis, ctx.tag = mesh, axis, tag
        return mesh.all_reduce(t.clone(), axis, tag=tag)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        return (ctx.mesh.all_reduce(grad, ctx.axis, tag=ctx.tag + "_grad"),
                None, None, None)


def reduce_sum(t: torch.Tensor, mesh: Mesh | None, axis: str, tag: str
               ) -> torch.Tensor:
    """Differentiable sum of ``t`` over ``axis``; ``t`` itself where there
    is no mesh or it does not span the axis."""
    if mesh is None or not mesh.spans(axis):
        return t
    return _AllReduce.apply(t, mesh, axis, tag)


def param_spec(name: str, shape, model: int) -> tuple:
    """The sharding of one parameter, by its state_dict name: at model 2 a
    bidirectional RNN layer's ``w_ih``, ``w_hh``, ``b_ih`` and ``b_hh``
    shard their direction axis, ("model", None, ...); everything else,
    the classifier head included, is replicated, (). The JAX rule's other
    candidates (gate-dim sharding for model > 2, the head's classes) are
    not ported."""
    parts = name.split(".")
    if (model == 2 and parts[0] == "rnns" and parts[-1] in RNN_WEIGHTS
            and len(shape) and shape[0] == 2):
        return ("model",) + (None,) * (len(shape) - 1)
    return ()


def attach(model: torch.nn.Module, mesh: Mesh) -> None:
    """Hand the mesh to every module that acts on it (a class with a
    ``mesh`` attribute): train-mode BatchNorm takes its moments over the
    data group, a direction-sharded RNN layer runs over the model group,
    a ConvStack's dropout draws for the global batch."""
    for module in model.modules():
        if hasattr(type(module), "mesh"):
            module.mesh = mesh


def _sharded_positions(model, names) -> list:
    return [i for i, (n, _) in enumerate(model.named_parameters())
            if n in names]


def shard_params(model: torch.nn.Module, mesh: Mesh) -> tuple:
    """Slice every parameter ``param_spec`` shards to this rank's (1, ...)
    direction, in place, and attach the mesh; -> the sharded names."""
    names = []
    i = mesh.model_index
    for name, p in list(model.named_parameters()):
        if param_spec(name, p.shape, mesh.model):
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf,
                    torch.nn.Parameter(p.detach()[i:i + 1].clone()))
            names.append(name)
    attach(model, mesh)
    return tuple(names)


def shard_state(state, mesh: Mesh):
    """A TrainState onto the mesh: its parameters (``shard_params``) and
    their optimizer moments sliced alike, ``state.sharded`` set to the
    sharded names."""
    names = shard_params(state.model, mesh)
    i = mesh.model_index
    positions = _sharded_positions(state.model, names)
    for key in ("trace", "mu", "nu"):
        moments = state.opt_state.get(key, ())
        for pos in positions if moments else ():
            moments[pos] = moments[pos][i:i + 1].clone()
    state.sharded = names
    return state


def unshard(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole (model, ...) tensor of a direction-sharded (1, ...) one:
    each rank writes its slice into zeros and the model group sums them
    (``all_reduce``, which both backends run)."""
    full = t.new_zeros((mesh.model,) + tuple(t.shape[1:]))
    full[mesh.model_index] = t[0]
    return mesh.all_reduce(full, "model", tag="gather")


def gather_state(state, mesh: Mesh) -> tuple[dict, dict]:
    """(state_dict, optimizer state) with every sharded tensor whole, for a
    checkpoint: a collective every rank enters."""
    sd = dict(state.model.state_dict())
    for name in state.sharded:
        sd[name] = unshard(sd[name], mesh)
    opt = dict(state.opt_state)
    positions = _sharded_positions(state.model, state.sharded)
    for key in ("trace", "mu", "nu"):
        if key in opt:
            opt[key] = list(opt[key])
            for pos in positions:
                opt[key][pos] = unshard(opt[key][pos], mesh)
    return sd, opt


def equalize_batch_padding(batch: dict, mesh: Mesh) -> tuple[dict, int]:
    """Pad every non-batch dim of a host batch to the largest over the
    data group, and count the global batch's real rows: one
    ``all_reduce(MAX)`` of the dims and of each shard's ``valid`` count in
    a slot of its own, on the host over the ``host`` axis (gloo), so that
    the loader does not wait for the step running on the card. ->
    (padded batch, real rows of the global batch).

    Rank-strided bins give the shards different utterances, so their
    bucket pads can differ; train-mode BatchNorm counts padding frames, so
    the shards must pad alike to reproduce the global batch. The padding
    is zeros, which the length masks ignore."""
    keys = sorted(k for k, v in batch.items() if getattr(v, "ndim", 0) >= 2)
    dims = [s for k in keys for s in batch[k].shape[1:]]
    slots = [0] * mesh.data
    slots[mesh.data_index] = int(np.asarray(batch["valid"]).sum())
    both = torch.tensor(dims + slots, dtype=torch.int64)
    both = mesh.all_reduce(both, "host", op="max", tag="pad").tolist()
    out, i = dict(batch), 0
    for k in keys:
        v = np.asarray(batch[k])
        want = both[i:i + v.ndim - 1]
        i += v.ndim - 1
        if list(v.shape[1:]) != want:
            out[k] = np.pad(v, [(0, 0)] + [(0, w - s) for w, s
                                           in zip(want, v.shape[1:])])
    return out, int(sum(both[len(dims):]))


def local_batch_to_global(batch: dict, mesh: Mesh) -> dict:
    """Each rank feeds its own rows: the batch as it is."""
    return batch


def metrics_to_local(metrics: dict, mesh: Mesh) -> dict:
    """Each rank's step outputs are its own rows already."""
    return metrics
