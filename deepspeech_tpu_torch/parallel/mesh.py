"""The (data, model) mesh over torch.distributed and its sharding rule (the
JAX package's ``parallel/mesh.py``).

One process drives one card. ``world = data x model``: rank r sits at data
index ``r // model`` and model index ``r % model``, the row-major (data,
model) order of the JAX ``make_mesh``. ``make_mesh`` builds one data group
per model index (the ranks that hold the same parameter shards and
different rows) and one model group per data index (the ranks that hold
the same rows and, between them, every sharded parameter whole).

Every collective goes through ``Mesh.all_reduce``, ``Mesh.all_gather`` or
``Mesh.broadcast``, on tensors of the rank's device (the ``host`` axis's
below aside; the test CLI's per-row results reach rank 0 through
``Mesh.gather_object``, the train CLI's host names every rank through
``Mesh.all_gather_object``), so that NCCL takes them on the card and gloo on
the CPU (gloo also runs all_reduce and broadcast on CUDA tensors, through
the host). Each call counts one under its tag in ``Mesh.counts``. An axis
of one rank has no group and its collectives are skipped, except in a
world of one rank, where every axis is that world and every collective
runs, as DistributedDataParallel's all-reduce does at world size 1 (so
that a one-card run measures what the collectives cost). The axis
``host`` is the data group again over gloo, for values that live on the
host (the loader's padding): a CPU exchange there never waits for the
card, where one over NCCL would wait for the step queued before it.

The sharding rule (``param_spec``) is the JAX rule: each parameter takes
the first candidate whose sharded dim divides over the model axis (RNN
tensors their direction axis, then their gate axis; the head's kernel its
class axis in a DeepSpeech2, its input channels in a ConvStack), the rest
is replicated, and the optimizer moments follow their parameter. A rank
stores its contiguous slice of each sharded tensor and of its moments
(``shard_state``); the layer that reads it gathers it whole first
(``parallel.tp_rnn.gathered``), as GSPMD gathers a sharded operand at a
``pallas_call`` boundary, and runs the kernels it runs on one card. The
one exception is a bidirectional layer whose two directions sit on the
two ranks of a 2-wide model axis: it runs one direction a rank
(``parallel.tp_rnn.direction_sharded_rnn``), as the JAX package's
shard_map does.

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

from deepspeech_tpu_torch.utils import trace

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
            with trace.span("collective." + (tag or axis)):
                dist.all_reduce(t, op=_OPS[op], group=self.groups[axis])
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int,
                   tag: str) -> torch.Tensor:
        """The whole tensor of which each rank of ``axis`` holds one
        contiguous slice along ``dim``, in the group's rank order: ``t``
        itself where the mesh does not span the axis. NCCL gathers into
        one buffer; gloo's all_gather takes no CUDA tensor, so over gloo
        each rank writes its slice into zeros and the group sums them
        (its all_reduce takes both, a CUDA tensor through the host)."""
        if not self.spans(axis):
            return t
        self.counts[tag] += 1
        group = self.groups[axis]
        n = dist.get_world_size(group)
        t = t.contiguous()
        with trace.span("collective." + tag):
            if dist.get_backend(group) == "nccl":
                out = t.new_empty((n,) + tuple(t.shape))
                dist.all_gather_into_tensor(out, t, group=group)
            else:
                out = t.new_zeros((n,) + tuple(t.shape))
                out[dist.get_group_rank(group, self.rank)] = t
                dist.all_reduce(out, group=group)
        shape = list(t.shape)
        shape[dim] *= n
        return out.movedim(0, dim).reshape(shape)

    def broadcast(self, t: torch.Tensor, axis: str = "world",
                  tag: str = "broadcast") -> torch.Tensor:
        """``t`` from the first rank of ``axis`` to the others, in place (a
        no-op where the mesh does not span it); returns ``t``."""
        if self.spans(axis):
            self.counts[tag] += 1
            group = self.groups[axis]
            with trace.span("collective." + tag):
                dist.broadcast(t, src=dist.get_global_rank(group, 0),
                               group=group)
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

    def all_gather_object(self, obj, axis: str = "world",
                          tag: str = "gather_object") -> list:
        """Every rank's picklable ``obj`` over ``axis`` on every rank of
        it, in the group's rank order; ``[obj]`` where the mesh does not
        span the axis."""
        if not self.spans(axis):
            return [obj]
        self.counts[tag] += 1
        group = self.groups[axis]
        out = [None] * dist.get_world_size(group)
        dist.all_gather_object(out, obj, group=group)
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
    """The sharding of one parameter over a ``model``-wide axis, by its
    state_dict name: the first of the JAX rule's candidates (the JAX
    ``param_spec``, ``_spec_for_leaf``) whose sharded dim divides by
    ``model``, in the port's axis order, or () (replicated):

    * an RNN's ``w_ih``/``w_hh`` (D, F|H, G*H): the direction axis,
      ("model", None, None), then the gate axis, (None, None, "model");
      its ``b_ih``/``b_hh`` (D, G*H): ("model", None), then (None,
      "model");
    * the head's ``fc.weight``: a DeepSpeech2's (C, H), the transpose of
      the JAX (H, C) kernel, its classes, ("model", None); a ConvStack's
      (C, in, 1) its input channels, (None, "model", None), which the
      JAX P(None, "model") on the (1, in, C) kernel shards;
    * everything else: ().

    The gate axis is cut in contiguous slices, as the JAX rule cuts it: a
    slice is only stored, and the layer computes on the whole tensor."""
    parts = name.split(".")
    shape = tuple(shape)
    candidates: tuple = ()
    if parts[0] == "rnns" and parts[-1] in RNN_WEIGHTS:
        last = (None,) * (len(shape) - 1) + ("model",)
        candidates = (("model",) + (None,) * (len(shape) - 1), last)
    elif name == "fc.weight":
        candidates = ((("model", None),) if len(shape) == 2
                      else ((None, "model", None),))
    for spec in candidates:
        if all(axis is None or shape[d] % model == 0
               for d, axis in enumerate(spec)):
            return spec
    return ()


def shard_dim(spec: tuple) -> int | None:
    """The dim a ``param_spec`` shards, or None."""
    return spec.index("model") if "model" in spec else None


def shard_slice(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous slice along ``dim`` of a whole tensor that
    the model axis shards (a view)."""
    n = t.shape[dim] // mesh.model
    return t.narrow(dim, mesh.model_index * n, n)


def attach(model: torch.nn.Module, mesh: Mesh) -> None:
    """Hand the mesh to every module that acts on it (a class with a
    ``mesh`` attribute): train-mode BatchNorm takes its moments over the
    data group, an RNN layer and the head gather their sharded tensors
    (or run a direction a rank) over the model group, a ConvStack's
    dropout draws for the global batch."""
    for module in model.modules():
        if hasattr(type(module), "mesh"):
            module.mesh = mesh


def shard_dims(model: torch.nn.Module) -> dict:
    """{state_dict name: sharded dim} of the parameters ``shard_params``
    sharded: each carries its dim as ``shard_dim``, the one record of what
    is sharded."""
    return {n: p.shard_dim for n, p in model.named_parameters()
            if getattr(p, "shard_dim", None) is not None}


def _sharded_positions(model) -> list:
    """[(position in the parameter order, sharded dim)]: where the
    optimizer's moment lists hold a sharded parameter's moments."""
    return [(i, p.shard_dim) for i, p in enumerate(model.parameters())
            if getattr(p, "shard_dim", None) is not None]


def shard_params(model: torch.nn.Module, mesh: Mesh) -> None:
    """Replace every parameter ``param_spec`` shards by this rank's slice,
    in place, marked with its dim (``shard_dim``), and attach the mesh.
    Nothing is sharded where the mesh does not span the model axis,
    except in a world of one rank, where each such parameter is its own
    one slice and is gathered by a one-rank collective, as every
    collective runs there."""
    if not mesh.spans("model"):
        attach(model, mesh)
        return
    for name, p in list(model.named_parameters()):
        dim = shard_dim(param_spec(name, p.shape, mesh.model))
        if dim is None:
            continue
        owner, _, leaf = name.rpartition(".")
        q = torch.nn.Parameter(shard_slice(p.detach(), dim, mesh).clone())
        q.shard_dim = dim
        setattr(model.get_submodule(owner), leaf, q)
    attach(model, mesh)


def shard_state(state, mesh: Mesh):
    """A TrainState onto the mesh: its parameters (``shard_params``) and
    their optimizer moments sliced alike."""
    shard_params(state.model, mesh)
    for key in ("trace", "mu", "nu"):
        moments = state.opt_state.get(key, ())
        for pos, dim in _sharded_positions(state.model) if moments else ():
            moments[pos] = shard_slice(moments[pos], dim, mesh).clone()
    return state


def unshard(t: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The whole tensor of a rank's slice ``t`` sharded along ``dim``,
    gathered over the model group (``Mesh.all_gather``)."""
    return mesh.all_gather(t, "model", dim, tag="gather_state")


def gather_state(state, mesh: Mesh) -> tuple[dict, dict]:
    """(state_dict, optimizer state) with every sharded tensor whole, for a
    checkpoint: a collective every rank enters."""
    dims = shard_dims(state.model)
    sd = dict(state.model.state_dict())
    for name, dim in dims.items():
        sd[name] = unshard(sd[name], mesh, dim)
    opt = dict(state.opt_state)
    for key in ("trace", "mu", "nu"):
        if key in opt:
            opt[key] = list(opt[key])
            for pos, dim in _sharded_positions(state.model):
                opt[key][pos] = unshard(opt[key][pos], mesh, dim)
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
