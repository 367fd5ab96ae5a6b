"""CUDA graphs of the train step: the card's side of ``--steps-per-dispatch``.

The JAX package runs k same-shape train steps in one device dispatch (a
``lax.scan`` over a stacked superbatch, ``make_multi_train_step``). What
that dispatch saves on the card is host time: one eager step of the
default model issues hundreds of ATen ops and ctypes kernel launches from
Python. ``StepGraphs`` captures one train step per batch shape as a CUDA
graph and replays it once a microbatch:

* the first microbatch of a shape runs eagerly. It is the warm-up: the
  kernels build and get their function attributes, cuDNN picks its
  algorithms, and the wrappers' per-shape caches fill (the card's
  capacities, ``recurrence.fwd_capacity`` / ``resident_blocks``; K1's
  device constants, ``stft._fft_on`` / ``_dft_on``), so that no pageable
  copy and no host query of them is left for the capture;
* the second is captured on the cache's own stream. Capture executes
  nothing, so the state does not move; the microbatch then runs as the
  first replay;
* every microbatch of the shape is copied into the graph's static inputs,
  the graph replayed on the current stream and its metrics cloned out of
  the graph's static outputs.

One step a graph, not k: dead lanes never run, a short group (an epoch's
tail, a bucket switch) needs no graph of its own, the generator moves per
replay exactly as an eager step moves it, and the memory pool holds one
step.

The step updates every tensor of the state in place (``train/step.py``,
``optim.assign_where``; the learning rate is a device tensor that
``optim.set_lr`` fills), so the captured addresses stay the live state.
The step's generator is registered with every graph
(``CUDAGraph.register_generator_state``): a replay reads the generator's
seed and offset when it is launched and advances the offset by what the
captured step draws, so replays draw what eager steps draw.

Memory: one private pool (``torch.cuda.graph_pool_handle``) for every
graph of the cache. Graphs replay one at a time on one stream, and each
replay's outputs are cloned before anything else runs, so a graph may
reuse another's scratch; the static inputs (one batch a shape, outside
the pool) and outputs (one step's metrics a shape) stay allocated while
their graph is cached. The cache holds at most ``max_graphs`` graphs
(``MAX_GRAPHS`` unless set) and evicts the least recently replayed one to
capture a new shape; an evicted shape seen again is captured again at
once (its warm-up has run). The bound caps the graph execs and static
inputs; the pool keeps its high-water mark, which grows when a capture
needs blocks larger than the pool has free: on an H100, 16 graphs of the
default model over 2-17 s buckets in rising order grew it by about half
a GiB a graph, and smaller shapes after them by nothing (PERF.md,
``chip_smoke.py``'s ``spd_cache``).

Launch counts: a wrapper counts a launch when it issues it, which under
capture happens once per graph. The cache reads every counter
(``ops.cuda.read_counters``) around a capture, puts them back (nothing
ran) and adds the graph's launches once a replay, so the counters count
what ran on the card. The mesh's collective counts (``Mesh.counts``) are
treated alike.

Across ranks (a ``parallel.Mesh``): each rank captures its own train
step, whose NCCL collectives (the gradient all-reduce, the grad-norm
squares, the NaN flag, the BatchNorm moments, the gathers of the sharded
parameters) become nodes of its graph; every rank replays its graph in
the same order, as it would run the eager steps. The eager first step of
a shape also sets up the NCCL communicators before the capture. The
loader's padding exchange (``equalize_batch_padding``, over gloo on the
host) runs before a lane is stacked, outside any graph. A gloo collective
on CUDA tensors is staged through the host and cannot be captured, so
the rule is fixed: the lanes are captured where every group of the step
is NCCL's, and run eagerly over gloo, on the card as on the CPU
(``train/step.py:captures``; the train CLI logs which, once). Eager
lanes launch every kernel as the replays do.

The kernels capture as they are. Their launch paths' host calls
(``cudaFuncSetAttribute``, the occupancy and attribute queries of K4/K6's
rule in ``csrc/rnn_mma.cuh``) are not stream work, and capture takes them;
the cooperative launches of the persistent variants and the cluster
launches through ``cudaLaunchKernelEx`` (K2/K3's W-resident variant,
K5/K7) become kernel nodes with their attributes; the grid-barrier
counters and K9's global-route workspace come from the graph's pool and
are zeroed by memset nodes on every replay. So no variant needs another
route under capture. ``tests/test_torch_cuda.py`` captures every variant
and holds its replays bit-equal to eager calls; a pageable host-to-device
copy under capture raises there.

A capture or replay that fails raises; no eager step stands in for it.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import torch

from deepspeech_tpu_torch.ops.cuda import add_counters, read_counters
from deepspeech_tpu_torch.utils import trace

MAX_GRAPHS = 16  # graphs a cache holds at most (module docstring)


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: dict          # static inputs, one per batch key
    outputs: dict         # static outputs: the step's metrics
    launches: dict        # kernel launches of one replay, by counter
    collectives: dict     # the mesh's collectives of one replay, by tag


def _key(batch: dict, shared: dict) -> tuple:
    """A graph's key: the batch's shapes and types, and the addresses of
    the shared tensors it reads in place."""
    return (tuple(sorted((k, tuple(v.shape), v.dtype)
                         for k, v in batch.items())),
            tuple(sorted((k, v.data_ptr()) for k, v in shared.items())))


class StepGraphs:
    """The train step of one (state, generator) as a CUDA graph per batch
    shape (module docstring). ``self(batch, shared)`` runs one step on
    ``batch`` (the first of a shape eagerly, the others as replays) and
    returns its metrics; ``shared`` holds tensors the step reads in place
    (the device noise bank)."""

    def __init__(self, train_step: Callable, state,
                 generator: torch.Generator | None, mesh=None):
        self.train_step, self.state, self.generator = (train_step, state,
                                                       generator)
        self.mesh = mesh
        self.max_graphs = MAX_GRAPHS
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(state.step.device)
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.warm: set = set()
        self.capture_s: list = []  # every capture's host seconds
        self.eager_steps = self.replays = self.evictions = 0

    def __call__(self, batch: dict, shared: dict | None = None) -> dict:
        shared = shared or {}
        key = _key(batch, shared)
        g = self.graphs.get(key)
        if g is None:
            if key not in self.warm:
                self.warm.add(key)
                self.eager_steps += 1
                return self.train_step(self.state, {**batch, **shared},
                                       generator=self.generator)
            while len(self.graphs) >= self.max_graphs:
                self.graphs.popitem(last=False)
                self.evictions += 1
            with trace.span("capture"):
                g = self.graphs[key] = self._capture(batch, shared)
        else:
            self.graphs.move_to_end(key)
        with trace.span("replay"):
            for k, v in batch.items():
                g.inputs[k].copy_(v, non_blocking=True)
            g.graph.replay()
            add_counters(g.launches)
            if self.mesh is not None:
                self.mesh.counts.update(g.collectives)
            self.replays += 1
            return {k: v.clone() for k, v in g.outputs.items()}

    def _capture(self, batch: dict, shared: dict) -> _Graph:
        inputs = {k: torch.empty_like(v) for k, v in batch.items()}
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = read_counters()
        counts = self.mesh.counts if self.mesh is not None else \
            collections.Counter()
        issued = counts.copy()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                outputs = self.train_step(self.state, {**inputs, **shared},
                                          generator=self.generator)
        finally:
            after = read_counters()
            add_counters({c: before[c] - n for c, n in after.items()})
            collectives = counts - issued
            counts.clear()
            counts.update(issued)
        self.capture_s.append(time.perf_counter() - t0)
        return _Graph(graph, inputs, outputs,
                      {c: n - before[c] for c, n in after.items()
                       if n != before[c]}, dict(collectives))

    def stats(self) -> dict:
        """Graphs held, every capture's seconds, evictions, eager steps,
        replays."""
        return {"graphs": len(self.graphs), "capture_s": list(self.capture_s),
                "evictions": self.evictions, "eager_steps": self.eager_steps,
                "replays": self.replays}
