"""The train and eval steps (``train/step.py`` of the JAX package).

One call of ``train_step`` runs the reference loop body (reference
train.py:555-647) on the model's device: wire descale -> featurize (K1) ->
forward (a DeepSpeech2's K2 with residuals, or a ConvStack's cuDNN convs)
-> CTC (K8) -> backward (K9, then K5, cuBLAS and cuDNN) -> clip -> NaN
guard -> SGD/Adam update, plus the greedy ids the loop reports. Everything
from the featurize to the update runs with TF32 off (``ops.fp32_matmul``),
the backward included: cuDNN's convolution gradients would otherwise run
in TF32.

NaN semantics follow the reference and the JAX package:

* NaN logits are zeroed before the loss (train.py:595-598);
* loss = sum of the finite per-sample losses / max(valid rows, 1);
* the optimizer step is skipped when any logit is NaN or the grad norm is
  not finite (train.py:625-630, extended to the grads): the parameters and
  the optimizer state keep their values; the BatchNorm running stats and
  the step counter still move, as ``step.py:150-164`` does.

Unlike the JAX step, this one updates the model's parameters, the
BatchNorm buffers, the optimizer state and the step counter in place (no
second copy of the weights; ``optim.assign_where``); the guard selects per
tensor, on the device, with no host sync. Every tensor of the state keeps
its storage across steps, so a CUDA graph of the step (``train/graph.py``)
replays on the live state.

``make_multi_train_step`` is ``--steps-per-dispatch``'s step (JAX
``make_multi_train_step``): k same-shape microbatches stacked on a leading
axis, the dead lanes of a short group never run, each live lane through
``train_step``, on the card as a replay of its shape's CUDA graph (on a
mesh of NCCL groups, the collectives inside the graph; over gloo, eager).

On a ``parallel.Mesh`` (one process a card) the step computes what the
JAX SPMD program computes for the global batch: each rank takes its data
shard's rows, the augmentation draws are the global batch's (the same
seeded generator on every rank) cut to those rows, the BatchNorms take the
global moments, the loss divides by the global count of real rows, and
after ``autograd.grad`` one flat all-reduce sums the gradients and the
loss over the data group (DistributedDataParallel's hooks do not fire
under ``autograd.grad``) and a broadcast from the model group's first
rank gives every rank of it that rank's gradients of the replicated
parameters, so that their replicas stay bit-equal. The grad
norm counts each element once (the sharded parameters' squares summed
over the model group, each rank holding its own slice), and the NaN flag
is the world's maximum, so every rank clips, skips and updates alike. A
sharded parameter's gradient is the rank's slice of the whole one
(``parallel/tp_rnn.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from deepspeech_tpu_torch.audio.features import (AudioConf, draw_masks,
                                                 featurize_batch)
from deepspeech_tpu_torch.augment.noise_device import apply_noise, draw_noise
from deepspeech_tpu_torch.ops import fp32_matmul
from deepspeech_tpu_torch.ops.ctc import ctc_loss
from deepspeech_tpu_torch.train.optim import (Optimizer, assign_where,
                                              global_norm)
from deepspeech_tpu_torch.utils import trace


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BatchNorm stats), the optimizer state
    and the step counter (a 0-d int64 on the model's device)."""
    model: torch.nn.Module
    opt_state: dict
    step: torch.Tensor

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: Optimizer):
        params = list(model.parameters())
        return cls(model, optimizer.init(params),
                   torch.zeros((), dtype=torch.int64,
                               device=params[0].device))


@dataclasses.dataclass(frozen=True)
class StepConfig:
    audio_conf: AudioConf = AudioConf()
    normalize: str = "max_frame"
    max_frame_jitter: bool = True  # reference data_loader_aug.py:213-214
    # the in-step noise mix (augment/noise_device.py; reference
    # audio_aug.py:79-107 AddNoise semantics): active when > 0 and the
    # batch carries a "noise_bank", which the train CLI uploads once
    device_noise_prob: float = 0.0
    device_noise_limit: float = 0.2


def descale_audio(batch: dict) -> torch.Tensor:
    """The batch's waveforms in f32: the int16 wire is scaled back
    linearly, the mulaw8 wire mu-law expanded (data/loader.py wire_dtype)."""
    audio = batch["audio"]
    if "audio_scale" not in batch:
        return audio.float()
    scale = batch["audio_scale"].float()[:, None]
    if audio.dtype == torch.int8:
        v = audio.float() * (1.0 / 127.0)
        return (torch.sign(v) * torch.expm1(v.abs() * math.log(256.0))
                * (1.0 / 255.0)) * scale
    return audio.float() * scale


def draw_augment(batch: dict, cfg: StepConfig,
                 generator: torch.Generator, replicas: int = 1) -> dict:
    """The train step's random draws, in the JAX step's key order
    (``train/step.py:67-98``: jitter, then the spectrogram masks, then the
    noise mix): ``jitter`` (B,) ~ U(-0.5, 0.5), ``masks``
    (``features.draw_masks``) and ``noise`` (``noise_device.draw_noise``),
    each None where it is off; for ``replicas`` x the batch's rows (the
    global batch of a data-parallel step)."""
    b, s = batch["audio"].shape
    b *= replicas
    dev = generator.device
    out = {"jitter": None, "masks": None, "noise": None}
    if cfg.max_frame_jitter:
        out["jitter"] = torch.rand(b, generator=generator, device=dev) - 0.5
    out["masks"] = draw_masks(b, 1 + s // cfg.audio_conf.hop, cfg.audio_conf,
                              generator)
    if cfg.device_noise_prob > 0 and "noise_bank" in batch:
        out["noise"] = draw_noise(b, s, batch["noise_bank"].shape[0],
                                  generator)
    return out


def featurize(batch: dict, cfg: StepConfig,
              jitter: torch.Tensor | None = None, masks: dict | None = None,
              noise: dict | None = None):
    """Wire batch -> (spect (B, 161, T), frame lengths (B,)). ``noise``
    (draws) mixes the batch's noise bank into the waveforms first, then
    ``masks`` and ``jitter`` act in the featurizer."""
    audio = descale_audio(batch)
    if noise is not None:
        audio = apply_noise(audio, batch["audio_lengths"], noise,
                            batch["noise_bank"], batch["noise_bank_lengths"],
                            cfg.device_noise_prob, cfg.device_noise_limit,
                            reflect_pad=cfg.audio_conf.n_fft // 2)
    return featurize_batch(audio, batch["audio_lengths"], cfg.audio_conf,
                           cfg.normalize, jitter=jitter, masks=masks)


def _loss(logits, out_lens, batch, mesh=None):
    per_sample = ctc_loss(logits, out_lens, batch["targets"],
                          batch["target_lengths"])
    valid = batch.get("valid")
    if valid is None:
        valid = torch.ones_like(per_sample)
    # `valid` masks bucket-padding rows; the mean divides by the real rows
    # (on a mesh, the global batch's: the shards' losses then sum to it)
    finite = torch.isfinite(per_sample) & (valid > 0)
    n_valid = valid.float().sum()
    if mesh is not None:
        mesh.all_reduce(n_valid, "data", tag="valid")
    loss = (torch.where(finite, per_sample, 0.0).sum()
            / n_valid.clamp(min=1.0))
    return loss, per_sample


def _reduce_over_mesh(mesh, grads, loss, has_nan, sharded: list):
    """The data shards' gradients and losses summed by one flat all-reduce
    over the data group; the replicated parameters' gradients the model
    group's first rank's (a broadcast); the grad norm with each element
    once (the ``sharded`` parameters' squares summed over the model
    group); the NaN flag's maximum over the world. -> (grads, loss, grad
    norm, has_nan).

    The ranks of a model group compute a replicated parameter's gradient
    from the same rows, but not bit for bit: cuDNN's default convolution
    algorithms sum the weight gradients in an order of their own each
    call, so the replicas of the conv front would part. One broadcast of
    those gradients over the model group keeps them equal, and, where
    cuDNN's algorithms are deterministic, equal to one process's bit for
    bit (an average of equal values need not be)."""
    if mesh.spans("data"):
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        mesh.all_reduce(flat, "data", tag="grads")
        sizes = [g.numel() for g in grads] + [1]
        *parts, loss = torch.split(flat, sizes)
        grads = [p.view_as(g) for p, g in zip(parts, grads)]
        loss = loss[0]
    replicated = [i for i, s in enumerate(sharded) if not s]
    if mesh.spans("model") and replicated:
        flat = torch.cat([grads[i].reshape(-1) for i in replicated])
        mesh.broadcast(flat, "model", tag="replicas")
        grads = list(grads)
        for i, part in zip(replicated, torch.split(
                flat, [grads[i].numel() for i in replicated])):
            grads[i] = part.view_as(grads[i])
    squares = [torch.sum(g * g) for g in grads]
    zero = loss.new_zeros(())
    sq_sharded = sum((q for q, s in zip(squares, sharded) if s), zero)
    if any(sharded):
        sq_sharded = mesh.all_reduce(sq_sharded.reshape(1), "model",
                                     tag="grad_norm")[0]
    grad_norm = torch.sqrt(
        sum((q for q, s in zip(squares, sharded) if not s), zero)
        + sq_sharded)
    flag = mesh.all_reduce(has_nan.float().reshape(1), "world", op="max",
                           tag="nan")
    return grads, loss, grad_norm, flag[0] > 0


def make_train_step(model: torch.nn.Module, optimizer: Optimizer,
                    cfg: StepConfig = StepConfig(), mesh=None) -> Callable:
    """-> train_step(state, batch, jitter=None, generator=None,
    return_grads=False) -> metrics.

    batch: dict of tensors on the model's device: audio (B, S) f32 (or the
    int16 / int8 wire with audio_scale (B,)), audio_lengths, targets
    (B, L), target_lengths, optional valid (B,), and with the noise mix on
    the bank, noise_bank (N, S2) and noise_bank_lengths (N,). With a
    ``generator`` the step draws its augmentation from it
    (``draw_augment``: the jitter, the masks, the noise; then a
    ``ConvStack``'s dropout); ``jitter`` (B,),
    when given, replaces the drawn jitter. metrics: loss, per_sample,
    greedy ids, out_lens, grad_norm, step_skipped, all on the device, and
    with ``return_grads`` the gradients (a list in the model's parameter
    order) too.

    With a ``mesh`` (the model placed on it by ``parallel.shard_state``)
    the batch holds this data shard's rows, ``jitter`` too, and the
    metrics' loss and grad norm are the global batch's; per_sample, greedy
    and out_lens stay the shard's rows (module docstring)."""

    def train_step(state: TrainState, batch: dict,
                   jitter: torch.Tensor | None = None,
                   generator: torch.Generator | None = None,
                   return_grads: bool = False) -> dict:
        with trace.span("step"):
            return _train_step(state, batch, jitter, generator, return_grads)

    def _train_step(state, batch, jitter, generator, return_grads):
        model.train()
        params = list(model.parameters())
        draws = {"masks": None, "noise": None}
        if generator is not None:
            draws = draw_augment(batch, cfg, generator,
                                 1 if mesh is None else mesh.data)
            if mesh is not None:
                draws = mesh.data_rows(draws)
            if jitter is None:
                jitter = draws["jitter"]
        with fp32_matmul():
            with trace.span("featurize"):
                spect, lengths = featurize(batch, cfg, jitter,
                                           draws["masks"], draws["noise"])
            with trace.span("forward"):
                logits, _, out_lens = model(spect, lengths, generator)
            has_nan = torch.isnan(logits).any()
            logits = torch.where(torch.isnan(logits), 0.0, logits)
            with trace.span("ctc"):
                loss, per_sample = _loss(logits, out_lens, batch, mesh)
            with trace.span("backward"):
                grads = torch.autograd.grad(loss, params)
        with torch.no_grad(), trace.span("optim"):
            loss = loss.detach()
            if mesh is None:
                grad_norm = global_norm(grads)
            else:
                sharded = [getattr(p, "shard_dim", None) is not None
                           for p in params]
                grads, loss, grad_norm, has_nan = _reduce_over_mesh(
                    mesh, grads, loss, has_nan, sharded)
            ok = ~has_nan & torch.isfinite(grad_norm)
            current = [p.detach() for p in params]
            new_params, new_opt = optimizer.update(
                list(grads), state.opt_state, current, grad_norm)
            assign_where(ok, new_params, current)
            assign_where(ok, new_opt, state.opt_state)
            state.step += 1
        out = dict(loss=loss, per_sample=per_sample.detach(),
                   greedy=logits.detach().argmax(-1).to(torch.int32),
                   out_lens=out_lens, grad_norm=grad_norm,
                   step_skipped=~ok)
        if return_grads:
            out["grads"] = list(grads)
        return out

    return train_step


def captures(mesh) -> bool:
    """Whether ``make_multi_train_step`` captures its lanes on the card:
    with no mesh, or where every group the step's collectives take is
    NCCL's. A gloo collective on CUDA tensors is staged through the host,
    which a CUDA graph cannot capture, so over gloo the lanes run eagerly
    (``train/graph.py``)."""
    import torch.distributed as dist

    return mesh is None or all(dist.get_backend(g) == "nccl"
                               for axis, g in mesh.groups.items()
                               if axis != "host")


def make_multi_train_step(model: torch.nn.Module, optimizer: Optimizer,
                          cfg: StepConfig = StepConfig(),
                          mesh=None) -> Callable:
    """-> multi_step(state, stacked, generator, live, shared=None) ->
    metrics, k steps of one call (JAX ``make_multi_train_step``).

    ``stacked``: a batch dict on the model's device with a leading
    microbatch axis (k, B, ...), k host batches of one shape stacked by
    ``data.stack_microbatches``; ``live`` (k,) bool on the host, False for
    the padding lanes of a short group; ``shared``: tensors every
    microbatch reads (the device noise bank), never copied. The live lanes
    run in order, each one ``train_step(state, lane, generator=
    generator)`` (``make_train_step(..., mesh)``: on a mesh each rank
    passes its data shard's rows, and the lanes' collectives run as at
    k=1): on the CPU that call itself; on the card a replay of the CUDA
    graph of its shape's step (``graph.StepGraphs``, the first lane of a
    new shape eager) where ``captures(mesh)``, else the call itself. Dead
    lanes do not run, so after a group with k' live lanes the parameters,
    BatchNorm buffers, optimizer state, step counter and generator are
    where k' ``train_step`` calls leave them. metrics: each of
    ``train_step``'s stacked over the live lanes, (k', ...). The graph
    cache, once made, is ``multi_step.graphs``; it is bound to the first
    call's state and generator. ``multi_step.captured`` says whether
    lanes on the card are captured."""
    from deepspeech_tpu_torch.train.graph import StepGraphs

    train_step = make_train_step(model, optimizer, cfg, mesh)

    def multi_step(state: TrainState, stacked: dict,
                   generator: torch.Generator | None, live,
                   shared: dict | None = None) -> dict:
        shared = shared or {}
        lanes = [j for j, on in enumerate(live) if on]
        if not lanes:
            raise ValueError("multi_step: no live microbatch")
        if (multi_step.captured
                and next(iter(stacked.values())).device.type == "cuda"):
            if multi_step.graphs is None:
                multi_step.graphs = StepGraphs(train_step, state, generator,
                                               mesh)
            step = multi_step.graphs
            if step.state is not state or step.generator is not generator:
                raise ValueError("multi_step: the graphs were captured on "
                                 "another state or generator")
        else:
            def step(lane, shared):
                return train_step(state, {**lane, **shared},
                                  generator=generator)
        outs = [step({k: v[j] for k, v in stacked.items()}, shared)
                for j in lanes]
        return {k: torch.stack([m[k] for m in outs]) for k in outs[0]}

    multi_step.graphs = None
    multi_step.captured = captures(mesh)
    return multi_step


def make_eval_step(model: torch.nn.Module,
                   cfg: StepConfig = StepConfig()) -> Callable:
    """-> eval_step(batch) -> metrics with loss, per_sample, greedy ids,
    out_lens and probs; the model in eval mode, no gradient."""

    def eval_step(batch: dict) -> dict:
        with trace.span("step"):
            model.eval()
            with torch.no_grad(), fp32_matmul():
                with trace.span("featurize"):
                    spect, lengths = featurize(batch, cfg)
                with trace.span("forward"):
                    logits, probs, out_lens = model(spect, lengths)
                with trace.span("ctc"):
                    loss, per_sample = _loss(logits, out_lens, batch)
            return dict(loss=loss, per_sample=per_sample,
                        greedy=logits.argmax(-1).to(torch.int32),
                        out_lens=out_lens, probs=probs)

    return eval_step
