"""The ``train_model`` entry: the ``train`` entry's loop, window, read-back
and checked steps (``entries/train.py:TrainCell``) for any model the
port's factory builds, by the configuration's ``model`` key.

* the model: ``ds2`` through ``harness/program.py:model``; ``conformer``
  through ``models.build_model("conformer", ...)`` at the configuration's
  sizes, over the port's log-mel front (``AudioConf.n_mels``); the weights
  from the seed by the key's plain reference (``reference/ds2.py``,
  ``reference/conformer.py``), which also checks the steps;
* the job's precision: the mix's ``compute_dtype`` where it gives one,
  else the configuration's. The cell's configuration is handed on with
  it, so the check's operand rounding and every reader that counts at the
  configuration's types (``harness/counts.py``) see the job's;
* the optimizer the configuration names: SGD-Nesterov, or Adam with its
  beta2 and eps; the first gradient's norms are read from SGD's momentum
  trace or from Adam's first moment after one step (mu / (1 - beta1): the
  clipped gradient).

The model is built before the inputs are written, so a program without
the configuration's model exits at once.
"""

from __future__ import annotations

import torch

from portbench.entries.train import CHECKED, TrainCell
from portbench.harness import cell, program, traffic
from portbench.reference import conformer, ds2

REFERENCES = {"ds2": ds2, "conformer": conformer}


def audio_conf(cfg: dict):
    """The front of the configuration: a log-mel one where it names
    ``n_mels``."""
    if not cfg.get("n_mels"):
        return program.audio_conf(cfg)
    from deepspeech_tpu_torch.audio.features import AudioConf

    return AudioConf(sample_rate=cfg["sample_rate"],
                     window_size=cfg["window_size"],
                     window_stride=cfg["window_stride"],
                     window=cfg["window"], n_mels=cfg["n_mels"])


def build(cfg: dict, weights: dict, device: torch.device):
    """The port's model of the configuration on ``device`` with ``weights``
    copied in (every name and shape must match)."""
    if cfg["model"] == "ds2":
        return program.model(cfg, weights, device)
    from deepspeech_tpu_torch.models import build_model

    with torch.device(device):
        net, _ = build_model(
            cfg["model"], num_classes=cfg["num_classes"],
            d_model=cfg["d_model"], heads=cfg["heads"],
            layers=cfg["layers"], ff=cfg["ff"],
            conv_kernel=cfg["conv_kernel"], n_mels=cfg["n_mels"],
            dropout=cfg["dropout"], bnm=cfg["bnm"],
            compute_dtype=cfg["compute_dtype"], device=device)
    net.load_state_dict(weights, strict=True)
    return net


def optimizer_of(cfg: dict):
    from deepspeech_tpu_torch.train.optim import ADAM_B1, build_optimizer

    opt = cfg["optimizer"]
    if opt["kind"] == "sgd":
        return build_optimizer("sgd", lr=opt["lr"], momentum=opt["momentum"],
                               max_norm=opt["max_norm"])
    if opt["beta1"] != ADAM_B1:
        raise ValueError(f"the port's Adam takes beta1 {ADAM_B1}")
    return build_optimizer("adam", lr=opt["lr"], max_norm=opt["max_norm"],
                           beta2=opt["beta2"], eps=opt["eps"])


class TrainModelCell(TrainCell):
    def __init__(self, ctx):
        from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                     make_train_step)

        cfg, mix = ctx.cell["config"], ctx.cell["traffic"]
        ctx.cell["config"] = {**cfg, "compute_dtype": mix.get(
            "compute_dtype", cfg["compute_dtype"])}
        cell.Cell.__init__(self, ctx)
        cfg, dev = self.cfg, ctx.device
        self.ref = REFERENCES[cfg["model"]]
        with ctx.phase("weights"):
            self.model = build(cfg, self.ref.make_weights(cfg, ctx.seed, dev),
                               dev)
            self.optimizer = optimizer_of(cfg)
            self.state = TrainState.create(self.model, self.optimizer)
            self.step = make_train_step(self.model, self.optimizer,
                                        StepConfig(
                                            audio_conf=audio_conf(cfg),
                                            normalize=cfg["normalize"]))
        with ctx.phase("inputs"):
            manifest = traffic.write_inputs(self.mix, cfg["sample_rate"],
                                            ctx.seed, ctx.tmp)
            self.data = program.dataset(cfg, manifest)
        self.jitter_gen = torch.Generator(device=dev).manual_seed(
            (ctx.seed + 1) % 2 ** 63)
        self.decoder = program.decoder(cfg)
        self.readings = {"loss": []}
        self.checked = []

    def first_grads(self) -> list:
        """The first step's clipped gradients, from the optimizer's state
        after it."""
        opt = self.state.opt_state
        if self.optimizer.kind == "sgd":
            return opt["trace"]
        from deepspeech_tpu_torch.train.optim import ADAM_B1

        return [m / (1 - ADAM_B1) for m in opt["mu"]]

    def warm_up(self, whole: bool = True):
        """``TrainCell.warm_up`` with the first gradient from
        ``first_grads``."""
        self.pipeline(traffic.stream(self.mix, self.ctx.seed, self.PASSES))
        named = list(self.model.named_parameters())
        start = {n: p.detach().clone() for n, p in named}
        for i in range(CHECKED):
            self.pipe.step()
            _, batch, jitter = self.pipe.pending
            self.readings["loss"].append(self.pipe.drain()["loss"])
            self.checked.append((batch, jitter.cpu()))
            if i == 0:
                self.readings["grad"] = {
                    n: float(t.double().norm())
                    for (n, _), t in zip(named, self.first_grads())}
        self.readings["change"] = {
            n: float((p.detach() - start[n]).double().norm())
            for n, p in named}
        del start
        if whole:
            for _ in range(self.n_bins - CHECKED):
                self.pipe.step()

    def reference(self, operand: str = "config", half_batch: bool = False):
        dev = self.ctx.device
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()
                    if k != "paths"} for b, _ in self.checked]
        jitters = [j.to(dev) for _, j in self.checked]
        return self.ref.train_steps(
            self.ref.make_weights(self.cfg, self.ctx.seed, dev), batches,
            jitters, self.cfg, self.operand(operand), half_batch)


Cell = TrainModelCell
