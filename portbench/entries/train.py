"""The ``train`` entry: ``train/step.py:make_train_step``'s step, eager, as
the train CLI runs it at ``--steps-per-dispatch 1``.

Set-up builds one model, optimizer state and step from the seed and
drives them through one pass of the mix's bins (the warm-up, every shape
of the cell once); its first three steps, one at a time, give the
readings the check compares. The same objects then run the window. Each
step takes the batch from the port's loader on its wire, a max-frame
jitter the benchmark draws on the device, and is read back on the host
one step behind (its loss, its greedy ids decoded), as
``cli/train.py:account_step`` does. Augmentation is off; nothing is
logged or saved.
"""

from __future__ import annotations

import math

import torch

from portbench.harness import cell, check, loop, program, traffic
from portbench.reference import ds2

CHECKED = 3  # steps the reference follows


class TrainCell(cell.Cell):
    kind = "train"
    rate = "train_audio_s_per_s"
    program_state = ("model", "state", "step")

    def __init__(self, ctx):
        from deepspeech_tpu_torch.train.optim import build_optimizer
        from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                     make_train_step)

        super().__init__(ctx)
        cfg, dev = self.cfg, ctx.device
        with ctx.phase("inputs"):
            manifest = traffic.write_inputs(self.mix, cfg["sample_rate"],
                                            ctx.seed, ctx.tmp)
            self.data = program.dataset(cfg, manifest)
        with ctx.phase("weights"):
            self.model = program.model(
                cfg, ds2.make_weights(cfg, ctx.seed, dev), dev)
            opt = cfg["optimizer"]
            optimizer = build_optimizer("sgd", lr=opt["lr"],
                                        momentum=opt["momentum"],
                                        max_norm=opt["max_norm"])
            self.state = TrainState.create(self.model, optimizer)
            self.step = make_train_step(self.model, optimizer, StepConfig(
                audio_conf=program.audio_conf(cfg),
                normalize=cfg["normalize"]))
        self.jitter_gen = torch.Generator(device=dev).manual_seed(
            (ctx.seed + 1) % 2 ** 63)
        self.decoder = program.decoder(cfg)
        self.readings = {"loss": []}
        self.checked = []  # (host batch, jitter) of the checked steps

    def launch(self, batch):
        dev = self.ctx.device
        jitter = torch.rand(batch["audio"].shape[0], device=dev,
                            generator=self.jitter_gen) - 0.5
        m = self.step(self.state, program.to_device(batch, dev),
                      jitter=jitter)
        return m, batch, jitter

    def finish(self, handle):
        m, batch, _ = handle
        loss = float(m["loss"])
        t = loop.clock()
        self.decoder.decode_ids(m["greedy"], m["out_lens"])
        decode_s = loop.clock() - t
        n = batch["audio_lengths"][batch["valid"] > 0]
        return {"audio_s": float(n.sum()) / self.cfg["sample_rate"],
                "samples": [int(x) for x in n], "decode_s": decode_s,
                "loss": loss,
                "failed": bool(m["step_skipped"]) or not math.isfinite(loss)}

    def warm_up(self, whole: bool = True):
        """Pass 0: the checked steps one at a time with their readings
        (the losses, the first gradient's norms from the momentum trace,
        each parameter's change), then with ``whole`` the rest of the pass
        queued as in the window."""
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
                    n: float(t.double().norm()) for (n, _), t in
                    zip(named, self.state.opt_state["trace"])}
        self.readings["change"] = {
            n: float((p.detach() - start[n]).double().norm())
            for n, p in named}
        del start
        if whole:
            for _ in range(self.n_bins - CHECKED):
                self.pipe.step()

    def reference(self, operand: str = "config", half_batch: bool = False):
        """The reference's readings over the checked steps' batches and
        jitters."""
        dev = self.ctx.device
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()
                    if k != "paths"} for b, _ in self.checked]
        jitters = [j.to(dev) for _, j in self.checked]
        return ds2.train_steps(ds2.make_weights(self.cfg, self.ctx.seed, dev),
                               batches, jitters, self.cfg,
                               self.operand(operand), half_batch)

    def numbers(self, ref=None) -> dict:
        return check.train_numbers(self.readings, ref or self.reference())

    def outcome(self) -> dict:
        return {"attempted": len(self.records),
                "failed": sum(r["failed"] for r in self.records)}


Cell = TrainCell
