"""The ``eval`` entry: ``train/step.py:make_eval_step`` and
``decoders/greedy.py:GreedyDecoder.decode_ids``, as ``cli/test.py`` runs
them: batch N + 1 is queued on the device before batch N's ids are
decoded on the host.

Set-up builds the model from the seed in eval mode and runs one pass of
the mix's bins (every shape once). The window's first sight of each bin
keeps its sampled rows' posteriors, greedy ids and output lengths (two
rows a bin drawn from the seed, the longest utterance among them); once
the window has closed and the program is freed, the reference computes
those rows again.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import cell, check, loop, program, traffic
from portbench.reference import ds2

SAMPLE_PER_BIN = 2


class EvalCell(cell.Cell):
    kind = "infer"
    rate = "infer_audio_s_per_s"
    program_state = ("model", "step")

    def __init__(self, ctx):
        from deepspeech_tpu_torch.train.step import StepConfig, make_eval_step

        super().__init__(ctx)
        cfg, dev = self.cfg, ctx.device
        with ctx.phase("inputs"):
            manifest = traffic.write_inputs(self.mix, cfg["sample_rate"],
                                            ctx.seed, ctx.tmp)
            self.data = program.dataset(cfg, manifest)
        with ctx.phase("weights"):
            self.model = program.model(
                cfg, ds2.make_weights(cfg, ctx.seed, dev), dev)
            self.step = make_eval_step(self.model, StepConfig(
                audio_conf=program.audio_conf(cfg),
                normalize=cfg["normalize"]))
        self.decoder = program.decoder(cfg)
        groups = traffic.bins(self.mix)
        r = traffic.rng(ctx.seed, 2)
        self.plan = {}  # bin -> its sampled rows
        for i, g in enumerate(groups):
            rows = [int(x) for x in r.choice(
                len(g), min(SAMPLE_PER_BIN, len(g)), replace=False)]
            if i == len(groups) - 1 and len(g) - 1 not in rows:
                rows[-1] = len(g) - 1  # the longest utterance
            self.plan[i] = sorted(rows)
        self.kept = {}

    def launch(self, batch):
        return self.step(program.to_device(batch, self.ctx.device)), batch

    def finish(self, handle):
        m, batch = handle
        t = loop.clock()
        self.decoder.decode_ids(m["greedy"], m["out_lens"])
        decode_s = loop.clock() - t
        valid = batch["valid"] > 0
        per = m["per_sample"].cpu().numpy()
        b = program.row_index(batch["paths"][0]) // self.mix["batch"]
        if self.pipe.in_window and b not in self.kept:
            rows = self.plan[b]
            idx = torch.tensor(rows, device=m["probs"].device)
            self.kept[b] = {
                "probs": m["probs"][idx].clone(),
                "ids": m["greedy"][idx].clone(),
                "out_lens": m["out_lens"][idx].clone(),
                "batch": {k: batch[k][rows] for k in
                          ("audio", "audio_scale", "audio_lengths")
                          if k in batch}}
        n = batch["audio_lengths"][valid]
        return {"audio_s": float(n.sum()) / self.cfg["sample_rate"],
                "samples": [int(x) for x in n], "decode_s": decode_s,
                "failed": int((~np.isfinite(per[valid])).sum())}

    def warm_up(self):
        self.pipeline(traffic.stream(self.mix, self.ctx.seed, self.PASSES))
        for _ in range(self.n_bins):
            self.pipe.step()

    def run_window(self):
        super().run_window()
        self.sample = self._gather()

    def _gather(self) -> tuple:
        """The kept rows on the host: (the program's rows, their wire
        batch padded to the widest)."""
        rows, wires = [], []
        for b in sorted(self.kept):
            k = self.kept[b]
            probs, ids = k["probs"].cpu().numpy(), k["ids"].cpu().numpy()
            lens = k["out_lens"].cpu().numpy()
            for j in range(len(lens)):
                rows.append({"probs": probs[j], "ids": ids[j],
                             "out_len": int(lens[j])})
            wires.append(k["batch"])
        self.kept = {}
        width = max(w["audio"].shape[1] for w in wires)
        audio = np.concatenate([np.pad(w["audio"], ((0, 0), (
            0, width - w["audio"].shape[1]))) for w in wires])
        batch = {"audio": audio, "audio_lengths": np.concatenate(
            [w["audio_lengths"] for w in wires])}
        if "audio_scale" in wires[0]:
            batch["audio_scale"] = np.concatenate(
                [w["audio_scale"] for w in wires])
        return rows, batch

    def reference(self, operand: str = "config"):
        """The reference's (log-posteriors, output lengths) of the sampled
        rows, numpy."""
        dev = self.ctx.device
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in self.sample[1].items()}
        lp, lens = ds2.posteriors(ds2.make_weights(self.cfg, self.ctx.seed,
                                                   dev), batch, self.cfg,
                                  self.operand(operand))
        return lp.cpu().numpy(), lens.cpu().numpy()

    def numbers(self, ref=None) -> dict:
        lp, lens = ref or self.reference()
        return check.eval_numbers(self.sample[0], lp, lens)

    def outcome(self) -> dict:
        return {"attempted": sum(len(r["samples"]) for r in self.records),
                "failed": sum(r["failed"] for r in self.records)}


Cell = EvalCell
