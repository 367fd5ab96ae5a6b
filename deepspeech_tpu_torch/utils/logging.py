"""Metrics logging: JSONL stream + optional TensorBoard (the JAX package's
``utils/logging.py``, with the same event names and keys).

The replacement for the reference's visdom/tensorboardX plot windows
(reference train.py:155-314): the same three streams — per-epoch train
loss/WER/CER, per-checkpoint val, optional trainval — plus the LR-finder
points (loss vs LR, train.py:254-314) and param/grad summaries
(``--log-params``, train.py:247-251), written as one JSONL event log that
any plotting front-end can tail, and mirrored to TensorBoard when enabled.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir: str | None = None, run_id: str = "run",
                 tensorboard: bool = False, enabled: bool = True,
                 live_html: bool = False):
        self.enabled = enabled
        self.log_dir = log_dir
        self.run_id = run_id
        self._file = None
        self._tb = None
        # --visdom realization: a live self-refreshing HTML dashboard
        # (utils/liveplot.py) instead of the reference's visdom server
        self._live = None
        self._live_path = None
        self._live_last = 0.0
        if not enabled:
            return
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, f"{run_id}.jsonl"), "a")
            if live_html:
                self._live = {"train": [], "epoch": {}, "val": {}}
                self._live_path = os.path.join(log_dir, f"{run_id}.html")
        if tensorboard and log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(log_dir, run_id))
            except Exception:
                self._tb = None

    def _render_live(self, force: bool):
        now = time.time()
        if not force and now - self._live_last < 2.0:
            return
        self._live_last = now
        from deepspeech_tpu_torch.utils.liveplot import render_dashboard
        live = self._live
        epochs = sorted(set(live["epoch"]) | set(live["val"]))
        val_e = sorted(live["val"])
        state = {
            "train_steps": [r[0] for r in live["train"]],
            "train_loss": [r[1] for r in live["train"]],
            "train_avg": [r[2] for r in live["train"]],
            "epochs": epochs,
            "epoch_loss": [live["epoch"].get(e) for e in epochs],
            "val_loss": [live["val"][e][0] if e in live["val"] else None
                         for e in epochs],
            "val_epochs": val_e,
            "val_wer": [live["val"][e][1] for e in val_e],
            "val_cer": [live["val"][e][2] for e in val_e],
        }
        try:
            render_dashboard(self._live_path, self.run_id, state)
        except OSError:
            pass  # a failed dashboard write must never kill training

    def log(self, event: str, step: int | None = None, **fields):
        if not self.enabled:
            return
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        if step is not None:
            rec["step"] = step
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._tb and step is not None:
            for k, v in fields.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{event}/{k}", v, step)
        if self._live is not None and step is not None:
            if event == "train" and "loss" in fields:
                self._live["train"].append(
                    (step, float(fields["loss"]),
                     float(fields.get("avg_loss", fields["loss"]))))
                self._render_live(force=False)
            elif event == "epoch" and "loss" in fields:
                self._live["epoch"][step] = float(fields["loss"])
                self._render_live(force=True)
            elif event in ("val", "val_checkpoint") and "wer" in fields:
                self._live["val"][step] = (
                    float(fields.get("loss", float("nan"))),
                    float(fields["wer"]), float(fields["cer"]))
                self._render_live(force=True)

    def log_params(self, params: dict, grads: dict | float | None,
                   step: int):
        """Per-tensor L2 norms of ``params`` and the global norm of
        ``grads`` to JSONL (cheap, always), plus full parameter histograms
        to TensorBoard when enabled — the reference's ``--log-params``
        behavior (train.py:247-251). Both are the JAX package's trees of
        arrays (``convert.torch_to_jax``), so the tensor names are its
        ``conv/conv0/kernel``, ..., and the norms of the same weights are
        the same; ``grads`` may also be the step's grad norm itself, as
        ``--steps-per-dispatch`` logs it (the JAX CLI's float)."""
        if not self.enabled:
            return
        import numpy as np

        from deepspeech_tpu_torch.convert import tree_items

        named = {"/".join(path): leaf for path, leaf in tree_items(params)}
        norms = {name: float(np.linalg.norm(np.asarray(leaf)))
                 for name, leaf in named.items()}
        grad_norm = None
        if isinstance(grads, float):
            grad_norm = grads
        elif grads is not None:
            grad_norm = float(np.sqrt(sum(
                float(np.sum(np.square(np.asarray(g, np.float64))))
                for _, g in tree_items(grads))))
        self.log("params", step=step, grad_norm=grad_norm, norms=norms)
        if self._tb:
            for name, leaf in named.items():
                self._tb.add_histogram(name, np.asarray(leaf), step)

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
        if self._tb:
            self._tb.close()
            self._tb = None


class Observer:
    """Training-event hook base (the reference's cleaner-but-dead pattern,
    observer.py:8-22, revived as the extension point)."""

    def on_epoch_start(self, epoch: int, **kw): ...
    def on_epoch_end(self, epoch: int, **kw): ...
    def on_batch_start(self, epoch: int, iteration: int, **kw): ...
    def on_batch_end(self, epoch: int, iteration: int, **kw): ...
    def on_checkpoint(self, epoch: int, iteration: int, path: str, **kw): ...


class ObserverList:
    def __init__(self, observers=()):
        self.observers = list(observers)

    def emit(self, hook: str, *args, **kw):
        for ob in self.observers:
            getattr(ob, hook)(*args, **kw)
