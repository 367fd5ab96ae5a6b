"""Self-describing single-file checkpoints, in the JAX package's container.

A zip (the ``.npz`` layout) holding ``__meta__.json``, the package structure
with each array leaf replaced by ``{"__array__": i}``, plus one ``a{i}.npy``
entry per array. Loads run no code (no pickle). Each package reads and
resumes the other's files: the weights are the JAX trees (``params``,
``batch_stats``), which ``convert.py`` maps to and from the port's
state_dict, and ``optim_state`` is optax's leaf list
(``train/optim.py``).
"""

from __future__ import annotations

import io
import json
import os
import zipfile

import numpy as np

FORMAT_VERSION = "0.2.0-tpu"
_ARRAY_KEY = "__array__"
_META_ENTRY = "__meta__.json"


def package_from_model(model, meta: dict, labels: str, audio_conf: dict,
                       step: int = 0, epoch: int | None = None,
                       iteration: int | None = None,
                       avg_loss: float | None = None,
                       history: dict | None = None,
                       opt_state: dict | None = None,
                       checkpoint: int | None = None,
                       state_dict: dict | None = None) -> dict:
    """A checkpoint package of the port's model: the JAX trees of its
    weights and BatchNorm stats, the optimizer state as optax's leaves
    (``optim.to_optax_leaves``; None without ``opt_state``), the mid-epoch
    ``checkpoint`` id, and the JAX package's bookkeeping keys (``epoch`` is
    stored 1-based, as there; ``history`` holds the metric lists).
    ``state_dict`` replaces the model's own (a tensor-parallel model's,
    gathered whole by ``parallel.gather_state``, with ``opt_state``)."""
    from deepspeech_tpu_torch.convert import torch_to_jax
    from deepspeech_tpu_torch.train.optim import to_optax_leaves

    params, batch_stats = torch_to_jax(model.state_dict() if state_dict
                                       is None else state_dict)
    package = {"version": FORMAT_VERSION, "labels": labels,
               "audio_conf": dict(audio_conf), **meta, "params": params,
               "batch_stats": batch_stats,
               "optim_state": (None if opt_state is None
                               else to_optax_leaves(opt_state, model)),
               "step": int(step), "checkpoint": checkpoint}
    if epoch is not None:
        package["epoch"] = epoch + 1
    if iteration is not None:
        package["iteration"] = iteration
    if avg_loss is not None:
        package["avg_loss"] = float(avg_loss)
    if history:
        package.update({k: [float(x) for x in v] for k, v in history.items()})
    return package


def restore_params_only(package: dict, state):
    """The package's weights and BatchNorm stats into ``state.model``
    (``--finetune``, reference train.py:841); the optimizer state is left
    as it is. ``load_state_dict`` refuses a tensor whose name or shape
    does not fit the model."""
    from deepspeech_tpu_torch.convert import jax_to_torch

    sd = jax_to_torch(package["params"], package["batch_stats"])
    state.model.load_state_dict(sd)
    return state


def restore_state(package: dict, state):
    """The whole train state from a package of either package: weights and
    stats (``restore_params_only``), the optimizer state from optax's
    leaves (asserting their count and shapes, as the JAX
    ``restore_state`` does) and the step counter."""
    import torch

    from deepspeech_tpu_torch.train.optim import Optimizer, from_optax_leaves

    restore_params_only(package, state)
    kind = "sgd" if "trace" in state.opt_state else "adam"
    state.opt_state = from_optax_leaves(package["optim_state"], state.model,
                                        Optimizer(kind))
    state.step = torch.tensor(int(package.get("step", 0)), dtype=torch.int64,
                              device=state.step.device)
    return state


def _extract_arrays(obj, arrays: list):
    if isinstance(obj, np.ndarray):
        arrays.append(obj)
        return {_ARRAY_KEY: len(arrays) - 1}
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {str(k): _extract_arrays(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_extract_arrays(v, arrays) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"checkpoint leaf of unsupported type {type(obj)!r}")


def _insert_arrays(obj, arrays):
    if isinstance(obj, dict):
        if set(obj) == {_ARRAY_KEY}:
            return arrays[obj[_ARRAY_KEY]]
        return {k: _insert_arrays(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_insert_arrays(v, arrays) for v in obj]
    return obj


def save(path: str, package: dict):
    """Write ``package`` atomically (tmp file + rename)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays: list = []
    struct = _extract_arrays(package, arrays)
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr(_META_ENTRY, json.dumps(struct))
        for i, a in enumerate(arrays):
            buf = io.BytesIO()
            # np.asarray keeps 0-d leaves 0-d (ascontiguousarray would not)
            np.lib.format.write_array(buf, np.asarray(a, order="C"),
                                      allow_pickle=False)
            zf.writestr(f"a{i}.npy", buf.getvalue())
    os.replace(tmp, path)


def load(path: str) -> dict:
    """Read a checkpoint package (zip format only; no pickle)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic != b"PK":
        raise ValueError(f"{path} is not a zip checkpoint; legacy pickle "
                         "files are not read by the PyTorch port")
    with zipfile.ZipFile(path) as zf:
        struct = json.loads(zf.read(_META_ENTRY).decode("utf8"))
        names = set(zf.namelist())
        arrays = []
        while f"a{len(arrays)}.npy" in names:
            with zf.open(f"a{len(arrays)}.npy") as f:
                arrays.append(np.lib.format.read_array(f, allow_pickle=False))
    return _insert_arrays(struct, arrays)
