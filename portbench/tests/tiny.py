"""A copy of the benchmark with tiny cells that run on the CPU.

``make_copy(dst)`` copies ``portbench/`` and ``BENCHMARK.json`` into
``dst`` and adds, as new files and entries only, tiny configurations
(2 x BiGRU-16, f32), mixes (8 utterances of 1-3 s, batch 2) and cells,
``tiny-train`` and ``tiny-eval``, each with the committed limits of the
full cell of its entry. (In bf16 a model this small drifts past the
train cell's limits in three steps: the tiny cells run f32.)
"""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FULL = {"train": "train-gru800-b20-ls100",
        "eval": "eval-gru1600-b64-testclean"}
TINY = {"tiny-train": ("train", "float32"),
        "tiny-eval": ("eval", "float32")}


def _json(path):
    with open(path) as f:
        return json.load(f)


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_copy(dst: str) -> str:
    """-> ``dst``, holding the copy."""
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = _json(os.path.join(REPO, "BENCHMARK.json"))
    full = {w["name"]: w for w in bench["workloads"]}
    cfgs = {c["name"]: c for c in bench["configs"]}
    for name, (entry, dtype) in TINY.items():
        w = full[FULL[entry]]
        cfg = _json(os.path.join(REPO, cfgs[w["config"]]["file"]))
        cfg.update(hidden_size=16, hidden_layers=2, compute_dtype=dtype)
        _write(os.path.join(dst, "portbench", "configs", f"{name}.json"), cfg)
        bench["configs"].append({
            "name": name, "source": "https://arxiv.org/abs/1512.02595",
            "file": f"portbench/configs/{name}.json",
            "reduced": ["hidden_size", "hidden_layers"], "why": "tests"})
        mix = _json(os.path.join(REPO, "portbench", "traffic",
                                 f"{w['traffic']}.json"))
        mix.update(split_utterances=8, bins=4, batch=2, loader_workers=2,
                   duration_quantiles=[[0.0, 1.0], [1.0, 3.0]])
        _write(os.path.join(dst, "portbench", "traffic", f"{name}.json"),
               mix)
        bench["workloads"].append({"name": name, "config": name,
                                   "traffic": name, "chips": 1,
                                   "why": "tests"})
        shutil.copy(os.path.join(REPO, "portbench", "limits",
                                 f"{FULL[entry]}.json"),
                    os.path.join(dst, "portbench", "limits",
                                 f"{name}.json"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if FULL[entry] in m.get("workloads", ()):
                m["workloads"].append(name)
    _write(os.path.join(dst, "BENCHMARK.json"), bench)
    return dst
