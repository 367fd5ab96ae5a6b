"""Finding a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, entry, layer or
per-layer metric is a file of its own, found by name:

* ``configs/<config>.json``: the model's sizes and precision (the path is
  the configuration's ``file`` in ``BENCHMARK.json``);
* ``traffic/<traffic>.json``: a mix's parameters, read by
  ``harness/traffic.py``; its ``entry`` names the file below;
* ``entries/<entry>.py``: the loop that drives one entry of the program;
* ``limits/<workload>.json``: each number the cell's check compares, with
  its limit;
* ``layers/*.json``: which modules' spans make a layer; files naming the
  same layer merge;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``.

Paths resolve from this file, so a copy of the benchmark's folder beside
its own ``BENCHMARK.json`` finds its own files.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def cell(bench: dict, workload: str) -> dict:
    """The workload's entry, with its configuration's file and its mix,
    limits and metrics read: {"workload", "config", "traffic", "limits",
    "end_to_end", "per_layer"}."""
    w = _named(bench["workloads"], workload, "workload")
    c = _named(bench["configs"], w["config"], "configuration")
    config = {**_json(os.path.join(ROOT, c["file"])), "name": c["name"]}
    traffic = {**_json(os.path.join(BENCH_DIR, "traffic",
                                    f"{w['traffic']}.json")),
               "name": w["traffic"]}

    def reported(m):
        return workload in m.get("workloads", [workload])

    return {"workload": w, "config": config, "traffic": traffic,
            "limits": _json(os.path.join(BENCH_DIR, "limits",
                                         f"{workload}.json")),
            "end_to_end": [m for m in bench["end_to_end"] if reported(m)],
            "per_layer": [m for m in bench["per_layer"] if reported(m)]}


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    """The module ``entries/<name>.py``."""
    return _module(os.path.join(BENCH_DIR, "entries", f"{name}.py"),
                   f"portbench_entry_{name}")


def reader(metric: str):
    """``read`` of ``metrics/<metric>.py``."""
    return _module(os.path.join(BENCH_DIR, "metrics", f"{metric}.py"),
                   f"portbench_metric_{metric.replace('.', '_')}").read


def layers() -> dict:
    """{layer name: [module name patterns]}, every file of ``layers/``
    merged by its ``layer``."""
    out: dict = {}
    for path in sorted(glob.glob(os.path.join(BENCH_DIR, "layers",
                                              "*.json"))):
        spec = _json(path)
        out.setdefault(spec["layer"], []).extend(spec["modules"])
    return out
