"""Hand-written CUDA kernels for Hopper (``csrc/``) and their wrappers.

Each wrapper module of ``COUNTED`` counts its kernel's launches in
module-level integers whose names end in ``launches``, one where it issues
a launch; ``read_counters`` finds and reads them all and ``add_counters``
moves them, as the CUDA graphs of the train step do (``train/graph.py``: a
launch issued under capture runs once per replay). A new counter needs no
list of its own: its name is enough. ``attention`` is the port's
attention route (``ops/attention.py``), beside this package: a library
kernel's wrapper, counted as the others are."""

from __future__ import annotations

import importlib

COUNTED = ("stft", "gru", "lstm", "ctc", "topk", "attention")
BESIDE = ("attention",)  # modules of ``ops`` rather than of ``ops.cuda``


def _module(name: str):
    package = __name__.rpartition(".")[0] if name in BESIDE else __name__
    return importlib.import_module(f"{package}.{name}")


def read_counters() -> dict:
    """{(module, attribute): launches} of every wrapper's counters."""
    out = {}
    for m in COUNTED:
        mod = _module(m)
        out.update(((m, a), n) for a, n in sorted(vars(mod).items())
                   if a.endswith("launches") and type(n) is int)
    return out


def add_counters(delta: dict) -> None:
    """Add ``delta`` ({(module, attribute): n}) to the counters."""
    for (m, a), n in delta.items():
        mod = _module(m)
        setattr(mod, a, getattr(mod, a) + n)


def reset_counters() -> None:
    """Every counter to 0."""
    add_counters({c: -n for c, n in read_counters().items()})
