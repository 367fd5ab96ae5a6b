"""The port's own spans (``deepspeech_tpu_torch/utils/trace.py``), read two
ways.

In the traced pass's device trace, with the port's recorder on, each span
is a ``ds.<name>`` range on the kernels' clock. ``analyse`` puts each
device op after the marker down to the chain of program spans that held
its launch, by the rule ``trace.py`` applies to the benchmark's hooks: a
span on the launching thread holds it (the innermost first, then the
spans around it); a backward node (``autograd::engine::evaluate_function:
...``) stands for the program span that held the forward op of its
sequence number; a backward span (``ds.rnn.bwd``, ``ds.ctc.bwd``, inside
such a node) holds its launches directly. The device's idle gaps go to
the innermost program span that holds each gap's middle on the loop's
thread (the one that opens ``ds.step``).

Over the untraced window, ``window`` reads the recorder's spans: host
wall, self and thread CPU ms a step by span name, and from them the
step's issue time, the loader threads' CPU and the decoder's work less
its read-back.
"""

from __future__ import annotations

from portbench.harness.trace import (BACKWARD, DEVICE_CATS, LAUNCH_CATS,
                                     MARKER, _Intervals, _union)

PREFIX = "ds."
OUTSIDE = "outside any span"


def _nested(items: list) -> dict:
    """{item: the item that encloses it, or None} of one thread's
    (start, end, name, key) intervals, which nest."""
    parent, stack = {}, []
    for it in sorted(items, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= it[0]:
            stack.pop()
        parent[it[3]] = stack[-1][3] if stack else None
        stack.append(it)
    return parent


def _chains(cpu: list):
    """-> ({tid: _Intervals of (start, end, name, key)}, {key: chain of
    names, innermost first}, the loop's thread id or None)."""
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"],
               e["name"][len(PREFIX):]) for e in cpu
              if e.get("cat") == "user_annotation"
              and e["name"].startswith(PREFIX)]
    by_tid: dict = {}
    for start, end, tid, name in ranges:
        by_tid.setdefault(tid, []).append((start, end, name))
    spans = {tid: _Intervals(v) for tid, v in by_tid.items()}
    seq_span = {}  # a forward op's sequence number -> its innermost span
    for e in cpu:
        args = e.get("args", {})
        seq = args.get("Sequence number")
        if (seq is None or args.get("Fwd thread id", 0) != 0
                or e["name"].startswith(BACKWARD) or e["tid"] not in spans):
            continue
        hit = spans[e["tid"]].inner(float(e["ts"]))
        if hit is not None:
            seq_span[seq] = hit[2]
    owners: dict = {tid: list(v) for tid, v in by_tid.items()}
    for e in cpu:
        seq = e.get("args", {}).get("Sequence number")
        if e["name"].startswith(BACKWARD) and seq in seq_span:
            owners.setdefault(e["tid"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 seq_span[seq]))
    loop = next((tid for _, _, tid, name in ranges if name == "step"), None)
    intervals, chain = {}, {}
    for tid, items in owners.items():
        keyed = [(s, e, n, (tid, i)) for i, (s, e, n) in enumerate(items)]
        parent = _nested(keyed)
        for s, e, n, key in keyed:
            names, k = [n], parent[key]
            while k is not None:
                names.append(owners[tid][k[1]][2])
                k = parent[k]
            chain[key] = tuple(names)
        intervals[tid] = _Intervals(keyed)
    return intervals, chain, loop


def analyse(events: list, steps: int) -> dict | None:
    """-> {"by_chain": {chain of span names: device ms a step}, "idle_ms":
    {innermost program span on the loop's thread: idle ms a step},
    "issue_idle_ms": idle ms a step whose gap's middle lies inside
    ``ds.step``}; None where the trace holds no program span."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    cpu = [e for e in xs if e.get("cat") in ("cpu_op", "user_annotation")]
    intervals, chain, loop = _chains(cpu)
    if loop is None:
        return None
    dev = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"], e.get("args", {}))
                  for e in xs if e.get("cat") in DEVICE_CATS),
                 key=lambda op: op[:2])
    t0 = [end for _, end, name, _ in dev if MARKER in name][-1]
    dev = [op for op in dev if op[0] > t0]
    launches = {e["args"]["correlation"]: (e["tid"], float(e["ts"]))
                for e in xs if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    by_chain: dict = {}
    for start, end, _, args in dev:
        launch = launches.get(args.get("correlation"))
        hit = None
        if launch is not None and launch[0] in intervals:
            hit = intervals[launch[0]].inner(launch[1])
        key = chain[hit[3]] if hit is not None else (OUTSIDE,)
        by_chain[key] = by_chain.get(key, 0.0) + end - start
    busy = _union(dev)
    gaps = [(t0, busy[0][0])] + [(a[1], b[0]) for a, b in zip(busy,
                                                                busy[1:])]
    on_loop = intervals[loop]
    idle: dict = {}
    issue = 0.0
    for start, end in gaps:
        hit = on_loop.inner((start + end) / 2)
        names = chain[hit[3]] if hit is not None else (OUTSIDE,)
        idle[names[0]] = idle.get(names[0], 0.0) + end - start
        issue += (end - start) * ("step" in names)
    ms = 1e3 * steps
    return {"by_chain": {k: v / ms for k, v in by_chain.items()},
            "idle_ms": {k: v / ms for k, v in idle.items()},
            "issue_idle_ms": issue / ms}


def under(a: dict, names) -> float:
    """Device ms a step of the ops whose chain holds any of ``names`` (a
    name ending in ``*`` matches by prefix)."""
    def hit(name):
        return any(name == n or (n.endswith("*") and name.startswith(n[:-1]))
                   for n in names)
    return sum(ms for key, ms in a["by_chain"].items()
               if any(hit(name) for name in key))


def innermost(a: dict) -> dict:
    """{innermost span: device ms a step}."""
    out: dict = {}
    for key, ms in a["by_chain"].items():
        out[key[0]] = out.get(key[0], 0.0) + ms
    return out


def window(spans: list, t0: float, seconds: float, steps: int) -> dict:
    """The recorder's spans that started inside the window (``t0`` and
    ``seconds`` on ``time.perf_counter``'s clock) -> {"wall_ms",
    "self_ms", "cpu_ms": {name: ms a step}, "host_issue_ms": mean wall ms
    of a ``step`` span, "loader_cpu_ms": thread CPU ms a step in
    ``loader.read`` and ``loader.collate``, "decode_work_ms": wall ms a
    step in ``decode`` less its ``decode.readback``}."""
    from deepspeech_tpu_torch.utils import trace

    lo, hi = int(t0 * 1e9), int((t0 + seconds) * 1e9)
    table = trace.summary([s for s in spans if lo <= s.start_ns < hi])
    out = {k: {n: r[k] / steps for n, r in table.items()}
           for k in ("wall_ms", "self_ms", "cpu_ms")}

    def total(key, *names):
        return sum(table[n][key] for n in names if n in table)

    step = table.get("step")
    out["host_issue_ms"] = step["wall_ms"] / step["count"] if step else None
    out["loader_cpu_ms"] = total("cpu_ms", "loader.read",
                                 "loader.collate") / steps
    out["decode_work_ms"] = (total("wall_ms", "decode")
                             - total("wall_ms", "decode.readback")) / steps
    return out
