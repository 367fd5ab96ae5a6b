"""What the entries share: the loader stream and its pipeline, the
traced pass and the release of the program's state.

An entry's cell (``entries/<entry>.py``) sets ``kind``, ``rate`` (its
end-to-end metric) and ``program_state``, and gives ``launch``,
``finish``, ``warm_up``, ``numbers`` and ``outcome``; its ``__init__``
makes the inputs (``data``) and the program (``model``).
"""

from __future__ import annotations

import gc

import torch

from portbench.harness import loop, program, trace, traffic


class Cell:
    kind = rate = ""
    program_state = ()  # the attributes holding the program, freed at release
    PASSES = 400  # the loader's stream: more passes than any window holds

    def __init__(self, ctx):
        self.ctx, self.cfg, self.mix = (ctx, ctx.cell["config"],
                                        ctx.cell["traffic"])
        self.n_bins = len(traffic.bins(self.mix))
        self.records = []
        self.window = None
        self.pipe = None
        self._it = None
        self.traced_samples, self.traced_steps = [], 0

    def pipeline(self, bins, span=loop.no_span) -> loop.Pipeline:
        """A pipeline over a new loader iterator of ``bins``."""
        self.close()
        self._it = iter(program.loader(self.data, self.cfg, self.mix, bins))
        self.pipe = loop.Pipeline(self.launch, self.finish, self._it, span)
        return self.pipe

    def close(self):
        if self._it is not None:
            self._it.close()
            self._it = None

    def run_window(self):
        self.window = loop.window(self.pipe, self.n_bins, self.ctx.seconds)
        self.records = self.window["records"]
        self.pipe.drain()
        self.close()

    def traced_pass(self) -> dict:
        """One uncounted step (the shortest bin), the marker, then a whole
        pass under the profiler -> the trace's analysis."""
        order = traffic.stream(self.mix, self.ctx.seed, 1)
        pipe = self.pipeline(traffic.bins(self.mix)[:1] + order,
                             trace.host_span)
        done = []

        def uncounted():
            pipe.step()
            pipe.drain()

        def one_pass():
            for _ in range(self.n_bins):
                done.append(pipe.step())
            done.append(pipe.drain())

        with trace.traced(self.model, self.ctx.layers):
            events = trace.record(uncounted, one_pass, self.ctx.tmp)
        self.close()
        done = [r for r in done if r is not None]
        self.traced_samples = [n for r in done for n in r["samples"]]
        self.traced_steps = len(done)
        return trace.analyse(events, len(done))

    def release(self):
        """The card's peak memory, then the program's state freed."""
        dev = self.ctx.device
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None)
        self.close()
        for name in self.program_state:
            setattr(self, name, None)
        self.pipe = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return peak

    def operand(self, operand: str) -> str | None:
        """The reference's operand rounding: "config" is the
        configuration's precision."""
        if operand != "config":
            return operand
        return "bfloat16" if self.cfg["compute_dtype"] == "bfloat16" else None
