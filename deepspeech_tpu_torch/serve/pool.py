"""Continuous-batching streaming pool (the JAX package's ``serve/pool.py``):
independent stream lifecycles over one chunk step.

``StreamingTranscriber`` runs B lockstep streams; a server needs streams
that join and leave at any time. ``StreamPool`` keeps B *slots* riding the
batch dimension of the same fixed-shape chunk step and gives each slot its
own lifecycle:

* ``open()`` leases a free slot; the stream's frames begin at the next
  chunk boundary (the lane's ``start_frames``: every validity test of the
  step is stream-relative, so a previous tenant's frames mask to zero, and
  the recurrent / lookahead / SE state is zeroed on join);
* ``write(slot, samples)`` buffers audio; ``tick()`` advances every slot by
  one chunk (idle slots ride along masked, so a tick's device cost is
  constant);
* ``close(slot)`` marks the end of the stream: the pool appends the
  reflect tail, drains the pipeline over the next ticks and frees the slot
  once every output frame has been emitted.

An active slot with no buffered audio at tick time is silence-filled (the
stream clock keeps running; ``underruns[slot]`` counts it). Transcripts
are decoded incrementally with the lockstep runtime's greedy collapse.
CNN stacks always run ``se_mode="running"`` here.
"""

from __future__ import annotations

import numpy as np
import torch

from deepspeech_tpu_torch.serve.streaming import (_INT_SENTINEL,
                                                  StreamingTranscriber)
from deepspeech_tpu_torch.serve.streaming_cnn import CNNStreamingTranscriber

FREE, PENDING, ACTIVE, CLOSING = range(4)
# beam offsets pack (frame + 1) * 64 + char into int32: frames below 2^25
_IDX_CAP = (1 << 25) - 1


class StreamPool:
    """B-slot continuous batching around the streaming chunk step; the
    constructor of StreamingTranscriber with ``slots`` for
    ``batch_size``."""

    def __init__(self, model, labels, audio_conf=None,
                 normalize: str = "max_frame", chunk_frames: int = 96,
                 slots: int = 8, frozen_norm=None,
                 decoder: str = "greedy", beam_width: int = 16,
                 cutoff_top_n: int = 40, cutoff_prob: float = 1.0,
                 beam_max_len: int = 1000, collect_logits: bool = False,
                 lm_path: str | None = None, lm_alpha: float = 0.8,
                 lm_beta: float = 1.0):
        from deepspeech_tpu_torch.models.cnn import ConvStack
        cls = (CNNStreamingTranscriber if isinstance(model, ConvStack)
               else StreamingTranscriber)
        self._st = cls(
            model, labels, audio_conf=audio_conf, normalize=normalize,
            chunk_frames=chunk_frames, batch_size=slots,
            frozen_norm=frozen_norm, decoder=decoder, beam_width=beam_width,
            cutoff_top_n=cutoff_top_n, cutoff_prob=cutoff_prob,
            beam_max_len=beam_max_len, lm_path=lm_path, lm_alpha=lm_alpha,
            lm_beta=lm_beta)
        self.slots = slots
        self.labels = labels
        g = self._st.geo
        self._pad = g.n_fft // 2
        self._A = g.chunk_samples
        self._appended = 0          # the carry's frame counter, mirrored
        self._conv_base = -self._st._emit_lag
        self._ctx = self._st._extra_delay
        self._stride = self._st._out_stride  # input frames per output
        self.underruns = np.zeros(slots, np.int64)
        self._state = [FREE] * slots
        self._buf = [np.zeros(0, np.float32) for _ in range(slots)]
        self._tail = [np.zeros(0, np.float32) for _ in range(slots)]
        self._start = np.zeros(slots, np.int64)      # start_frames per slot
        self._t_frames = np.full(slots, _INT_SENTINEL, np.int64)
        self._t_out = np.full(slots, _INT_SENTINEL, np.int64)
        self._fed = np.zeros(slots, np.int64)        # real samples consumed
        self._total = np.full(slots, -1, np.int64)
        self._done_text = [None] * slots
        self._done_beam = [None] * slots
        # logits retention is opt-in: a long-running server would otherwise
        # keep every chunk's (B, E, C) block
        self._collect_logits = collect_logits
        self._logit_blocks: list[list] = [[] for _ in range(slots)]

    # -- lifecycle ---------------------------------------------------------

    def open(self) -> int:
        """Lease a free slot; raises RuntimeError when the pool is full."""
        st = self._st
        for s in range(self.slots):
            if self._state[s] == FREE:
                self._state[s] = PENDING
                self._buf[s] = np.zeros(0, np.float32)
                self._tail[s] = np.zeros(0, np.float32)
                self._t_frames[s] = _INT_SENTINEL
                self._t_out[s] = _INT_SENTINEL
                self._fed[s] = 0
                self._total[s] = -1
                st._n_emitted[s] = 0
                st._prev_id[s] = None
                st._texts[s] = ""
                self._done_text[s] = None
                self._done_beam[s] = None
                self._logit_blocks[s] = []
                self.underruns[s] = 0
                return s
        raise RuntimeError("StreamPool full")

    def write(self, slot: int, samples: np.ndarray) -> None:
        if self._state[slot] not in (PENDING, ACTIVE):
            raise RuntimeError(f"slot {slot} not writable")
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buf[slot] = np.concatenate([self._buf[slot], samples])

    def close(self, slot: int) -> None:
        """End of stream for this slot: its length becomes known and the
        reflect end pad is queued; the slot frees itself once drained."""
        if self._state[slot] not in (PENDING, ACTIVE):
            raise RuntimeError(f"slot {slot} not open")
        total = int(self._fed[slot] + len(self._buf[slot]))
        if total <= self._pad:
            raise ValueError(f"stream too short ({total} samples)")
        self._total[slot] = total
        t_total = 1 + total // self._st.geo.hop
        self._t_frames[slot] = t_total
        self._t_out[slot] = self._st._out_len(t_total)
        last = np.concatenate([self._tail[slot], self._buf[slot]])
        last = last[-(self._pad + 1):]
        reflect = last[-2::-1][: self._pad]
        self._buf[slot] = np.concatenate([self._buf[slot], reflect])
        if self._state[slot] == ACTIVE:
            self._state[slot] = CLOSING
        # a PENDING slot stays PENDING; tick() activates it straight into
        # CLOSING (its total is known), so short streams still get a lane

    def busy(self) -> bool:
        return any(s != FREE for s in self._state)

    def done(self, slot: int) -> bool:
        return self._done_text[slot] is not None

    def text(self, slot: int) -> str:
        return (self._done_text[slot] if self.done(slot)
                else self._st._texts[slot])

    def collected_logits(self, slot: int) -> np.ndarray:
        """(T_emitted, C) logits of this slot's current or last stream
        (with ``collect_logits``)."""
        rows = []
        for base, block in self._logit_blocks[slot]:
            for j in range(block.shape[0]):
                if 0 <= base + j < self._t_out[slot]:
                    rows.append(block[j])
        return np.stack(rows) if rows else np.zeros((0, 1), np.float32)

    # -- the tick ----------------------------------------------------------

    def _activate(self, s: int) -> None:
        """The stream of slot ``s`` starts at the current chunk boundary:
        its STFT tail, model state, beam and running norm are reset."""
        st, pad = self._st, self._pad
        self._start[s] = self._appended
        wave_tail = (self._buf[s][pad:0:-1] if len(self._buf[s]) > pad
                     else np.zeros(pad, np.float32))
        c = st._carry
        c["wave_tail"][s] = torch.from_numpy(
            np.ascontiguousarray(wave_tail)).to(c["wave_tail"].device)
        st.reset_slot_carry(s)
        if st._beam_state is not None:
            fresh = st._fresh_beam_state(1)
            for a, f in zip(st._beam_state, fresh):
                a[s] = f[0]
        if st.frozen_norm is None:
            for key in ("norm_sum", "norm_cnt", "norm_std_sum"):
                c[key][s] = 0.0
        self._state[s] = ACTIVE if self._total[s] < 0 else CLOSING

    def _take(self, s: int, chunk: np.ndarray) -> None:
        """Move up to one chunk of slot ``s``'s audio into ``chunk[s]``,
        silence-filling an active stream that runs short."""
        A, pad, state = self._A, self._pad, self._state[s]
        take = min(len(self._buf[s]), A)
        if take:
            chunk[s, :take] = self._buf[s][:take]
            # the last pad + 1 samples seen, for close()'s reflect pad
            joined = np.concatenate([self._tail[s], self._buf[s][:take]])
            self._tail[s] = joined[-(pad + 1):]
            self._buf[s] = self._buf[s][take:]
            self._fed[s] += take if state == ACTIVE else 0
        elif state == ACTIVE:
            self.underruns[s] += 1
            self._fed[s] += A  # silence-filled real time
        if state == ACTIVE and take < A:
            if take:
                self.underruns[s] += 1
                self._fed[s] += A - take  # silence completes the chunk
            # the stream the device saw ended with silence: close()'s
            # reflect pad mirrors that, not the audio before it
            joined = np.concatenate([self._tail[s],
                                     np.zeros(A - take, np.float32)])
            self._tail[s] = joined[-(pad + 1):]

    def tick(self) -> list[str]:
        """Advance every slot by one chunk. Returns the new text fragment
        per slot ('' for idle slots)."""
        st = self._st
        g = st.geo
        chunk = np.zeros((self.slots, self._A), np.float32)
        for s in range(self.slots):
            if self._state[s] == PENDING:
                ready = len(self._buf[s]) >= self._A or (
                    self._total[s] >= 0 and len(self._buf[s]) > 0)
                if not ready:
                    continue
                self._activate(s)
            if self._state[s] in (ACTIVE, CLOSING):
                self._take(s, chunk)

        active = np.array([x in (ACTIVE, CLOSING) for x in self._state])
        t_frames = np.where(active, self._t_frames, 0)
        t_out = np.where(active, self._t_out, 0)
        anchor = self._conv_base - self._ctx
        base_rel = anchor - self._start // self._stride          # (slots,)
        idx = base_rel[:, None] + np.arange(g.emit, dtype=np.int64)[None, :]
        valid = (active[:, None] & (idx >= 0) & (idx < t_out[:, None])
                 & (idx <= _IDX_CAP))
        logits = st.advance(chunk, t_frames, t_out, self._start,
                            np.clip(idx, -1, _IDX_CAP), valid)
        self._appended += g.chunk_frames
        self._conv_base += g.emit

        frags = [""] * self.slots
        for s in np.flatnonzero(active).tolist():
            if self._collect_logits:
                self._logit_blocks[s].append((int(base_rel[s]), logits[s]))
            frags[s] = st._greedy(s, logits[s], int(base_rel[s]),
                                  int(self._t_out[s]))
            st._texts[s] += frags[s]
            if (self._state[s] == CLOSING
                    and st._n_emitted[s] >= self._t_out[s]):
                self._done_text[s] = st._texts[s]
                if st._beam_state is not None:
                    self._done_beam[s] = self.beam_text(s)
                self._state[s] = FREE
        if not self.busy():
            # idle: rebase the frame counters so a long-running pool never
            # overflows the stream-relative index arithmetic
            self._appended = 0
            self._conv_base = -st._emit_lag
            self._start[:] = 0
            st._carry["appended"] = 0
        return frags

    def beam_text(self, slot: int) -> str:
        """Best beam hypothesis of this slot (decoder="beam"): the finished
        stream's final beam once done, else the current best."""
        if self._done_beam[slot] is not None:
            return self._done_beam[slot]
        from deepspeech_tpu_torch.decoders.beam_device import beam_state_best
        st = self._st
        prefixes, lens, _, _ = beam_state_best(
            st._beam_state, 1, lm=st.lm, space=st._lm_space,
            alpha=st.lm_alpha, beta=st.lm_beta)
        n = int(lens[slot, 0])
        ids = prefixes[slot, 0, :n].cpu().numpy()
        return "".join(self.labels.labels[int(x)] for x in ids)

