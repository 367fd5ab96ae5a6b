"""Chunked streaming inference for unidirectional DeepSpeech2 (the JAX
package's ``serve/streaming.py``).

Audio arrives in fixed-size chunks; one chunk step advances the whole
pipeline (STFT -> normalize -> conv front -> unidirectional RNN stack ->
lookahead -> head) and carries every piece of sequential state as tensors
on the stream's device (the model's):

* ``wave_tail``  the n_fft - hop samples before the chunk (STFT framing);
* ``mag_buf``    raw magnitude frames covering the conv front's receptive
                 field, so each chunk emits exactly the conv outputs whose
                 inputs are final;
* ``rnn_h/rnn_c`` per-layer recurrent state;
* ``la_buf``     the lookahead FIFO (``context`` frames of future delay);
* the running normalization scalars: every normalize mode reduces to
  per-utterance scalars, so the stream keeps running means of per-frame
  statistics. ``frozen_norm`` pins them instead, which makes the stream's
  logits equal the batch forward's.

The chunk's |STFT| is K1 (``ops/cuda/stft.py:stft_mag``, ``center=False``),
the kernel of the batch front, frame for frame. The recurrence over a
chunk's frames is plain PyTorch, as the JAX package runs it as an XLA scan
outside any Pallas kernel. With ``decoder="beam"`` each chunk step is the
model step, then ``ctc_beam_continue`` on the same stream (K10 once a
frame), with no host synchronisation between the two.

Emission is exact: a chunk's conv outputs are emitted once every input
frame of their receptive field is final (an 8-output lag), and the
lookahead delays emission by ``context`` more outputs. Algorithmic latency
is 16 input frames + ``context`` conv outputs, plus the chunk period.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deepspeech_tpu_torch.audio.features import N_BINS, AudioConf, make_window
from deepspeech_tpu_torch.models.layers import hardtanh_0_20
from deepspeech_tpu_torch.ops import fp32_matmul
from deepspeech_tpu_torch.ops.cuda import stft as stft_kernel

_INT_SENTINEL = np.int64(2 ** 31 - 1)

# conv-front geometry: conv1 k_t=11 pad 5 stride 2, conv2 k_t=11 pad 5
# stride 1 -> conv2 output t reads input frames [2t-15, 2t+15]; 16-frame
# margins keep everything even-aligned.
_CTX_F = 32          # input-frame context kept left of each chunk
_EMIT_LAG_OUT = 8    # first emitted conv output of a window (= _CTX_F/4)


def bn_inference(bn, x: torch.Tensor) -> torch.Tensor:
    """A TorchBatchNorm's inference transform over x's last axis, from its
    running stats whatever the module's mode."""
    inv = torch.rsqrt(bn.running_var + bn.eps)
    return (x - bn.running_mean) * (inv * bn.weight) + bn.bias


def _gru_step(h, xp, w_hh, b_hh):
    """xp: x @ W_ih + b_ih, (B, 3H); h: (B, H). The JAX ``_gru_step`` in
    seven launches: r and z share one sigmoid, (1 - z) * n + z * h is a
    lerp."""
    hidden = h.shape[-1]
    hp = torch.addmm(b_hh, h, w_hh)
    rz = torch.sigmoid(xp[:, :2 * hidden] + hp[:, :2 * hidden])
    n = torch.tanh(torch.addcmul(xp[:, 2 * hidden:], rz[:, :hidden],
                                 hp[:, 2 * hidden:]))
    return torch.lerp(n, h, rz[:, hidden:])


def _lstm_step(h, c, xp, w_hh, b_hh):
    hidden = h.shape[-1]
    gates = torch.addmm(b_hh, h, w_hh) + xp
    sg = torch.sigmoid(gates)  # i, f, o (g's block unused)
    g = torch.tanh(gates[:, 2 * hidden:3 * hidden])
    c = torch.addcmul(sg[:, hidden:2 * hidden] * c, sg[:, :hidden], g)
    return sg[:, 3 * hidden:] * torch.tanh(c), c


def _rnn_step(h, xp, w_hh, b_hh):
    return torch.tanh(torch.addmm(b_hh, h, w_hh) + xp)


@dataclass(frozen=True)
class _Geometry:
    chunk_frames: int        # K: input frames per chunk
    hop: int
    n_fft: int
    emit: int                # model outputs emitted per chunk
    window_frames: int       # K + the left context

    @property
    def chunk_samples(self) -> int:
        return self.chunk_frames * self.hop


class StreamingTranscriber:
    """Stateful streaming ASR over a unidirectional DeepSpeech2.

    model: the port's ``DeepSpeech2`` (``bidirectional=False``) with its
    weights, on the device the stream runs on (the runtime puts it in eval
    mode); labels: ``text.Labels``; normalize: any of the five modes;
    chunk_frames: input STFT frames per chunk (even); batch_size: lockstep
    streams riding the batch dimension; frozen_norm: optional (mean, std)
    arrays of shape (B,) pinning the normalization scalars (batch parity),
    None for the causal running statistics. ``decoder="beam"`` runs the
    streaming prefix beam search on the same device, LM-fused with
    ``lm_path``.
    """

    def __init__(self, model, labels, audio_conf: AudioConf | None = None,
                 normalize: str = "max_frame", chunk_frames: int = 96,
                 batch_size: int = 1, frozen_norm=None,
                 decoder: str = "greedy", beam_width: int = 16,
                 cutoff_top_n: int = 40, cutoff_prob: float = 1.0,
                 beam_max_len: int = 1000, lm_path: str | None = None,
                 lm_alpha: float = 0.8, lm_beta: float = 1.0):
        self._validate_model(model)
        if chunk_frames < 4:
            raise ValueError("chunk_frames must be >= 4")
        conf = audio_conf or AudioConf()
        if conf.n_fft != 2 * conf.hop:
            raise ValueError("streaming assumes 50%-overlap STFT framing "
                             "(n_fft == 2*hop)")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.labels = labels
        self.conf = conf
        self.normalize = normalize
        self.batch_size = batch_size
        self.frozen_norm = frozen_norm
        self._window = make_window(conf.window, conf.n_fft)
        self.geo = self._build_geometry(chunk_frames)
        if decoder not in ("greedy", "beam"):
            raise ValueError(f"decoder must be greedy|beam, got {decoder!r}")
        self.decoder = decoder
        self.beam_width = beam_width
        self.cutoff_top_n = cutoff_top_n
        self.cutoff_prob = float(cutoff_prob)
        self.beam_max_len = beam_max_len
        self.lm = None
        self.lm_alpha = float(lm_alpha)
        self.lm_beta = float(lm_beta)
        if lm_path and decoder == "beam":
            from deepspeech_tpu_torch.decoders.lm_device import load_device_lm
            self.lm = load_device_lm(lm_path, labels.labels, self.device)
        self._lm_space = (labels.labels.index(" ")
                          if " " in labels.labels else -1)
        self.reset()

    # -- model-family hooks (CNNStreamingTranscriber overrides these) -------

    def _validate_model(self, model):
        if not hasattr(model, "rnns"):
            raise ValueError(
                f"{type(model).__name__} is a CNN-family acoustic model — "
                "use serve.CNNStreamingTranscriber (chunked overlap-save "
                "conv streaming) instead of the DS2 recurrent runtime")
        if model.bidirectional:
            raise ValueError("streaming requires a unidirectional model "
                             "(lookahead head, reference model.py:329-333)")

    def _build_geometry(self, chunk_frames: int) -> _Geometry:
        if chunk_frames % 2:
            raise ValueError("chunk_frames must be even")
        self._emit_lag = _EMIT_LAG_OUT
        self._extra_delay = self.model.lookahead.context
        self._out_stride = 2  # input frames per conv output
        return _Geometry(chunk_frames=chunk_frames, hop=self.conf.hop,
                         n_fft=self.conf.n_fft, emit=chunk_frames // 2,
                         window_frames=chunk_frames + _CTX_F)

    def _out_len(self, t_frames: int) -> int:
        """Model output count of a t_frames-frame utterance."""
        return (t_frames - 1) // 2 + 1

    def _init_model_carry(self, zeros) -> dict:
        m, b = self.model, self.batch_size
        h, n = m.fc.in_features, len(m.rnns)
        return {"rnn_h": zeros(n, b, h), "rnn_c": zeros(n, b, h),
                "la_buf": zeros(b, m.lookahead.context, h)}

    def reset_slot_carry(self, s: int):
        """Zero one lane's model state in place (StreamPool slot reuse)."""
        c = self._carry
        c["rnn_h"][:, s] = 0.0
        c["rnn_c"][:, s] = 0.0
        c["la_buf"][s] = 0.0

    # -- stream lifecycle --------------------------------------------------

    def _fresh_beam_state(self, batch: int):
        from deepspeech_tpu_torch.decoders.beam_device import beam_state_init
        return beam_state_init(batch, self.beam_width, self.beam_max_len,
                               lm=self.lm, device=self.device)

    def reset(self):
        g, b, dev = self.geo, self.batch_size, self.device

        def zeros(*s):
            return torch.zeros(s, dtype=torch.float32, device=dev)

        self._carry = {
            "wave_tail": zeros(b, g.n_fft - g.hop),
            "mag_buf": zeros(b, N_BINS, g.window_frames),
            "norm_sum": zeros(b),
            "norm_cnt": zeros(b),
            "norm_std_sum": zeros(b),
            "appended": 0,  # frames appended so far, a host int
        }
        self._carry.update(self._init_model_carry(zeros))
        if self.frozen_norm is not None:
            mean, std = self.frozen_norm
            self._carry["norm_sum"] = torch.as_tensor(
                np.asarray(mean, np.float32)).to(dev)
            self._carry["norm_std_sum"] = torch.as_tensor(
                np.asarray(std, np.float32)).to(dev)
        # host bookkeeping
        self._buf = [np.zeros((self.batch_size, 0), np.float32)]
        self._started = False
        self._finished = False
        self._samples = 0
        self._conv_base = -self._emit_lag  # global idx of next emitted convs
        self._t_frames = np.full(self.batch_size, _INT_SENTINEL, np.int64)
        self._t_out = np.full(self.batch_size, _INT_SENTINEL, np.int64)
        self._prev_id = [None] * self.batch_size
        self._texts = [""] * self.batch_size
        self._logits: list[np.ndarray] = []   # per-step (B, E, C)
        self._anchor_bases: list[int] = []
        self._n_emitted = np.zeros(self.batch_size, np.int64)
        self._beam_state = None
        if self.decoder == "beam":
            self._beam_state = self._fresh_beam_state(self.batch_size)

    # -- feeding -----------------------------------------------------------

    def feed(self, samples: np.ndarray) -> list[str]:
        """Append raw waveform samples ((S,) for batch 1, else (B, S)) and
        run every complete chunk. Returns the newly decoded text fragment
        per stream."""
        if self._finished:
            raise RuntimeError("stream finished; call reset()")
        samples = np.asarray(samples, np.float32)
        if samples.ndim == 1:
            samples = samples[None, :]
        if samples.shape[0] != self.batch_size:
            raise ValueError("stream batch mismatch")
        self._buf.append(samples)
        self._samples += samples.shape[1]
        return self._drain_full_chunks()

    def finish(self) -> list[str]:
        """Flush: final (+1 reflected) STFT frame, conv drain, lookahead
        drain. Returns the final text fragment per stream."""
        if self._finished:
            return [""] * self.batch_size
        g = self.geo
        pad = g.n_fft // 2
        y = np.concatenate(self._buf, axis=1)
        total = self._samples
        if total <= pad:
            raise ValueError(f"stream too short ({total} samples)")
        t_total = 1 + total // g.hop
        self._t_frames[:] = t_total
        self._t_out[:] = self._out_len(t_total)
        # reflect end pad (np.pad mode="reflect"), enough for the final
        # centered frame; trailing zeros beyond it are masked invalid
        tail_src = y[:, -(pad + 1):]
        reflect = tail_src[:, -2::-1][:, :pad]
        self._buf.append(reflect)
        self._samples += pad
        out = self._drain_full_chunks()
        # drain with zero chunks until every stream has all t_out outputs
        while (self._n_emitted < self._t_out).any():
            zeros = np.zeros((self.batch_size, g.chunk_samples), np.float32)
            self._buf.append(zeros)
            self._samples += g.chunk_samples
            out = [a + b for a, b in zip(out, self._drain_full_chunks())]
        self._finished = True
        return out

    @property
    def texts(self) -> list[str]:
        return list(self._texts)

    def beam_texts(self, top_paths: int = 1):
        """Current best beam hypotheses (decoder="beam"): nested
        [stream][path] strings, mid-stream or after finish()."""
        if self._beam_state is None:
            raise RuntimeError('built with decoder="greedy"; '
                               'pass decoder="beam"')
        from deepspeech_tpu_torch.decoders.beam_device import beam_state_best
        prefixes, lens, _, _ = beam_state_best(
            self._beam_state, top_paths=top_paths, lm=self.lm,
            space=self._lm_space, alpha=self.lm_alpha, beta=self.lm_beta)
        prefixes, lens = prefixes.cpu().numpy(), lens.cpu().numpy()
        chars = self.labels.labels
        return [["".join(chars[int(x)] for x in prefixes[b, p, :lens[b, p]])
                 for p in range(top_paths)]
                for b in range(self.batch_size)]

    def collected_logits(self) -> np.ndarray:
        """(B, T_out, C) logits emitted so far (anchors >= 0 only)."""
        if not self._logits:
            return np.zeros((self.batch_size, 0, 1), np.float32)
        steps = []
        for base, block in zip(self._anchor_bases, self._logits):
            steps.append(block[:, max(0, -base):, :])
        full = np.concatenate(steps, axis=1)
        t = int(min(self._t_out.max(), full.shape[1]))
        return full[:, :t]

    # -- the chunk step ------------------------------------------------------

    def _as_long(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.minimum(a, _INT_SENTINEL).astype(
            np.int64)).to(self.device)

    @torch.no_grad()
    def advance(self, chunk: np.ndarray, t_frames: np.ndarray,
                t_out: np.ndarray, start: np.ndarray,
                beam_ts: np.ndarray | None = None,
                beam_valid: np.ndarray | None = None) -> np.ndarray:
        """One chunk step of every lane: (B, K*hop) samples, each lane's
        total frames and outputs (the sentinel while open) and its start
        frame -> (B, E, C) logits on the host. With the beam, the search
        then continues over the logits at frames ``beam_ts`` where
        ``beam_valid`` holds, on the device, before the logits are read."""
        dev = self.device
        args = (torch.from_numpy(np.ascontiguousarray(chunk)).to(dev),
                self._as_long(t_frames), self._as_long(t_out),
                self._as_long(start))
        if self._beam_state is not None:
            ts = torch.from_numpy(beam_ts.astype(np.int32)).to(dev)
            valid = torch.from_numpy(np.ascontiguousarray(beam_valid)).to(dev)
        self._carry, logits = self._forward(self._carry, *args)
        if self._beam_state is not None:
            from deepspeech_tpu_torch.decoders.beam_device import \
                ctc_beam_continue
            self._beam_state = ctc_beam_continue(
                self._beam_state, logits, ts, valid,
                blank=self.labels.blank_index,
                cutoff_top_n=self.cutoff_top_n, cutoff_prob=self.cutoff_prob,
                lm=self.lm, space=self._lm_space, alpha=self.lm_alpha,
                beta=self.lm_beta)
        return logits.cpu().numpy()

    def _forward(self, carry, audio, t_frames_total, t_out_total,
                 start_frames):
        return _chunk_step(carry, audio, t_frames_total, t_out_total,
                           start_frames, model=self.model, geo=self.geo,
                           normalize=self.normalize, window=self._window,
                           frozen=self.frozen_norm is not None)

    # -- internals ---------------------------------------------------------

    def _drain_full_chunks(self) -> list[str]:
        g = self.geo
        frags = [""] * self.batch_size
        while True:
            buf = np.concatenate(self._buf, axis=1) if len(self._buf) > 1 \
                else self._buf[0]
            self._buf = [buf]
            need = g.chunk_samples
            if buf.shape[1] < need:
                return frags
            chunk, rest = buf[:, :need], buf[:, need:]
            if not self._started:
                # librosa-centered stream start: wave_tail = the reflect
                # prefix of the padded signal (y[pad:0:-1])
                pad = g.n_fft - g.hop
                self._carry["wave_tail"] = torch.from_numpy(
                    np.ascontiguousarray(chunk[:, pad:0:-1])).to(self.device)
                self._started = True
            self._buf = [rest]
            frags = [a + b for a, b in zip(frags, self._run_chunk(chunk))]

    def _run_chunk(self, chunk: np.ndarray) -> list[str]:
        g = self.geo
        anchor_base = self._conv_base - self._extra_delay
        idx = anchor_base + np.arange(g.emit, dtype=np.int64)[None, :]
        valid = (idx >= 0) & (idx < self._t_out[:, None])
        logits = self.advance(chunk, self._t_frames, self._t_out,
                              np.zeros(self.batch_size, np.int64),
                              np.broadcast_to(idx, valid.shape), valid)
        self._conv_base += g.emit
        self._logits.append(logits)
        self._anchor_bases.append(anchor_base)
        frags = []
        for b in range(self.batch_size):
            s = self._greedy(b, logits[b], anchor_base, self._t_out[b])
            self._texts[b] += s
            frags.append(s)
        return frags

    def _greedy(self, b: int, logits: np.ndarray, base: int,
                t_out: int) -> str:
        """Greedy collapse of one lane's (E, C) block at frames base + j,
        carrying the previous id across chunks."""
        blank = self.labels.blank_index
        chars = self.labels.labels
        ids = logits.argmax(-1)
        frag = []
        for j, cid in enumerate(ids.tolist()):
            idx = base + j
            if idx < 0 or idx >= t_out:
                continue
            self._n_emitted[b] = max(self._n_emitted[b], idx + 1)
            prev = self._prev_id[b]
            if cid != blank and not (prev is not None and cid == prev
                                     and idx != 0):
                frag.append(chars[cid])
            self._prev_id[b] = cid
        return "".join(frag)


# ---------------------------------------------------------------------------
# the chunk step
# ---------------------------------------------------------------------------

def _frontend_step(carry, audio, t_frames_total, start_frames, *,
                   geo: _Geometry, normalize: str, window: np.ndarray,
                   frozen: bool):
    """The shared streaming front: K new STFT frames (K1) into the
    magnitude ring + the running normalization scalars. The DS2 chunk step
    and the CNN-family step both ride it. Returns (carry updates,
    normalized spect window (B, 161, W), frame validity (B, W))."""
    k = geo.chunk_frames
    w = geo.window_frames
    b = audio.shape[0]
    dev = audio.device

    sig = torch.cat([carry["wave_tail"], audio], dim=-1)
    mag = stft_kernel.stft_mag(sig, geo.n_fft, geo.hop, window,
                               center=False)                   # (B, bins, K)
    n_bins = geo.n_fft // 2 + 1
    if n_bins < N_BINS:   # mirror-fill, as the batch front
        out = mag.new_zeros((b, N_BINS, mag.shape[-1]))
        out[:, :n_bins] = mag
        out[:, 81:] = torch.flip(out[:, 1:81], dims=(1,))
        mag = out
    else:
        mag = mag[:, :N_BINS]

    appended = carry["appended"] + k
    mag_buf = torch.cat([carry["mag_buf"][..., k:], mag], dim=-1)

    # stream-relative frame index of every buffer slot, (B, W)
    g_idx = appended - w + torch.arange(w, device=dev)
    g_rel = g_idx[None, :] - start_frames[:, None]
    valid_f = (g_rel >= 0) & (g_rel < t_frames_total[:, None])
    new_valid = valid_f[:, -k:].float()

    scale = 1048576.0 if normalize == "max_frame" else 1.0
    lg_new = torch.log1p(mag * scale)
    if frozen:
        norm_sum, norm_cnt = carry["norm_sum"], carry["norm_cnt"]
        norm_std = carry["norm_std_sum"]
        mean_scalar, std_scalar = norm_sum, norm_std
    else:
        fm = lg_new.mean(dim=1)                                # (B, K)
        norm_sum = carry["norm_sum"] + (fm * new_valid).sum(-1)
        norm_cnt = carry["norm_cnt"] + new_valid.sum(-1)
        if normalize == "norm":
            # the per-frame std over frequency is shift-invariant, so the
            # batch path's std of (x - mean) equals the std of x
            fmean = lg_new.mean(dim=1, keepdim=True)
            var = ((lg_new - fmean) ** 2).sum(dim=1) / (N_BINS - 1)
            norm_std = carry["norm_std_sum"] + (torch.sqrt(var)
                                                * new_valid).sum(-1)
        else:
            norm_std = carry["norm_std_sum"]
        cnt = norm_cnt.clamp(min=1.0)
        mean_scalar = norm_sum / cnt
        std_scalar = norm_std / cnt
    lg_buf = torch.log1p(mag_buf * scale)
    if normalize in ("mean", "frame", "max_frame"):
        spect = lg_buf - mean_scalar[:, None, None]
    elif normalize == "norm":
        spect = ((lg_buf - mean_scalar[:, None, None])
                 / std_scalar.clamp(min=1e-6)[:, None, None])
    elif not normalize or normalize == "none":
        spect = lg_buf
    else:
        raise ValueError(f"No such normalization: {normalize}")
    spect = spect * valid_f[:, None, :].float()

    fe = dict(wave_tail=audio[:, -(geo.n_fft - geo.hop):],
              mag_buf=mag_buf, norm_sum=norm_sum, norm_cnt=norm_cnt,
              norm_std_sum=norm_std, appended=appended)
    return fe, spect, valid_f


def _chunk_step(carry, audio, t_frames_total, t_out_total, start_frames, *,
                model, geo: _Geometry, normalize: str, window: np.ndarray,
                frozen: bool):
    """One streaming step: (carry, (B, K*hop) samples) -> (carry,
    (B, K/2, C) logits anchored ``context`` conv outputs in the past).

    ``start_frames`` (B,) (even): the global frame where each lane's stream
    begins, 0 for lockstep streams; the pool points it at the chunk
    boundary where a stream joined its slot, so every validity test is
    stream-relative and stale frames of a previous tenant mask to zero."""
    e = geo.emit
    w = geo.window_frames
    b = audio.shape[0]
    dev = audio.device

    fe, spect, _ = _frontend_step(
        carry, audio, t_frames_total, start_frames,
        geo=geo, normalize=normalize, window=window, frozen=frozen)
    appended = fe["appended"]

    # ---- conv front over the window: the valid conv-output range [lo, hi)
    # makes conv2 read true zeros outside the utterance
    wp = (w - 1) // 2 + 1
    s_half = (appended - w) // 2          # global conv idx of local output 0
    start_half = start_frames // 2
    t_out_eff = t_out_total.clamp(max=2 ** 30)
    lo = (start_half - s_half).clamp(0, wp)
    hi = (t_out_eff + start_half - s_half).clamp(0, wp)
    x = model.conv(spect, hi, lo)                       # (B, 32, 41, W')
    x = x.reshape(b, -1, wp).transpose(1, 2)            # c*41 + f features
    x = x[:, _EMIT_LAG_OUT:_EMIT_LAG_OUT + e].float()

    out_base = (appended - w) // 2 + _EMIT_LAG_OUT
    o_idx = out_base + torch.arange(e, device=dev)
    o_rel = o_idx[None, :] - start_half[:, None]
    vmask = ((o_rel >= 0) & (o_rel < t_out_total[:, None])).float()  # (B, E)

    # ---- the unidirectional RNN stack with carried state: invalid steps
    # keep the state and emit zeros
    rnn_h, rnn_c = [], []
    y = x
    with fp32_matmul():
        for i, layer in enumerate(model.rnns):
            if i > 0:
                y = bn_inference(layer.bn, y)
            xp = y @ layer.w_ih[0] + layer.b_ih[0]     # (B, E, G*H)
            w_hh, b_hh = layer.w_hh[0], layer.b_hh[0]
            h, c = carry["rnn_h"][i], carry["rnn_c"][i]
            outs = []
            for j in range(e):
                v = vmask[:, j:j + 1]
                if layer.cell == "lstm":
                    hn, cn = _lstm_step(h, c, xp[:, j], w_hh, b_hh)
                    c = torch.lerp(c, cn, v)
                elif layer.cell == "gru":
                    hn = _gru_step(h, xp[:, j], w_hh, b_hh)
                else:
                    hn = _rnn_step(h, xp[:, j], w_hh, b_hh)
                h = torch.lerp(h, hn, v)  # v is 0 or 1: exact
                outs.append(h)
            rnn_h.append(h)
            rnn_c.append(c)
            y = torch.stack(outs, dim=1) * vmask[:, :, None]  # (B, E, H)

        # ---- lookahead FIFO (context-frame delay) and the head
        ctx = model.lookahead.context
        combined = torch.cat([carry["la_buf"], y], dim=1)  # (B, ctx+E, H)
        taps = torch.stack([combined[:, j:j + e] for j in range(ctx + 1)],
                           dim=2)                          # (B, E, ctx+1, H)
        la = hardtanh_0_20(torch.einsum("bejh,hj->beh", taps,
                                        model.lookahead.weight))
        a, sh = model.fc_bn(la)
        kernel = model.fc.weight.float().t()
        logits = la @ (a[:, None] * kernel) + sh @ kernel

    new_carry = dict(carry)
    new_carry.update(fe)
    new_carry.update(rnn_h=torch.stack(rnn_h), rnn_c=torch.stack(rnn_c),
                     la_buf=combined[:, e:])
    return new_carry, logits.float()
