"""Chunked overlap-save streaming for the CNN model family (the JAX
package's ``serve/streaming_cnn.py``).

A pure conv stack has a finite receptive field, so streaming is
overlap-save: keep a sliding window of spectrogram frames (the shared
front's ring, ``serve/streaming.py``), rerun the whole stack over the
window each chunk, and emit exactly the outputs whose receptive field is
final. No per-layer state is carried: the window is the state. Per-block
``bounds`` reproduce the conv zero padding at the utterance's start and
the masked zeros at its end, so a stack without squeeze-excitation emits
the batch forward's logits.

Squeeze-excitation (cnn_residual, cnn_jasper) averages over the whole
utterance, which no finite-lookahead stream can match mid-utterance.
``se_mode``:

* ``"running"`` (default): the gate from the running mean over every frame
  made final so far, per block (lagged per layer, so each contribution is
  a final value, counted once);
* ``"two_pass"``: the running gate for the incremental fragments, then at
  ``finish`` the retained audio through the batch ``featurize_batch``
  (K1) + ``ConvStack``: ``texts``, ``collected_logits`` and
  ``beam_texts`` are then the batch model's. Not for pool slots;
* ``"error"``: refuse SE stacks.

Receptive-field geometry is folded through the block specs: layer l maps
composite spans via LO -= A*p, HI += A*(d*(k-1) - p), A *= s. Emission lag
= ceil(HI/A) outputs; window context = max over layers of (A_l*LAG_l -
LO_l), so every emitted output and every running-SE contribution has its
true input span inside the window.
"""

from __future__ import annotations

import numpy as np
import torch

from deepspeech_tpu_torch.models.cnn import ConvStack, conv1d_out_length
from deepspeech_tpu_torch.ops import fp32_matmul
from deepspeech_tpu_torch.serve.streaming import (StreamingTranscriber,
                                                  _frontend_step, _Geometry)

__all__ = ["CNNStreamingTranscriber", "conv_stack_geometry"]


def conv_stack_geometry(blocks) -> list[tuple[int, int, int]]:
    """Per-layer composite (A_l, LO_l, HI_l): through layer l, output j
    reads input frames [A_l*j + LO_l, A_l*j + HI_l]."""
    a, lo, hi = 1, 0, 0
    out = []
    for spec in blocks:
        k = spec["kernel"]
        s = spec.get("stride", 1)
        p = spec.get("padding", 0)
        d = spec.get("dilation", 1)
        lo -= a * p
        hi += a * (d * (k - 1) - p)
        a *= s
        out.append((a, lo, hi))
    return out


class CNNStreamingTranscriber(StreamingTranscriber):
    """Streaming transcription over a ``ConvStack``: the surface of
    StreamingTranscriber (feed/finish/texts, greedy or device
    beam, LM fusion, pool slots) with the model-family hooks replaced."""

    def __init__(self, model: ConvStack, labels, *args,
                 se_mode: str = "running", **kw):
        if se_mode not in ("running", "two_pass", "error"):
            raise ValueError("se_mode must be running|two_pass|error, "
                             f"got {se_mode!r}")
        self.se_mode = se_mode
        super().__init__(model, labels, *args, **kw)
        self._has_se = any(b.se for b in model.blocks)

    # -- model-family hooks --------------------------------------------------

    def _validate_model(self, model):
        if not isinstance(model, ConvStack):
            raise ValueError(
                f"CNNStreamingTranscriber needs a ConvStack; "
                f"{type(model).__name__} should use StreamingTranscriber")
        if self.se_mode == "error" and any(b.se for b in model.blocks):
            raise ValueError(
                "this stack uses squeeze-excitation — an utterance-global "
                "average no finite-lookahead stream can reproduce exactly; "
                'pass se_mode="running" for the causal running-mean '
                "approximation")

    def _build_geometry(self, chunk_frames: int) -> _Geometry:
        self._layer_geo = conv_stack_geometry(self.model.specs)
        a_total, _, hi_total = self._layer_geo[-1]
        if chunk_frames % a_total:
            raise ValueError(f"chunk_frames must be a multiple of the "
                             f"stack's total stride {a_total}")
        ctx = 0
        for a_l, lo_l, hi_l in self._layer_geo:
            lag_l = max(-(-hi_l // a_l), 0)
            ctx = max(ctx, a_l * lag_l - lo_l)
        ctx = -(-ctx // a_total) * a_total
        self._emit_lag = max(-(-hi_total // a_total), 0)
        self._extra_delay = 0  # no lookahead FIFO in the conv family
        self._out_stride = a_total
        return _Geometry(chunk_frames=chunk_frames, hop=self.conf.hop,
                         n_fft=self.conf.n_fft,
                         emit=chunk_frames // a_total,
                         window_frames=chunk_frames + ctx)

    def _out_len(self, t_frames: int) -> int:
        n = t_frames
        for spec in self.model.specs:
            n = conv1d_out_length(n, spec["kernel"], spec.get("stride", 1),
                                  spec.get("padding", 0),
                                  spec.get("dilation", 1))
        return n

    def _init_model_carry(self, zeros) -> dict:
        carry = {}
        for i, spec in enumerate(self.model.specs):
            if self.model.blocks[i].se:
                carry[f"se_sum{i}"] = zeros(self.batch_size, spec["out"])
                carry[f"se_cnt{i}"] = zeros(self.batch_size)
        return carry

    def reset_slot_carry(self, s: int):
        for key, value in self._carry.items():
            if key.startswith(("se_sum", "se_cnt")):
                value[s] = 0.0

    # -- exact two-pass SE (se_mode="two_pass") -----------------------------

    def _two_pass_active(self) -> bool:
        return self.se_mode == "two_pass" and self._has_se

    def reset(self):
        super().reset()
        self._raw = []            # retained raw audio for the second pass
        self._exact = None        # (logits (B, T, C) f32, out_lens (B,))

    def feed(self, samples):
        if self._two_pass_active():
            s = np.asarray(samples, np.float32)
            self._raw.append(s[None, :] if s.ndim == 1 else s.copy())
        return super().feed(samples)

    def finish(self):
        if self._finished:
            return [""] * self.batch_size
        out = super().finish()
        if self._two_pass_active() and self._raw:
            self._run_second_pass(np.concatenate(self._raw, axis=1))
        return out

    @torch.inference_mode()
    def _run_second_pass(self, y: np.ndarray):
        """The batch forward over the retained utterance replaces the
        collected logits and texts (and the beam's basis)."""
        from deepspeech_tpu_torch.audio.features import featurize_batch
        from deepspeech_tpu_torch.decoders import GreedyDecoder

        audio = torch.from_numpy(y).to(self.device)
        lengths = torch.full((y.shape[0],), y.shape[1], dtype=torch.int64,
                             device=self.device)
        spect, frame_lengths = featurize_batch(audio, lengths, self.conf,
                                               normalize=self.normalize)
        logits, _, out_lens = self.model(spect, frame_lengths)
        logits = logits.float().cpu().numpy()
        out_lens = out_lens.cpu().numpy()
        self._exact = (logits, out_lens)
        dec = GreedyDecoder(self.labels.labels,
                            blank_index=self.labels.blank_index)
        strings, _ = dec.decode_ids(np.argmax(logits, -1), out_lens)
        self._texts = [s[0] for s in strings]

    def collected_logits(self) -> np.ndarray:
        if self._exact is not None:
            logits, out_lens = self._exact
            return logits[:, : int(out_lens.max())]
        return super().collected_logits()

    def beam_texts(self, top_paths: int = 1):
        if self._exact is None:
            return super().beam_texts(top_paths)
        # the exact pass: the one-shot device beam over its posteriors
        from deepspeech_tpu_torch.decoders import DeviceBeamCTCDecoder
        logits, out_lens = self._exact
        dec = DeviceBeamCTCDecoder(
            self.labels.labels, beam_width=self.beam_width,
            cutoff_top_n=self.cutoff_top_n, cutoff_prob=self.cutoff_prob,
            blank_index=self.labels.blank_index, lm_path=None,
            top_paths=top_paths, alpha=self.lm_alpha, beta=self.lm_beta,
            device=self.device)
        dec.lm = self.lm  # the stream's device LM
        probs = torch.softmax(torch.from_numpy(logits).to(self.device), -1)
        strings, _ = dec.decode(probs, torch.from_numpy(out_lens))
        return [list(s) for s in strings]

    def _forward(self, carry, audio, t_frames_total, t_out_total,
                 start_frames):
        del t_out_total  # each layer's hi bound follows from t_frames
        geo = self.geo
        fe, spect, _ = _frontend_step(
            carry, audio, t_frames_total, start_frames, geo=geo,
            normalize=self.normalize, window=self._window,
            frozen=self.frozen_norm is not None)
        wf = geo.window_frames
        w0 = fe["appended"] - wf              # global base of the window
        new_carry = dict(carry)
        new_carry.update(fe)
        x = spect
        lens = t_frames_total.clamp(max=1 << 27)
        k_chunk = geo.chunk_frames
        with fp32_matmul():
            for i, block in enumerate(self.model.blocks):
                a_l, _lo_l, hi_l = self._layer_geo[i]
                out_len = block.out_lengths(lens)
                lo = start_frames // a_l - w0 // a_l   # w0: a multiple of A
                hi = lo + out_len
                y, _ = block(x, lens, None, (lo, hi), defer_se=block.se)
                if block.se:
                    # running squeeze over this chunk's newly final slice
                    lag_l = max(-(-hi_l // a_l), 0)
                    e_l = k_chunk // a_l
                    s0 = wf // a_l - e_l - lag_l
                    sl = y[:, :, s0:s0 + e_l].float()
                    idx = s0 + torch.arange(e_l, device=y.device)[None, :]
                    v = ((idx >= lo[:, None]) & (idx < hi[:, None])).float()
                    se_sum = carry[f"se_sum{i}"] + (sl * v[:, None, :]).sum(-1)
                    se_cnt = carry[f"se_cnt{i}"] + v.sum(-1)
                    new_carry[f"se_sum{i}"] = se_sum
                    new_carry[f"se_cnt{i}"] = se_cnt
                    mean = se_sum / se_cnt.clamp(min=1.0)[:, None]
                    y = block.se_gate(mean)[:, :, None] * y
                    if (block.skip and x.shape[1] == y.shape[1]
                            and block.stride == 1):
                        y = y + x
                x, lens = y, out_len
            logits = self.model.fc(x).transpose(1, 2).float()
        e0 = wf // self._out_stride - geo.emit - self._emit_lag
        return new_carry, logits[:, e0:e0 + geo.emit]
