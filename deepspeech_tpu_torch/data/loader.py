"""Batch assembly and a prefetching loader (the JAX package's
``data/loader.py``, waveform batches only).

Every batch is padded up to a bucket boundary: audio lengths to a multiple
of ``audio_step`` samples, target lengths to a multiple of ``target_step``,
and the batch to exactly ``batch_size`` rows (short final bins get rows
with ``valid=0``). Each utterance's own reflection is written into its pad
region (``reflect_tail``), so the device featurizer's centred last frame
reads what a host reflect-pad gives. The default wire is int16 (audio
(B, S) int16 + audio_scale (B,) f32, descaled on the device by
``train/step.py``); float32 and mulaw8 are the other choices.

Loading overlaps device compute through a thread pool and a bounded
prefetch queue (reference train.py:664-667). ``stack_microbatches`` stacks
k same-shape batches for ``--steps-per-dispatch``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from deepspeech_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Padding policy."""
    audio_step: int = 16000   # samples; pad S to a multiple (1 s at 16 kHz)
    target_step: int = 50     # label ids; pad L to a multiple
    min_target: int = 50
    reflect_tail: int = 160   # n_fft // 2 of the STFT front end
    wire_dtype: str = "float32"  # "float32", "int16" or "mulaw8"

    def pad_to(self, n: int, step: int, lo: int = 0) -> int:
        return max(lo, step * -(-max(n, 1) // step))


def collate_batch(samples: list[dict], batch_size: int | None = None,
                  bucket: BucketSpec = BucketSpec()) -> dict:
    """samples: dataset dicts with 'audio', 'target', 'path'.

    -> numpy batch dict: audio (B, S) (+ audio_scale (B,) for the int16 and
    mulaw8 wires), audio_lengths (B,), targets (B, L), target_lengths,
    valid (B,), paths (list). B == batch_size; padded rows have valid=0
    and a 1-sample length. With no samples (a data shard's share of a
    short final bin) every row is padding, at the least bucket."""
    n = len(samples)
    b = batch_size or n
    tmax = max((len(s["target"]) for s in samples), default=0)
    l_pad = bucket.pad_to(tmax, bucket.target_step, bucket.min_target)
    targets = np.zeros((b, l_pad), np.int32)
    target_lengths = np.zeros(b, np.int32)
    valid = np.zeros(b, np.float32)
    paths = [s["path"] for s in samples] + [""] * (b - n)

    smax = max((s["audio"].shape[0] for s in samples), default=0)
    # keep room for the longest utterance's reflect tail
    s_pad = bucket.pad_to(smax + bucket.reflect_tail, bucket.audio_step)
    audio = np.zeros((b, s_pad), np.float32)
    audio_lengths = np.full(b, 1, np.int32)  # dummy rows: 1 sample
    for i, s in enumerate(samples):
        y = s["audio"]
        m = y.shape[0]
        audio[i, :m] = y
        audio_lengths[i] = m
        # numpy 'reflect' (edge sample excluded), as np.pad appends it
        tail = min(bucket.reflect_tail, s_pad - m, max(m - 1, 0))
        if tail > 0:
            audio[i, m:m + tail] = y[m - 2 - np.arange(tail)]
        t = s["target"][:l_pad]
        targets[i, :len(t)] = t
        target_lengths[i] = len(t)
        valid[i] = 1.0

    batch = {}
    if bucket.wire_dtype == "int16":
        scale = np.maximum(np.abs(audio).max(axis=1), 1e-9)
        q = np.rint(audio / scale[:, None] * 32767.0)
        batch["audio"] = q.astype(np.int16)
        batch["audio_scale"] = (scale / 32767.0).astype(np.float32)
    elif bucket.wire_dtype == "mulaw8":
        scale = np.maximum(np.abs(audio).max(axis=1), 1e-9)
        xn = audio / scale[:, None]
        v = np.sign(xn) * np.log1p(255.0 * np.abs(xn)) / np.log(256.0)
        batch["audio"] = np.rint(v * 127.0).astype(np.int8)
        batch["audio_scale"] = scale.astype(np.float32)
    elif bucket.wire_dtype == "float32":
        batch["audio"] = audio
    else:
        raise ValueError(f"unknown wire_dtype {bucket.wire_dtype!r}")
    batch.update(audio_lengths=audio_lengths, targets=targets,
                 target_lengths=target_lengths, valid=valid, paths=paths)
    return batch


class AudioDataLoader:
    """Iterates a sampler's index bins over a dataset with threaded loading
    and bounded prefetch. One pass is one epoch, or with ``iter_from`` the
    rest of one from a bin (mid-epoch resume, reference train.py:658)."""

    def __init__(self, dataset, sampler, batch_size: int | None = None,
                 bucket: BucketSpec = BucketSpec(), num_workers: int = 4,
                 prefetch: int = 2):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.bucket = bucket
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start_bin: int = 0):
        """The batches of the sampler's bins from ``start_bin`` on."""
        bins = list(self.sampler)[start_bin:]
        if not bins:
            return
        out: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def read(i):
            with trace.span("loader.read"):
                return self.dataset.__getitem__(i)

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for ids in bins:
                    if stop.is_set():
                        break
                    try:
                        samples = list(pool.map(read, ids))
                        with trace.span("loader.collate"):
                            batch = collate_batch(samples, self.batch_size,
                                                  self.bucket)
                        with trace.span("loader.put"):
                            out.put(("ok", batch))
                    except Exception as e:  # surface worker errors in-line
                        out.put(("err", e))
                        break
            out.put(("end", None))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                with trace.span("loader.wait"):
                    kind, item = out.get()
                if kind == "end":
                    break
                if kind == "err":
                    raise item
                yield item
        finally:
            stop.set()
            while thread.is_alive():  # drain so the producer can exit
                try:
                    out.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.1)


def stack_microbatches(group: list[dict], k: int) -> tuple[dict, np.ndarray]:
    """Stack k' <= k collated host batches (``paths`` removed) into one
    (k, B, ...) superbatch for ``--steps-per-dispatch`` (the JAX
    ``stack_microbatches``) -> (stacked, live (k,) bool).

    The audio and target axes are zero-padded to the group's widest, which
    is what ``collate_batch`` writes at the larger bucket (the pad past
    each row's reflect tail is zeros there too). Train-mode BatchNorm
    counts padding frames, so a widened batch does not give its narrow
    form's numbers: the train CLI groups same-shape batches only. A short
    group is filled with all-padding lanes under collate's dummy-row
    convention (zeros, lengths and scales 1), which ``live`` marks False
    and the step does not run."""
    if not group or len(group) > k:
        raise ValueError(f"stack_microbatches: {len(group)} batches for "
                         f"{k} lanes")
    mats: dict[str, list] = {key: [] for key in group[0] if key != "paths"}
    wides = {key: max(b[key].shape[-1] for b in group)
             for key in ("audio", "targets")}
    for b in group:
        for key, vs in mats.items():
            v = b[key]
            wide = wides.get(key)
            if wide and v.shape[-1] < wide:
                v = np.pad(v, [(0, 0)] * (v.ndim - 1)
                           + [(0, wide - v.shape[-1])])
            vs.append(v)
    for _ in range(k - len(group)):
        for key, vs in mats.items():
            ones = key in ("audio_lengths", "audio_scale")
            vs.append(np.ones_like(vs[0]) if ones else np.zeros_like(vs[0]))
    stacked = {key: np.stack(vs) for key, vs in mats.items()}
    return stacked, np.arange(k) < len(group)
