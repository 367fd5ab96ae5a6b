#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (deepspeech_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them. In order:

1. prints the card's name and power limit (nvidia-smi);
2. builds both CUDA kernels from csrc/ (one nvcc each, in parallel);
3. K1 (stft_mag) against its plain version at the main-path shape,
   20 x 120,000 samples: errors, kernel/plain/library ms, bound;
4. K2 (gru_fwd) against its plain version at full width, T 376, B 20,
   H 800, F 1312 and 800, unequal lengths, bf16 and f32; then the latency
   floor of its one-launch-per-step recurrence (an empty launch from a host
   loop, and the step kernel at the least work);
5. the main path: the default DS2 (6 x BiGRU-800, 30 classes) in bf16 from
   seeded random weights on 20 synthetic 7.5 s waveforms, featurize ->
   forward -> greedy ids, with both kernels' launch counts read around it
   and the logits held to the same model run through the plain versions;
   one forward under torch.profiler gives the device's busy and idle time
   from its trace timeline;
6. the transcribe CLI answers 3 requests (f32, as the JAX CLI runs);
7. prints one JSON line of kernel results, then the device line last.

No phase catches its own failure: a mismatch raises and the exit is
non-zero. Times are CUDA-event medians with warm L2.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
PEAK_F32 = 67e12        # H100 SXM, non-tensor f32 FLOP/s
PEAK_BF16 = 989e12      # H100 SXM, dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
REPLACES = {
    "stft_mag": "deepspeech_tpu/ops/pallas/stft_kernel.py:57",
    "gru_fwd": "deepspeech_tpu/ops/pallas/rnn_fused.py:95",
}
SOURCES = {
    "stft_mag": "deepspeech_tpu_torch/csrc/stft_mag.cu",
    "gru_fwd": "deepspeech_tpu_torch/csrc/gru_fwd.cu",
}
# Stated tolerances (kernel vs plain version, same inputs, on the card):
STFT_TOL = dict(rtol=1e-4, atol=1e-4)   # both true f32 FMA sums
GRU_TOL = {"float32": 1e-4,             # |h| <= 1; f32 sums in other orders
           "bfloat16": 5e-3}            # + bf16 rounding flips of h_prev
LOGIT_TOL = 2e-2                        # x max(1, max|logits|), bf16 forward


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=10, warmup=2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(flops: float, peak: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def synthetic_audio(rng, n: int, sr: int = 16000) -> np.ndarray:
    """Peak-normalized chirps plus noise, speech-like in level."""
    t = np.arange(n) / sr
    f0 = rng.uniform(100, 300)
    y = (np.sin(2 * np.pi * (f0 + 400 * t / t[-1]) * t)
         * (0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t))
         + 0.05 * rng.standard_normal(n))
    return (y / np.abs(y).max()).astype(np.float32)


def random_weights(model, rng) -> dict:
    """Seeded numpy weights in the JAX layout, then into the port's model
    through convert.py."""
    from deepspeech_tpu_torch.convert import jax_to_torch, torch_to_jax

    params, stats = torch_to_jax(model.state_dict())

    def fill(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v, path + (k,))
                continue
            name = "/".join(path + (k,))
            if k == "kernel" and v.ndim == 4:
                fan_in = v.shape[0] * v.shape[1] * v.shape[2]
                tree[k] = rng.standard_normal(v.shape) / np.sqrt(fan_in)
            elif k == "kernel":
                tree[k] = rng.standard_normal(v.shape) / np.sqrt(v.shape[0])
            elif k in ("w_ih", "b_ih", "w_hh", "b_hh"):
                s = 1.0 / np.sqrt(v.shape[-1] // 3)
                tree[k] = rng.uniform(-s, s, v.shape)
            elif k == "scale":
                tree[k] = rng.uniform(0.8, 1.2, v.shape)
            elif k == "mean":
                tree[k] = rng.uniform(-0.2, 0.2, v.shape)
            elif k == "var":
                tree[k] = rng.uniform(0.6, 1.4, v.shape)
            elif k == "bias":
                tree[k] = rng.uniform(-0.1, 0.1, v.shape)
            else:
                raise KeyError(f"no random init for {name}")
            tree[k] = tree[k].astype(np.float32)

    fill(params)
    fill(stats)
    model.load_state_dict(jax_to_torch(params, stats))
    return params, stats


@contextlib.contextmanager
def plain_path():
    """Route the model's two kernel calls to their plain versions."""
    from deepspeech_tpu_torch.ops.cuda import gru, stft

    saved = stft.stft_mag, gru.gru_layer

    def stft_plain(y, n_fft, hop, window, center=True):
        return stft.plain(y, n_fft, hop, window, center=center)

    stft.stft_mag, gru.gru_layer = stft_plain, gru.plain
    try:
        yield
    finally:
        stft.stft_mag, gru.gru_layer = saved


def phase_stft(torch, results):
    from deepspeech_tpu_torch.audio.features import make_window
    from deepspeech_tpu_torch.ops.cuda import stft

    rng = np.random.default_rng(SEED)
    b, s, n_fft, hop = 20, 120_000, 320, 160
    y = torch.from_numpy(np.stack([synthetic_audio(rng, s)
                                   for _ in range(b)])).cuda()
    win = make_window("hamming", n_fft)
    got = stft.stft_mag(y, n_fft, hop, win)
    ref = stft.plain(y, n_fft, hop, win)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    rel = (err / ref.abs().clamp(min=1e-6)).max().item()
    log(f"K1 stft_mag {tuple(got.shape)}: max_abs_err {err.max().item():.3e}"
        f" max_rel_err {rel:.3e}")
    torch.testing.assert_close(got, ref, **STFT_TOL)
    win_t = torch.from_numpy(win).cuda()
    ms = time_ms(lambda: stft.stft_mag(y, n_fft, hop, win), reps=20)
    plain_ms = time_ms(lambda: stft.plain(y, n_fft, hop, win), reps=20)
    lib_ms = time_ms(lambda: torch.stft(
        y, n_fft, hop, n_fft, win_t, center=True, pad_mode="reflect",
        return_complex=True).abs(), reps=20)
    frames, n_bins = b * got.shape[-1], got.shape[1]
    # The function is |STFT|. A real FFT of N points computes it exactly in
    # f32 with ~2.5 N log2 N operations, plus N for the window and 4 per bin
    # for the magnitude; this kernel's DFT spends 4 N n_bins instead.
    fft_flops = frames * (2.5 * n_fft * np.log2(n_fft) + n_fft + 4 * n_bins)
    dft_ms = 4.0 * frames * n_bins * n_fft / PEAK_F32 * 1e3
    nbytes = 4.0 * (b * s + frames * n_bins)
    bound_ms, by = bound(fft_flops, PEAK_F32, nbytes)
    log(f"K1 stft_mag: {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.stft "
        f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}; FFT operation "
        f"count); this design's DFT alone needs {dft_ms:.4f} ms of f32 FMA")
    results["stft_mag"] = dict(route="cuda", max_abs_err=err.max().item(),
                               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=by, library_ms=lib_ms)


def phase_gru(torch, results):
    from deepspeech_tpu_torch.ops.cuda import gru

    rng = np.random.default_rng(SEED + 1)
    t, b, h = 376, 20, 800
    lens = torch.from_numpy(np.linspace(t, 190, b).astype(np.int64)).cuda()
    for f_in in (1312, 800):
        s = 1.0 / np.sqrt(h)
        x32 = torch.from_numpy(rng.uniform(0, 1, (t, b, f_in)).astype(
            np.float32)).cuda()
        w_ih32 = torch.from_numpy(rng.uniform(-s, s, (2, f_in, 3 * h)).astype(
            np.float32)).cuda()
        w_hh32 = torch.from_numpy(rng.uniform(-s, s, (2, h, 3 * h)).astype(
            np.float32)).cuda()
        b_ih = torch.from_numpy(rng.uniform(-s, s, (2, 3 * h)).astype(
            np.float32)).cuda()
        b_hh = torch.from_numpy(rng.uniform(-s, s, (2, 3 * h)).astype(
            np.float32)).cuda()
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            args = (x32.to(dt), w_ih32.to(dt), b_ih, w_hh32.to(dt), b_hh,
                    lens)
            got = gru.gru_layer(*args)
            ref = gru.plain(*args)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            log(f"K2 gru_fwd {name} F={f_in}: max_abs_err {err:.3e} "
                f"(tolerance {GRU_TOL[name]})")
            if not err <= GRU_TOL[name]:
                raise AssertionError(f"gru_fwd {name} F={f_in} disagrees "
                                     f"with its plain version: {err}")
            ms = time_ms(lambda: gru.gru_layer(*args), reps=5)
            plain_ms = time_ms(lambda: gru.plain(*args), reps=3, warmup=1)
            cudnn = torch.nn.GRU(f_in, h, bidirectional=True,
                                 device="cuda", dtype=dt)
            for d, sfx in enumerate(("", "_reverse")):
                getattr(cudnn, "weight_ih_l0" + sfx).copy_(args[1][d].t())
                getattr(cudnn, "weight_hh_l0" + sfx).copy_(args[3][d].t())
                getattr(cudnn, "bias_ih_l0" + sfx).copy_(b_ih[d])
                getattr(cudnn, "bias_hh_l0" + sfx).copy_(b_hh[d])
            # torch flattens cuDNN weights in f16/f32/f64 only: the bf16
            # call also copies its weights into one buffer (and warns once)
            cudnn.flatten_parameters()
            lib_ms = time_ms(lambda: cudnn(args[0]), reps=5)
            n_valid = float(lens.sum().item())
            esize = 2 if dt == torch.bfloat16 else 4
            flops = 2.0 * 2 * n_valid * (f_in + h) * 3 * h
            nbytes = (esize * (t * b * f_in + 2 * (f_in + h) * 3 * h)
                      + 4 * (4 * 3 * h + 2 * t * b * h) + 8 * b)
            peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32
            bound_ms, by = bound(flops, peak, nbytes)
            log(f"K2 gru_fwd {name} F={f_in}: {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, cuDNN GRU {lib_ms:.3f} ms, bound "
                f"{bound_ms:.4f} ms ({by})")
            if f_in == 1312 and dt == torch.bfloat16:
                results["gru_fwd"] = dict(
                    route="cuda", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)
            del cudnn
    results["gru_fwd"]["floor"] = step_floor(torch)


def step_floor(torch) -> dict:
    """Latency floor of one recurrence step as gru_fwd issues them (one
    launch per step from a host loop): the gap between empty launches, and
    the step kernel at the least work (B 1, H 16: one block per direction,
    one dependent read of h_prev, one reduction), per step from the
    difference of T 376 and T 188 so the projection and set-up cancel."""
    from deepspeech_tpu_torch.ops.cuda import build, gru

    lib = build.load("gru_fwd")
    lib.empty_launches.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.empty_launches.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    n = 2256
    gap_ms = time_ms(lambda: build.check(
        lib, lib.empty_launches(n, stream), "empty launches"), reps=5) / n

    def tiny(t):  # the kernel's time does not depend on the values
        x = torch.full((t, 1, 16), 0.5, device="cuda")
        w_ih = torch.full((2, 16, 48), 0.01, device="cuda")
        w_hh = torch.full((2, 16, 48), 0.01, device="cuda")
        bias = torch.zeros(2, 48, device="cuda")
        lens = torch.full((1,), t, dtype=torch.int64, device="cuda")
        return time_ms(lambda: gru.gru_layer(x, w_ih, bias, w_hh, bias, lens),
                       reps=7)

    step_ms = (tiny(376) - tiny(188)) / 188
    log(f"K2 latency floor per step: empty launch {gap_ms * 1e3:.3f} us, "
        f"least-work step {step_ms * 1e3:.3f} us; x 2,256 steps of a "
        f"6 x BiGRU forward = {2256 * step_ms:.3f} ms")
    return dict(gap_ms=gap_ms, step_ms=step_ms)


def phase_forward(torch, counts, floor):
    from deepspeech_tpu_torch.audio.features import AudioConf, featurize_batch
    from deepspeech_tpu_torch.decoders import greedy_ids
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.ops.cuda import gru, stft

    rng = np.random.default_rng(SEED + 2)
    model, meta = build_model("gru", 30, 800, 6, bidirectional=True,
                              compute_dtype="bfloat16", device="cuda")
    random_weights(model, rng)
    model.eval()
    b, s = 20, 120_000
    audio = torch.from_numpy(np.stack([synthetic_audio(rng, s)
                                       for _ in range(b)])).cuda()
    lengths = torch.full((b,), s, dtype=torch.int64).cuda()
    conf = AudioConf()

    def forward():
        spect, frames = featurize_batch(audio, lengths, conf)
        logits, probs, out_lens = model(spect, frames)
        return logits, probs, out_lens, greedy_ids(probs)

    with torch.inference_mode():
        stft.launches = gru.launches = 0
        logits, probs, out_lens, ids = forward()
        torch.cuda.synchronize()
        counts.update(stft_mag=stft.launches, gru_fwd=gru.launches)
        log(f"main path (bf16 forward): launches {counts}")
        if counts["stft_mag"] < 1 or counts["gru_fwd"] != 6:
            raise AssertionError(f"main path missed a kernel: {counts}")
        with plain_path():
            ref_logits, _, ref_lens, ref_ids = forward()
        torch.cuda.synchronize()
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        if logits.shape != (b, 376, 30) or not (out_lens == 376).all():
            raise AssertionError(f"logits {tuple(logits.shape)}, "
                                 f"lengths {out_lens.tolist()}")
        if not torch.equal(out_lens, ref_lens):
            raise AssertionError("output lengths differ from the plain path")
        torch.testing.assert_close(probs.sum(-1),
                                   torch.ones_like(probs[..., 0]))
        scale = max(1.0, ref_logits.abs().max().item())
        err = (logits - ref_logits).abs().max().item()
        agree = (ids == ref_ids).float().mean().item()
        log(f"main path: logits max_abs_err vs plain {err:.3e} (scale "
            f"{scale:.2f}, tolerance {LOGIT_TOL * scale:.3e}); greedy ids "
            f"agree on {agree:.4%} of frames")
        if not err <= LOGIT_TOL * scale:
            raise AssertionError(f"forward disagrees with plain: {err}")
        ms = time_ms(forward, reps=5, warmup=1)
        with plain_path():
            plain_ms = time_ms(forward, reps=1, warmup=0)
        profile_forward(torch, forward, ms, floor)
    audio_s = b * s / conf.sample_rate
    log(f"main path: {ms:.3f} ms per forward of {b} x {s / 16000} s "
        f"(featurize + 6 x BiGRU-800 bf16 + greedy) = "
        f"{audio_s / (ms / 1e3):.1f} audio-s/s; through the plain versions "
        f"{plain_ms:.3f} ms")
    return model, meta


def profile_forward(torch, forward, ms: float, floor: dict):
    """One forward under torch.profiler: device time by kernel, and the
    device's busy and idle time on its trace timeline (the union of kernel,
    memcpy and memset intervals between the first device op and the
    last)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                 for e in events if e.get("ph") == "X" and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    if not ops:
        log("profile of one forward: the trace holds no device op; busy "
            "and idle time not measured")
        return
    busy, (lo, hi) = 0.0, ops[0][:2]
    for start, end, _ in ops[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy += hi - lo
    span = max(end for _, end, _ in ops) - ops[0][0]
    log(f"profile of one forward ({ms:.3f} ms unprofiled, CUDA events): "
        f"{len(ops)} device ops over {span / 1e3:.3f} ms of trace timeline, "
        f"busy {busy / 1e3:.3f} ms, idle {(span - busy) / 1e3:.3f} ms "
        f"({(span - busy) / span:.2%})")
    by_name: dict = {}
    for start, end, name in ops:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + end - start)
    for name, (n, t) in sorted(by_name.items(), key=lambda r: -r[1][1])[:8]:
        log(f"  {t / 1e3:9.3f} ms {n:6d} x {name[:90]}")
    steps = [(n, t) for name, (n, t) in by_name.items() if "gru_step" in name]
    if steps:
        n, t = map(sum, zip(*steps))
        log(f"K2 step at full width: {t / n:.3f} us of kernel time per step "
            f"({n} steps), {t / n / (floor['step_ms'] * 1e3):.1f}x the "
            f"least-work step of {floor['step_ms'] * 1e3:.3f} us")


def phase_cli(torch, model, meta, counts):
    from deepspeech_tpu_torch.audio.features import AudioConf
    from deepspeech_tpu_torch.audio.io import save_wav
    from deepspeech_tpu_torch.cli.transcribe import main
    from deepspeech_tpu_torch.ops.cuda import gru, stft
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    rng = np.random.default_rng(SEED + 3)
    labels = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 "
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ds2.ckpt")
        ckpt.save(path, ckpt.package_from_model(model, meta, labels,
                                                AudioConf().to_dict()))
        wavs = []
        for i, seconds in enumerate((2.0, 3.5, 5.0)):
            wavs.append(os.path.join(d, f"req{i}.wav"))
            save_wav(wavs[-1], synthetic_audio(rng, int(seconds * 16000)),
                     16000)
        stft.launches = gru.launches = 0
        for wav in wavs:
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = main(["--model-path", path, "--audio-path", wav,
                           "--offsets"])
            dt = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"transcribe exited {rc}")
            out = json.loads(buf.getvalue().strip().splitlines()[-1])
            text = out["output"][0]["transcription"]
            log(f"transcribe {os.path.basename(wav)}: {len(text)} chars in "
                f"{dt:.3f} s (host clock, checkpoint load included): "
                f"{text[:60]!r}")
        torch.cuda.synchronize()
        counts.update(stft_mag=stft.launches, gru_fwd=gru.launches)
        log(f"transcribe CLI (f32): launches {counts}")
        if counts["stft_mag"] != 3 or counts["gru_fwd"] != 18:
            raise AssertionError(f"CLI path missed a kernel: {counts}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import deepspeech_tpu_torch  # noqa: F401  (fails outside the repo)
    from deepspeech_tpu_torch.ops.cuda import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    log(card)

    t0 = time.perf_counter()
    outputs = build.build_all(force=True)
    log(f"built {sorted(outputs)} in {time.perf_counter() - t0:.1f} s")
    for name, out in outputs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    results: dict = {}
    main_counts: dict = {}
    with torch.inference_mode():
        phase_stft(torch, results)
        phase_gru(torch, results)
        model, meta = phase_forward(torch, main_counts,
                                    results["gru_fwd"]["floor"])
    phase_cli(torch, model, meta, {})

    kernels = []
    for name in ("stft_mag", "gru_fwd"):
        r = results[name]
        kernels.append({"name": name, "route": r["route"],
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": main_counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
