#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (deepspeech_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them. In order:

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel from csrc/ (one nvcc each, in parallel);
3. K1 (stft_mag) against its plain version at the main-path shape,
   20 x 120,000 samples, n_fft 320 (the FFT route): errors, its device
   time beside torch.stft(...).abs()'s (and each one's host-visible time),
   the plain version's, the bound; the DFT route's export at the same
   shape (K1's design before the FFT), held and timed; then the DFT route
   (n_fft 448, through the wrapper) held to its plain version;
4. K2 (gru_fwd), both variants, against its plain version at full width,
   T 376, B 20, H 800, F 1312 and 800, unequal lengths, bf16 (each of its
   three recurrence variants, W-resident persistent, streamed persistent
   and one launch a step, and the rule's choice) and f32 (the training
   variant's residuals g and hn too); each variant's time a call and a
   step, and its tensor-core projection GEMM alone beside cuBLAS
   (torch.matmul of the same bf16 operands) and its bound; then the
   latency floor of the recurrences: an empty launch from a host loop,
   the f32 step kernels of K2, K5, K3 and K7 at the least work, and a
   persistent grid doing only its grid barrier a step (on the W-resident
   grid at H 800 and on the streamed kernels' grid at H 1600);
5. K5 (gru_bwd) against its plain version at the same shapes: dg, dnh and
   the bias grads (bf16: the rule's variant, one launch a step and
   persistent), then dx, dW_ih and dW_hh through the layer's autograd
   Function against the same Function on the plain versions; its time
   (bf16: each variant's too) beside cuDNN's bidirectional GRU backward
   with the same weights, its bound and the bf16 step's L2 floor;
6. K8/K9 (ctc_alpha with the loss, ctc_beta with the logit gradient)
   against their plain versions at B 20, T 376, C 30, L 150 with unequal
   lengths and one impossible row, again with a NaN row, and at S 1041
   (B 2, T 1,100, L 520): alphas, loss, the debug betas and dlogits, the
   impossible and NaN rows' non-finite loss and zero gradient; the layer
   (loss + dlogits) against the plain path; K8's and K9's device time and
   time a call beside their bytes bound, the chain floor (the same block
   doing only a barrier and one logaddexp3 a frame) and F.ctc_loss's
   forward and backward; the layer's beside F.ctc_loss forward + backward;
   each held again on the global route (the per-state rows in global
   memory) and timed there; then long label sequences, L 2,200 (S 4,401,
   the ring's last size for K9) and L 2,250 (S 4,501, past it), B 2,
   T 1.1 L + 40, held on the rule's route and the global route, timed
   beside F.ctc_loss at the same shape;
7. K10 (topk) against its plain version bit for bit at the beam's shapes,
   (20, 310) k 10 and (20, 3968) k 128 (the selection route; the whole
   order of 4 rows through the bitonic route), on stress rows (ties,
   signed zeros, infinities, NaNs) and on a wide beam's early-step -inf
   flood; its device time at both widths, on beam-like rows and on the
   flood, beside its bound, the plain version, torch.topk and torch.sort;
8. the inference path: the default DS2 (6 x BiGRU-800, 30 classes) in bf16
   from seeded random weights on 20 synthetic 7.5 s waveforms, featurize
   -> forward -> greedy ids, launch counts read around it, the logits held
   to the plain versions, one profiled forward's busy and idle time;
9. the transcribe CLI answers 3 requests (f32, as the JAX CLI runs);
10. the beam path: 20 x 7.5 s -> featurize -> the same model -> the device
   beam search (width 10) through DeviceBeamCTCDecoder, its launch counts
   read around it (K10 once a time step); then the device beam at width
   10, at width 128 and at width 10 with a synthetic trigram LM (3,000
   words over the label alphabet, written from a seed, converted to DSLM)
   on those posteriors, each bit-equal to the same search with the plain
   top-k on the card, held against the search on the CPU, each timed;
11. transcribe with --decoder device_beam and --decoder beam, each with
   --lm-path; the test CLI on a synthetic manifest of 20 x 7.5 s with
   --decoder device_beam --lm-path, its summary equal to an in-process
   decode of the same batch;
11a. the data path to a LibriSpeech WER (phase_data_path): the host C++
   library rebuilt with g++ (its version and the host CPU logged); a
   LibriSpeech-layout test-clean.tar.gz of 20 FLAC utterances of 7.5 s
   (the port's save_flac; one chapter at 32 kHz) through the librispeech
   CLI, with no network: the manifest's rows and every wav equal to the
   encoded samples (resampled at 32 kHz); KenLM probing and trie binaries
   of the synthetic LM from this script's own writer; the test CLI on the
   manifest with --decoder beam and the ARPA (auto must pick the native
   search), with the probing and with the trie binary (the Python search,
   width 10, a few utterances) and with --decoder device_beam and the
   trie, launch counts reset before each (K1 1, K2 6, K8 1, K10 once a
   frame with the device beam); the eval step's own launches of K1, K2
   and K8 at the CLI's padded shape each held to the plain version on
   its inputs, and the whole step to the step through every plain
   version; the trie's device beam bit-equal through K10's plain twin;
   on the same posteriors the native search's
   hypotheses and offsets bit-equal to the Python search's with and
   without the LM, the trie's device beam texts equal to the DSLM's, the
   native WER/CER and batch_edit_distance equal to the numpy ones; host
   decode times (native against Python at width 10, native at width 128
   with and without the LM, 1 and 4 threads); the model as a reference
   torch.save package through import_torch, transcribed on the card
   (text equal to the original checkpoint's);
12. the train path: the same model trained on 20
   synthetic 7.5 s waveforms with random transcripts on the int16 wire,
   SGD-Nesterov (lr 3e-4, momentum 0.9, clip 100). The launch counts of
   every kernel are read around one step; that step's loss, grad norm and
   every parameter's gradient are held to the same step through the plain
   versions; 5 steps give finite losses with none skipped, a CUDA-event
   median step time in audio-s/s, and one more, profiled, step its busy
   and idle time;
12a. the same step with the train CLI's device augmentation (the noise
   mix at prob 0.4, SpecAugment at 0.5, the 8 kHz band zero at 0.2) and
   without, 5 steps each in turns, each median and one profiled step;
13. the train CLI trains 1 epoch at full width on a synthetic manifest in a
   temporary directory, and its checkpoint answers one transcribe request;
13a. the train CLI at full width with its augmentation, resume,
   checkpoint, logging and profiling flags (--augment --aug-type 0, the
   device masks and noise mix with a noise bank from synthetic noise
   wavs, --checkpoint-per-samples with --checkpoint-anneal,
   --train-val-manifest, the JSONL log, --visdom, --log-params, a
   profiler trace of step 1) for 1 epoch of 60 synthetic
   7.5 s utterances (3 steps), then resumed from its mid-epoch checkpoint
   for epoch 2: the launches of each run against the count of steps and
   validation batches, the files written, the mid-epoch checkpoint's
   optimizer leaves restored on the card bit for bit, the annealed LR, the
   batches of the resume (no epoch re-run); the loader's batches/s with and
   without the host waveform pipeline, and the CLI's steps/s with and
   without --augment, each over RATE_STEPS batches after RATE_WARM on the
   manifest repeated;
13b. the serving path: the default train config with --no-bidirectional
   (6 x GRU-800, context 20, f32) from seeded weights as a checkpoint,
   the serve CLI on SERVE_UTTS synthetic utterances of 2-7.5 s with 8
   slots and 0.96 s chunks, with --decoder greedy and device_beam: K1
   once a tick and K10 once a beam step (48 a tick), tick latency p50 and
   p95 after the first tick, audio-s/s (the CLI's summary, and over the
   ticks after the first); the same pool in-process on the audio the CLI
   hears, its texts equal to the CLI's and held to one stream of each
   utterance (equal, or apart only where that stream's top two logits tie
   within their difference), 10 of its ticks on the host clock and
   profiled (device ops, busy, idle); K1 on its first tick's inputs
   (center=False) against its plain version; its logits and texts held to
   the same pool through the plain versions; the device-beam pool's texts
   and logits bit-equal with the pool on K10's plain twin, and equal to
   the CLI's; the stream with frozen normalization against the batch
   forward (K2, f32) of 4 of the utterances;
13c. the CNN zoo: a train step at phase 12's batch for cnn (width 256,
   epilog 800, 6 body layers) and cnn_jasper, f32: K1, K8 and K9 once a
   step; the loss and grad norm against the whole step through the plain
   versions, K1's magnitudes against its plain version, each gradient
   against the plain step from the same spectrogram; the pre-ReLU sign
   changes between the plain runs from K1's and from the plain
   spectrogram, and the gradient gap with the latter's ReLU pattern
   replayed on the former; 5 steps and a profiled one; cnn_residual
   through the pool (running SE), its texts held to one stream each and
   its logits to the pool through the plain versions; the cnn stream (no
   SE) with frozen normalization against the batch forward; transcribe
   --chunk-seconds 0.96 --se-mode two_pass on cnn_jasper, its launches,
   its logits against the batch forward and its text against the batch
   greedy text;
14. K3 (lstm_fwd), both variants, against its plain version at the K2
   shapes (the training variant's residuals c and g too; bf16 in each
   recurrence variant, with the GEMM beside cuBLAS), beside cuDNN's
   bidirectional nn.LSTM with the same weights;
15. K7 (lstm_bwd) as phase 5: dg and the bias grad, then dx, dW_ih and
   dW_hh through LSTMLayer against the same Function on the plain
   versions; its time beside cuDNN's LSTM backward;
16. the LSTM inference path: 6 x BiLSTM-800 bf16 from seeded weights,
   featurize -> forward -> greedy, as phase 8;
17. the LSTM train path, as phase 12: one step's loss, grad norm and every
   gradient against the plain path, its launches (stft_mag 1, lstm_fwd 6,
   all with residuals, lstm_bwd 6, ctc_alpha 1, ctc_beta 1, no GRU
   kernel), 5 steps and a profiled one;
18. the train CLI with --rnn-type lstm, 1 epoch at full width, and one
   transcribe request on its checkpoint;
19. K4 (gru_scan), inference and training, against its plain version at
   the wide model's width: T 376, B 64, H 1600, on the wide route's
   projection of 1600-wide inputs rounded to the operand type, unequal
   lengths, bf16 and f32 (one launch a step, persistent, and the rule's
   choice), D 2 and D 1; its time a call and a step beside its bound, the
   bf16 step's L2 floor (W_hh's and h's bytes a step over the warm W_hh's
   read rate), the f32 step's product floor (67 TFLOP/s), each variant's
   time, the plain version, the wide route's layer and cuDNN's nn.GRU; then
   K5 in bf16 at the same width (B 64) on the plain forward's residuals,
   each variant against plain_bwd, its time a call and a step beside its
   bound, the step's L2 floor (the packed W_hh and the operand copy's
   bytes over the warm W_hh's read rate), the plain version and cuDNN's
   bidirectional GRU backward;
20. K2 at the wide GRU's layer 0 (T 376, B 64, H 1600, F 1312, bf16): the
   streamed persistent variant (the rule's choice) and one launch a step
   against plain, timed beside cuDNN's nn.GRU; the W-resident variant
   refused (its slices do not fit); then
   the 6 x BiGRU-1600 model (DeepSpeech2-large, BASELINE.md config 4) at
   batch 64: the route of every layer (layer 0 on K2, layers 1-5 on K4),
   the bf16 forward's launches and logits against the plain versions, then
   the train step as phase 12 (stft_mag 1, gru_fwd 1 and gru_scan 5, all
   with residuals, gru_bwd 6, ctc_alpha 1, ctc_beta 1), 5 steps and a
   profiled one;
21. K6 (lstm_scan) as phase 19 at B 20, on projections of 1312- and
   1600-wide inputs, beside nn.LSTM, and K7 as K5 there; then 6 x
   BiLSTM-1600 at batch 20 as
   phase 20: every layer on K6 (lstm_scan 6, lstm_bwd 6, no lstm_fwd);
22. config 4's train CLI: --hidden-size 1600 --batch-size 64
   --use-curriculum --checkpoint --epochs 2 on 128 synthetic utterances of
   6.8-7.5 s; its launches, both curriculum sidecars of every checkpoint
   (one row per wav), the drawn utterances' CERs moved from 0.999, epoch
   1's draw equal to Curriculum.sample recomputed from epoch 0's sidecar;
   one f32 transcribe request and one f32 test batch of 64 (K4 in all 6);
22a. multi-GPU training (phase_multi_gpu): the single-process bf16 step
   of the default model on phase 12's batch and of config 4 at batch 64,
   3 steps each from seeded weights, saved as the reference; then two
   rank processes of this script (``--rank``) on cuda:0, over gloo on
   CUDA tensors (one card, and NCCL refuses two ranks on one device):
   data 2 on the default model (10 rows a rank) and model 2 on config 4
   (each rank one direction of every layer, at D=1), every step's loss,
   grad norm and parameters held to the reference at phase 12's
   tolerances, the launches of a step (K1 1, K2 with residuals 6, K5 6,
   K8 1, K9 1; no K4 at model 2), the collectives of a step, the model-2
   ranks' K2 and K5 launches each held to its plain version on its
   inputs, the time-sliced step times, the replicated leaves bit-equal
   across the model-2 ranks (and which raw gradients differed before
   the model group's broadcast); then the data-parallel step at world size
   1 over NCCL against phase 12's step time, and its
   --steps-per-dispatch 4 replays with the NCCL collectives captured,
   bit-equal to eager steps under cuDNN deterministic, the mesh's
   collectives counted per replay; where the machine has two cards, data
   2 over NCCL a card a rank;
22a'. the rest of the JAX mesh rule (phase_mesh_model): the single-process
   references of the default model, the unidirectional LSTM-800 (bf16)
   and cnn (f32, dropout 0.1) at phase 12's batch, under cuDNN's
   deterministic algorithms; four rank processes on cuda:0 over gloo at
   data 1 x model 4 on the default model (every RNN tensor gate-sharded,
   1/4 a rank, gathered whole before its layer), every step held to the
   reference near bit for bit (MESH_TOLS), the launches of a step against
   phase 12's, the gathers counted, each rank's K1, K2 (D=2), K5, K8 and
   K9 launches of its first step held to plain; two ranks at model 2 on
   the LSTM (K1, K3 and K7 at D=1, K8, K9; its head class-sharded) and on
   cnn (K1, K8, K9; its head sharded on input channels) likewise; each
   model group's replicated leaves bit-equal after the steps; the ranks'
   step times (time-sliced: not a scaling figure); then two gloo ranks at
   data 2 at
   --steps-per-dispatch 2 against k 1 (eager lanes, logged);
22b. --steps-per-dispatch 4 (phase_steps_per_dispatch): the default model
   (bf16, batch 20 x 7.5 s, SGD-Nesterov, clip 100) through two full
   groups of 4 and a short group of 2 batches of a shorter bucket (a second
   graph), and config 4 (B 64: K2, the cooperative K4, the persistent K5)
   through one group, each as CUDA-graph replays of the train step
   (train/graph.py) against the same batches eagerly: the launches of both
   (the replays counted), with cuDNN's deterministic algorithms the steps,
   states and generator held equal; under its default algorithms the
   per-step CUDA-event median eager against replay, each kernel counted
   by name in the trace of 4 profiled steps against the counters, the
   host's issue time and idle share, the device's idle share, the capture
   seconds of each shape, the peak reserved memory, and the replays' drift
   beside two eager runs'; then the graph cache over 16 buckets of 2-17 s
   (spd_cache: memory after each capture, capture seconds, then a bound of
   4 with evictions and captures anew), and the train CLI itself at
   --steps-per-dispatch 4 against k 1 (phase_spd_cli: full width, device
   noise, masks, three checkpoint anneals between replays; the losses,
   the final checkpoint and the launches held equal);
22c. the test CLI on two gloo ranks sharing cuda:0 (phase_test_multi;
   ``--test-rank``, torchrun's variables set by hand) against one process,
   greedy and device_beam, 20 x ~7.5 s at batch 10: rank 0's stdout and
   the report CSV byte-equal, each rank's K1, K2, K8 and K10 launches;
   the script's total time;
23. prints one JSON line of kernel results (launches from one train step of
   the path each kernel is on: the GRU-800 step for K1, K2, K5, K8 and K9,
   the LSTM-800 step for K3 and K7, the BiGRU-1600 step for K4, the
   BiLSTM-1600 step for K6; for K10 the beam path of phase 10; K8's and
   K9's entries add the route the train shape takes, their global
   route's device time and the long-label times; K1's entry
   adds its shape route and host-visible time, K10's its times at width
   128, K5's and K7's their times at the wide width, K2's and K3's the
   recurrence variant the rule chose, each variant's time, a step's time
   and the projection GEMM's beside cuBLAS, K2's its wide layer 0, K8's
   and K9's their device time, the chain floor and F.ctc_loss's device
   time, K9's the layer's times too; the kernels of phase 22b add their
   launches there, ``launches_steps_per_dispatch``), after a line of the
   serving, CNN, data-path, multi-GPU, mesh-model, steps-per-dispatch and
   multi-rank test figures, then the device line last.

No phase catches its own failure: a mismatch raises and the exit is
non-zero. Times are CUDA-event medians with warm L2; K1's and K10's (and
their library calls') are device time per call of 50 calls queued behind a
sleeping kernel (``device_ms``).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import importlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
PEAK_F32 = 67e12        # H100 SXM, non-tensor f32 FLOP/s
PEAK_BF16 = 989e12      # H100 SXM, dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
KERNELS = ("stft_mag", "gru_fwd", "gru_scan", "gru_bwd", "lstm_fwd",
           "lstm_scan", "lstm_bwd", "ctc_alpha", "ctc_beta", "topk")
REPLACES = {
    "stft_mag": "deepspeech_tpu/ops/pallas/stft_kernel.py:57",
    "gru_fwd": "deepspeech_tpu/ops/pallas/rnn_fused.py:95",
    "gru_scan": "deepspeech_tpu/ops/pallas/rnn_kernel.py:123",
    "lstm_scan": "deepspeech_tpu/ops/pallas/rnn_kernel.py:551",
    "gru_bwd": "deepspeech_tpu/ops/pallas/rnn_kernel.py:220",
    "lstm_fwd": "deepspeech_tpu/ops/pallas/rnn_fused.py:344",
    "lstm_bwd": "deepspeech_tpu/ops/pallas/rnn_kernel.py:628",
    "ctc_alpha": "deepspeech_tpu/ops/pallas/ctc_kernel.py:59",
    "ctc_beta": "deepspeech_tpu/ops/pallas/ctc_kernel.py:101",
    "topk": "deepspeech_tpu/ops/pallas/topk_kernel.py:73",
}
SOURCES = {
    "stft_mag": "deepspeech_tpu_torch/csrc/stft_mag.cu",
    "gru_fwd": "deepspeech_tpu_torch/csrc/gru_fwd.cu",
    "gru_scan": "deepspeech_tpu_torch/csrc/gru_scan.cu",
    "lstm_scan": "deepspeech_tpu_torch/csrc/lstm_scan.cu",
    "gru_bwd": "deepspeech_tpu_torch/csrc/gru_bwd.cu",
    "lstm_fwd": "deepspeech_tpu_torch/csrc/lstm_fwd.cu",
    "lstm_bwd": "deepspeech_tpu_torch/csrc/lstm_bwd.cu",
    "ctc_alpha": "deepspeech_tpu_torch/csrc/ctc.cu",
    "ctc_beta": "deepspeech_tpu_torch/csrc/ctc.cu",
    "topk": "deepspeech_tpu_torch/csrc/topk.cu",
}
# Stated tolerances (kernel vs plain version, same inputs, on the card):
STFT_TOL = dict(rtol=1e-4, atol=1e-4)   # both true f32 FMA sums
GRU_TOL = {"float32": 1e-4,             # |h| <= 1; f32 sums in other orders
           "bfloat16": 5e-3}            # + bf16 rounding flips of h_prev
BF16_ULP = 2.0 ** -7                    # one bf16 ulp at [1, 2)
# K5 and the layer's grads, x max(1, max|reference|): f32 sums in other
# orders; in bf16 a one-ulp flip of a rounded operand moves the carried dh
GRU_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# K3 and K7 hold the GRU's tolerances, for the same reasons; c, which is
# not bounded by 1, is held x max(1, max|c|)
LSTM_TOL, LSTM_BWD_TOL = GRU_TOL, GRU_BWD_TOL
CTC_TOL = dict(rtol=1e-4, atol=1e-4)    # log-space sums, f32 exp/log
LOGIT_TOL = 2e-2                        # x max(1, max|logits|), bf16 forward
# the f32 eval step's probs (in [0, 1]) against the step through every
# plain version: f32 sums in other orders through 6 layers, as GRU_TOL
EVAL_PROB_TOL = GRU_TOL["float32"]
# the long label sequences of K8/K9's routes: L 2,200 (S 4,401, the ring's
# last size for K9) and 2,250 (S 4,501, the global route), 2 rows each
CTC_LONG_L, CTC_LONG_B = (2200, 2250), 2
# K2's/K3's projection GEMM against the f32 einsum of the same bf16
# operands, x max(1, max|ref|) x sqrt(K): exact products, f32 sums of K
# terms in another order
GEMM_TOL = 1e-5
# the train step in bf16, kernels against plain versions: the loss and the
# grad norm relative; each parameter's gradient x max(1, max|its grad|)
STEP_LOSS_TOL, STEP_GRAD_TOL = 2e-3, 5e-2
# the default model and batch (BASELINE.md config 2): 6 x BiGRU-800 (or,
# with the cell changed, 6 x BiLSTM-800), 30 labels, 20 x 7.5 s of 16 kHz
# audio = 376 frames after the convs
SR, AUDIO_S, BATCH, FRAMES = 16000, 120_000, 20, 376
HIDDEN, LAYERS, FEATURES, CLASSES, CTC_L = 800, 6, 1312, 30, 150
LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 "  # labels.json, 30 classes
# the beam searches: (name, beam width, with the LM, utterances also
# searched on the CPU: that search at width 128 takes ~130 ms a step there)
# the wide models (BASELINE.md config 4): 6 x BiGRU-1600 trained at batch
# 64, where layer 0 takes K2 and layers 1-5 K4; 6 x BiLSTM-1600 at batch
# 20, where every layer takes K6 (ops/cuda/route.py)
WIDE, WIDE_BATCH = 1600, {"gru": 64, "lstm": 20}
# the config-4 train CLI: utterances of 6.8-7.5 s, validation on the first
# half
CLI_UTTS = 128
# the full train CLI phase: 60 utterances of 6.8-7.5 s, 3 steps an epoch;
# the host's rates (the loader alone, the CLI's steps) over RATE_STEPS
# batches after RATE_WARM, on that manifest repeated
CLI_FULL_UTTS = 60
RATE_WARM, RATE_STEPS = 5, 30
SEARCHES = (("width 10", 10, False, BATCH), ("width 128", 128, False, 2),
            ("width 10 + LM", 10, True, BATCH))
# the serving path (phase_serve): the default train config with
# --no-bidirectional (6 x GRU-800, context 20), f32, on SERVE_UTTS synthetic
# utterances of 2-7.5 s, 8 slots, 0.96 s chunks (96 frames, 48 outputs and
# beam steps a tick); 10 ticks profiled
SERVE_UTTS, SERVE_SLOTS, SERVE_CHUNK_S, SERVE_PROFILE_TICKS = 16, 8, 0.96, 10
# a stream's logits against the batch forward of the same utterance (and a
# pool lane's against one stream), x max(1, max|logits|): f32 throughout,
# the chunk recurrence's and K2's sums in other orders
STREAM_TOL = 1e-3
# the CNN train step in f32 against the plain path. The whole step through
# the plain versions moves the loss and the grad norm by ~1e-7, but K1's
# ~1e-6 differences (~1e-2 in the log-spectrogram, where log1p(2^20 m)
# magnifies the f32 round-off of the bins near 0) change the sign of the
# pre-ReLU activations nearest 0, each change dropping or adding one
# position's term in the gradients below it (one element by ~5% of its
# tensor's largest on an NVIDIA H100 80GB HBM3, 700.00 W). So the loss
# and the norm are held relative on the whole plain path; K1's
# magnitudes of the batch alone, at STFT_TOL; each
# gradient, x max(1, max|grad|), against the plain path run from the same
# spectrogram (K8/K9 against their twins, f32 sums in other orders); and
# the plain path from K1's spectrogram with the plain spectrogram's ReLU
# pattern replayed against the plain path, at CNN_PATTERN_TOL: what stays
# of the gap once the sign changes are taken out (2.9e-4 and 4.3e-4 of
# scale for cnn and cnn_jasper, against 4.9e-2 and 5.6e-2 with them, on
# the same card)
CNN_LOSS_TOL, CNN_GRAD_TOL, CNN_PATTERN_TOL = 1e-3, 1e-4, 2e-3
# the synthetic LM's weights (the CLIs' defaults) and size
LM_ALPHA, LM_BETA, LM_WORDS = 0.8, 1.0, 3000
PROFILE_STEPS = 40  # beam steps under the profiler, per search


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


def device_ms(fn, reps=50) -> float:
    """Device time of one call of ``fn``: ``reps`` calls enqueued behind a
    sleeping kernel (so that the host's enqueue time is hidden), between
    two CUDA events, over ``reps``. For kernels shorter than their launch
    from Python."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms of clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    from deepspeech_tpu_torch.ops.rnn import CELL_GATES

    params, stats = torch_to_jax(model.state_dict())
    gates = CELL_GATES[model.rnns[0].cell] if hasattr(model, "rnns") else 1

    def fill(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v, path + (k,))
                continue
            name = "/".join(path + (k,))
            if k == "kernel" and v.ndim == 4:
                fan_in = v.shape[0] * v.shape[1] * v.shape[2]
                tree[k] = rng.standard_normal(v.shape) / np.sqrt(fan_in)
            elif k == "kernel" and v.ndim == 3:  # a CNN's (k, in, out)
                fan_in = v.shape[0] * v.shape[1]
                tree[k] = rng.standard_normal(v.shape) / np.sqrt(fan_in)
            elif k == "weight":  # the lookahead's (H, context + 1)
                s = 1.0 / np.sqrt(v.shape[1])
                tree[k] = rng.uniform(-s, s, v.shape)
            elif k == "kernel":
                tree[k] = rng.standard_normal(v.shape) / np.sqrt(v.shape[0])
            elif k in ("w_ih", "b_ih", "w_hh", "b_hh"):
                s = 1.0 / np.sqrt(v.shape[-1] // gates)
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


def phase_stft(torch, results):
    """K1 at the main path's shape (n_fft 320: the FFT route) against its
    plain version; its device time beside torch.stft(...).abs()'s and the
    bound; then the DFT route (n_fft 448) held to its plain version on the
    same batch."""
    from deepspeech_tpu_torch.audio.features import make_window
    from deepspeech_tpu_torch.ops.cuda import build, stft

    rng = np.random.default_rng(SEED)
    b, s, n_fft, hop = BATCH, AUDIO_S, 320, 160
    y = torch.from_numpy(np.stack([synthetic_audio(rng, s)
                                   for _ in range(b)])).cuda()
    win = make_window("hamming", n_fft)
    got = stft.stft_mag(y, n_fft, hop, win)
    ref = stft.plain(y, n_fft, hop, win)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    rel = (err / ref.abs().clamp(min=1e-6)).max().item()
    log(f"K1 stft_mag {tuple(got.shape)}, {stft.route(n_fft)} route (plan "
        f"{stft.fft_plan(n_fft)}, {stft.fft_frames_per_block(n_fft, hop)} "
        f"frames a block): max_abs_err {err.max().item():.3e} max_rel_err "
        f"{rel:.3e}")
    torch.testing.assert_close(got, ref, **STFT_TOL)
    win_t = torch.from_numpy(win).cuda()

    def library():
        return torch.stft(y, n_fft, hop, n_fft, win_t, center=True,
                          pad_mode="reflect", return_complex=True).abs()

    ms = device_ms(lambda: stft.stft_mag(y, n_fft, hop, win))
    lib_ms = device_ms(library)
    call_ms = time_ms(lambda: stft.stft_mag(y, n_fft, hop, win), reps=20)
    lib_call_ms = time_ms(library, reps=20)
    # the plain version copies its DFT matrices to the card each call, which
    # blocks the host, so it is timed by CUDA events around one call
    plain_ms = time_ms(lambda: stft.plain(y, n_fft, hop, win), reps=20)
    frames, n_bins = b * got.shape[-1], got.shape[1]
    # The function is |STFT|. A real FFT of N points computes it exactly in
    # f32 with ~2.5 N log2 N operations, plus N for the window and 4 per bin
    # for the magnitude.
    fft_flops = frames * (2.5 * n_fft * np.log2(n_fft) + n_fft + 4 * n_bins)
    nbytes = 4.0 * (b * s + frames * n_bins)
    bound_ms, by = bound(fft_flops, PEAK_F32, nbytes)
    log(f"K1 stft_mag: {ms * 1e3:.2f} us device time a call ({call_ms:.4f} "
        f"ms host-visible, CUDA events around one call), torch.stft(...)"
        f".abs() {lib_ms * 1e3:.2f} us ({lib_call_ms:.4f} ms host-visible), "
        f"plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({by})")
    results["stft_mag"] = dict(route="cuda", max_abs_err=err.max().item(),
                               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=by, library_ms=lib_ms,
                               extra={"shape_route": stft.route(n_fft),
                                      "call_ms": call_ms})
    # the DFT route's export at this shape: the design K1 had before the
    # FFT (the wrapper sends n_fft 320 to the FFT route), for its time
    lib = stft._kernel()
    cos_w, sin_w = stft._dft_on(n_fft, np.asarray(win, np.float32).tobytes(),
                                y.device)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(tuple(got.shape), device=y.device)

    def dft_export():
        build.check(lib, lib.stft_mag_dft_f32(
            y.data_ptr(), cos_w.data_ptr(), sin_w.data_ptr(), out.data_ptr(),
            b, s, got.shape[-1], n_fft, hop, n_bins, n_fft // 2, stream),
            "stft_mag_dft_f32")

    dft_export()
    torch.testing.assert_close(out, ref, **STFT_TOL)
    dft_ms = device_ms(dft_export)
    log(f"K1's DFT route at n_fft {n_fft} (its design before the FFT): "
        f"{dft_ms * 1e3:.2f} us device time a call")
    results["stft_mag"]["extra"]["dft_route_ms"] = dft_ms
    n_dft, hop_dft = 448, 160
    win = make_window("hamming", n_dft)
    got = stft.stft_mag(y, n_dft, hop_dft, win)
    ref = stft.plain(y, n_dft, hop_dft, win)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    n_dft_ms = device_ms(lambda: stft.stft_mag(y, n_dft, hop_dft, win))
    log(f"K1 stft_mag n_fft {n_dft} hop {hop_dft} {tuple(got.shape)}, "
        f"{stft.route(n_dft)} route: max_abs_err {err:.3e}, "
        f"{n_dft_ms * 1e3:.2f} us device time a call")
    torch.testing.assert_close(got, ref, **STFT_TOL)


CELLS = {"gru": dict(gates=3, fwd="gru_fwd", bwd="gru_bwd", name="K2",
                    bname="K5"),
         "lstm": dict(gates=4, fwd="lstm_fwd", bwd="lstm_bwd", name="K3",
                     bname="K7")}


def cell_kernels(cell):
    """The wrapper module of a cell's kernels and its layer Function."""
    from deepspeech_tpu_torch.ops.cuda import gru, lstm

    return (gru, gru.GRULayer) if cell == "gru" else (lstm, lstm.LSTMLayer)


def layer_inputs(torch, rng, t, b, h, f_in, gates, ndir=2):
    """Full-width layer inputs in f32 on the card, unequal lengths."""
    s = 1.0 / np.sqrt(h)

    def u(*shape, lo=-s, hi=s):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32)).cuda()

    lens = torch.from_numpy(np.linspace(t, t // 2 + 2, b).astype(
        np.int64)).cuda()
    g = gates * h
    return (u(t, b, f_in, lo=0, hi=1), u(ndir, f_in, g), u(ndir, g),
            u(ndir, h, g), u(ndir, g), lens)


def cudnn_layer(torch, args, dt, cell):
    """torch.nn.GRU or nn.LSTM (cuDNN) carrying the same weights as
    ``args``; both use the port's gate order."""
    x, w_ih, b_ih, w_hh, b_hh, _ = args
    f_in, h = x.shape[-1], w_hh.shape[1]
    cls = torch.nn.GRU if cell == "gru" else torch.nn.LSTM
    net = cls(f_in, h, bidirectional=True, device="cuda", dtype=dt)
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse")):
            getattr(net, "weight_ih_l0" + sfx).copy_(w_ih[d].t())
            getattr(net, "weight_hh_l0" + sfx).copy_(w_hh[d].t())
            getattr(net, "bias_ih_l0" + sfx).copy_(b_ih[d])
            getattr(net, "bias_hh_l0" + sfx).copy_(b_hh[d])
    # torch flattens cuDNN weights in f16/f32/f64 only: the bf16 call also
    # copies its weights into one buffer (and warns once)
    net.flatten_parameters()
    return net


FUSED_VARIANTS = ("resident", "persistent", "step", "auto")


def fused_variant(torch, cell, b, h, ndir=2) -> str:
    """The bf16 recurrence variant K2's/K3's rule picks on this card for a
    layer of ``ndir`` directions, B b and H h."""
    from deepspeech_tpu_torch.ops.cuda.recurrence import (FWD_VARIANTS as V,
                                                          fwd_capacity,
                                                          fwd_variant)

    mod, _ = cell_kernels(cell)
    caps = fwd_capacity(mod._fwd_kernel(), f"{cell}_fwd_capacity", b, h,
                        torch.device("cuda"))
    mode = fwd_variant("auto", CELLS[cell]["gates"], b, h, ndir, *caps)
    return {m: v for v, m in V.items()}[mode]


def bwd_variant_name(torch, b, h, ndir) -> str:
    """The bf16 variant K5's rule picks on this card for a layer of
    ``ndir`` directions, B b and H h."""
    from deepspeech_tpu_torch.ops.cuda import gru
    from deepspeech_tpu_torch.ops.cuda.recurrence import (bwd_blocks,
                                                          bwd_variant,
                                                          resident_blocks)

    mode = bwd_variant("auto", b, bwd_blocks(ndir, h), resident_blocks(
        gru._bwd_kernel(), "gru_bwd_resident", b, torch.device("cuda")))
    return {1: "step", 2: "persistent"}[mode]


def hold_fused(torch, cell, args, variants, label) -> float:
    """K2 or K3 at ``args`` in each of ``variants``, inference and training,
    against plain (every stream against the cell's tolerance, c against it
    x max(1, max|c|)) -> the largest error."""
    mod, _ = cell_kernels(cell)
    spec = CELLS[cell]
    layer = mod.gru_layer if cell == "gru" else mod.lstm_layer
    names = ("h", "g", "hn") if cell == "gru" else ("h", "c", "g")
    name = str(args[0].dtype).split(".")[-1]
    tol = (GRU_TOL if cell == "gru" else LSTM_TOL)[name]
    ref = mod.plain(*args, residuals=True)
    worst = 0.0
    for variant in variants:
        got = layer(*args, variant=variant)
        res = layer(*args, residuals=True, variant=variant)
        torch.cuda.synchronize()
        err = (got - ref[0]).abs().max().item()
        errs = [(e, sc if k == "c" else 1.0) for k, (e, sc) in
                zip(names, (max_err(a, r) for a, r in zip(res, ref)))]
        log(f"{spec['name']} {spec['fwd']} {name} {variant} {label}: "
            f"max_abs_err {err:.3e}; with residuals "
            + " ".join(f"{k} {e:.3e}" for k, (e, _) in zip(names, errs))
            + f" (tolerance {tol}"
            + (", c x max(1, max|c|))" if cell == "lstm" else ")"))
        if not (err <= tol and all(e <= tol * sc for e, sc in errs)):
            raise AssertionError(f"{spec['fwd']} {name} {variant} {label} "
                                 f"disagrees with its plain version: "
                                 f"{err} {errs}")
        worst = max([worst, err] + [e for e, _ in errs])
    return worst


def gemm_yardstick(torch, x, w_ih) -> dict:
    """K2's/K3's bf16 projection GEMM alone (gru.projection) against its
    plain einsum, timed beside cuBLAS on the same bf16 operands
    (torch.matmul, bf16 out; torch.mm with an f32 out, one call a
    direction) and its bound."""
    from deepspeech_tpu_torch.ops import fp32_matmul
    from deepspeech_tpu_torch.ops.cuda import gru

    t, b, f_in = x.shape
    ndir, _, n = w_ih.shape
    got = gru.projection(x, w_ih)
    with fp32_matmul():
        ref = torch.einsum("tbf,dfn->dtbn", x.float(), w_ih.float())
    err, scale = max_err(got, ref)
    if not err <= GEMM_TOL * scale * f_in ** 0.5:
        raise AssertionError(f"projection GEMM disagrees with its plain "
                             f"einsum: {err} (scale {scale})")
    x2 = x.reshape(t * b, f_in)
    ms = time_ms(lambda: gru.projection(x, w_ih), reps=10)
    lib_ms = time_ms(lambda: torch.matmul(x2, w_ih), reps=10)
    lib_f32_ms = time_ms(lambda: [torch.mm(x2, w_ih[d],
                                           out_dtype=torch.float32)
                                  for d in range(ndir)], reps=10)
    flops = 2.0 * ndir * t * b * n * f_in
    bound_ms, by = bound(flops, PEAK_BF16, 2 * (t * b * f_in
                                                + ndir * f_in * n)
                         + 4 * ndir * t * b * n)
    log(f"projection GEMM (proj_mma.cuh) M {t * b} N {n} K {f_in} D {ndir}: "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), max_abs_err "
        f"{err:.3e} vs the f32 einsum; cuBLAS torch.matmul (bf16 out) "
        f"{lib_ms:.4f} ms, torch.mm f32 out {lib_f32_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms ({by})")
    return dict(gemm_ms=ms, gemm_library_ms=lib_ms,
                gemm_library_f32_ms=lib_f32_ms, gemm_bound_ms=bound_ms,
                gemm_max_abs_err=err)


def phase_layer_fwd(torch, results, cell):
    """K2 or K3, both variants, against the plain version at full width
    (bf16 in each recurrence variant), with times, bounds and cuDNN's
    layer as the yardstick; the projection GEMM beside cuBLAS."""
    mod, _ = cell_kernels(cell)
    spec = CELLS[cell]
    layer = mod.gru_layer if cell == "gru" else mod.lstm_layer
    rng = np.random.default_rng(SEED + (1 if cell == "gru" else 8))
    t, b, h = FRAMES, BATCH, HIDDEN
    gh = spec["gates"] * h
    for f_in in (FEATURES, HIDDEN):
        x32, w_ih32, b_ih, w_hh32, b_hh, lens = layer_inputs(
            torch, rng, t, b, h, f_in, spec["gates"])
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            args = (x32.to(dt), w_ih32.to(dt), b_ih, w_hh32.to(dt), b_hh,
                    lens)
            bf16 = dt == torch.bfloat16
            worst = hold_fused(torch, cell, args,
                               FUSED_VARIANTS if bf16 else ("auto",),
                               f"F={f_in}")
            ms = time_ms(lambda: layer(*args), reps=5)
            ms_res = time_ms(lambda: layer(*args, residuals=True), reps=5)
            extra = {}
            if bf16:
                extra = dict(variant=fused_variant(torch, cell, b, h),
                             by_variant={v: time_ms(lambda: layer(
                                 *args, residuals=True, variant=v), reps=5)
                                 for v in FUSED_VARIANTS[:3]},
                             **gemm_yardstick(torch, args[0], args[1]))
                extra["step_us"] = ((ms_res - extra["gemm_ms"]) / t * 1e3)
                g_ms = extra["gemm_ms"]
                log(f"{spec['name']} {spec['fwd']} bf16 F={f_in} (with "
                    "residuals): "
                    + ", ".join(f"{v} {m:.3f} ms ({(m - g_ms) / t * 1e3:.2f}"
                                " us a step)"
                                for v, m in extra["by_variant"].items())
                    + f"; the rule chose {extra['variant']}")
            plain_ms = time_ms(lambda: mod.plain(*args, residuals=True),
                               reps=3, warmup=1)
            net = cudnn_layer(torch, args, dt, cell)
            with torch.no_grad():
                lib_ms = time_ms(lambda: net(args[0]), reps=5)
            n_valid = float(lens.sum().item())
            esize = 2 if dt == torch.bfloat16 else 4
            flops = 2.0 * 2 * n_valid * (f_in + h) * gh
            nbytes = (esize * (t * b * f_in + 2 * (f_in + h) * gh)
                      + 4 * (4 * gh + 2 * t * b * h) + 8 * b)
            if cell == "gru":  # g and hn in the operand type, both ways
                res_bytes = esize * 2 * t * b * 4 * h
            else:  # c in f32 and g in the operand type, both ways
                res_bytes = 4 * 2 * t * b * h + esize * 2 * t * b * gh
            peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32
            bound_ms, by = bound(flops, peak, nbytes)
            bound_res_ms, by_res = bound(flops, peak, nbytes + res_bytes)
            log(f"{spec['name']} {spec['fwd']} {name} F={f_in}: {ms:.3f} ms, "
                f"with residuals {ms_res:.3f} ms, plain (with residuals) "
                f"{plain_ms:.3f} ms, cuDNN {cell.upper()} {lib_ms:.3f} ms, "
                f"bound {bound_ms:.4f} ms ({by}), with residuals "
                f"{bound_res_ms:.4f} ms ({by_res})")
            if f_in == FEATURES and bf16:
                # the train path runs the residual variant
                results[spec["fwd"]] = dict(
                    route="cuda", max_abs_err=worst, ms=ms_res,
                    ms_inference=ms, plain_ms=plain_ms,
                    bound_ms=bound_res_ms, bound_by=by_res,
                    library_ms=lib_ms, extra=extra)
            del net


def step_floor(torch) -> dict:
    """Latency floor of one recurrence step as the layer kernels launch them
    (one launch per step from a host loop): the gap between empty launches,
    and each step kernel (K2, K5, K3, K7) at the least work (B 1, H 16: one
    block per direction), per step from the difference of T 376 and T 188
    so the set-up cancels."""
    from deepspeech_tpu_torch.ops.cuda import build, gru, lstm

    lib = build.load("gru_fwd")
    lib.empty_launches.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.empty_launches.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    n = 2256
    gap_ms = time_ms(lambda: build.check(
        lib, lib.empty_launches(n, stream), "empty launches"), reps=5) / n

    def tiny(t, cell, backward):  # the time does not depend on the values
        g = 16 * CELLS[cell]["gates"]
        x = torch.full((t, 1, 16), 0.5, device="cuda")
        w_ih = torch.full((2, 16, g), 0.01, device="cuda")
        w_hh = torch.full((2, 16, g), 0.01, device="cuda")
        bias = torch.zeros(2, g, device="cuda")
        lens = torch.full((1,), t, dtype=torch.int64, device="cuda")
        layer = gru.gru_layer if cell == "gru" else lstm.lstm_layer
        if not backward:
            return time_ms(lambda: layer(x, w_ih, bias, w_hh, bias, lens),
                           reps=7)
        out, r1, r2 = layer(x, w_ih, bias, w_hh, bias, lens, residuals=True)
        if cell == "gru":
            return time_ms(lambda: gru.gru_bwd(out, r1, r2, out, w_hh, lens),
                           reps=7)
        return time_ms(lambda: lstm.lstm_bwd(out, r2, r1, w_hh, lens),
                       reps=7)

    # the persistent grids' floor: a grid doing only its barrier a step, on
    # the W-resident variant's grid at H 800, D 2 and on K4's and K5's
    # 100-block grids at H 1600
    from deepspeech_tpu_torch.ops.cuda.recurrence import fwd_blocks

    lib.grid_sync_steps.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p]
    lib.grid_sync_steps.restype = ctypes.c_int
    bar = torch.zeros(1, dtype=torch.int32, device="cuda")

    def sync_ms(steps, blocks):
        return time_ms(lambda: build.check(lib, lib.grid_sync_steps(
            blocks, steps, bar.data_ptr(), stream), "grid sync"), reps=7)

    res_blocks = fwd_blocks(2, HIDDEN)[1]
    floor = dict(gap_ms=gap_ms)
    floor["sync_us"] = (sync_ms(376, res_blocks)
                        - sync_ms(188, res_blocks)) / 188 * 1e3
    floor["sync_streamed_us"] = (sync_ms(376, 100)
                                 - sync_ms(188, 100)) / 188 * 1e3
    log(f"persistent floor per step (a grid doing only its barrier, the "
        f"one grid barrier of the persistent kernels): "
        f"{floor['sync_us']:.3f} us on the W-resident grid ({res_blocks} "
        f"blocks), {floor['sync_streamed_us']:.3f} us on the streamed "
        f"grid (100 blocks); x 376 steps = "
        f"{floor['sync_us'] * 376 / 1e3:.3f} ms a call")
    for cell, key in (("gru", ""), ("lstm", "lstm_")):
        for backward, what in ((False, "step_ms"), (True, "bwd_step_ms")):
            floor[key + what] = (tiny(376, cell, backward)
                                 - tiny(188, cell, backward)) / 188
    log(f"latency floor per step: empty launch {gap_ms * 1e3:.3f} us; "
        f"least-work step K2 {floor['step_ms'] * 1e3:.3f} us, K5 "
        f"{floor['bwd_step_ms'] * 1e3:.3f} us, K3 "
        f"{floor['lstm_step_ms'] * 1e3:.3f} us, K7 "
        f"{floor['lstm_bwd_step_ms'] * 1e3:.3f} us; x 2,256 steps of a "
        f"6 x BiGRU layer stack = {2256 * floor['step_ms']:.3f} ms forward, "
        f"{2256 * floor['bwd_step_ms']:.3f} ms backward; of a 6 x BiLSTM "
        f"stack {2256 * floor['lstm_step_ms']:.3f} ms forward, "
        f"{2256 * floor['lstm_bwd_step_ms']:.3f} ms backward")
    return floor


def max_err(a, ref) -> tuple[float, float]:
    """(max abs error, max(1, max|ref|)) of two tensors."""
    return ((a.float() - ref.float()).abs().max().item(),
            max(1.0, ref.float().abs().max().item()))


@contextlib.contextmanager
def plain_path(only: tuple = ()):
    """Route every kernel call of the model, the loss and the beam search
    to its plain version (with ``only``, just the wrappers named there)."""
    from deepspeech_tpu_torch.ops.cuda import ctc, gru, lstm, stft, topk

    def stft_plain(y, n_fft, hop, window, center=True):
        return stft.plain(y, n_fft, hop, window, center=center)

    swaps = ((stft, "stft_mag", stft_plain), (gru, "gru_layer", gru.plain),
             (gru, "gru_scan", gru.plain_scan),
             (gru, "gru_bwd", gru.plain_bwd), (lstm, "lstm_layer", lstm.plain),
             (lstm, "lstm_scan", lstm.plain_scan),
             (lstm, "lstm_bwd", lstm.plain_bwd),
             (ctc, "ctc_alpha", ctc.plain_alpha),
             (ctc, "ctc_beta", ctc.plain_beta),
             (topk, "topk_total_order", topk.plain))
    swaps = tuple(w for w in swaps if not only or w[1] in only)
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def recorded(names: tuple):
    """Inside, each wrapper named in ``names`` (``stft_mag``, ``gru_layer``,
    ``gru_bwd``, ``lstm_layer``, ``lstm_bwd``, ``ctc_alpha``,
    ``ctc_beta``) records every call: {name: [(args, kwargs, result)]},
    tensors cloned, so a launch of the path itself can be held to its
    plain version on its own inputs afterwards."""
    from deepspeech_tpu_torch.ops.cuda import ctc, gru, lstm, stft

    mods = {"stft_mag": stft, "gru_layer": gru, "gru_bwd": gru,
            "lstm_layer": lstm, "lstm_bwd": lstm, "ctc_alpha": ctc,
            "ctc_beta": ctc}
    calls = {name: [] for name in names}
    saved = {name: getattr(mods[name], name) for name in names}

    def copy(v):
        if isinstance(v, (tuple, list)):
            return type(v)(copy(x) for x in v)
        return v.clone() if hasattr(v, "clone") else v

    def recorder(name):
        def call(*args, **kw):
            args, kw = copy(args), {k: copy(v) for k, v in kw.items()}
            result = saved[name](*args, **kw)
            calls[name].append((args, kw, copy(result)))
            return result
        return call

    for name in names:
        setattr(mods[name], name, recorder(name))
    try:
        yield calls
    finally:
        for name in names:
            setattr(mods[name], name, saved[name])


def hold_recorded(torch, calls: dict) -> dict:
    """Each launch ``recorded`` kept against the plain version on the same
    inputs: K1 at STFT_TOL, K2 at GRU_TOL of its operand type (its bf16
    residuals g and hn, stored in bf16, within one bf16 ulp, BF16_ULP x
    max(1, max|reference|): hn = W_hn h + b_hn is not bounded by 1, and an
    ulp at [1, 2) is 2^-7), K5's outputs at GRU_BWD_TOL x max(1,
    max|reference|), K3 at LSTM_TOL (its cell stream c x max(1, max|c|),
    as ``hold_fused``), K7's outputs at LSTM_BWD_TOL x max(1,
    max|reference|), K8's alphas and loss and K9's logit gradient at
    CTC_TOL (non-finite entries in the same places) -> {wrapper: (launches
    held, the largest max_abs_err)}."""
    from deepspeech_tpu_torch.ops.cuda import ctc, gru, lstm, stft

    plain = {"stft_mag": stft.plain, "gru_layer": gru.plain,
             "gru_bwd": gru.plain_bwd, "lstm_layer": lstm.plain,
             "lstm_bwd": lstm.plain_bwd, "ctc_alpha": ctc.plain_alpha,
             "ctc_beta": ctc.plain_beta}
    out = {}
    for name, seen in calls.items():
        worst = 0.0
        for args, kw, got in seen:
            ref = plain[name](*args, **kw)
            pairs = (tuple(zip(got, ref)) if isinstance(got, tuple)
                     else ((got, ref),))
            for i, (g, r) in enumerate(pairs):
                fin = torch.isfinite(r)
                err, scale = max_err(g[fin], r[fin]) if fin.any() else (
                    0.0, 1.0)
                worst = max(worst, err)
                if name == "gru_layer":
                    tol = GRU_TOL[str(args[0].dtype).split(".")[-1]]
                    if i > 0 and g.dtype == torch.bfloat16:
                        tol = BF16_ULP * scale
                if name == "gru_bwd":
                    tol = GRU_BWD_TOL[str(args[1].dtype).split(".")[-1]] \
                        * scale
                if name == "lstm_layer":  # (out, c, g)
                    tol = LSTM_TOL[str(args[0].dtype).split(".")[-1]] * (
                        scale if i == 1 else 1.0)
                if name == "lstm_bwd":  # args (dout, g, c, w_hh, lengths)
                    tol = LSTM_BWD_TOL[str(args[1].dtype).split(".")[-1]] \
                        * scale
                if name in RNN_HELD:
                    if not err <= tol:
                        raise AssertionError(f"{name} at "
                                             f"{tuple(args[0].shape)}"
                                             f": {err} against plain "
                                             f"(tolerance {tol})")
                else:
                    torch.testing.assert_close(
                        g, r, equal_nan=True,
                        **(STFT_TOL if name == "stft_mag" else CTC_TOL))
        out[name] = (len(seen), worst)
    return out


# the RNN wrappers ``recorded`` can hold, and where in each one's arguments
# its directions D and rows B sit: (argument, dim) of each
RNN_HELD = {"gru_layer": ((1, 0), (0, 1)), "lstm_layer": ((1, 0), (0, 1)),
            "gru_bwd": ((0, 0), (0, 2)), "lstm_bwd": ((0, 0), (0, 2))}


def held_shapes(calls: dict) -> dict:
    """{wrapper: {"directions": [D ...], "rows": [B ...]}} of the launches
    ``recorded`` kept (the rows alone for K1, K8 and K9: the batch's)."""
    out = {}
    for name, seen in calls.items():
        (di, dd), (ri, rd) = RNN_HELD.get(name, ((None, 0), (0, 0)))
        out[name] = {"rows": sorted({a[ri].shape[rd] for a, _, _ in seen})}
        if di is not None:
            out[name]["directions"] = sorted({a[di].shape[dd]
                                              for a, _, _ in seen})
    return out


def check_held(label: str, got: dict, names: tuple, ndir: int,
               rows: int) -> None:
    """A rank's first-step launches held to plain (``rank_steps``): each
    wrapper in ``names`` held LAYERS times (an RNN wrapper) or once, at
    ``ndir`` directions and ``rows`` rows."""
    for name in names:
        h = got["held"][name]
        n = LAYERS if name in RNN_HELD else 1
        if (h["launches"] != n or h["rows"] != [rows]
                or h.get("directions", [ndir]) != [ndir]):
            raise AssertionError(f"{label}: {name} held {h}, expected "
                                 f"{n} launches at D={ndir}, B {rows}")


# the wrappers' launch counters (``ops.cuda.read_counters``) by the names
# this script prints; ``<cell>_fwd_res`` counts the training variant's
# launches among ``<cell>_fwd``'s, ``<cell>_scan_res`` among
# ``<cell>_scan``'s (K4, K6); K2's projection GEMM alone (``gru.projection``)
# is not a kernel of this line
COUNT_NAMES = {("stft", "launches"): "stft_mag",
               ("ctc", "alpha_launches"): "ctc_alpha",
               ("ctc", "beta_launches"): "ctc_beta",
               ("topk", "launches"): "topk",
               **{(cell, attr): f"{cell}_{name}" for cell in ("gru", "lstm")
                  for attr, name in (("launches", "fwd"),
                                     ("res_launches", "fwd_res"),
                                     ("scan_launches", "scan"),
                                     ("scan_res_launches", "scan_res"),
                                     ("bwd_launches", "bwd"))},
               ("gru", "scan_f32_persistent_launches"):
                   "gru_scan_f32_persistent",
               ("attention", "mhsa_sdpa_launches"): "mhsa_sdpa",
               ("attention", "mhsa_plain_launches"): "mhsa_plain",
               **{("conv", f"{name}_launches"): f"conv_{name}"
                  for name in ("fprop", "dgrad", "wgrad", "reduce")}}
UNNAMED_COUNTERS = {("gru", "proj_launches")}


def conv_launches(forwards: int = 0, steps: int = 0) -> dict:
    """The conv kernels' launches (``ops.cuda.conv``) of ``forwards``
    forwards and ``steps`` train steps of a bf16 DS2: both convs' forward
    each, and a step's conv1 dgrad and both wgrads with their reductions."""
    return dict(conv_fprop=2 * (forwards + steps), conv_dgrad=steps,
                conv_wgrad=2 * steps, conv_reduce=2 * steps)


def reset_counts():
    """Every kernel's launch count to 0."""
    from deepspeech_tpu_torch.ops.cuda import reset_counters

    reset_counters()


def read_counts() -> dict:
    """Every kernel's launch count, by ``COUNT_NAMES``; a counter of the
    wrappers that is neither named nor left out on purpose raises."""
    from deepspeech_tpu_torch.ops.cuda import read_counters

    counters = read_counters()
    unknown = set(counters) - set(COUNT_NAMES) - UNNAMED_COUNTERS
    if unknown:
        raise AssertionError(f"launch counters without a name: {unknown}")
    return {name: counters[c] for c, name in COUNT_NAMES.items()}


def expect_counts(**nonzero) -> dict:
    """The launch counts of a run that launches only the named kernels."""
    return {**{k: 0 for k in read_counts()}, **nonzero}


def phase_layer_bwd(torch, results, cell):
    """K5 or K7 at full width, alone (bf16: the rule's variant and each
    variant) and through the layer's autograd Function."""
    mod, function = cell_kernels(cell)
    spec = CELLS[cell]
    tol_of = GRU_BWD_TOL if cell == "gru" else LSTM_BWD_TOL
    bwd = mod.gru_bwd if cell == "gru" else mod.lstm_bwd
    names = ("dg", "dnh", "dbi", "dbh") if cell == "gru" else ("dg", "db")
    rng = np.random.default_rng(SEED + (4 if cell == "gru" else 9))
    t, b, h = FRAMES, BATCH, HIDDEN
    gh = spec["gates"] * h
    for f_in in (FEATURES, HIDDEN):
        x32, w_ih32, b_ih, w_hh32, b_hh, lens = layer_inputs(
            torch, rng, t, b, h, f_in, spec["gates"])
        dout = torch.from_numpy(rng.standard_normal((t, b, h)).astype(
            np.float32)).cuda() * 0.1
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            tol = tol_of[name]
            x, w_ih, w_hh = x32.to(dt), w_ih32.to(dt), w_hh32.to(dt)
            out, r1, r2 = mod.plain(x, w_ih, b_ih, w_hh, b_hh, lens,
                                    residuals=True)
            d2 = dout[None].expand(2, -1, -1, -1).contiguous()
            if cell == "gru":  # r1, r2 = g, hn
                bwd_args = (d2, r1, r2, out, w_hh, lens)
            else:  # r1, r2 = c, g
                bwd_args = (d2, r2, r1, w_hh, lens)
            got = bwd(*bwd_args)
            ref = mod.plain_bwd(*bwd_args)
            errs = {k: max_err(a, r) for k, a, r in zip(names, got, ref)}
            # bf16: the rule's choice above, and each variant
            variants = (("step", "persistent") if dt == torch.bfloat16
                        else ())
            for v in variants:
                errs.update({f"{k} {v}": max_err(a, r) for k, a, r in
                             zip(names, bwd(*bwd_args, variant=v), ref)})

            def layer_grads():
                ins = [a.clone().requires_grad_(True)
                       for a in (x, w_ih, b_ih, w_hh32, b_hh)]
                o = function.apply(*ins, lens)
                return torch.autograd.grad((o[0] + o[1]), ins, dout)

            lg = layer_grads()
            with plain_path():
                lref = layer_grads()
            for k, a, r in zip(("dx", "dW_ih", "db_ih", "dW_hh", "db_hh"),
                               lg, lref):
                errs[k] = max_err(a, r)
            torch.cuda.synchronize()
            log(f"{spec['bname']} {spec['bwd']} {name} F={f_in}: "
                + ", ".join(f"{k} {e:.3e} (scale {sc:.2f})"
                            for k, (e, sc) in errs.items())
                + f"; tolerance {tol} x scale")
            bad = {k: e for k, (e, sc) in errs.items() if not e <= tol * sc}
            if bad:
                raise AssertionError(f"{spec['bwd']} {name} F={f_in} "
                                     f"disagrees with its plain version: "
                                     f"{bad}")
            if f_in != FEATURES:
                continue
            ms = time_ms(lambda: bwd(*bwd_args), reps=5)
            by_variant = {v: time_ms(lambda: bwd(*bwd_args, variant=v),
                                     reps=5) for v in variants}
            plain_ms = time_ms(lambda: mod.plain_bwd(*bwd_args), reps=2,
                               warmup=1)
            ins = [a.clone().requires_grad_(True)
                   for a in (x, w_ih, b_ih, w_hh32, b_hh)]
            o = function.apply(*ins, lens)
            layer_ms = time_ms(lambda: torch.autograd.grad(
                o[0] + o[1], ins, dout, retain_graph=True), reps=5)
            net = cudnn_layer(torch, (x, w_ih, b_ih, w_hh, b_hh, lens), dt,
                              cell)
            xin = x.clone().requires_grad_(True)
            y, _ = net(xin)
            dy = torch.cat([dout, dout], -1).to(dt)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                y, [xin] + list(net.parameters()), dy, retain_graph=True),
                reps=5)
            n_valid = float(lens.sum().item())
            esize = 2 if dt == torch.bfloat16 else 4
            flops = 2.0 * 2 * n_valid * gh * h
            peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32
            bound_ms, by = bound(flops, peak, bwd_bytes(cell, t, b, h, esize))
            log(f"{spec['bname']} {spec['bwd']} {name} F={f_in}: {ms:.3f} ms "
                f"({ms / t * 1e3:.2f} us a step"
                + "".join(f"; {v} {m:.3f} ms" for v, m in by_variant.items())
                + f"), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                f"({by}); "
                f"the layer's whole backward ({spec['bname']} + dx, dW_ih, "
                f"dW_hh on cuBLAS) {layer_ms:.3f} ms; cuDNN bidirectional "
                f"{cell.upper()} backward (dx and all weight grads) "
                f"{lib_ms:.3f} ms")
            if dt == torch.bfloat16:
                floor_ms, _ = bwd_floor(torch, w_hh, spec["gates"], b)
                log(f"{spec['bname']} {spec['bwd']} bf16 per-step L2 floor "
                    f"{floor_ms * 1e3:.2f} us")
                results[spec["bwd"]] = dict(
                    route="cuda",
                    max_abs_err=max(errs[k][0] for k in names),
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                    library_ms=lib_ms, layer_ms=layer_ms,
                    extra=dict(step_us=ms / t * 1e3, by_variant=by_variant,
                               floor_step_us=floor_ms * 1e3))
            del net, y, o


SCAN = {"gru": dict(name="K4", kernel="gru_scan", f_ins=(WIDE,)),
        "lstm": dict(name="K6", kernel="lstm_scan", f_ins=(FEATURES, WIDE))}


def route_log(torch, cell, hidden, batch):
    """Print the route each layer of 6 x Bi<cell>-<hidden> takes in bf16
    at ``batch`` (layer 0 reads the conv's FEATURES, the rest H)."""
    from deepspeech_tpu_torch.ops.cuda.route import fused_route

    gates = CELLS[cell]["gates"]
    fused, wide = CELLS[cell]["name"], SCAN[cell]["name"]
    routes = [f"layer {i}: " + (f"{fused} (fused)" if fused_route(
        f_in, hidden, gates, batch, 2, torch.bfloat16) else f"{wide} (wide)")
        for i, f_in in enumerate([FEATURES] + [hidden] * (LAYERS - 1))]
    log(f"route of 6 x Bi{cell.upper()}-{hidden} in bf16 at batch {batch}: "
        + ", ".join(routes))


def l2_floor(torch, w_pk, operand_bytes: int) -> tuple[float, float]:
    """A bf16 tensor-core step's L2 floor (K4/K6, K5/K7): the bytes a step
    brings to the SMs (the packed W_hh ``w_pk`` once, and ``operand_bytes``:
    the bf16 h or operand copy once for each block) over the read rate of
    the warm packed W_hh (a cuBLAS matrix-vector product over it, device
    time of 50 calls in a row), timed here -> (floor ms, rate bytes/s)."""
    rows = w_pk.view(-1, 1024)
    ones = torch.ones(1024, dtype=w_pk.dtype, device=w_pk.device)
    ms = device_ms(lambda: torch.mv(rows, ones))
    rate = w_pk.numel() * 2 / (ms * 1e-3)
    return (w_pk.numel() * 2 + operand_bytes) / rate * 1e3, rate


def scan_floor(torch, w_hh, gates: int, b: int) -> tuple[float, float]:
    """K4/K6's per-step L2 floor: W_hh packed by pack_w_hh, and the
    (D, B8, Hk) h copy once for each of the NJ * D blocks."""
    from deepspeech_tpu_torch.ops.cuda.recurrence import (MMA_TJ,
                                                          h_copy_shape,
                                                          pack_w_hh)

    ndir, h = w_hh.shape[:2]
    hb = h_copy_shape(ndir, b, h)
    return l2_floor(torch, pack_w_hh(w_hh, gates),
                    ndir * -(-h // MMA_TJ) * hb[2] * hb[3] * 2)


def bwd_floor(torch, w_hh, gates: int, b: int) -> tuple[float, float]:
    """K5/K7's per-step L2 floor: W_hh packed by pack_w_hh_bwd, and the
    (D, B8, Gk) operand copy once for each of the NJ * D clusters (each
    block of a cluster reads its share of K)."""
    from deepspeech_tpu_torch.ops.cuda.recurrence import (BWD_TM,
                                                          op_copy_shape,
                                                          pack_w_hh_bwd)

    ndir, h = w_hh.shape[:2]
    op = op_copy_shape(ndir, b, h, gates)
    return l2_floor(torch, pack_w_hh_bwd(w_hh),
                    ndir * -(-h // BWD_TM) * op[2] * op[3] * 2)


def bwd_bytes(cell, t, b, h, esize, ndir=2) -> float:
    """The bytes K5/K7 must move: GRU reads dout, h (f32), g, hn, W_hh and
    writes dg, dnh, dbi, dbh; LSTM reads dout, c (f32), g, W_hh and writes
    dg, db."""
    gh = CELLS[cell]["gates"] * h
    if cell == "gru":
        return (4 * ndir * 2 * t * b * h + esize * ndir * t * b * 4 * h
                + esize * ndir * h * gh + esize * ndir * t * b * 4 * h
                + 4 * ndir * 2 * gh)
    return (4 * ndir * 2 * t * b * h + esize * ndir * t * b * gh
            + esize * ndir * h * gh + esize * ndir * t * b * gh
            + 4 * ndir * gh)


def phase_bwd_wide(torch, results, cell):
    """K5 or K7 in bf16 at the wide model's width (T 376, H 1600; B 64 for
    the GRU, 20 for the LSTM; unequal lengths), on residuals of the plain
    forward: each variant against plain_bwd, then the time a call and a
    step of each beside the bound, the per-step L2 floor, the plain
    version and cuDNN's bidirectional backward (dx and all weight grads)
    with the same weights."""
    from deepspeech_tpu_torch.ops.rnn import project

    mod, _ = cell_kernels(cell)
    spec = CELLS[cell]
    gates = spec["gates"]
    bwd = mod.gru_bwd if cell == "gru" else mod.lstm_bwd
    names = ("dg", "dnh", "dbi", "dbh") if cell == "gru" else ("dg", "db")
    tol = (GRU_BWD_TOL if cell == "gru" else LSTM_BWD_TOL)["bfloat16"]
    rng = np.random.default_rng(SEED + (18 if cell == "gru" else 19))
    t, b, h = FRAMES, WIDE_BATCH[cell], WIDE
    dt = torch.bfloat16
    x32, w_ih32, b_ih, w_hh32, b_hh, lens = layer_inputs(
        torch, rng, t, b, h, WIDE, gates)
    x, w_ih, w_hh = x32.to(dt), w_ih32.to(dt), w_hh32.to(dt)
    out, r1, r2 = mod.plain_scan(project(x, w_ih), b_ih, w_hh, b_hh, lens,
                                 residuals=True)
    dout = torch.from_numpy(rng.standard_normal((t, b, h)).astype(
        np.float32)).cuda() * 0.1
    d2 = dout[None].expand(2, -1, -1, -1).contiguous()
    args = ((d2, r1, r2, out, w_hh, lens) if cell == "gru"
            else (d2, r2, r1, w_hh, lens))
    ref = mod.plain_bwd(*args)
    torch.cuda.synchronize()
    errs = {}
    for variant in ("step", "persistent", "auto"):
        got = bwd(*args, variant=variant)
        torch.cuda.synchronize()
        e = {k: max_err(a, r) for k, a, r in zip(names, got, ref)}
        log(f"{spec['bname']} {spec['bwd']} bf16 {variant} (T {t}, B {b}, "
            f"H {h}): "
            + ", ".join(f"{k} {v:.3e} (scale {sc:.2f})"
                        for k, (v, sc) in e.items())
            + f"; tolerance {tol} x scale")
        bad = {k: v for k, (v, sc) in e.items() if not v <= tol * sc}
        if bad:
            raise AssertionError(f"{spec['bwd']} bf16 {variant} at H {h} "
                                 f"disagrees with its plain version: {bad}")
        errs[variant] = max(v for v, _ in e.values())
    by = {v: time_ms(lambda: bwd(*args, variant=v), reps=5)
          for v in ("step", "persistent")}
    ms = time_ms(lambda: bwd(*args), reps=5)
    plain_ms = time_ms(lambda: mod.plain_bwd(*args), reps=1, warmup=1)
    floor_ms, rate = bwd_floor(torch, w_hh, gates, b)
    net = cudnn_layer(torch, (x, w_ih, b_ih, w_hh, b_hh, lens), dt, cell)
    xin = x.clone().requires_grad_(True)
    y, _ = net(xin)
    dy = torch.cat([dout, dout], -1).to(dt)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        y, [xin] + list(net.parameters()), dy, retain_graph=True), reps=3)
    del net, y
    flops = 2.0 * 2 * float(lens.sum().item()) * gates * h * h
    bound_ms, bound_by = bound(flops, PEAK_BF16, bwd_bytes(cell, t, b, h, 2))
    log(f"{spec['bname']} {spec['bwd']} bf16 at T {t}, B {b}, H {h}, D 2: "
        + ", ".join(f"{v} {m:.3f} ms ({m / t * 1e3:.2f} us a step)"
                    for v, m in by.items())
        + f"; the rule's choice {ms:.3f} ms ({ms / t * 1e3:.2f} us a "
        f"step); per-step L2 floor {floor_ms * 1e3:.2f} us "
        f"({floor_ms * t:.3f} ms a call) at the warm W_hh's read rate "
        f"{rate / 1e12:.2f} TB/s; plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); cuDNN bidirectional "
        f"{cell.upper()} backward (dx and all weight grads) {lib_ms:.3f} ms")
    results[spec["bwd"]].setdefault("extra", {})["wide"] = dict(
        shape=[t, b, h], ms=ms, step_us=ms / t * 1e3,
        max_abs_err=max(errs.values()), plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
        floor_step_us=floor_ms * 1e3, by_variant=by)


def phase_fused_wide(torch, results):
    """K2 at the wide GRU's layer 0 (T 376, B 64, H 1600, F 1312, bf16,
    unequal lengths): the streamed persistent variant (the rule's choice
    there) and one launch a step against plain, each timed, beside cuDNN's
    nn.GRU and the GEMM's yardstick; the W-resident variant, whose slices
    do not fit a block's shared memory there, must be refused."""
    from deepspeech_tpu_torch.ops.cuda import gru

    rng = np.random.default_rng(SEED + 21)
    t, b, h = FRAMES, WIDE_BATCH["gru"], WIDE
    dt = torch.bfloat16
    x32, w_ih32, b_ih, w_hh32, b_hh, lens = layer_inputs(
        torch, rng, t, b, h, FEATURES, 3)
    args = (x32.to(dt), w_ih32.to(dt), b_ih, w_hh32.to(dt), b_hh, lens)
    variant = fused_variant(torch, "gru", b, h)
    if variant != "persistent":
        raise AssertionError(f"K2's rule at H {h}, B {b}: {variant}, "
                             "expected persistent")
    worst = hold_fused(torch, "gru", args, ("persistent", "step", "auto"),
                       f"H={h} B={b} F={FEATURES}")
    try:
        gru.gru_layer(*args, variant="resident")
    except RuntimeError as e:
        log(f"K2 resident at H {h}, B {b}: refused ({e})")
    else:
        raise AssertionError("K2's resident variant ran at H 1600")
    by = {v: time_ms(lambda: gru.gru_layer(*args, residuals=True,
                                           variant=v), reps=5)
          for v in ("persistent", "step")}
    plain_ms = time_ms(lambda: gru.plain(*args, residuals=True), reps=1,
                       warmup=1)
    net = cudnn_layer(torch, args, dt, "gru")
    with torch.no_grad():
        lib_ms = time_ms(lambda: net(args[0]), reps=5)
    del net
    gemm = gemm_yardstick(torch, args[0], args[1])
    log(f"K2 gru_fwd bf16 at the wide layer 0 (T {t}, B {b}, H {h}, "
        f"F {FEATURES}, with residuals): "
        + ", ".join(f"{v} {m:.3f} ms ({(m - gemm['gemm_ms']) / t * 1e3:.2f}"
                    f" us a step)" for v, m in by.items())
        + f"; plain {plain_ms:.3f} ms; cuDNN GRU {lib_ms:.3f} ms")
    results["gru_fwd"].setdefault("extra", {})["wide"] = dict(
        shape=[t, b, h, FEATURES], variant=variant, ms=by[variant],
        by_variant=by, max_abs_err=worst, plain_ms=plain_ms,
        library_ms=lib_ms, gemm_ms=gemm["gemm_ms"],
        gemm_library_ms=gemm["gemm_library_ms"])


def phase_scan(torch, results, cell):
    """K4 or K6 against plain_scan at the wide model's width (T 376,
    H 1600; B 64 for the GRU, 20 for the LSTM; unequal lengths) on the wide
    route's projection of F-wide inputs, rounded to the operand type; bf16
    and K4's f32 (one launch a step, persistent, and the rule's choice) and
    K6's f32, D 2 and D 1, inference and training. Its time a call and a
    step beside its bound, the bf16 step's L2 floor, the f32 step's product
    floor, the plain version and cuDNN's bidirectional layer with the same
    weights (a yardstick that includes the projection, so the wide route's
    whole layer, projection + kernel, is timed too)."""
    from deepspeech_tpu_torch.ops.rnn import project

    mod, _ = cell_kernels(cell)
    spec = SCAN[cell]
    scan = getattr(mod, spec["kernel"])
    gates = CELLS[cell]["gates"]
    tol_of = GRU_TOL if cell == "gru" else LSTM_TOL
    names = ("h", "g", "hn") if cell == "gru" else ("h", "c", "g")
    rng = np.random.default_rng(SEED + (16 if cell == "gru" else 17))
    t, b, h = FRAMES, WIDE_BATCH[cell], WIDE
    gh = gates * h
    for f_in in spec["f_ins"]:
        x32, w_ih32, b_ih, w_hh32, b_hh, lens = layer_inputs(
            torch, rng, t, b, h, f_in, gates)
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            tol = tol_of[name]
            x, w_ih, w_hh = x32.to(dt), w_ih32.to(dt), w_hh32.to(dt)
            # the LSTM's f32 (K6) has one variant
            variants = (("step", "persistent", "auto")
                        if dt == torch.bfloat16 or cell == "gru"
                        else ("auto",))
            for ndir in (1, 2):
                args = (project(x, w_ih[:ndir]), b_ih[:ndir], w_hh[:ndir],
                        b_hh[:ndir], lens)
                ref = mod.plain_scan(*args, residuals=True)
                for variant in variants:
                    got = scan(*args, variant=variant)
                    res = scan(*args, residuals=True, variant=variant)
                    torch.cuda.synchronize()
                    err = (got - ref[0]).abs().max().item()
                    errs = [(e, sc if k == "c" else 1.0) for k, (e, sc) in
                            zip(names, (max_err(a, r)
                                        for a, r in zip(res, ref)))]
                    log(f"{spec['name']} {spec['kernel']} {name} {variant} "
                        f"D={ndir} F={f_in}: max_abs_err {err:.3e}; with "
                        "residuals "
                        + " ".join(f"{k} {e:.3e}" for k, (e, _) in
                                   zip(names, errs))
                        + f" (tolerance {tol}"
                        + (", c x max(1, max|c|))" if cell == "lstm"
                           else ")"))
                    if not (err <= tol
                            and all(e <= tol * sc for e, sc in errs)):
                        raise AssertionError(
                            f"{spec['kernel']} {name} {variant} D={ndir} "
                            f"F={f_in} disagrees with its plain version: "
                            f"{err} {errs}")
            if f_in != WIDE:
                continue
            # D = 2 from here on (the last args of the loop above)
            ms = time_ms(lambda: scan(*args), reps=5)
            ms_res = time_ms(lambda: scan(*args, residuals=True), reps=5)
            by_variant = {v: time_ms(lambda: scan(*args, residuals=True,
                                                  variant=v), reps=5)
                          for v in variants if v != "auto"}
            plain_ms = time_ms(lambda: mod.plain_scan(*args, residuals=True),
                               reps=2, warmup=1)
            layer_ms = time_ms(lambda: scan(project(x, w_ih), *args[1:]),
                               reps=5)
            net = cudnn_layer(torch, (x, w_ih, b_ih, w_hh, b_hh, lens), dt,
                              cell)
            with torch.no_grad():
                lib_ms = time_ms(lambda: net(x), reps=5)
            del net
            n_valid = float(lens.sum().item())
            esize = 2 if dt == torch.bfloat16 else 4
            # the recurrence's products; xp and W_hh in, h out; the
            # training variant adds its residuals
            flops = 2.0 * 2 * n_valid * h * gh
            nbytes = (esize * 2 * (t * b * gh + h * gh) + 4 * (4 * gh
                      + 2 * t * b * h) + 8 * b)
            if cell == "gru":  # g and hn in the operand type
                res_bytes = esize * 2 * t * b * (gh + h)
            else:  # c in f32 and the gates in the operand type
                res_bytes = 4 * 2 * t * b * h + esize * 2 * t * b * gh
            peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32
            bound_ms, by = bound(flops, peak, nbytes)
            bound_res_ms, by_res = bound(flops, peak, nbytes + res_bytes)
            if dt == torch.bfloat16:
                floor_ms, rate = scan_floor(torch, w_hh, gates, b)
                log(f"{spec['name']} {spec['kernel']} bf16 variants (with "
                    "residuals): "
                    + ", ".join(f"{v} {m:.3f} ms ({m / t * 1e3:.2f} us a "
                                f"step)" for v, m in by_variant.items())
                    + f"; per-step L2 floor {floor_ms * 1e3:.2f} us (the "
                    f"step's W_hh and h bytes at the warm W_hh's read rate "
                    f"{rate / 1e12:.2f} TB/s), {floor_ms * t:.3f} ms a "
                    "call")
            if dt == torch.float32 and len(by_variant) > 1:
                # the step's products alone at the f32 FMA peak
                floor_us = 2.0 * 2 * b * h * gh / PEAK_F32 * 1e6
                log(f"{spec['name']} {spec['kernel']} f32 variants (with "
                    "residuals): "
                    + ", ".join(f"{v} {m:.3f} ms ({m / t * 1e3:.2f} us a "
                                f"step)" for v, m in by_variant.items())
                    + f"; the rule's {ms_res:.3f} ms; a step's f32 product "
                    f"floor {floor_us:.2f} us (67 TFLOP/s), "
                    f"{floor_us * t / 1e3:.3f} ms a call")
            log(f"{spec['name']} {spec['kernel']} {name} D=2 (T {t}, B {b}, "
                f"H {h}): {ms:.3f} ms ({ms / t * 1e3:.2f} us a step), with "
                f"residuals {ms_res:.3f} ms ({ms_res / t * 1e3:.2f} us a "
                f"step), plain (with residuals) {plain_ms:.3f} ms, bound "
                f"{bound_ms:.4f} ms ({by}), with residuals "
                f"{bound_res_ms:.4f} ms ({by_res}); the wide route's layer "
                f"(projection F={f_in} on cuBLAS + {spec['name']}) "
                f"{layer_ms:.3f} ms; cuDNN {cell.upper()} (bidirectional, "
                f"projection included) {lib_ms:.3f} ms")
            if dt == torch.bfloat16:  # the train path runs this variant
                results[spec["kernel"]] = dict(
                    route="cuda", max_abs_err=max([err] + [e for e, _ in
                                                           errs]),
                    ms=ms_res, ms_inference=ms, plain_ms=plain_ms,
                    bound_ms=bound_res_ms, bound_by=by_res,
                    library_ms=lib_ms, layer_ms=layer_ms)
            elif cell == "gru":  # the f32 eval path runs the rule's choice,
                # the persistent variant here, for inference
                results["gru_scan_f32_persistent"] = dict(
                    route="cuda", max_abs_err=max([err] + [e for e, _ in
                                                           errs]),
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=by, library_ms=lib_ms, extra=dict(
                        ms_residuals=ms_res, layer_ms=layer_ms,
                        step_variant_ms=by_variant["step"],
                        product_floor_ms=floor_us * t / 1e3))


def ctc_inputs(torch, rng):
    """Logits, logit lengths, targets, target lengths at the train shape:
    unequal lengths, row 0 at full length, row 1 impossible."""
    b, t, c, lmax = BATCH, FRAMES, CLASSES, CTC_L
    logits = torch.from_numpy(rng.standard_normal((b, t, c)).astype(
        np.float32)).cuda()
    ll = torch.from_numpy(np.linspace(t, t // 2 + 12, b).astype(
        np.int64)).cuda()
    targets = torch.from_numpy(rng.integers(1, c, (b, lmax))).cuda()
    tl = torch.from_numpy(rng.integers(lmax // 4, lmax + 1, b)).cuda()
    tl[0] = lmax
    ll[1], tl[1] = lmax // 2, lmax  # L labels cannot fit L / 2 frames
    return logits, ll, targets, tl


def hold_ctc(torch, logits, ll, targets, tl, rows: dict, how=None) -> dict:
    """K8 and K9 (one launch each, on the route ``how``, by default the
    rule's) against plain_alpha / plain_beta on the same inputs: alphas,
    loss, the debug betas and dlogits within CTC_TOL, non-finite entries in
    the same places; ``rows`` names rows whose loss must not be finite
    ("inf" or "nan") and whose dlogits must be 0."""
    from deepspeech_tpu_torch.ops import ctc as ctc_loss_mod
    from deepspeech_tpu_torch.ops.cuda import ctc

    rng = np.random.default_rng(SEED + 6)
    lp, ext = ctc_loss_mod._prep(logits, targets, 0)
    g = torch.from_numpy(rng.uniform(0.5, 1.5, len(ll)).astype(
        np.float32)).cuda()
    before = (ctc.alpha_launches, ctc.beta_launches)
    alphas, loss = ctc._alpha(lp, ext, tl, ll, how)
    dl, betas = ctc._beta(lp, ext, tl, ll, alphas, loss, g, True, how)
    if (ctc.alpha_launches, ctc.beta_launches) != (before[0] + 1,
                                                   before[1] + 1):
        raise AssertionError("K8/K9 did not launch once each")
    ref_a, ref_l = ctc.plain_alpha(lp, ext, tl, ll)
    ref_d, ref_b = ctc.plain_beta(lp, ext, tl, ll, ref_a, ref_l, g,
                                  with_betas=True)
    errs = {}
    for name, got, ref in (("alphas", alphas, ref_a), ("loss", loss, ref_l),
                           ("betas", betas, ref_b), ("dlogits", dl, ref_d)):
        torch.testing.assert_close(got, ref, equal_nan=True, **CTC_TOL)
        fin = torch.isfinite(ref)
        errs[name] = max_err(got[fin], ref[fin])[0] if fin.any() else 0.0
    for row, kind in rows.items():
        bad = loss[row].item()
        if (kind == "inf" and bad != float("inf")) or (
                kind == "nan" and bad == bad):
            raise AssertionError(f"row {row}: loss {bad}, expected {kind}")
        if dl[row].abs().max().item() != 0.0:
            raise AssertionError(f"row {row}: dlogits not 0")
    fin = torch.ones_like(loss, dtype=torch.bool)
    fin[list(rows)] = False
    if not torch.isfinite(loss[fin]).all():
        raise AssertionError(f"CTC losses: {loss.tolist()}")
    return errs


def ctc_chain_floor(torch, b: int, t: int, s: int) -> float:
    """Device ms of the frame chain's floor: K8's block shape doing, for t
    frames, only one logaddexp3 on shared memory and the barrier
    (``ctc_chain_floor_f32``, csrc/ctc.cu)."""
    from deepspeech_tpu_torch.ops.cuda import build

    lib = build.load("ctc")
    lib.ctc_chain_floor_f32.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.ctc_chain_floor_f32.restype = ctypes.c_int
    out = torch.empty((b, s), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    return device_ms(lambda: build.check(lib, lib.ctc_chain_floor_f32(
        out.data_ptr(), b, t, s, stream), "ctc chain floor"))


def long_label_inputs(torch, rng, lmax: int, b: int = CTC_LONG_B):
    """``b`` rows of ``lmax`` labels with no repeats over T = 1.1 lmax + 40
    frames (S = 2 lmax + 1), the logits peaked along one alignment (label
    i at frame i, then blanks), row 1 shorter by 13 frames and 7 labels."""
    t, c = lmax + lmax // 10 + 40, CLASSES
    targets = np.empty((b, lmax), np.int64)
    logits = rng.standard_normal((b, t, c)).astype(np.float32)
    for r in range(b):
        prev = 0
        for i in range(lmax):
            prev = (prev + rng.integers(1, c - 1)) % (c - 1) + 1
            targets[r, i] = prev
        logits[r, np.arange(lmax), targets[r]] += 8.0
        logits[r, lmax:, 0] += 8.0
    ll = torch.full((b,), t).cuda()
    tl = torch.full((b,), lmax).cuda()
    ll[1], tl[1] = t - 13, lmax - 7
    return (torch.from_numpy(logits).cuda(), ll,
            torch.from_numpy(targets).cuda(), tl)


def phase_ctc_long(torch, results):
    """Long label sequences: at S 4,401 (L 2,200; the ring route's last
    size, K9 ~230 KB of shared memory) and S 4,501 (L 2,250, past it)
    each kernel held against its plain version on the rule's route and on
    the global route, with both routes timed at S 4,401 and the global
    route at S 4,501, beside F.ctc_loss on the same log-probs."""
    from deepspeech_tpu_torch.ops import ctc as ctc_loss_mod
    from deepspeech_tpu_torch.ops.cuda import ctc

    rng = np.random.default_rng(SEED + 23)
    out = {}
    for lmax in CTC_LONG_L:
        logits, ll, targets, tl = long_label_inputs(torch, rng, lmax)
        s, c = 2 * lmax + 1, CLASSES
        rule = ctc.route(s, c, True)
        hows = [None] if rule == "global" else [None, "global"]
        for how in hows:
            errs = hold_ctc(torch, logits, ll, targets, tl, {}, how)
            out[f"S {s} {how or rule} max_abs_err"] = max(errs.values())
        lp, ext = ctc_loss_mod._prep(logits, targets, 0)
        ones = torch.ones(len(ll), device="cuda")
        for how in hows:
            name = how or rule
            alphas, loss = ctc._alpha(lp, ext, tl, ll, how)
            out[f"S {s} K8 {name} device_ms"] = device_ms(
                lambda: ctc._alpha(lp, ext, tl, ll, how), reps=10)
            out[f"S {s} K9 {name} device_ms"] = device_ms(
                lambda: ctc._beta(lp, ext, tl, ll, alphas, loss, ones, False,
                                  how), reps=10)
        lpt = lp.transpose(0, 1).detach().requires_grad_(True)

        def torch_fwd():
            return torch.nn.functional.ctc_loss(lpt, targets, ll, tl,
                                                reduction="none")

        ref = torch_fwd().sum()
        out[f"S {s} F.ctc_loss forward device_ms"] = device_ms(torch_fwd,
                                                               reps=10)
        out[f"S {s} F.ctc_loss backward device_ms"] = device_ms(
            lambda: torch.autograd.grad(ref, lpt, retain_graph=True),
            reps=10)
        log(f"K8/K9 at S {s} (B {len(ll)}, T {logits.shape[1]}, L {lmax}; "
            f"the rule's route {rule}): " + ", ".join(
                f"{k.split(' ', 2)[2]} {v:.4g}" for k, v in out.items()
                if k.startswith(f"S {s} ")))
    results["ctc_alpha"]["extra"]["long_labels"] = {
        k: v for k, v in out.items() if "K9" not in k}
    results["ctc_beta"]["extra"]["long_labels"] = {
        k: v for k, v in out.items() if "K8" not in k}


def phase_ctc(torch, results):
    from deepspeech_tpu_torch.ops import ctc as ctc_loss_mod
    from deepspeech_tpu_torch.ops.cuda import ctc

    rng = np.random.default_rng(SEED + 5)
    logits, ll, targets, tl = ctc_inputs(torch, rng)
    b, t, c = logits.shape
    s = 2 * targets.shape[1] + 1
    # the train shape, row 1 impossible, and again with row 2 NaN; both on
    # the rule's route (the ring) and on the global route
    errs = hold_ctc(torch, logits, ll, targets, tl, {1: "inf"})
    nan_logits = logits.clone()
    nan_logits[2, t // 3, 3] = float("nan")
    hold_ctc(torch, nan_logits, ll, targets, tl, {1: "inf", 2: "nan"})
    global_errs = hold_ctc(torch, logits, ll, targets, tl, {1: "inf"},
                           how="global")
    hold_ctc(torch, nan_logits, ll, targets, tl, {1: "inf", 2: "nan"},
             how="global")
    # S > 1024 (L 520, S 1041), several states a thread
    big = (2, 1100, c, 520)
    big_logits = torch.from_numpy(rng.standard_normal(big[:3]).astype(
        np.float32)).cuda()
    big_errs = hold_ctc(
        torch, big_logits, torch.tensor([1100, 1000]).cuda(),
        torch.from_numpy(rng.integers(1, c, (2, 520))).cuda(),
        torch.tensor([520, 500]).cuda(), {})

    def loss_and_grad():
        lg = logits.clone().requires_grad_(True)
        per = ctc_loss_mod.ctc_loss(lg, ll, targets, tl)
        (g,) = torch.autograd.grad(
            torch.where(torch.isfinite(per), per, 0.0).sum(), lg)
        return per, g

    per, grad = loss_and_grad()
    with plain_path():
        ref_per, ref_grad = loss_and_grad()
    if torch.isfinite(per[1]) or not torch.isfinite(per[[0] + list(
            range(2, b))]).all():
        raise AssertionError(f"CTC losses: {per.tolist()}")
    if grad[1].abs().max().item() != 0.0:
        raise AssertionError("the impossible row's gradient is not 0")
    torch.testing.assert_close(per, ref_per, **CTC_TOL)
    torch.testing.assert_close(grad, ref_grad, **CTC_TOL)
    fin = torch.isfinite(per)
    log(f"K8/K9 ctc (B {b}, T {t}, C {c}, S {s}): max_abs_err alphas "
        f"{errs['alphas']:.3e}, loss {errs['loss']:.3e}, betas "
        f"{errs['betas']:.3e}, dlogits {errs['dlogits']:.3e}; impossible "
        f"row: loss inf, dlogits 0; NaN row: loss NaN, dlogits 0; at S 1041 "
        f"(B 2, T 1,100): alphas {big_errs['alphas']:.3e}, betas "
        f"{big_errs['betas']:.3e}, dlogits {big_errs['dlogits']:.3e}; the "
        f"layer's loss {max_err(per[fin], ref_per[fin])[0]:.3e}, grad "
        f"{max_err(grad, ref_grad)[0]:.3e} against the plain path")

    lp, ext = ctc_loss_mod._prep(logits, targets, 0)
    alphas, loss = ctc.ctc_alpha(lp, ext, tl, ll)
    ones = torch.ones(b, device="cuda")

    def k8(how=None):
        return ctc._alpha(lp, ext, tl, ll, how)

    def k9(how=None):
        return ctc._beta(lp, ext, tl, ll, alphas, loss, ones, False, how)

    a_ms, b_ms = time_ms(k8, reps=20), time_ms(k9, reps=20)
    a_dev, b_dev = device_ms(k8), device_ms(k9)
    a_glob = device_ms(lambda: k8("global"))
    b_glob = device_ms(lambda: k9("global"))
    log(f"K8/K9 global route at the train shape: max_abs_err "
        f"{max(global_errs.values()):.3e}, device K8 {a_glob:.4f} ms, K9 "
        f"{b_glob:.4f} ms (the ring's: {a_dev:.4f}, {b_dev:.4f})")
    pa_ms = time_ms(lambda: ctc.plain_alpha(lp, ext, tl, ll), reps=3,
                    warmup=1)
    pb_ms = time_ms(lambda: ctc.plain_beta(lp, ext, tl, ll, alphas, loss,
                                           ones), reps=3, warmup=1)
    floor_ms = ctc_chain_floor(torch, b, t, s)
    port_ms, port_dev = time_ms(loss_and_grad, reps=10), device_ms(
        loss_and_grad, reps=20)
    # F.ctc_loss on the same log-probs, a leaf: its forward, its backward
    # (the gradient w.r.t. the log-probs), and both
    lpt = lp.transpose(0, 1).detach()
    lpt.requires_grad_(True)

    def torch_fwd():
        return torch.nn.functional.ctc_loss(lpt, targets, ll, tl,
                                            reduction="none")

    ref_loss = torch_fwd().sum()

    def torch_bwd():
        return torch.autograd.grad(ref_loss, lpt, retain_graph=True)

    def torch_both():
        return torch.autograd.grad(torch_fwd().sum(), lpt)

    lib_fwd_ms, lib_fwd_dev = time_ms(torch_fwd), device_ms(torch_fwd)
    lib_bwd_ms, lib_bwd_dev = time_ms(torch_bwd), device_ms(torch_bwd)
    lib_ms, lib_dev = time_ms(torch_both), device_ms(torch_both, reps=20)
    # the bytes each kernel must move (this run's frames below the lengths)
    # and ~12 operations a state and frame (3 exp, 1 log, adds, compares),
    # for K9 ~6 more for gamma and ~4 a class and frame for dlogits
    n_valid = float(ll.clamp(max=t).sum().item())
    tables = 4.0 * (b * s + 2 * b)  # ext, the two lengths
    a_bytes = 4.0 * (n_valid * c + b * t * s + b) + tables
    b_bytes = 4.0 * (n_valid * (c + s) + b * t * c + 2 * b) + tables
    a_bound, a_by = bound(12.0 * n_valid * s, PEAK_F32, a_bytes)
    b_bound, b_by = bound(18.0 * n_valid * s + 4.0 * n_valid * c, PEAK_F32,
                          b_bytes)
    log(f"K8 ctc_alpha: device {a_dev:.4f} ms ({a_ms:.4f} by events around "
        f"a call), plain {pa_ms:.3f} ms, bound {a_bound:.4f} ms ({a_by}), "
        f"chain floor {floor_ms:.4f} ms; F.ctc_loss forward device "
        f"{lib_fwd_dev:.4f} ms ({lib_fwd_ms:.4f})")
    log(f"K9 ctc_beta (with dlogits): device {b_dev:.4f} ms ({b_ms:.4f}), "
        f"plain {pb_ms:.3f} ms, bound {b_bound:.4f} ms ({b_by}), chain "
        f"floor {floor_ms:.4f} ms; F.ctc_loss backward device "
        f"{lib_bwd_dev:.4f} ms ({lib_bwd_ms:.4f})")
    log(f"CTC layer, loss + dlogits (K8, K9 and the glue): device "
        f"{port_dev:.4f} ms ({port_ms:.4f}); F.ctc_loss forward + backward "
        f"device {lib_dev:.4f} ms ({lib_ms:.4f})")
    results["ctc_alpha"] = dict(
        route="cuda", max_abs_err=max(errs["alphas"], errs["loss"],
                                      global_errs["alphas"],
                                      global_errs["loss"]),
        ms=a_ms, plain_ms=pa_ms, bound_ms=a_bound, bound_by=a_by,
        library_ms=lib_fwd_ms,
        extra=dict(ctc_route=ctc.route(s, c, False), device_ms=a_dev,
                   global_route_device_ms=a_glob, chain_floor_ms=floor_ms,
                   library_device_ms=lib_fwd_dev))
    results["ctc_beta"] = dict(
        route="cuda", max_abs_err=max(errs["betas"], errs["dlogits"],
                                      global_errs["betas"],
                                      global_errs["dlogits"]),
        ms=b_ms, plain_ms=pb_ms, bound_ms=b_bound, bound_by=b_by,
        library_ms=lib_bwd_ms,
        extra=dict(ctc_route=ctc.route(s, c, True), device_ms=b_dev,
                   global_route_device_ms=b_glob, chain_floor_ms=floor_ms,
                   library_device_ms=lib_bwd_dev, layer_ms=port_ms,
                   layer_device_ms=port_dev, library_layer_ms=lib_ms,
                   library_layer_device_ms=lib_dev))


def default_model(torch, seed, cell="gru", hidden=HIDDEN):
    from deepspeech_tpu_torch.models import build_model

    model, meta = build_model(cell, CLASSES, hidden, LAYERS,
                              bidirectional=True,
                              compute_dtype="bfloat16", device="cuda")
    random_weights(model, np.random.default_rng(seed))
    return model, meta


def phase_forward(torch, counts, floor, cell="gru", hidden=HIDDEN,
                  batch=BATCH, want=None):
    """The bf16 forward of 6 x Bi<cell>-<hidden> on ``batch`` x 7.5 s:
    featurize -> forward -> greedy ids, its launches against ``want`` (by
    default K1 and the fused layer kernel in every layer), the logits held
    to the plain versions, timed and profiled."""
    from deepspeech_tpu_torch.audio.features import AudioConf, featurize_batch
    from deepspeech_tpu_torch.decoders import greedy_ids

    seed = SEED + (2 if cell == "gru" else 10) + (hidden != HIDDEN) * 20
    rng = np.random.default_rng(seed)
    model, meta = default_model(torch, seed, cell, hidden)
    model.eval()
    b, s = batch, AUDIO_S
    audio = torch.from_numpy(np.stack([synthetic_audio(rng, s)
                                       for _ in range(b)])).cuda()
    lengths = torch.full((b,), s, dtype=torch.int64).cuda()
    conf = AudioConf()

    def forward():
        spect, frames = featurize_batch(audio, lengths, conf)
        logits, probs, out_lens = model(spect, frames)
        return logits, probs, out_lens, greedy_ids(probs)

    with torch.inference_mode():
        reset_counts()
        logits, probs, out_lens, ids = forward()
        torch.cuda.synchronize()
        counts.update(read_counts())
        log(f"{cell}-{hidden} inference path (bf16 forward, batch {b}): "
            f"launches {counts}")
        want = want or expect_counts(stft_mag=1, **conv_launches(1),
                                     **{f"{cell}_fwd": LAYERS})
        if counts != want:
            raise AssertionError(f"inference path: launches {counts}, "
                                 f"expected {want}")
        with plain_path():
            ref_logits, _, ref_lens, ref_ids = forward()
        torch.cuda.synchronize()
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        if (logits.shape != (b, FRAMES, CLASSES)
                or not (out_lens == FRAMES).all()):
            raise AssertionError(f"logits {tuple(logits.shape)}, "
                                 f"lengths {out_lens.tolist()}")
        if not torch.equal(out_lens, ref_lens):
            raise AssertionError("output lengths differ from the plain path")
        torch.testing.assert_close(probs.sum(-1),
                                   torch.ones_like(probs[..., 0]))
        scale = max(1.0, ref_logits.abs().max().item())
        err = (logits - ref_logits).abs().max().item()
        agree = (ids == ref_ids).float().mean().item()
        log(f"{cell}-{hidden} inference path: logits max_abs_err vs plain "
            f"{err:.3e} "
            f"(scale "
            f"{scale:.2f}, tolerance {LOGIT_TOL * scale:.3e}); greedy ids "
            f"agree on {agree:.4%} of frames")
        if not err <= LOGIT_TOL * scale:
            raise AssertionError(f"forward disagrees with plain: {err}")
        ms = time_ms(forward, reps=5, warmup=1)
        with plain_path():
            plain_ms = time_ms(forward, reps=1, warmup=0)
        profile_run(torch, f"{cell}-{hidden} forward", forward, ms, floor)
    audio_s = b * s / conf.sample_rate
    log(f"{cell}-{hidden} inference path: {ms:.3f} ms per forward of {b} x "
        f"{s / SR} s (featurize + 6 x Bi{cell.upper()}-{hidden} bf16 + "
        f"greedy) = "
        f"{audio_s / (ms / 1e3):.1f} audio-s/s; through the plain versions "
        f"{plain_ms:.3f} ms")
    return model, meta


def trace_events(torch, fn) -> list:
    """``fn`` once under torch.profiler (CPU and CUDA activities) -> the
    Chrome trace's events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_ops(events: list) -> list:
    """The device ops of a trace's ``events`` as (start us, end us, name),
    in order."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))


def busy_of(ops: list) -> tuple[float, float]:
    """(the span from the first of ``ops`` to the end of the last, the busy
    time within it: the union of their intervals); (0, 0) for none."""
    if not ops:
        return 0.0, 0.0
    busy, (lo, hi) = 0.0, ops[0][:2]
    for start, end, _ in ops[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy += hi - lo
    return max(end for _, end, _ in ops) - ops[0][0], busy


def device_busy(torch, fn) -> tuple[list, float, float]:
    """``fn`` once under torch.profiler -> (its device ops as (start us,
    end us, name), the trace timeline's span from the first device op to
    the end of the last, the busy time within it: the union of kernel,
    memcpy and memset intervals); ([], 0, 0) where the trace holds no
    device op."""
    ops = device_ops(trace_events(torch, fn))
    return (ops, *busy_of(ops))


def profile_run(torch, label, fn, ms: float, floor: dict):
    """One call of ``fn`` under torch.profiler: device time by kernel, and
    the device's busy and idle time on its trace timeline
    (``device_busy``)."""
    ops, span, busy = device_busy(torch, fn)
    if not ops:
        log(f"profile of one {label}: the trace holds no device op; busy "
            "and idle time not measured")
        return
    log(f"profile of one {label} ({ms:.3f} ms unprofiled, CUDA events): "
        f"{len(ops)} device ops over {span / 1e3:.3f} ms of trace timeline, "
        f"busy {busy / 1e3:.3f} ms, idle {(span - busy) / 1e3:.3f} ms "
        f"({(span - busy) / span:.2%})")
    by_name: dict = {}
    for start, end, name in ops:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + end - start)
    for name, (n, t) in sorted(by_name.items(), key=lambda r: -r[1][1])[:16]:
        log(f"  {t / 1e3:9.3f} ms {n:6d} x {name[:90]}")
    for kernel, key, what in (("gru_step", "step_ms", "K2/K4"),
                              ("bwd_step", "bwd_step_ms", "K5"),
                              ("lstm_step", "lstm_step_ms", "K3/K6"),
                              ("lstm_bwd_step", "lstm_bwd_step_ms", "K7")):
        # whole words: K5's bwd_step is not K7's lstm_bwd_step
        steps = [(n, t) for name, (n, t) in by_name.items()
                 if re.search(rf"\b{kernel}\b", name)]
        if steps:
            n, t = map(sum, zip(*steps))
            log(f"{what} step at full width: {t / n:.3f} us of kernel time "
                f"per step ({n} steps), {t / n / (floor[key] * 1e3):.1f}x "
                f"the least-work step of {floor[key] * 1e3:.3f} us")
    # the bf16 forward recurrences (rnn_mma.cuh): on an f32 stream K2 (G 3)
    # and K3 (G 4), on a bf16 stream K4 and K6; proj_mma.cuh is K2's and
    # K3's projection GEMM
    for stream_t, gates, what in (("float", 3, "K2"), ("float", 4, "K3"),
                                  ("__nv_bfloat16", 3, "K4"),
                                  ("__nv_bfloat16", 4, "K6")):
        runs = [(n, t) for name, (n, t) in by_name.items()
                if re.search(rf"mma_rnn::\w+_kernel<{stream_t}, {gates}\b",
                             name)]
        if runs:
            n, t = map(sum, zip(*runs))
            log(f"{what} bf16 recurrence (rnn_mma.cuh): {t / 1e3:.3f} ms of "
                f"kernel time in {n} launches")
    runs = [(n, t) for name, (n, t) in by_name.items()
            if "proj_mma::gemm_kernel" in name]
    if runs:
        n, t = map(sum, zip(*runs))
        log(f"K2/K3 bf16 projection GEMM (proj_mma.cuh): {t / 1e3:.3f} ms "
            f"of kernel time in {n} launches")
    # the bf16 K5/K7 (rnn_mma_bwd.cuh): G 3 is the GRU's, 4 the LSTM's
    for gates, what in ((3, "K5"), (4, "K7")):
        runs = [(n, t) for name, (n, t) in by_name.items()
                if re.search(rf"mma_bwd::\w+_kernel<{gates}\b", name)]
        if runs:
            n, t = map(sum, zip(*runs))
            log(f"{what} bf16 (rnn_mma_bwd.cuh): {t / 1e3:.3f} ms of kernel "
                f"time in {n} launches")


def train_batch(torch, rng, labels: str, batch=BATCH, audio=AUDIO_S):
    """``batch`` synthetic waveforms of ``audio`` samples (7.5 s) down to
    ~0.9 of that with random transcripts, collated on the int16 wire as the
    train CLI does, on the card."""
    from deepspeech_tpu_torch.data import BucketSpec, collate_batch

    samples = []
    for i in range(batch):
        n = audio - audio // 30 * (i % 5)  # unequal, the longest full
        words = ["".join(rng.choice(list(labels[2:28]), rng.integers(2, 8)))
                 for _ in range(rng.integers(FRAMES // 40 + 1,
                                             FRAMES // 27 + 2))]
        ids = [labels.index(ch) for ch in " ".join(words)]
        samples.append({"audio": synthetic_audio(rng, n),
                        "target": np.asarray(ids, np.int32),
                        "path": f"synthetic{i}"})
    out = collate_batch(samples, batch, BucketSpec(
        reflect_tail=160, audio_step=8000, wire_dtype="int16"))
    out.pop("paths")
    return {k: torch.from_numpy(v).cuda() for k, v in out.items()}


def step_grads(torch, model, batch, jitter):
    """Loss, per-parameter gradients and grad norm of one train step's
    forward and backward, with TF32 off throughout as the step runs it;
    a hook on the first conv's weight records cuDNN's TF32 flag at the
    moment its gradient is made."""
    from deepspeech_tpu_torch.ops import fp32_matmul
    from deepspeech_tpu_torch.train.optim import global_norm
    from deepspeech_tpu_torch.train.step import StepConfig, _loss, featurize

    flags = []
    hook = model.conv.conv0.weight.register_hook(
        lambda g: flags.append(torch.backends.cudnn.allow_tf32))
    model.train()
    names, params = zip(*model.named_parameters())
    with fp32_matmul():
        spect, lengths = featurize(batch, StepConfig(), jitter)
        logits, _, out_lens = model(spect, lengths)
        loss, _ = _loss(logits, out_lens, batch)
        grads = torch.autograd.grad(loss, params)
    hook.remove()
    if flags != [False]:
        raise AssertionError(f"cuDNN TF32 during the backward: {flags}")
    return loss.detach(), dict(zip(names, grads)), global_norm(grads)


def phase_train(torch, counts, floor, cell="gru", hidden=HIDDEN,
                batch_size=BATCH, want=None):
    """One bf16 train step of 6 x Bi<cell>-<hidden> at ``batch_size`` x
    7.5 s:
    its loss, grad norm and every gradient against the plain path, its
    launches against ``want`` (by default K1, the fused layer kernel with
    residuals and the backward kernel in every layer, K8 and K9), then 5
    steps and a profiled one."""
    from deepspeech_tpu_torch.train.optim import build_optimizer
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_train_step)

    seed = SEED + (6 if cell == "gru" else 11) + (hidden != HIDDEN) * 20
    rng = np.random.default_rng(seed)
    labels = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 "
    model, _ = default_model(torch, seed, cell, hidden)
    route_log(torch, cell, hidden, batch_size)
    batch = train_batch(torch, rng, labels, batch_size)
    jitter = torch.from_numpy(rng.uniform(-0.5, 0.5, batch_size).astype(
        np.float32)).cuda()
    init = {k: v.clone() for k, v in model.state_dict().items()}

    loss, grads, norm = step_grads(torch, model, batch, jitter)
    model.load_state_dict(init)
    with plain_path():
        ref_loss, ref_grads, ref_norm = step_grads(torch, model, batch,
                                                   jitter)
    model.load_state_dict(init)
    torch.cuda.synchronize()
    rel_loss = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    rel_norm = abs(norm.item() - ref_norm.item()) / ref_norm.item()
    worst = max(((max_err(grads[k], ref_grads[k])[0]
                  / max_err(grads[k], ref_grads[k])[1], k) for k in grads))
    log(f"{cell}-{hidden} train step vs plain path: loss "
        f"{loss.item():.4f} / "
        f"{ref_loss.item():.4f} (rel {rel_loss:.2e}), grad norm "
        f"{norm.item():.4f} / {ref_norm.item():.4f} (rel {rel_norm:.2e}); "
        f"{len(grads)} parameter grads, worst {worst[1]} at "
        f"{worst[0]:.2e} x scale (tolerances {STEP_LOSS_TOL}, "
        f"{STEP_GRAD_TOL} x scale)")
    if not (rel_loss <= STEP_LOSS_TOL and rel_norm <= STEP_LOSS_TOL
            and worst[0] <= STEP_GRAD_TOL):
        raise AssertionError("train step disagrees with the plain path")
    zero = [k for k, g in grads.items() if not g.abs().max().item() > 0]
    if zero:
        raise AssertionError(f"parameters without a gradient: {zero}")

    optimizer = build_optimizer("sgd", lr=3e-4, momentum=0.9, max_norm=100.0)
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, optimizer, StepConfig())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    times, losses = [], []
    for i in range(5):
        if i == 0:
            reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(state, batch, generator=gen)
        end.record()
        end.synchronize()
        if i == 0:
            counts.update(read_counts())
            log(f"{cell}-{hidden} train path, one step: launches {counts}")
            want = want or expect_counts(
                stft_mag=1, ctc_alpha=1, ctc_beta=1, **conv_launches(steps=1),
                **{f"{cell}_{k}": LAYERS for k in ("fwd", "fwd_res", "bwd")})
            if counts != want:
                raise AssertionError(f"train step launches {counts}, "
                                     f"expected {want}")
        times.append(start.elapsed_time(end))
        losses.append(m["loss"].item())
        if not np.isfinite(losses[-1]) or bool(m["step_skipped"]):
            raise AssertionError(f"step {i}: loss {losses[-1]}, skipped "
                                 f"{bool(m['step_skipped'])}")
        log(f"train step {i + 1}: loss {losses[-1]:.4f}, grad norm "
            f"{m['grad_norm'].item():.3f}, {times[-1]:.3f} ms")
    ms = float(np.median(times[1:]))
    audio_s = float(batch["audio_lengths"].sum().item()) / SR
    log(f"{cell}-{hidden} train path: {ms:.3f} ms per step (median of "
        f"steps 2-5, CUDA events) for {audio_s:.2f} s of audio = "
        f"{audio_s / (ms / 1e3):.1f} audio-s/s (bf16, 6 x Bi{cell.upper()}"
        f"-{hidden}, batch {batch_size})")
    profile_run(torch, f"{cell}-{hidden} train step",
                lambda: step(state, batch, generator=gen), ms, floor)
    return dict(ms=ms, rel_loss=rel_loss, rel_norm=rel_norm,
                grad_worst=worst[0])


def phase_cli(torch, model, meta, counts):
    from deepspeech_tpu_torch.audio.features import AudioConf
    from deepspeech_tpu_torch.audio.io import save_wav
    from deepspeech_tpu_torch.cli.transcribe import main
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
            save_wav(wavs[-1], synthetic_audio(rng, int(seconds * SR)), SR)
        reset_counts()
        for wav in wavs:
            text, dt = transcribe_once(main, path, wav)
            log(f"transcribe {os.path.basename(wav)}: {len(text)} chars in "
                f"{dt:.3f} s (host clock, checkpoint load included): "
                f"{text[:60]!r}")
        torch.cuda.synchronize()
        counts.update(read_counts())
        log(f"transcribe CLI (f32): launches {counts}")
        if counts != expect_counts(stft_mag=3, gru_fwd=3 * LAYERS):
            raise AssertionError(f"CLI path missed a kernel: {counts}")


def transcribe_once(main, path: str, wav: str,
                    *flags: str) -> tuple[str, float]:
    """One transcribe CLI request -> (transcription, host seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(["--model-path", path, "--audio-path", wav, "--offsets",
                   *flags])
    dt = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"transcribe exited {rc}")
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    return out["output"][0]["transcription"], dt


def phase_train_cli(torch, cell="gru"):
    """The train CLI, 1 epoch at full width on a synthetic manifest, then
    one transcribe request on its final checkpoint."""
    from deepspeech_tpu_torch.audio.io import save_wav
    from deepspeech_tpu_torch.cli.train import main as train_main
    from deepspeech_tpu_torch.cli.transcribe import main as transcribe_main

    rng = np.random.default_rng(SEED + 7)
    texts = ["HELLO WORLD", "THE QUICK BROWN FOX", "A DOG RAN HOME",
             "GOOD DAY TO YOU", "SPEECH ON THE CARD", "TRAIN AND TEST"]
    labels_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "labels.json")
    with tempfile.TemporaryDirectory() as d:
        rows = []
        for i, text in enumerate(texts):
            n = int(SR * (1.5 + 0.5 * i))
            wav, txt = os.path.join(d, f"u{i}.wav"), os.path.join(d,
                                                                 f"u{i}.txt")
            save_wav(wav, synthetic_audio(rng, n), SR)
            with open(txt, "w") as f:
                f.write(text)
            rows.append(f"{wav},{txt},{n / SR}")
        manifest = os.path.join(d, "manifest.csv")
        with open(manifest, "w") as f:
            f.write("\n".join(rows) + "\n")
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train_main(["--train-manifest", manifest, "--val-manifest",
                             manifest, "--labels-path", labels_path,
                             "--epochs", "1", "--batch-size", "3",
                             "--val-batch-size", "3", "--num-workers", "2",
                             "--hidden-size", str(HIDDEN),
                             "--hidden-layers", str(LAYERS),
                             "--rnn-type", cell,
                             "--save-folder", os.path.join(d, "models")])
        dt = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            log(f"  train CLI: {line}")
        if rc != 0:
            raise AssertionError(f"train CLI exited {rc}")
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"train CLI --rnn-type {cell} (6 x Bi{cell.upper()}-800 bf16, 2 "
            f"steps + validation): {dt:.3f} s host clock, launches {counts}")
        # 2 train steps, then 2 validation batches (forward and loss only)
        want = expect_counts(stft_mag=4, ctc_alpha=4, ctc_beta=2,
                             **conv_launches(2, 2),
                             **{f"{cell}_fwd": 4 * LAYERS,
                                f"{cell}_fwd_res": 2 * LAYERS,
                                f"{cell}_bwd": 2 * LAYERS})
        if counts != want:
            raise AssertionError(f"train CLI launches {counts}, expected "
                                 f"{want}")
        final = os.path.join(d, "models", "deepspeech_final.ckpt")
        text, dt = transcribe_once(transcribe_main, final,
                                   os.path.join(d, "u0.wav"))
        log(f"transcribe on the trained {cell} checkpoint: {len(text)} "
            f"chars in "
            f"{dt:.3f} s: {text[:60]!r}")


def phase_train_augmented(torch, floor: dict) -> dict:
    """The GRU-800 train step at batch 20 x 7.5 s on the int16 wire, 5
    steps each without augmentation and with the device augmentation of
    the train CLI's ``--device-noise --aug-prob-spect 0.5 --aug-prob-8khz
    0.2`` (noise prob 0.4, limit 0.2, a bank of 4 clips of twice the
    batch's width), alternating, in one process: CUDA-event medians of
    steps 2-5 of each, then one profiled step of each (busy and idle)."""
    from deepspeech_tpu_torch.audio.features import AudioConf
    from deepspeech_tpu_torch.train.optim import build_optimizer
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_train_step)

    rng = np.random.default_rng(SEED + 24)
    model, _ = default_model(torch, SEED + 24)
    batch = train_batch(torch, rng, LABELS, BATCH)
    width = 2 * batch["audio"].shape[1]
    bank = 0.3 * torch.randn(4, width, device="cuda")
    bank_lengths = torch.full((4,), width, dtype=torch.int32, device="cuda")
    aug = dict(batch, noise_bank=bank, noise_bank_lengths=bank_lengths)
    configs = {
        "plain": (StepConfig(), batch),
        "augmented": (StepConfig(
            audio_conf=AudioConf(aug_prob_spect=0.5, aug_prob_8khz=0.2),
            device_noise_prob=0.4, device_noise_limit=0.2), aug)}
    optimizer = build_optimizer("sgd", lr=3e-4, momentum=0.9, max_norm=100.0)
    state = TrainState.create(model, optimizer)
    steps = {k: make_train_step(model, optimizer, cfg)
             for k, (cfg, _) in configs.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    times: dict = {k: [] for k in configs}
    for i in range(5):
        for name, (_, b) in configs.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = steps[name](state, b, generator=gen)
            end.record()
            end.synchronize()
            if not np.isfinite(m["loss"].item()) or bool(m["step_skipped"]):
                raise AssertionError(f"{name} step {i}: loss "
                                     f"{m['loss'].item()}")
            times[name].append(start.elapsed_time(end))
    out = {k: float(np.median(v[1:])) for k, v in times.items()}
    log(f"gru-800 train step with the device augmentation (noise mix, "
        f"SpecAugment p 0.5, 8 kHz p 0.2): {out['augmented']:.3f} ms "
        f"against {out['plain']:.3f} ms without (medians of steps 2-5, "
        f"alternating): {out['augmented'] - out['plain']:+.3f} ms")
    for name, (_, b) in configs.items():
        profile_run(torch, f"gru-800 train step, {name}",
                    lambda: steps[name](state, b, generator=gen), out[name],
                    floor)
    return out


class _StepClock:
    """An observer of the train CLI: the host clock at each hook, and the
    (epoch, iteration) of each batch start."""

    def __init__(self):
        self.starts, self.epochs, self.t = [], [], []

    def on_epoch_start(self, epoch, **kw):
        self.epochs.append(epoch)

    def on_epoch_end(self, epoch, **kw):
        pass

    def on_batch_start(self, epoch, iteration, **kw):
        self.starts.append((epoch, iteration))
        self.t.append(time.perf_counter())

    def on_batch_end(self, epoch, iteration, **kw):
        pass

    def on_checkpoint(self, epoch, iteration, path, **kw):
        pass


def phase_train_cli_full(torch) -> dict:
    """The rest of the train CLI at full width (6 x BiGRU-800, bf16) on a
    synthetic manifest of CLI_FULL_UTTS utterances of 6.8-7.5 s (batch
    20: 3 steps an epoch) with synthetic noise wavs, in a temporary
    directory: one epoch with every newly ported flag (--augment --aug-type
    0, the device masks and noise mix, --checkpoint-per-samples 40 (2
    batches) with
    --checkpoint-anneal 1.1, --train-val-manifest, the JSONL log, --visdom,
    --log-params, a torch.profiler trace of step 1), then a resume from its
    mid-epoch checkpoint (epoch 1, iteration 2) for epoch 2. Holds the
    launches of a step and of validation, the files written, the restored
    optimizer leaves against the saved ones on the card, the annealed LR,
    and that no epoch is re-run; then, on the manifest repeated to
    RATE_WARM + RATE_STEPS + 1 batches, the loader's batches/s alone and
    the CLI's steps/s over the last RATE_STEPS gaps between batches, each
    with and without the host waveform pipeline (--augment)."""
    from deepspeech_tpu_torch.audio.features import AudioConf
    from deepspeech_tpu_torch.audio.io import save_wav
    from deepspeech_tpu_torch.cli.train import main as train_main
    from deepspeech_tpu_torch.data import (AudioDataLoader, AudioDataset,
                                           BucketingSampler, BucketSpec)
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.train import checkpoint as ckpt
    from deepspeech_tpu_torch.train.optim import (build_optimizer,
                                                  to_optax_leaves,
                                                  tree_leaves)
    from deepspeech_tpu_torch.train.step import TrainState

    rng = np.random.default_rng(SEED + 25)
    labels_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "labels.json")
    out: dict = {}
    with tempfile.TemporaryDirectory() as d:
        rows = []
        for i in range(CLI_FULL_UTTS):
            n = AUDIO_S - AUDIO_S // 30 * (i % 5)
            words = ["".join(rng.choice(list(LABELS[2:28]),
                                        rng.integers(2, 8)))
                     for _ in range(rng.integers(10, 15))]
            wav, txt = (os.path.join(d, f"u{i}.wav"),
                        os.path.join(d, f"u{i}.txt"))
            save_wav(wav, synthetic_audio(rng, n), SR)
            with open(txt, "w") as f:
                f.write(" ".join(words))
            rows.append(f"{wav},{txt},{n / SR}")
        train = os.path.join(d, "train.csv")
        with open(train, "w") as f:
            f.write("\n".join(rows) + "\n")
        val = os.path.join(d, "val.csv")
        with open(val, "w") as f:
            f.write("\n".join(rows[:6]) + "\n")
        os.makedirs(os.path.join(d, "noise"))
        for i in range(3):
            save_wav(os.path.join(d, "noise", f"n{i}.wav"),
                     (0.5 * rng.standard_normal(SR * (4 + 3 * i))).clip(
                         -1, 1).astype(np.float32), SR)
        noise = os.path.join(d, "noise", "*.wav")
        logs, prof = os.path.join(d, "logs"), os.path.join(d, "prof")
        base = ["--train-manifest", train, "--val-manifest", val,
                "--labels-path", labels_path, "--batch-size", str(BATCH),
                "--val-batch-size", str(BATCH), "--num-workers", "4",
                "--hidden-size", str(HIDDEN), "--hidden-layers", str(LAYERS),
                "--log-dir", logs]
        full = ["--augment", "--aug-type", "0", "--aug-prob-spect", "0.5",
                "--aug-prob-8khz", "0.2", "--noise-dir", noise,
                "--device-noise", "--checkpoint-per-samples", str(2 * BATCH),
                "--checkpoint-anneal", "1.1", "--train-val-manifest", val,
                "--visdom", "--log-params", "--profile-dir", prof,
                "--profile-start", "1", "--profile-steps", "1"]

        def run(argv, label):
            clock = _StepClock()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = train_main(base + argv, observers=[clock])
            dt = time.perf_counter() - t0
            for line in buf.getvalue().splitlines():
                log(f"  train CLI ({label}): {line}")
            if rc != 0:
                raise AssertionError(f"train CLI ({label}) exited {rc}")
            torch.cuda.synchronize()
            return clock, buf.getvalue(), dt

        first = os.path.join(d, "first")
        reset_counts()
        clock, text, dt = run(full + ["--epochs", "1", "--save-folder", first,
                                      "--id", "full"], "every flag")
        counts = read_counts()
        out["launches"] = counts
        # 3 train steps; validation at the mid-epoch checkpoint and at the
        # epoch's end, each over the val and train-val manifests (vb
        # batches each)
        vb = -(-6 // BATCH)
        want = expect_counts(stft_mag=3 + 4 * vb, ctc_alpha=3 + 4 * vb,
                             ctc_beta=3, gru_fwd=(3 + 4 * vb) * LAYERS,
                             gru_fwd_res=3 * LAYERS, gru_bwd=3 * LAYERS,
                             **conv_launches(4 * vb, 3))
        log(f"train CLI with every flag (6 x BiGRU-800 bf16, 3 steps + 4 "
            f"validation batches): {dt:.3f} s host clock, launches {counts}")
        if counts != want:
            raise AssertionError(f"train CLI launches {counts}, expected "
                                 f"{want}")
        if clock.starts != [(0, 0), (0, 1), (0, 2)]:
            raise AssertionError(f"batches {clock.starts}")
        mid = os.path.join(first, "deepspeech_checkpoint_0001.ckpt")
        wanted = [os.path.join(logs, "full.jsonl"),
                  os.path.join(logs, "full.html")]
        for name in ("deepspeech_checkpoint_0001", "best_model",
                     "deepspeech_final"):
            path = os.path.join(first, name + ".ckpt")
            wanted += [path] + [path + x for x in (
                ".curriculum.csv", ".val.curriculum.csv",
                ".trainval.curriculum.csv")]
        missing = [p for p in wanted if not os.path.exists(p)]
        traces = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
        if missing or traces != ["summary_1_2.json", "trace_steps_1_2.json"]:
            raise AssertionError(f"missing {missing}, traces {traces}")
        with open(os.path.join(logs, "full.jsonl")) as f:
            names = {json.loads(line)["event"] for line in f}
        if names != {"train", "params", "val_checkpoint", "trainval",
                     "lr_find", "checkpoint", "epoch", "val"}:
            raise AssertionError(f"JSONL events {sorted(names)}")
        with open(os.path.join(prof, traces[1])) as f:
            kernels = sum(1 for e in json.load(f)["traceEvents"]
                          if e.get("cat") == "kernel")
        package = ckpt.load(mid)
        leaves = tree_leaves(package["optim_state"])
        final = ckpt.load(os.path.join(first, "deepspeech_final.ckpt"))
        lr_final = float(tree_leaves(final["optim_state"])[1])
        if ((package["epoch"], package["iteration"], package["step"])
                != (1, 2, 2) or leaves[1] != np.float32(3e-4)
                or abs(lr_final / (3e-4 / 1.1 / 1.1) - 1) > 1e-6):
            raise AssertionError(
                f"mid checkpoint epoch {package['epoch']} iteration "
                f"{package['iteration']} step {package['step']}, lr "
                f"{leaves[1]}, final lr {lr_final}")
        # the saved optimizer leaves restored on the card, bit for bit
        model, _ = build_model("gru", CLASSES, HIDDEN, LAYERS,
                               compute_dtype="bfloat16", device="cuda")
        state = TrainState.create(model, build_optimizer("sgd"))
        state = ckpt.restore_state(package, state)
        got = to_optax_leaves(state.opt_state, model)
        if len(got) != len(leaves) or not all(
                np.array_equal(a, b) for a, b in zip(got, leaves)):
            raise AssertionError("restored optimizer leaves differ")
        del model, state
        log(f"train CLI: {len(traces)} profiler trace ({kernels} device "
            f"kernels in step 1), JSONL events {sorted(names)}, sidecars "
            f"of 3 checkpoints, mid-epoch checkpoint at epoch 1 iteration "
            f"2 with {len(leaves)} optimizer leaves restored on the card "
            f"bit for bit, LR {leaves[1]:.3e} -> {lr_final:.3e} (anneal "
            f"1.1 at the checkpoint, 1.1 at the epoch)")

        # the resume: the rest of epoch 1, then epoch 2
        second = os.path.join(d, "second")
        reset_counts()
        clock, text, dt = run(full + ["--epochs", "2", "--save-folder",
                                      second, "--id", "resumed",
                                      "--continue-from", mid], "resumed")
        counts = read_counts()
        # 4 steps; validations: the epochs' ends (2), the checkpoints of
        # epoch 2 (2), each on both manifests
        want = expect_counts(stft_mag=4 + 8 * vb, ctc_alpha=4 + 8 * vb,
                             ctc_beta=4, gru_fwd=(4 + 8 * vb) * LAYERS,
                             gru_fwd_res=4 * LAYERS, gru_bwd=4 * LAYERS,
                             **conv_launches(8 * vb, 4))
        if counts != want:
            raise AssertionError(f"resumed CLI launches {counts}, expected "
                                 f"{want}")
        if (clock.epochs != [0, 1] or clock.starts
                != [(0, 2), (1, 0), (1, 1), (1, 2)]):
            raise AssertionError(f"resumed epochs {clock.epochs}, batches "
                                 f"{clock.starts}")
        final = ckpt.load(os.path.join(second, "deepspeech_final.ckpt"))
        if final["step"] != 6 or len(final["loss_results"]) != 2:
            raise AssertionError(f"resumed final step {final['step']}, "
                                 f"history {final['loss_results']}")
        log(f"train CLI resumed from the mid-epoch checkpoint: batches "
            f"{clock.starts} (no epoch re-run), {dt:.3f} s host clock, "
            f"launches {counts}")

        # the host waveform pipeline against the step, in steady state:
        # the manifest repeated, the first RATE_WARM batches dropped
        need = RATE_WARM + RATE_STEPS + 1
        rate_csv = os.path.join(d, "rate.csv")
        with open(rate_csv, "w") as f:
            f.write("\n".join(rows * -(-need * BATCH // len(rows))) + "\n")

        def rate(ts, what):
            if len(ts) < need:
                raise AssertionError(f"{what}: {len(ts)} batches, expected "
                                     f"{need} or more")
            return (len(ts) - 1 - RATE_WARM) / (ts[-1] - ts[RATE_WARM])

        conf = AudioConf(noise_dir=noise)
        bucket = BucketSpec(reflect_tail=160, wire_dtype="int16")
        for augment in (False, True):
            ds = AudioDataset(conf, rate_csv, LABELS, augment=augment)
            loader = AudioDataLoader(ds, BucketingSampler(len(ds), BATCH),
                                     BATCH, bucket, 4)
            ts = [time.perf_counter() for _ in loader]
            r = rate(ts, "loader")
            out[f"loader_batches_per_s_augment_{augment}"] = r
            log(f"loader alone, --num-workers 4, batch {BATCH} x 6.8-7.5 s, "
                f"augment {augment}: {r:.3f} batches/s over batches "
                f"{RATE_WARM}-{len(ts) - 1} of {len(ts)}")
        # the CLI's steps with and without --augment (1 epoch)
        for augment in (False, True):
            flags = ["--augment", "--aug-type", "0", "--noise-dir",
                     noise] if augment else []
            # the later --train-manifest overrides base's
            clock, _, dt = run(["--train-manifest", rate_csv] + flags + [
                "--epochs", "1", "--save-folder",
                os.path.join(d, f"a{augment}"), "--id", f"a{augment}"],
                f"augment {augment}")
            r = rate(clock.t, "train CLI")
            out[f"cli_steps_per_s_augment_{augment}"] = r
            log(f"train CLI, augment {augment}: {r:.3f} steps/s between the "
                f"starts of batches {RATE_WARM}-{len(clock.t) - 1} of "
                f"{len(clock.t)}, {dt:.1f} s the whole run")
    return out


def phase_wide_cli(torch):
    """BASELINE.md config 4 on one card: the train CLI with --hidden-size
    1600 --batch-size 64 --use-curriculum --checkpoint --epochs 2 on a
    synthetic manifest of 128 utterances of 6.8-7.5 s (validation on the
    first 64), in a temporary directory. Its launches (layer 0 on K2,
    layers 1-5 on K4 in every step and validation batch); both curriculum
    sidecars beside every checkpoint with one row per wav; the drawn
    utterances' CERs moved from 0.999; epoch 1's list equal to
    Curriculum.sample recomputed from the store epoch 0 left (its sidecar),
    shuffled by the epoch. Then one f32 transcribe request on the final
    checkpoint, which runs K4 in all 6 layers (one row: one launch a step,
    the rule's choice), and the f32 test CLI on the validation manifest in
    one batch of 64, the eval cell's shape (K4's persistent variant in all
    6 layers) -> that batch's launches."""
    from deepspeech_tpu_torch.audio.io import save_wav
    from deepspeech_tpu_torch.cli.test import main as test_main
    from deepspeech_tpu_torch.cli.train import main as train_main
    from deepspeech_tpu_torch.cli.transcribe import main as transcribe_main
    from deepspeech_tpu_torch.data import AudioDataset, read_manifest
    from deepspeech_tpu_torch.data.curriculum import (Curriculum,
                                                      CurriculumStore)

    rng = np.random.default_rng(SEED + 18)
    batch = WIDE_BATCH["gru"]
    labels_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "labels.json")
    drawn: dict = {}
    original = AudioDataset.set_curriculum_epoch

    def recorded(self, epoch, sample=False, sample_size=0.5):
        original(self, epoch, sample, sample_size)
        drawn[epoch] = list(self.ids)

    with tempfile.TemporaryDirectory() as d:
        rows = []
        for i in range(CLI_UTTS):
            n = int(SR * rng.uniform(6.8, 7.5))
            wav, txt = (os.path.join(d, f"u{i}.wav"),
                        os.path.join(d, f"u{i}.txt"))
            save_wav(wav, synthetic_audio(rng, n), SR)
            with open(txt, "w") as f:
                f.write(" ".join("".join(rng.choice(list(LABELS[2:28]),
                                                    int(rng.integers(2, 8))))
                                 for _ in range(int(rng.integers(10, 16)))))
            rows.append(f"{wav},{txt},{n / SR}")
        manifest, val = (os.path.join(d, "train.csv"),
                         os.path.join(d, "val.csv"))
        with open(manifest, "w") as f:
            f.write("\n".join(rows) + "\n")
        with open(val, "w") as f:
            f.write("\n".join(rows[:batch]) + "\n")
        save = os.path.join(d, "models")
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        AudioDataset.set_curriculum_epoch = recorded
        try:
            with contextlib.redirect_stdout(buf):
                rc = train_main([
                    "--train-manifest", manifest, "--val-manifest", val,
                    "--labels-path", labels_path, "--epochs", "2",
                    "--batch-size", str(batch), "--val-batch-size",
                    str(batch), "--num-workers", "8", "--hidden-size",
                    str(WIDE), "--hidden-layers", str(LAYERS),
                    "--use-curriculum", "--checkpoint", "--save-folder",
                    save])
        finally:
            AudioDataset.set_curriculum_epoch = original
        dt = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            log(f"  train CLI: {line}")
        if rc != 0:
            raise AssertionError(f"train CLI exited {rc}")
        torch.cuda.synchronize()
        counts = read_counts()
        steps = sum(-(-len(ids) // batch) for ids in drawn.values())
        evals = 2  # one validation batch an epoch
        log(f"train CLI, config 4 (6 x BiGRU-{WIDE} bf16, batch {batch}, "
            f"--use-curriculum, 2 epochs drawing "
            f"{[len(drawn[e]) for e in sorted(drawn)]} of {CLI_UTTS} "
            f"utterances: {steps} steps + {evals} validation batches): "
            f"{dt:.3f} s host clock, launches {counts}")
        want = expect_counts(
            stft_mag=steps + evals, gru_fwd=steps + evals, gru_fwd_res=steps,
            gru_scan=(LAYERS - 1) * (steps + evals),
            gru_scan_res=(LAYERS - 1) * steps, gru_bwd=LAYERS * steps,
            ctc_alpha=steps + evals, ctc_beta=steps,
            **conv_launches(evals, steps))
        if sorted(drawn) != [0, 1] or counts != want:
            raise AssertionError(f"config-4 train CLI: epochs {sorted(drawn)}"
                                 f", launches {counts}, expected {want}")

        wavs = [r.split(",")[0] for r in rows]
        for ck in ("deepspeech_epoch_001.ckpt", "deepspeech_epoch_002.ckpt",
                   "best_model.ckpt", "deepspeech_final.ckpt"):
            for sidecar, n in ((".curriculum.csv", CLI_UTTS),
                               (".val.curriculum.csv", batch)):
                store = CurriculumStore.load(os.path.join(save, ck + sidecar))
                if sorted(store.rows) != sorted(wavs[:n]):
                    raise AssertionError(f"{ck}{sidecar}: {len(store)} rows, "
                                         f"expected one per wav ({n})")
        after0 = CurriculumStore.load(os.path.join(
            save, "deepspeech_epoch_001.ckpt.curriculum.csv"))
        used = [r for r in after0.rows.values() if r["times_used"]]
        moved = [r for r in used if r["cer"] != 0.999]
        ids = read_manifest(manifest)
        want_ids = list(Curriculum.sample(
            ids, lambda item: (after0.get(item[0])["text"],
                               after0.get(item[0])["cer"]),
            epoch=1, min=len(ids) * 0.5))
        np.random.default_rng(1).shuffle(want_ids)
        cers = sorted(r["cer"] for r in used)
        log(f"curriculum after epoch 0: {len(used)} of {CLI_UTTS} utterances "
            f"decoded, {len(moved)} CERs moved from 0.999 (median "
            f"{cers[len(cers) // 2] if cers else float('nan'):.3f}); epoch 1 "
            f"drew {len(drawn[1])}, the draw recomputed from the sidecar "
            f"{len(want_ids)}, equal: {drawn[1] == want_ids}")
        if not used or len(moved) != len(used) or drawn[1] != want_ids:
            raise AssertionError("config-4 curriculum: the store or epoch "
                                 "1's draw is not what the sidecar gives")

        reset_counts()
        text, sec = transcribe_once(transcribe_main, os.path.join(
            save, "deepspeech_final.ckpt"), wavs[0])
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"transcribe on the config-4 checkpoint (f32, one request): "
            f"{len(text)} chars in {sec:.3f} s (host clock, checkpoint load "
            f"included), launches {counts}: {text[:50]!r}")
        if counts != expect_counts(stft_mag=1, gru_scan=LAYERS):
            raise AssertionError(f"config-4 transcribe launches {counts}")

        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = test_main(["--model-path",
                            os.path.join(save, "deepspeech_final.ckpt"),
                            "--test-manifest", val, "--batch-size",
                            str(batch), "--num-workers", "4"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"config-4 test CLI exited {rc}")
        counts = read_counts()
        log(f"test CLI on the config-4 checkpoint (f32, {batch} "
            f"utterances, batch {batch}): {dt:.3f} s host clock (checkpoint "
            f"load included), launches {counts}; "
            f"{buf.getvalue().strip().splitlines()[-1:]}")
        want = expect_counts(stft_mag=1, ctc_alpha=1, gru_scan=LAYERS,
                             gru_scan_f32_persistent=LAYERS)
        if counts != want:
            raise AssertionError(f"config-4 test CLI launches {counts}, "
                                 f"expected {want}")
        return counts


def topk_rows(rng, r: int, n: int, kind: str) -> np.ndarray:
    """Beam-like candidate scores (R, n): log masses around -40 with a
    third of each row -inf (invalid or absorbed candidates); "stress" rows
    add exact ties, signed zeros, infinities, NaNs of both signs with
    payloads, and one row of -0.0 alone; "flood" rows are a wide beam's
    early steps, 31 finite candidates a row and the rest -inf."""
    x = (rng.standard_normal((r, n)) * 8 - 40).astype(np.float32)
    if kind == "flood":
        keep = np.argsort(rng.random((r, n)), axis=1)[:, :31]
        flood = np.full_like(x, -np.inf)
        np.put_along_axis(flood, keep, np.take_along_axis(x, keep, 1), 1)
        return flood
    x[rng.random((r, n)) < 0.33] = -np.inf
    if kind == "stress":
        nans = np.array([0x7FC00011, 0xFFC00022], np.uint32).view(np.float32)
        specials = np.concatenate(
            [np.array([0.0, -0.0, np.inf, -np.inf, -40.0], np.float32), nans])
        pick = rng.random((r, n)) < 0.3
        x[pick] = rng.choice(specials, int(pick.sum()))
        x[0] = np.float32(-0.0)
    return x


# the conv front's products (phase_conv): both train cells' batches at their
# mean bin (12.7 s: 1,273 spectrogram frames, 637 after conv0)
CONV_BATCHES, CONV_FRAMES = (20, 64), 1273


def conv_products(torch, conv, b: int, t_in: int, seed: int):
    """The five conv products at (b, t_in) on bf16-valued operands drawn
    on the card -> {name: (kernel call, plain twin call, cuDNN f32 call,
    useful FLOPs)}; the plain twins and cuDNN run under fp32_matmul."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    t = conv.out_frames(0, t_in)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x0 = randn(b, 1, 161, t_in)
    x1 = randn(b, 32, 81, t).to(torch.bfloat16)
    w0 = randn(32, 1, 41, 11, scale=0.05).to(torch.bfloat16)
    w1 = randn(32, 32, 21, 11, scale=0.05).to(torch.bfloat16)
    b0, b1 = randn(32), randn(32)
    dy0, dy1 = randn(b, 32, 81, t), randn(b, 32, 41, t)
    x0r, x1f, w0f, w1f = (x0.to(torch.bfloat16).float(), x1.float(),
                          w0.float(), w1.float())
    g0, g1 = conv.GEOMETRIES
    f0 = 2.0 * b * 81 * t * 32 * 41 * 11
    f1 = 2.0 * b * 41 * t * 32 * 32 * 21 * 11
    return {
        "fprop0": (lambda: conv.fprop(x0, w0, b0, 0),
                   lambda: conv.plain_fprop(x0, w0, b0, 0),
                   lambda: F.conv2d(x0r, w0f, b0, g0.stride, g0.padding), f0),
        "fprop1": (lambda: conv.fprop(x1, w1, b1, 1),
                   lambda: conv.plain_fprop(x1, w1, b1, 1),
                   lambda: F.conv2d(x1f, w1f, b1, g1.stride, g1.padding), f1),
        "dgrad1": (lambda: conv.dgrad(dy1, w1, 1, x1.shape),
                   lambda: conv.plain_dgrad(dy1, w1, 1, x1.shape),
                   lambda: torch.nn.grad.conv2d_input(
                       x1.shape, w1f, dy1, g1.stride, g1.padding), f1),
        "wgrad0": (lambda: conv.wgrad(dy0, x0, 0),
                   lambda: conv.plain_wgrad(dy0, x0, 0),
                   lambda: torch.nn.grad.conv2d_weight(
                       x0r, w0.shape, dy0, g0.stride, g0.padding), f0),
        "wgrad1": (lambda: conv.wgrad(dy1, x1, 1),
                   lambda: conv.plain_wgrad(dy1, x1, 1),
                   lambda: torch.nn.grad.conv2d_weight(
                       x1f, w1.shape, dy1, g1.stride, g1.padding), f1)}


def phase_conv(torch, results):
    """The conv front's kernels (bf16 operands, f32 sums) at both train
    cells' batches and mean bin: each product against its plain twin on the
    same operands (the forward to 1e-4 of the twin's largest, the gradients
    within 2^-7 of it: one bf16 ulp of the largest), the weight gradients
    bit-equal on a second run; CUDA-event medians of the kernel, the plain
    twin and cuDNN's f32 product of the same operands (TF32 off), beside the
    bound of this product's useful FLOPs at the bf16 peak (the gradients'
    hi + lo split doubles their tensor work)."""
    from deepspeech_tpu_torch.ops import fp32_matmul
    from deepspeech_tpu_torch.ops.cuda import conv

    rows = {}
    for b in CONV_BATCHES:
        prods = conv_products(torch, conv, b, CONV_FRAMES, SEED + 40 + b)
        with fp32_matmul():
            for name, (kernel, plain, library, flops) in prods.items():
                got, want = kernel(), plain()
                err = max_err(got, want)[0]
                scale = want.float().abs().max().item()
                tol = (1e-4 if name.startswith("fprop") else 2.0 ** -7) * scale
                if not err <= tol:
                    raise AssertionError(f"conv {name} at B {b}: {err} "
                                         f"against plain (tolerance {tol})")
                if name.startswith("wgrad") and not torch.equal(got,
                                                                kernel()):
                    raise AssertionError(f"conv {name} at B {b}: two runs "
                                         "differ")
                split = 1 if name.startswith("fprop") else 2
                r = dict(ms=time_ms(kernel), plain_ms=time_ms(plain),
                         library_ms=time_ms(library), max_abs_err=err,
                         scale=scale, flops=flops,
                         bound_ms=flops / PEAK_BF16 * 1e3,
                         split_bound_ms=split * flops / PEAK_BF16 * 1e3)
                rows[f"{name}_b{b}"] = r
                log(f"conv {name} B {b} T' {conv.out_frames(0, CONV_FRAMES)}"
                    f": kernel {r['ms']:.3f} ms ({flops / r['ms'] / 1e9:.1f} "
                    f"TFLOP/s useful), plain {r['plain_ms']:.3f} ms, cuDNN "
                    f"f32 {r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f}"
                    f" ms (operations; {r['split_bound_ms']:.3f} with the "
                    f"split), max err {err:.3e} of {scale:.3e}")
        del prods
        torch.cuda.empty_cache()
    step = {b: sum(rows[f"{n}_b{b}"]["ms"] for n in
                   ("fprop0", "fprop1", "dgrad1", "wgrad0", "wgrad1"))
            for b in CONV_BATCHES}
    library = {b: sum(rows[f"{n}_b{b}"]["library_ms"] for n in
                      ("fprop0", "fprop1", "dgrad1", "wgrad0", "wgrad1"))
               for b in CONV_BATCHES}
    bound_ms = {b: sum(rows[f"{n}_b{b}"]["bound_ms"] for n in
                       ("fprop0", "fprop1", "dgrad1", "wgrad0", "wgrad1"))
                for b in CONV_BATCHES}
    log(f"conv products of a train step: kernels {step} ms, cuDNN f32 "
        f"{library} ms, bound {bound_ms} ms (B: ms)")
    wide = f"_b{CONV_BATCHES[-1]}"
    results["conv"] = dict(
        route="cuda", ms=step[CONV_BATCHES[-1]],
        plain_ms=sum(r["plain_ms"] for k, r in rows.items()
                     if k.endswith(wide)),
        library_ms=library[CONV_BATCHES[-1]],
        bound_ms=bound_ms[CONV_BATCHES[-1]], bound_by="operations",
        max_abs_err=max(r["max_abs_err"] / max(1.0, r["scale"])
                        for r in rows.values()),
        extra=dict(products=rows, step_ms=step, library_step_ms=library))


def phase_topk(torch, results):
    """K10 against its plain version, bit for bit (values as int32 bits,
    and indices; the top k and, on 4 rows, the whole order), at the beam's
    shapes n = K (C + 1) for K 10 and 128, on stress rows and on the -inf
    flood of a wide beam's early steps; its device time beside its bound,
    the plain version, torch.topk and torch.sort, on beam-like rows and on
    the flood."""
    from deepspeech_tpu_torch.ops.cuda import topk

    rng = np.random.default_rng(SEED + 12)
    for width in (10, 128):
        r, n, k = BATCH, width * (CLASSES + 1), width
        for kind in ("beam", "stress", "flood"):
            x = torch.from_numpy(topk_rows(rng, r, n, kind)).cuda()
            pairs = [(topk.topk_total_order(x, k), topk.plain(x, k)),
                     (topk.topk_total_order(x[:4], n), topk.plain(x[:4], n))]
            torch.cuda.synchronize()
            same = all(torch.equal(v.view(torch.int32), rv.view(torch.int32))
                       and torch.equal(i, ri)
                       for (v, i), (rv, ri) in pairs)
            log(f"K10 topk ({r}, {n}) k={k}, {kind} rows, {topk.route(k)} "
                f"route (and the whole order of 4 rows, {topk.route(n)} "
                f"route): bit-equal to plain {same}")
            if not same:
                raise AssertionError(f"topk ({r}, {n}) k={k} {kind} rows "
                                     "differ from its plain version")
        timed = {}
        for kind in ("beam", "flood"):
            x = torch.from_numpy(topk_rows(rng, r, n, kind)).cuda()
            t = timed[kind] = dict(
                ms=device_ms(lambda: topk.topk_total_order(x, k)),
                call_ms=time_ms(lambda: topk.topk_total_order(x, k), reps=20),
                plain_ms=device_ms(lambda: topk.plain(x, k)),
                library_ms=device_ms(lambda: torch.topk(x, k, dim=1)),
                sort_ms=device_ms(lambda: torch.sort(
                    x, dim=1, descending=True, stable=True)))
            tv, ti = torch.topk(x, k, dim=1)
            rv, ri = topk.plain(x, k)
            matched = (torch.equal(ti.to(torch.int32), ri) and torch.equal(
                tv.view(torch.int32), rv.view(torch.int32)))
            # bytes: the scores read once, values and indices written once;
            # operations: at least one comparison a candidate
            t["bound_ms"], t["bound_by"] = bound(float(r * n), PEAK_F32,
                                                 4.0 * r * n + 8.0 * r * k)
            log(f"K10 topk ({r}, {n}) k={k}, {kind} rows: "
                f"{t['ms'] * 1e3:.2f} us device time a call "
                f"({t['call_ms'] * 1e3:.2f} us host-visible, CUDA events "
                f"around one call), plain {t['plain_ms'] * 1e3:.2f} us, "
                f"torch.topk {t['library_ms'] * 1e3:.2f} us (order matched: "
                f"{matched}), torch.sort {t['sort_ms'] * 1e3:.2f} us, bound "
                f"{t['bound_ms'] * 1e3:.4f} us ({t['bound_by']})")
        beam = timed["beam"]
        if width == 10:  # the default beam's shape
            results["topk"] = dict(
                route="cuda", max_abs_err=0.0, ms=beam["ms"],
                plain_ms=beam["plain_ms"], bound_ms=beam["bound_ms"],
                bound_by=beam["bound_by"], library_ms=beam["library_ms"],
                extra={})
        else:
            results["topk"]["extra"]["at_width_128"] = dict(
                beam, flood_ms=timed["flood"]["ms"],
                flood_library_ms=timed["flood"]["library_ms"])


def write_synthetic_arpa(path: str, rng, n_words: int = LM_WORDS) -> None:
    """A trigram ARPA over the label alphabet, from ``rng``: ``n_words``
    random words of 1-7 letters, 2.5 bigrams and 2 trigrams a word (each
    trigram extends a bigram), random log10 probabilities and backoffs."""
    letters = list(LABELS[2:28])
    words: set = set()
    while len(words) < n_words:
        words.add("".join(rng.choice(letters, int(rng.integers(1, 8)))))
    vocab = sorted(words)
    bigrams = {(str(rng.choice(["<s>"] + vocab)),
                str(rng.choice(vocab + ["</s>"])))
               for _ in range(int(2.5 * n_words))}
    heads = sorted(g for g in bigrams if g[1] != "</s>")
    trigrams = {heads[int(rng.integers(len(heads)))]
                + (str(rng.choice(vocab)),) for _ in range(2 * n_words)}
    lines = ["\\data\\", f"ngram 1={len(vocab) + 3}",
             f"ngram 2={len(bigrams)}", f"ngram 3={len(trigrams)}", "",
             "\\1-grams:", f"-99.0000\t<s>\t{rng.uniform(-1, 0):.4f}",
             "-1.0000\t</s>\t0.0000", "-4.0000\t<unk>\t0.0000"]
    lines += [f"{rng.uniform(-6, -1.5):.4f}\t{w}\t{rng.uniform(-1, 0):.4f}"
              for w in vocab]
    lines += ["", "\\2-grams:"]
    lines += [f"{rng.uniform(-4, -0.3):.4f}\t{a} {b}\t"
              f"{rng.uniform(-0.8, 0):.4f}" for a, b in sorted(bigrams)]
    lines += ["", "\\3-grams:"]
    lines += [f"{rng.uniform(-3, -0.1):.4f}\t{' '.join(g)}"
              for g in sorted(trigrams)]
    with open(path, "w") as f:
        f.write("\n".join(lines + ["", "\\end\\", ""]))


def phase_beam(torch, model, counts, floor: dict, dslm: str) -> None:
    """The slice's main path at full width: 20 x 7.5 s -> featurize (K1)
    -> the bf16 6 x BiGRU-800 (K2) -> softmax -> the device beam search
    (K10 once a time step) -> strings, through DeviceBeamCTCDecoder.decode,
    its launch counts read around it. Then each search of SEARCHES on those
    posteriors: through K10 (T launches), against the same search with the
    plain top-k on the card (bit-equal prefixes, lengths, offsets and
    scores) and on the CPU (agreement reported), each timed, and its first
    steps profiled."""
    from deepspeech_tpu_torch.audio.features import AudioConf, featurize_batch
    from deepspeech_tpu_torch.decoders import DeviceBeamCTCDecoder
    from deepspeech_tpu_torch.decoders.beam_device import (
        ctc_beam_search_device)
    from deepspeech_tpu_torch.decoders.lm_device import load_device_lm

    rng = np.random.default_rng(SEED + 14)
    audio = torch.from_numpy(np.stack([synthetic_audio(rng, AUDIO_S)
                                       for _ in range(BATCH)])).cuda()
    lengths = torch.full((BATCH,), AUDIO_S, dtype=torch.int64).cuda()
    decoder = DeviceBeamCTCDecoder(LABELS, beam_width=10, device="cuda")
    model.eval()
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        spect, frames = featurize_batch(audio, lengths, AudioConf())
        _, probs, out_lens = model(spect, frames)
        strings, offsets = decoder.decode(probs, out_lens)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts.update(read_counts())
    t = probs.shape[1]
    log(f"beam path (featurize -> bf16 6 x BiGRU-800 -> device beam width "
        f"10, {BATCH} x {AUDIO_S / SR} s, T {t}): {dt:.3f} s host clock, "
        f"launches {counts}; {strings[0][0][:50]!r}")
    want = expect_counts(stft_mag=1, gru_fwd=LAYERS, topk=t,
                         **conv_launches(1))
    if counts != want:
        raise AssertionError(f"beam path launches {counts}, expected {want}")
    lens = out_lens.tolist()
    for s, o, n in zip(strings, offsets, lens):
        if len(s[0]) != len(o[0]) or not all(0 <= f < n for f in o[0]):
            raise AssertionError(f"malformed hypothesis {s[0]!r} {o[0]}")

    log_probs = torch.log(torch.clamp(probs.float(), 1e-30, 1.0))
    lms = {False: (None, None),
           True: (load_device_lm(dslm, LABELS, "cuda"),
                  load_device_lm(dslm, LABELS, "cpu"))}
    for name, width, with_lm, n_cpu in SEARCHES:
        lm_card, lm_cpu = lms[with_lm]
        kw = dict(beam_width=width, alpha=LM_ALPHA, beta=LM_BETA,
                  space=LABELS.index(" ") if with_lm else -1)

        def run(lp, lens, lm):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ctc_beam_search_device(lp, lens, lm=lm, **kw)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        reset_counts()
        got, ms = run(log_probs, out_lens, lm_card)
        launches = read_counts()["topk"]
        with plain_path():
            ref, plain_ms = run(log_probs, out_lens, lm_card)
        cpu, cpu_ms = run(log_probs[:n_cpu].cpu(), out_lens[:n_cpu].cpu(),
                          lm_cpu)
        exact = all(torch.equal(a, b) for a, b in zip(got, ref))
        g = [x[:n_cpu].cpu() for x in got]
        same = [all(torch.equal(a[i], c[i]) for a, c in zip(g[:3], cpu[:3]))
                for i in range(n_cpu)]
        rel = ((g[3] - cpu[3]).abs() / cpu[3].abs()).max().item()
        log(f"device beam {name}: {ms:.1f} ms through K10 ({launches} "
            f"launches, {ms / t * 1e3:.1f} us a step), {plain_ms:.1f} ms "
            f"with the plain top-k on the card (bit-equal: {exact}); the "
            f"CPU search of {n_cpu} utterances {cpu_ms:.1f} ms: top "
            f"hypothesis and offsets equal on {sum(same)}/{n_cpu}, scores "
            f"within {rel:.2e} relative; mean length "
            f"{got[1].float().mean().item():.1f} chars")
        if not exact or launches != t:
            raise AssertionError(f"device beam {name}: bit-equal {exact}, "
                                 f"K10 launches {launches} (want {t})")
        # where a step's time goes: the first PROFILE_STEPS steps, profiled
        head = (log_probs[:, :PROFILE_STEPS], out_lens.clamp(
            max=PROFILE_STEPS), lm_card)
        _, head_ms = run(*head)
        profile_run(torch, f"device beam {name}, {PROFILE_STEPS} steps",
                    lambda: run(*head), head_ms, floor)


def phase_beam_cli(torch, model, meta, arpa: str, dslm: str) -> None:
    """transcribe with --decoder device_beam and --decoder beam, each with
    --lm-path (the synthetic ARPA), on one 7.5 s request; the test CLI on a
    synthetic manifest of 20 x 7.5 s utterances with --decoder device_beam
    --lm-path (its DSLM), its summary held to an in-process decode of the
    same batch."""
    from deepspeech_tpu_torch.audio.features import AudioConf
    from deepspeech_tpu_torch.audio.io import save_wav
    from deepspeech_tpu_torch.cli.common import load_inference_model
    from deepspeech_tpu_torch.cli.test import main as test_main
    from deepspeech_tpu_torch.cli.transcribe import main as transcribe_main
    from deepspeech_tpu_torch.data import (AudioDataLoader, AudioDataset,
                                           BucketingSampler)
    from deepspeech_tpu_torch.decoders import DeviceBeamCTCDecoder
    from deepspeech_tpu_torch.metrics import get_cer_wer
    from deepspeech_tpu_torch.train import checkpoint as ckpt
    from deepspeech_tpu_torch.train.step import StepConfig, make_eval_step

    rng = np.random.default_rng(SEED + 15)
    lm_flags = ("--lm-path", arpa, "--alpha", str(LM_ALPHA), "--beta",
                str(LM_BETA))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ds2.ckpt")
        ckpt.save(path, ckpt.package_from_model(model, meta, LABELS,
                                                AudioConf().to_dict()))
        rows = []
        for i in range(BATCH):
            wav, txt = (os.path.join(d, f"u{i}.wav"),
                        os.path.join(d, f"u{i}.txt"))
            save_wav(wav, synthetic_audio(rng, AUDIO_S), SR)
            with open(txt, "w") as f:
                f.write(" ".join("".join(rng.choice(list(LABELS[2:28]),
                                                    int(rng.integers(1, 7))))
                                 for _ in range(int(rng.integers(6, 14)))))
            rows.append(f"{wav},{txt},{AUDIO_S / SR}")
        manifest = os.path.join(d, "manifest.csv")
        with open(manifest, "w") as f:
            f.write("\n".join(rows) + "\n")

        for decoder in ("device_beam", "beam"):
            reset_counts()
            text, dt = transcribe_once(transcribe_main, path,
                                       rows[0].split(",")[0], "--decoder",
                                       decoder, *lm_flags)
            torch.cuda.synchronize()
            counts = read_counts()
            log(f"transcribe --decoder {decoder} --lm-path (f32, one "
                f"{AUDIO_S / SR} s request): {len(text)} chars in {dt:.3f} s "
                f"(host clock, checkpoint and LM load included), launches "
                f"{counts}: {text[:50]!r}")
            want = expect_counts(stft_mag=1, gru_fwd=LAYERS,
                                 topk=FRAMES if decoder == "device_beam"
                                 else 0)
            if counts != want:
                raise AssertionError(f"transcribe {decoder}: launches "
                                     f"{counts}, expected {want}")

        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = test_main(["--model-path", path, "--test-manifest",
                            manifest, "--batch-size", str(BATCH),
                            "--num-workers", "4", "--decoder", "device_beam",
                            "--lm-path", dslm, "--alpha", str(LM_ALPHA),
                            "--beta", str(LM_BETA), "--report-file",
                            os.path.join(d, "report.csv")])
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = read_counts()
        if rc != 0:
            raise AssertionError(f"test CLI exited {rc}")
        summary = buf.getvalue().strip().splitlines()[-2:]
        for line in summary:
            log(f"  test CLI: {line}")

        # the same batch decoded in-process, the summary by the same sums
        model32, labels, conf, _ = load_inference_model(path, device="cuda")
        dataset = AudioDataset(conf, manifest, labels)
        loader = AudioDataLoader(dataset, BucketingSampler(len(dataset),
                                                           BATCH), BATCH)
        step = make_eval_step(model32, StepConfig(audio_conf=conf))
        decoder = DeviceBeamCTCDecoder(LABELS, beam_width=10, lm_path=dslm,
                                       alpha=LM_ALPHA, beta=LM_BETA,
                                       device="cuda")
        tot = np.zeros(4)
        utt = np.zeros(2)
        for batch in loader:
            batch.pop("paths")
            m = step({k: torch.from_numpy(v).cuda() for k, v in batch.items()})
            hyps, _ = decoder.decode(m["probs"], m["out_lens"])
            frames = m["probs"].shape[1]
            for x in range(BATCH):
                ref = labels.render_transcript(
                    batch["targets"][x, :int(batch["target_lengths"][x])])
                w, c, wr, cr = get_cer_wer(hyps[x][0][:2000], ref[:2000])
                tot += (w, c, wr, cr)
                utt += (w / wr, c / cr)
        mine = [f"Summary (token-weighted)    WER "
                f"{100.0 * tot[0] / max(tot[2], 1.0):.3f}  CER "
                f"{100.0 * tot[1] / max(tot[3], 1.0):.3f}",
                f"Summary (per-utt averaged)  WER "
                f"{100.0 * utt[0] / BATCH:.3f}  CER "
                f"{100.0 * utt[1] / BATCH:.3f}  ({BATCH} utterances)"]
        log(f"test CLI --decoder device_beam --lm-path ({BATCH} x "
            f"{AUDIO_S / SR} s, T {frames} after bucket padding): {dt:.3f} s "
            f"host clock (checkpoint, LM and audio load included), launches "
            f"{counts}; the in-process decode of the same batch gives the "
            f"same summary: {mine == summary}")
        want = expect_counts(stft_mag=1, gru_fwd=LAYERS, ctc_alpha=1,
                             topk=frames)
        if counts != want or mine != summary:
            raise AssertionError(f"test CLI: launches {counts} (expected "
                                 f"{want}); summary {summary} vs {mine}")


def _pack_lsb(fields, n: int) -> bytes:
    """``n`` fixed-width records, LSB-first (util/bit_packing.hh): each
    field a (values (n,) of uint64, bits) pair, fields in record order."""
    cols = [((np.asarray(v, np.uint64)[:, None]
              >> np.arange(bits, dtype=np.uint64)) & np.uint64(1))
            for v, bits in fields]
    bits = np.concatenate(cols, axis=1).astype(np.uint8).reshape(-1)
    return np.packbits(bits, bitorder="little").tobytes()


def write_kenlm_binary(path: str, arpa_path: str, kind: str) -> None:
    """A KenLM format-5 binary of the ARPA at ``arpa_path``: ``kind``
    "probing" (model type 0: the vocabulary and each order a linear-probing
    table keyed by MurmurHash64A and the chained word hash) or "trie"
    (model type 2: the sorted-hash vocabulary, dense unigram records, the
    bit-packed middle and longest levels in suffix order, blank carrier
    nodes where an n-gram's suffix is absent). Both carry the word strings
    last. Written from the layout the readers (decoders/lm_kenlm.py,
    decoders/lm_trie.py) parse, with grouping by dicts, so that a 3,000-word
    trigram LM takes a fraction of a second."""
    import struct

    from deepspeech_tpu_torch.decoders.lm import ArpaLM
    from deepspeech_tpu_torch.decoders.lm_kenlm import (_FIXED_PARAMS_SIZE,
                                                        MAGIC,
                                                        murmur_hash64a,
                                                        ngram_hash,
                                                        probing_buckets,
                                                        sanity_size)
    from deepspeech_tpu_torch.decoders.lm_trie import required_bits

    def align8(n):
        return (n + 7) // 8 * 8

    arpa = ArpaLM(arpa_path)
    order = arpa.order
    grams = {k: {} for k in range(1, order + 1)}
    for words, pb in arpa.ngrams.items():
        grams[len(words)][words] = pb
    mh = {w: murmur_hash64a(w.encode("utf8"))
          for (w,) in grams[1] if w != "<unk>"}
    if kind == "probing":
        vocab = ["<unk>"] + [w for (w,) in grams[1] if w != "<unk>"]
    else:
        vocab = ["<unk>"] + sorted(mh, key=mh.get)
    wid = {w: i for i, w in enumerate(vocab)}

    if kind == "trie":
        # suffix paths (newest .. oldest ids); blank carriers for parents
        nodes = {d: {tuple(wid[w] for w in reversed(g)): (lp, bo if d < order
                                                         else 0.0)
                     for g, (lp, bo) in grams[d].items()}
                 for d in range(1, order + 1)}
        for d in range(order, 1, -1):
            for pth in list(nodes[d]):
                nodes[d - 1].setdefault(pth[:-1], (float("-inf"), 0.0))
        kids = {d: {} for d in range(2, order + 1)}
        for d in range(2, order + 1):
            for pth in nodes[d]:
                kids[d].setdefault(pth[:-1], []).append(pth)
        levels = {1: [(w,) for w in range(len(vocab))]}
        for d in range(2, order + 1):
            levels[d] = [c for p in levels[d - 1]
                         for c in sorted(kids[d].get(p, ()))]
        counts = [len(vocab)] + [len(levels[d]) for d in range(2, order + 1)]
    else:
        counts = [len(vocab)] + [len(grams[k]) for k in range(2, order + 1)]

    out = bytearray(sanity_size())
    out[: len(MAGIC)] = MAGIC
    f_off = (len(MAGIC) + 1 + 3) // 4 * 4
    struct.pack_into("<fff", out, f_off, 0.0, 1.0, -0.5)
    struct.pack_into("<II", out, f_off + 12, 1, 0xFFFFFFFF)
    struct.pack_into("<Q", out, align8(f_off + 20), 1)
    fp = bytearray(_FIXED_PARAMS_SIZE)
    fp[0] = order
    struct.pack_into("<f", fp, 4, 1.5)
    struct.pack_into("<i", fp, 8, 0 if kind == "probing" else 2)
    fp[12] = 1
    struct.pack_into("<I", fp, 16, 0 if kind == "probing" else 1)
    out += fp
    for c in counts:
        out += struct.pack("<Q", c)
    out += b"\x00" * (align8(len(out)) - len(out))

    def probing_table(entries, payload_of, count):
        nb = probing_buckets(count, 1.5)
        keys = np.zeros(nb, np.uint64)
        payload = np.zeros((nb, 8), np.uint8)
        for key, item in entries:
            j = key % nb
            while keys[j] != 0:
                j = (j + 1) % nb
            keys[j] = key
            payload[j] = np.frombuffer(payload_of(item), np.uint8)
        return np.concatenate([keys.view(np.uint8).reshape(nb, 8),
                               payload], axis=1).tobytes()

    if kind == "probing":
        out += struct.pack("<IxxxxQ", 0, len(vocab))
        out += probing_table([(mh[w], i) for w, i in wid.items() if i],
                             lambda i: struct.pack("<II", i, 0), counts[0])
        uni = np.zeros((counts[0] + 1, 2), np.float32)
        for (w,), pb in grams[1].items():
            uni[wid[w]] = pb
        out += uni.tobytes()
        for k in range(2, order + 1):
            out += probing_table(
                [(ngram_hash([wid.get(w, 0) for w in g]), pb)
                 for g, pb in grams[k].items()],
                lambda pb, k=k: struct.pack(
                    "<ff", pb[0], pb[1] if k < order else 0.0),
                counts[k - 1])
    else:
        out += struct.pack("<Q", len(mh))
        out += np.array([mh[w] for w in vocab[1:]], np.uint64).tobytes()
        n_kids = [len(kids[2].get(p, ())) if order > 1 else 0
                  for p in levels[1]]
        nxt = np.concatenate([[0], np.cumsum(n_kids)]).astype(np.uint64)
        uni = np.zeros(len(vocab) + 2, dtype=[("p", "<f4"), ("b", "<f4"),
                                              ("n", "<u8")])
        for i, p in enumerate(levels[1]):
            uni[i] = (*nodes[1].get(p, (float("-inf"), 0.0)), nxt[i])
        uni[len(vocab)] = (0.0, 0.0, counts[1] if order > 1 else 0)
        out += uni.tobytes()
        word_bits = required_bits(counts[0])

        def f32(vals):
            return np.asarray(vals, np.float32).view(np.uint32).astype(
                np.uint64)

        for d in range(2, order + 1):
            rows = levels[d]
            words = [p[-1] for p in rows]
            probs = f32([nodes[d][p][0] for p in rows]) & np.uint64(
                0x7FFFFFFF)
            if d < order:
                nk = [len(kids[d + 1].get(p, ())) for p in rows]
                nxt = np.cumsum([0] + nk).astype(np.uint64)
                fields = [(words + [0], word_bits),
                          (np.append(probs, 0), 31),
                          (np.append(f32([nodes[d][p][1] for p in rows]), 0),
                           32), (nxt, required_bits(counts[d]))]
                n = len(rows) + 1
            else:
                fields = [(words, word_bits), (probs, 31)]
                n = len(rows)
            total = sum(b for _, b in fields)
            raw = _pack_lsb(fields, n)
            out += raw + b"\x00" * ((n * total + 7) // 8 + 8 - len(raw))
    out += b"\x00".join(w.encode("utf8") for w in vocab) + b"\x00"
    with open(path, "wb") as f:
        f.write(bytes(out))


# the data path's synthetic LibriSpeech test-clean: 20 utterances of
# 7.5 s, the second chapter recorded at 32 kHz (the resampler runs)
LIBRI_CHAPTERS = ((1089, 134686, 16000), (1188, 133604, 32000))
LIBRI_UTTS = 20
# the host decode times: the Python search on LIBRI_PY_UTTS utterances
LIBRI_PY_UTTS = 3


def librispeech_tarball(d: str, rng) -> dict:
    """``d``/test_clean/test-clean.tar.gz in the LibriSpeech layout
    (``LibriSpeech/test-clean/<spk>/<chap>/<spk>-<chap>-<utt>.flac`` and
    ``<spk>-<chap>.trans.txt``), FLAC written by the port's ``save_flac``;
    -> {utterance: (the encoded int samples, rate, transcript)}, the
    samples as the port's decoder reads them back from the staged file."""
    import tarfile

    from deepspeech_tpu_torch.audio.flac_encode import save_flac
    from deepspeech_tpu_torch.audio.io import read_flac

    stage = os.path.join(d, "stage", "LibriSpeech", "test-clean")
    known = {}
    per = LIBRI_UTTS // len(LIBRI_CHAPTERS)
    letters = list(LABELS[2:28])
    for spk, chap, sr in LIBRI_CHAPTERS:
        cd = os.path.join(stage, str(spk), str(chap))
        os.makedirs(cd)
        lines = []
        for u in range(per):
            name = f"{spk}-{chap}-{u:04d}"
            y = synthetic_audio(rng, int(AUDIO_S / SR * sr), sr) * 0.9
            flac = os.path.join(cd, f"{name}.flac")
            save_flac(flac, y, sr)
            q = np.clip(np.round(y * 32767.0), -32768, 32767).astype(np.int64)
            data, got_sr, bits = read_flac(flac)
            if not (got_sr == sr and bits == 16
                    and np.array_equal(data.astype(np.int64), q)):
                raise AssertionError(f"{name}: the decoder does not return "
                                     f"the encoded samples")
            text = " ".join("".join(rng.choice(letters,
                                               int(rng.integers(1, 7))))
                            for _ in range(int(rng.integers(6, 14))))
            known[name] = (q, sr, text)
            lines.append(f"{name} {text.lower()}")
        with open(os.path.join(cd, f"{spk}-{chap}.trans.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    os.makedirs(os.path.join(d, "libri", "test_clean"))
    with tarfile.open(os.path.join(d, "libri", "test_clean",
                                   "test-clean.tar.gz"), "w:gz") as tar:
        tar.add(os.path.dirname(stage), arcname="LibriSpeech")
    return known


def reference_package(model, meta) -> dict:
    """The model's weights as the reference's torch.save package (its DS2
    state_dict key names, reference model.py:183-341, 426-450)."""
    import torch

    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    ref = {}

    def bn(dst, src):
        for k in ("weight", "bias", "running_mean", "running_var"):
            ref[f"{dst}.{k}"] = sd[f"{src}.{k}"]

    for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
        ref[f"conv.seq_module.{ci}.weight"] = sd[f"conv.conv{j}.weight"]
        ref[f"conv.seq_module.{ci}.bias"] = sd[f"conv.conv{j}.bias"]
        bn(f"conv.seq_module.{bi}", f"conv.bn{j}")
    for i in range(meta["hidden_layers"]):
        for d, s in enumerate(("", "_reverse")):
            for src, dst, t in (("w_ih", "weight_ih", True),
                                ("w_hh", "weight_hh", True),
                                ("b_ih", "bias_ih", False),
                                ("b_hh", "bias_hh", False)):
                v = sd[f"rnns.{i}.{src}"][d]
                ref[f"rnns.{i}.rnn.{dst}_l0{s}"] = (v.t() if t else v
                                                    ).contiguous()
        if i > 0:
            bn(f"rnns.{i}.batch_norm.module", f"rnns.{i}.bn")
    bn("fc.0.module.0", "fc_bn")
    ref["fc.0.module.1.weight"] = sd["fc.weight"]
    return {"version": "0.0.1", "hidden_size": meta["hidden_size"],
            "hidden_layers": meta["hidden_layers"], "rnn_type": "gru",
            "audio_conf": {"sample_rate": SR, "window_size": 0.02},
            "labels": LABELS, "state_dict": ref, "bnm": meta["bnm"],
            "bidirectional": True, "dropout": 0, "cnn_width": 0,
            "epoch": 1, "loss_results": torch.tensor([1.0])}


def host_cpu() -> str:
    """The host CPU as lscpu gives it: its model name, with the vendor,
    family and model numbers (on some virtual machines lscpu names no
    model)."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True,
                         check=True).stdout
    info = {}
    for line in out.splitlines():
        key, _, value = line.partition(":")
        info[key.strip()] = value.strip()
    return (f"{info.get('Model name', 'unknown')} ({info.get('Vendor ID')}, "
            f"family {info.get('CPU family')}, model {info.get('Model')})")


def host_decode_ms(decoder, probs, sizes) -> tuple[float, tuple]:
    t0 = time.perf_counter()
    out = decoder.decode(probs, sizes)
    return (time.perf_counter() - t0) * 1e3, out


def phase_data_path(torch, model, meta, arpa: str, dslm: str) -> dict:
    """The slice's path to a LibriSpeech WER: the host library rebuilt
    (g++), a LibriSpeech-layout FLAC tarball through the port's
    ``librispeech`` CLI (no network) into a manifest whose wavs and rows
    equal the encoded samples (resampled where the chapter is at 32 kHz);
    the ``test`` CLI on it four ways (ARPA on the native search, a KenLM
    probing and a trie binary on the Python search at width 10 on
    LIBRI_PY_UTTS utterances, the trie on the device beam), launches
    counted; the eval step's K1, K2 and K8 launches on the CLI's padded
    batch against their plain versions on the same inputs (``recorded``),
    the whole step against the plain path; on the same posteriors the
    native search against the Python one bit for bit, the trie's device
    beam against the DSLM's and against K10's plain twin, the native
    WER/CER against the numpy one; the host decode times; a
    reference-format package of the model imported and transcribed on the
    card."""
    from deepspeech_tpu_torch import native
    from deepspeech_tpu_torch.audio.dsp import resample
    from deepspeech_tpu_torch.audio.features import AudioConf
    from deepspeech_tpu_torch.cli import common, librispeech
    from deepspeech_tpu_torch.cli import import_torch
    from deepspeech_tpu_torch.cli.test import main as test_main
    from deepspeech_tpu_torch.cli.transcribe import main as transcribe_main
    from deepspeech_tpu_torch.data import (AudioDataLoader, AudioDataset,
                                           BucketingSampler, read_manifest)
    from deepspeech_tpu_torch.decoders import (BeamCTCDecoder,
                                               DeviceBeamCTCDecoder)
    from deepspeech_tpu_torch.decoders.beam import ctc_beam_search
    from deepspeech_tpu_torch.decoders.beam_native import (
        NativeArpaLM, ctc_beam_search_native)
    from deepspeech_tpu_torch.decoders.lm import ArpaLM
    from deepspeech_tpu_torch.metrics import (batch_edit_distance,
                                              get_cer_wer)
    from deepspeech_tpu_torch.train import checkpoint as ckpt
    from deepspeech_tpu_torch.train.step import StepConfig, make_eval_step

    out: dict = {"host_cpu": host_cpu()}
    log(f"host CPU: {out['host_cpu']}, {os.cpu_count()} cores")
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    t0 = time.perf_counter()
    native.load_native(force=True)
    out["gxx_s"] = time.perf_counter() - t0
    log(f"host library rebuilt with {gxx} in {out['gxx_s']:.1f} s: "
        f"{native.library_path()}")
    rng = np.random.default_rng(SEED + 21)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        known = librispeech_tarball(d, rng)
        probing = os.path.join(d, "lm.binary")
        trie = os.path.join(d, "lm.trie.binary")
        t0 = time.perf_counter()
        write_kenlm_binary(probing, arpa, "probing")
        write_kenlm_binary(trie, arpa, "trie")
        log(f"KenLM probing ({os.path.getsize(probing)} B) and trie "
            f"({os.path.getsize(trie)} B) binaries of the synthetic LM "
            f"written in {time.perf_counter() - t0:.2f} s")

        # the librispeech CLI, held off the network: the one tarball it
        # is asked for is on disk, and a download would raise
        fetch = librispeech.maybe_download

        def local_only(url, target_dir):
            if not os.path.exists(os.path.join(target_dir,
                                               url.split("/")[-1])):
                raise AssertionError(f"librispeech would download {url}")
            return fetch(url, target_dir)

        librispeech.maybe_download = local_only
        os.chdir(d)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = librispeech.main(["--target-dir",
                                       os.path.join(d, "libri"),
                                       "--files-to-use",
                                       "test-clean.tar.gz"])
            out["librispeech_s"] = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
            librispeech.maybe_download = fetch
        manifest = os.path.join(d, "libri_test_clean_manifest.csv")
        rows = read_manifest(manifest)
        if rc != 0 or len(rows) != LIBRI_UTTS:
            raise AssertionError(f"librispeech CLI: exit {rc}, "
                                 f"{len(rows)} rows")
        from scipy.io import wavfile
        for wav, txt, dur in rows:
            name = os.path.basename(wav)[:-4]
            q, sr, text = known[name]
            y = q.astype(np.float32) / 32768.0
            if sr != SR:
                y = resample(y, sr, SR)
            want = (np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16)
            got_sr, got = wavfile.read(wav)
            with open(txt) as f:
                got_text = f.read()
            if (got_sr != SR or not np.array_equal(got, want)
                    or got_text != text.upper()
                    or dur != round(len(want) / SR, 3)):
                raise AssertionError(f"{name}: the manifest's wav or text "
                                     f"is not what was encoded")
        if [r[2] for r in rows] != sorted(r[2] for r in rows):
            raise AssertionError("the manifest is not sorted by duration")
        log(f"librispeech CLI: {LIBRI_UTTS} FLAC utterances ({AUDIO_S / SR}"
            f" s; chapters at {[c[2] for c in LIBRI_CHAPTERS]} Hz) -> 16 kHz"
            f" wavs and a duration-sorted manifest in "
            f"{out['librispeech_s']:.2f} s, each wav equal to the encoded "
            f"samples (resampled at 32 kHz)")

        path = os.path.join(d, "ds2.ckpt")
        ckpt.save(path, ckpt.package_from_model(model, meta, LABELS,
                                                AudioConf().to_dict()))
        # the posteriors of the manifest, as the test CLI computes them
        model32, labels, conf, _ = common.load_inference_model(path, "cuda")
        dataset = AudioDataset(conf, manifest, labels)
        loader = AudioDataLoader(dataset, BucketingSampler(len(dataset),
                                                           LIBRI_UTTS),
                                 LIBRI_UTTS)
        batch = next(iter(loader))
        batch.pop("paths")
        wire = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        eval_step = make_eval_step(model32, StepConfig(audio_conf=conf))
        torch.cuda.synchronize()
        reset_counts()
        with recorded(("stft_mag", "gru_layer", "ctc_alpha")) as calls:
            m = eval_step(wire)
        torch.cuda.synchronize()
        counts = read_counts()
        probs, sizes = m["probs"], m["out_lens"]
        want = expect_counts(stft_mag=1, gru_fwd=LAYERS, ctc_alpha=1)
        if counts != want:
            raise AssertionError(f"eval step launches {counts}, expected "
                                 f"{want}")
        # each launch of this step against its plain version on its own
        # inputs (the test CLI's padded batch: K1 on the padded waveforms,
        # K2's f32 inference variant and K8 at the padded T)
        held = hold_recorded(torch, calls)
        shapes = {k: tuple(v[0][0][0].shape) for k, v in calls.items()}
        del calls
        out["eval_step_max_abs_err"] = {k: e for k, (_, e) in held.items()}
        log(f"eval step of the test CLI's batch ({tuple(wire['audio'].shape)}"
            f" samples, T {probs.shape[1]}, lengths up to "
            f"{int(sizes.max())}), each launch against its plain version on "
            f"its inputs: " + ", ".join(
                f"{k} x{n} at {shapes[k]} max_abs_err {e:.3e}"
                for k, (n, e) in held.items())
            + f" (tolerances {STFT_TOL}, {GRU_TOL['float32']}, {CTC_TOL})")
        # the whole step against the step through every plain version
        with plain_path():
            ref = eval_step(wire)
        torch.cuda.synchronize()
        err = max_err(probs, ref["probs"])[0]
        loss, ref_loss = m["per_sample"], ref["per_sample"]
        fin = torch.isfinite(ref_loss)
        rel_loss = (((loss - ref_loss).abs() / ref_loss.abs())[fin].max()
                    .item() if fin.any() else 0.0)
        out["eval_step_probs_err"] = err
        log(f"eval step against the step through every plain version: "
            f"probs max_abs_err {err:.3e} (tolerance {EVAL_PROB_TOL}), "
            f"per-utterance loss within {rel_loss:.2e} relative (tolerance "
            f"{STEP_LOSS_TOL}), lengths equal")
        if not (torch.equal(sizes, ref["out_lens"]) and err <= EVAL_PROB_TOL
                and torch.equal(fin, torch.isfinite(loss))
                and rel_loss <= STEP_LOSS_TOL):
            raise AssertionError("the eval step disagrees with the plain "
                                 "path")
        backends = []

        class Recording(BeamCTCDecoder):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                backends.append(self.backend)

        # (label, decoder, LM, utterances, the backend auto must pick,
        # --lm-workers): threads for the native search, one process for the
        # Python search
        runs = (("beam, ARPA (auto)", "beam", arpa, LIBRI_UTTS, "native", 4),
                ("beam, KenLM probing", "beam", probing, LIBRI_PY_UTTS,
                 "python", 1),
                ("beam, KenLM trie", "beam", trie, LIBRI_PY_UTTS, "python",
                 1),
                ("device_beam, KenLM trie", "device_beam", trie, LIBRI_UTTS,
                 None, 1))
        summaries = {}
        common.BeamCTCDecoder = Recording
        try:
            for label, decoder, lm, n, backend, workers in runs:
                backends.clear()
                buf = io.StringIO()
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = test_main([
                        "--model-path", path, "--test-manifest", manifest,
                        "--batch-size", str(n), "--max-items", str(n),
                        "--num-workers", "4", "--decoder", decoder,
                        "--lm-path", lm, "--alpha", str(LM_ALPHA),
                        "--beta", str(LM_BETA), "--beam-width", "10",
                        "--lm-workers", str(workers), "--report-file",
                        os.path.join(d, "report.csv")])
                dt = time.perf_counter() - t0
                torch.cuda.synchronize()
                counts = read_counts()
                summary = buf.getvalue().strip().splitlines()[-2:]
                want = expect_counts(stft_mag=1, gru_fwd=LAYERS,
                                     ctc_alpha=1,
                                     topk=probs.shape[1] if backend is None
                                     else 0)
                log(f"test CLI --decoder {label} ({n} x {AUDIO_S / SR} s): "
                    f"{dt:.3f} s host clock, backend "
                    f"{backends or ['device']}, launches {counts}")
                for line in summary:
                    log(f"  {line}")
                if (rc != 0 or counts != want
                        or backends != ([backend] if backend else [])):
                    raise AssertionError(
                        f"test CLI {label}: exit {rc}, launches {counts} "
                        f"(expected {want}), backends {backends}")
                summaries[label] = summary
                out[f"test_cli_s[{label}]"] = dt
        finally:
            common.BeamCTCDecoder = BeamCTCDecoder

        lp = np.log(np.clip(probs.double().cpu().numpy(), 1e-30, 1.0))
        lens = sizes.cpu().numpy()
        space = LABELS.index(" ")
        kw = dict(beam_width=10, space_index=space, alpha=LM_ALPHA,
                  beta=LM_BETA, labels=LABELS, top_paths=1)
        nlm, plm = NativeArpaLM(arpa), ArpaLM(arpa)
        same = 0
        for i in range(LIBRI_PY_UTTS):
            for lm_n, lm_p in ((None, None), (nlm, plm)):
                a = ctc_beam_search_native(lp[i, :lens[i]], lm=lm_n, **kw)
                b = ctc_beam_search(lp[i, :lens[i]], lm=lm_p, **kw)
                if [h[:2] for h in a] != [h[:2] for h in b]:
                    raise AssertionError(f"utterance {i}: the native "
                                         f"search's hypothesis differs from "
                                         f"the Python one")
                if abs(a[0][2] - b[0][2]) > 1e-10:
                    raise AssertionError(f"utterance {i}: scores "
                                         f"{a[0][2]} and {b[0][2]}")
                same += 1
        log(f"native search == Python search (hypotheses and offsets bit "
            f"for bit, scores within 1e-10) on {same} searches of "
            f"{LIBRI_PY_UTTS} utterances at width 10, with and without the "
            f"LM")

        # the trie's device beam against the DSLM's, on the card
        texts = {}
        for name, lm in (("trie", trie), ("dslm", dslm)):
            dec = DeviceBeamCTCDecoder(LABELS, beam_width=10, lm_path=lm,
                                       alpha=LM_ALPHA, beta=LM_BETA,
                                       device="cuda")
            texts[name] = dec.decode(probs, sizes)
        if texts["trie"][0] != texts["dslm"][0]:
            raise AssertionError("the KenLM trie's device beam differs from "
                                 "the DSLM's")
        # K10 against its plain twin on the same posteriors: the plain
        # top-k is K10's total order by contract, so texts and offsets
        # bit-equal
        reset_counts()
        with plain_path(only=("topk_total_order",)):
            plain_k10 = DeviceBeamCTCDecoder(
                LABELS, beam_width=10, lm_path=trie, alpha=LM_ALPHA,
                beta=LM_BETA, device="cuda").decode(probs, sizes)
        if read_counts()["topk"] != 0:
            raise AssertionError("the plain top-k launched K10")
        k10_same = (plain_k10[0] == texts["trie"][0] and all(
            np.array_equal(a, b) for ga, gb in zip(plain_k10[1],
                                                   texts["trie"][1])
            for a, b in zip(ga, gb)))
        log(f"device beam over the KenLM trie == over the DSLM of its ARPA: "
            f"{LIBRI_UTTS} texts equal; through K10's plain twin texts and "
            f"offsets bit-equal: {k10_same}")
        if not k10_same:
            raise AssertionError("the trie's device beam through K10 "
                                 "differs from its plain top-k")

        # the native WER/CER against the numpy dynamic program
        refs = [labels.render_transcript(
            batch["targets"][x, :int(batch["target_lengths"][x])])
            for x in range(LIBRI_UTTS)]
        hyps = [h[0] for h in texts["trie"][0]]
        got = [get_cer_wer(h, r) for h, r in zip(hyps, refs)]
        mod = importlib.import_module(
            "deepspeech_tpu_torch.metrics.edit_distance")
        loader_fn = mod.try_load_native
        mod.try_load_native = lambda: None
        try:
            want = [get_cer_wer(h, r) for h, r in zip(hyps, refs)]
            seqs = [[ord(c) for c in s] for s in hyps], \
                [[ord(c) for c in s] for s in refs]
            want_b = [mod.edit_distance(a, b) for a, b in zip(*seqs)]
        finally:
            mod.try_load_native = loader_fn
        got_b = batch_edit_distance(*seqs).tolist()
        if got != want or got_b != want_b:
            raise AssertionError("the native WER/CER differ from numpy's")
        tot = np.sum(got, axis=0)
        log(f"native WER/CER == numpy's on {LIBRI_UTTS} utterances (WER "
            f"{100 * tot[0] / tot[2]:.3f}, CER {100 * tot[1] / tot[3]:.3f} "
            f"against the random transcripts)")

        # host decode times of the 20 x 7.5 s posteriors
        host = probs.float().cpu().numpy()
        times = {}
        cases = (("python w10", dict(beam_width=10, backend="python",
                                     num_processes=1), LIBRI_PY_UTTS),
                 ("native w10", dict(beam_width=10, backend="native",
                                     num_processes=1), LIBRI_PY_UTTS),
                 ("native w10 all", dict(beam_width=10, backend="native",
                                         num_processes=1), LIBRI_UTTS),
                 ("native w128", dict(beam_width=128, backend="native",
                                      num_processes=1), LIBRI_UTTS),
                 ("native w128 + LM", dict(beam_width=128, backend="native",
                                           num_processes=1, lm_path=arpa),
                  LIBRI_UTTS),
                 ("native w128 + LM, 4 workers",
                  dict(beam_width=128, backend="native", num_processes=4,
                       lm_path=arpa), LIBRI_UTTS))
        for name, kw, n in cases:
            dec = BeamCTCDecoder(LABELS, alpha=LM_ALPHA, beta=LM_BETA, **kw)
            host_decode_ms(dec, host[:1], lens[:1])  # warm
            times[name], _ = host_decode_ms(dec, host[:n], lens[:n])
            log(f"host decode {name}: {times[name]:.1f} ms for {n} x "
                f"{AUDIO_S / SR} s ({times[name] / n:.1f} ms an utterance)")
        out["host_decode_ms"] = times
        out["python_over_native_w10"] = (times["python w10"]
                                         / times["native w10"])

        # a reference-format package of the model, imported and transcribed
        ref_path = os.path.join(d, "ref.pth")
        torch.save(reference_package(model, meta), ref_path)
        imported = os.path.join(d, "imported.ckpt")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = import_torch.main([ref_path, imported])
        out["import_s"] = time.perf_counter() - t0
        wav = rows[0][0]
        reset_counts()
        text, dt = transcribe_once(transcribe_main, imported, wav)
        torch.cuda.synchronize()
        counts = read_counts()
        orig, _ = transcribe_once(transcribe_main, path, wav)
        log(f"import_torch of the reference-format package "
            f"({os.path.getsize(ref_path)} B): {out['import_s']:.2f} s; "
            f"transcribe on it: {dt:.3f} s, launches {counts}, text equal "
            f"to the original checkpoint's: {text == orig}")
        if (rc != 0 or text != orig
                or counts != expect_counts(stft_mag=1, gru_fwd=LAYERS)):
            raise AssertionError(f"import_torch: exit {rc}, launches "
                                 f"{counts}, {text[:40]!r} vs {orig[:40]!r}")
    return out


def serve_utterances(rng, n: int | None = None) -> list:
    """``n`` (SERVE_UTTS) synthetic utterances of 2 to 7.5 s."""
    return [synthetic_audio(rng, int(s * SR))
            for s in np.linspace(2.0, 7.5, n or SERVE_UTTS)]


def write_requests(d: str, ys: list) -> tuple[str, list]:
    """The utterances as wavs under ``d`` and a manifest of them ->
    (manifest, each wav as the serve CLI loads it: 16-bit, peak-normalized
    again)."""
    from deepspeech_tpu_torch.audio.io import load_audio_norm, save_wav

    manifest, heard = os.path.join(d, "requests.csv"), []
    with open(manifest, "w") as f:
        for i, y in enumerate(ys):
            wav = os.path.join(d, f"req{i:02d}.wav")
            save_wav(wav, y, SR)
            heard.append(load_audio_norm(wav)[0])
            f.write(f"{wav},\n")
    return manifest, heard


def serve_cli(path: str, manifest: str, out: str, *flags: str):
    """One run of the serve CLI -> (records, ticks, audio-s/s, summary)."""
    from deepspeech_tpu_torch.cli.serve import main

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(["--model-path", path, "--manifest", manifest,
                   "--slots", str(SERVE_SLOTS), "--chunk-seconds",
                   str(SERVE_CHUNK_S), "--output", out, *flags])
    if rc != 0:
        raise AssertionError(f"serve exited {rc}")
    summary = err.getvalue().strip().splitlines()[-1]
    m = re.search(r"over (\d+) ticks .* = (\d+) audio-s/s", summary)
    if not m:
        raise AssertionError(f"no serve summary: {summary!r}")
    with open(out) as f:
        records = [json.loads(line) for line in f]
    return records, int(m.group(1)), int(m.group(2)), summary


def drive_pool(pool, ys: list, on_tick=None) -> dict:
    """The serve CLI's loop over ``ys`` (fill the free slots, tick, collect
    the finished) -> {index: (text, logits, beam text or None)};
    ``on_tick(i)`` runs before tick i."""
    pending, slot_of, out, i = list(range(len(ys))), {}, {}, 0
    beam = pool._st._beam_state is not None

    def collect():  # before a freed slot is leased again
        for s in list(slot_of):
            if pool.done(s):
                out[slot_of.pop(s)] = (
                    pool.text(s), pool.collected_logits(s),
                    pool.beam_text(s) if beam else None)

    while pending or pool.busy():
        collect()
        while pending:
            try:
                s = pool.open()
            except RuntimeError:
                break
            j = pending.pop(0)
            pool.write(s, ys[j])
            pool.close(s)
            slot_of[s] = j
        if on_tick is not None:
            on_tick(i)
        pool.tick()
        i += 1
    collect()
    return out


def hold_texts(label: str, got: dict, single) -> None:
    """Each pool text against one stream of the same audio: equal, or
    differing only where the stream's top two logits lie within the
    logits' difference (a tie the two batch shapes may break apart)."""
    for j, (text, logits, _) in sorted(got.items()):
        ref_text, ref_logits = single(j)
        if logits.shape != ref_logits.shape:
            raise AssertionError(f"{label} {j}: logits {logits.shape} vs "
                                 f"{ref_logits.shape}")
        err = float(np.abs(logits - ref_logits).max())
        scale = max(1.0, float(np.abs(ref_logits).max()))
        if not err <= STREAM_TOL * scale:
            raise AssertionError(f"{label} {j}: logits max_abs_err {err}")
        if text != ref_text:
            top2 = np.sort(ref_logits, -1)[:, -2:]
            flips = logits.argmax(-1) != ref_logits.argmax(-1)
            if not (top2[flips, 1] - top2[flips, 0] <= 2 * err).all():
                raise AssertionError(f"{label} {j}: {text!r} != {ref_text!r}")
            log(f"{label} {j}: text differs at {int(flips.sum())} tied "
                f"frames")


def phase_serve(torch, floor: dict) -> dict:
    """The serving path: the unidirectional DS2 (6 x GRU-800, context 20,
    f32) from seeded weights as a checkpoint, the serve CLI on
    SERVE_UTTS synthetic utterances with greedy and with device-beam
    decoding (K1 once a tick, K10 once a beam step), tick latency and
    audio-s/s (the CLI's, and over the ticks after the first); the same
    pool's texts held to one stream each, 10 ticks profiled; K1 on the
    first tick's inputs against its plain version; the greedy pool's
    logits held to the pool through the plain versions, the device-beam
    pool's texts bit-equal to the pool with K10's plain twin; the stream
    with frozen normalization held to the batch forward (K2, f32) of the
    same utterances."""
    from deepspeech_tpu_torch.audio.features import AudioConf
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.ops.cuda import stft
    from deepspeech_tpu_torch.serve import StreamingTranscriber, StreamPool
    from deepspeech_tpu_torch.text.labels import Labels
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    rng = np.random.default_rng(SEED + 40)
    model, meta = build_model("gru", CLASSES, HIDDEN, LAYERS,
                              bidirectional=False, device="cuda")
    random_weights(model, rng)
    model.eval()
    ys = serve_utterances(rng)
    audio_s = sum(len(y) for y in ys) / SR
    conf, labels = AudioConf(), Labels(LABELS)
    chunk = int(SERVE_CHUNK_S * SR / conf.hop)
    if min(len(y) for y in ys) <= chunk * conf.hop:
        raise AssertionError("an utterance shorter than a chunk")
    first_tick_s = SERVE_SLOTS * chunk * conf.hop / SR
    out: dict = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ds2_uni.ckpt")
        ckpt.save(path, ckpt.package_from_model(model, meta, LABELS,
                                                conf.to_dict()))
        # the in-process runs below hear the audio the CLI hears
        manifest, ys = write_requests(d, ys)
        ticks_ms: list = []
        tick = StreamPool.tick

        def timed(self):
            t0 = time.perf_counter()
            frags = tick(self)
            ticks_ms.append((time.perf_counter() - t0) * 1e3)
            return frags

        StreamPool.tick = timed
        try:
            for decoder in ("greedy", "device_beam"):
                ticks_ms.clear()
                reset_counts()
                records, ticks, rate, summary = serve_cli(
                    path, manifest, os.path.join(d, f"{decoder}.jsonl"),
                    "--decoder", decoder)
                torch.cuda.synchronize()
                counts = read_counts()
                beam = decoder == "device_beam"
                want = expect_counts(stft_mag=ticks,
                                     topk=ticks * chunk // 2 if beam else 0)
                log(f"serve CLI ({decoder}): {summary}; launches {counts}")
                if counts != want or len(records) != len(ys):
                    raise AssertionError(f"serve {decoder}: launches "
                                         f"{counts} (expected {want}), "
                                         f"{len(records)} records")
                lat = np.asarray(ticks_ms[1:])
                # every slot serves a whole chunk of real audio in the
                # first tick (each utterance is longer than a chunk), so
                # ticks 2-N serve the rest
                steady = (audio_s - first_tick_s) / (lat.sum() / 1e3)
                out[decoder] = dict(
                    ticks=ticks, audio_s_per_s=rate,
                    steady_audio_s_per_s=float(steady),
                    k1_per_tick=counts["stft_mag"] / ticks,
                    k10_per_tick=counts["topk"] / ticks,
                    tick_p50_ms=float(np.percentile(lat, 50)),
                    tick_p95_ms=float(np.percentile(lat, 95)),
                    texts={r["wav"]: r["transcription"] for r in records})
                log(f"serve ({decoder}, {SERVE_SLOTS} slots, "
                    f"{SERVE_CHUNK_S} s chunks, {audio_s:.1f} audio-s): "
                    f"{ticks} ticks, K1 {out[decoder]['k1_per_tick']:.0f} "
                    f"and K10 {out[decoder]['k10_per_tick']:.0f} a tick; "
                    f"tick latency p50 {out[decoder]['tick_p50_ms']:.3f} ms "
                    f"p95 {out[decoder]['tick_p95_ms']:.3f} ms (host clock, "
                    f"ticks 2-{ticks}); {rate} audio-s/s (the CLI's "
                    f"summary, its first tick's warm-up included); "
                    f"{steady:.3f} audio-s/s over ticks 2-{ticks} "
                    f"({audio_s - first_tick_s:.2f} audio-s in "
                    f"{lat.sum():.3f} ms)")
        finally:
            StreamPool.tick = tick
        wavs = sorted(out["greedy"]["texts"])

    # the same pool in-process: its texts against one stream each, 10 of
    # its ticks profiled, K1's inputs of its first tick recorded
    pool = StreamPool(model, labels, conf, chunk_frames=chunk,
                      slots=SERVE_SLOTS, collect_logits=True)
    k1, k1_calls = stft.stft_mag, []

    def k1_recorded(y, n_fft, hop, window, center=True):
        k1_calls.append((y.clone(), n_fft, hop, window, center))
        return k1(y, n_fft, hop, window, center=center)

    def on_tick(i):
        stft.stft_mag = k1_recorded if i == 0 else k1
        if i == 2:  # every slot busy from the first tick
            t0 = time.perf_counter()
            for _ in range(SERVE_PROFILE_TICKS):
                pool.tick()
            ms = (time.perf_counter() - t0) * 1e3
            log(f"{SERVE_PROFILE_TICKS} serve ticks: {ms:.3f} ms on the host "
                f"clock ({ms / SERVE_PROFILE_TICKS:.3f} ms a tick)")
            profile_run(torch, f"{SERVE_PROFILE_TICKS} serve ticks "
                        f"({SERVE_SLOTS} slots, greedy)",
                        lambda: [pool.tick() for _ in range(
                            SERVE_PROFILE_TICKS)], ms, floor)

    try:
        got = drive_pool(pool, ys, on_tick)
    finally:
        stft.stft_mag = k1
    # a lane's results do not depend on the other lanes: the CLI's texts
    # are this pool's
    cli = [out["greedy"]["texts"][w] for w in wavs]
    if cli != [got[j][0] for j in range(len(ys))]:
        raise AssertionError("the serve CLI's texts differ from the pool's")

    def single(j):
        st = StreamingTranscriber(model, labels, conf, chunk_frames=chunk)
        st.feed(ys[j])
        st.finish()
        return st.texts[0], st.collected_logits()[0]

    hold_texts("serve pool", got, single)
    log(f"serve: the CLI's {len(ys)} texts equal the pool's, each held to "
        f"one stream of its utterance")

    # K1 on the chunk route (center=False, the tick's wave tail + chunk)
    # against its plain version on the inputs of the first tick
    (sig, n_fft, hop, window, center), = k1_calls
    with torch.no_grad():
        mag = k1(sig, n_fft, hop, window, center=center)
        ref_mag = stft.plain(sig, n_fft, hop, window, center=center)
    k1_err = max_err(mag, ref_mag)[0]
    log(f"K1 on the serve tick's inputs ({tuple(sig.shape)}, center="
        f"{center}) -> {tuple(mag.shape)}: max_abs_err vs plain {k1_err:.3e}"
        f" (tolerance {STFT_TOL})")
    if center or not bool(((mag - ref_mag).abs() <= STFT_TOL["atol"]
                           + STFT_TOL["rtol"] * ref_mag.abs()).all()):
        raise AssertionError("K1 disagrees with plain on the serve tick")
    out["k1_chunk_max_abs_err"] = k1_err

    # the pool on the card against the same pool through the plain
    # versions: the logits at STREAM_TOL, the texts as against one stream
    with plain_path():
        plain = drive_pool(StreamPool(model, labels, conf, chunk_frames=chunk,
                                      slots=SERVE_SLOTS, collect_logits=True),
                           ys)
    hold_texts("serve pool vs plain path", got,
               lambda j: plain[j][:2])
    out["pool_vs_plain_rel_err"] = max(
        float(np.abs(got[j][1] - plain[j][1]).max())
        / max(1.0, float(np.abs(plain[j][1]).max())) for j in got)
    log(f"serve pool (greedy) vs the pool through the plain versions: "
        f"logits worst {out['pool_vs_plain_rel_err']:.3e} x scale "
        f"(tolerance {STREAM_TOL}); texts held")

    # the device beam in the pool (K10 once a step) against the same pool
    # with K10's plain twin: the same logits, so the beam texts bit-equal
    # (plain top-k is K10's order by contract); the CLI's are this pool's.
    # Through every plain version the logits move by K1's round-off, and a
    # beam may then order two hypotheses within it apart: counted, not held
    def beam_pool(**kw):
        return drive_pool(StreamPool(model, labels, conf, chunk_frames=chunk,
                                     slots=SERVE_SLOTS, decoder="beam",
                                     beam_width=10, collect_logits=True,
                                     **kw), ys)

    beams = beam_pool()
    with plain_path(only=("topk_total_order",)):
        plain_k10 = beam_pool()
    with plain_path():
        plain_all = beam_pool()
    same = [beams[j][2] == plain_k10[j][2]
            and np.array_equal(beams[j][1], plain_k10[j][1]) for j in beams]
    cli_same = ([out["device_beam"]["texts"][w] for w in wavs]
                == [beams[j][2] for j in range(len(ys))])
    n_all = sum(beams[j][2] == plain_all[j][2] for j in beams)
    log(f"serve pool (device beam, width 10): {sum(same)} of {len(ys)} beam "
        f"texts and logits bit-equal with K10's plain twin; the CLI's texts "
        f"{'equal' if cli_same else 'differ from'} the pool's; through every "
        f"plain version {n_all} of {len(ys)} beam texts equal")
    if not all(same) or not cli_same:
        raise AssertionError("the serve beam disagrees with plain top-k")
    out["beam_texts_equal_all_plain"] = n_all

    # frozen normalization: the stream against the batch forward
    out["frozen_norm_rel_err"] = hold_frozen_stream(
        torch, model, StreamingTranscriber, ys, range(0, len(ys), 5), chunk,
        expect_counts(stft_mag=1, gru_fwd=LAYERS), "K2, f32")
    return out


def hold_frozen_stream(torch, model, cls, ys, js, chunk, want,
                       label) -> float:
    """Stream ``ys[j]`` for j in ``js`` through ``cls`` with the
    normalization frozen at the utterance's mean and 1, and hold its logits
    to the batch forward of the utterance (launches ``want``) at
    STREAM_TOL -> the worst error x scale."""
    from deepspeech_tpu_torch.audio.features import (AudioConf,
                                                     featurize_batch,
                                                     make_window)
    from deepspeech_tpu_torch.ops.cuda import stft
    from deepspeech_tpu_torch.text.labels import Labels

    conf, labels = AudioConf(), Labels(LABELS)
    window = make_window(conf.window, conf.n_fft)
    worst = 0.0
    for j in js:
        y = torch.from_numpy(ys[j]).cuda()[None]
        lens = torch.tensor([len(ys[j])], device="cuda")
        with torch.no_grad():
            mag = stft.stft_mag(y, conf.n_fft, conf.hop, window)[:, :161]
            mean = torch.log1p(mag * 1048576.0).mean().item()
            reset_counts()
            spect, frames = featurize_batch(y, lens, conf)
            ref, _, ref_lens = model(spect, frames)
            torch.cuda.synchronize()
            counts = read_counts()
        if counts != want:
            raise AssertionError(f"batch forward launches {counts}")
        st = cls(model, labels, conf, chunk_frames=chunk,
                 frozen_norm=(np.array([mean], np.float32),
                              np.array([1.0], np.float32)))
        st.feed(ys[j])
        st.finish()
        stream = st.collected_logits()[0]
        ref = ref[0, :int(ref_lens[0])].cpu().numpy()
        if stream.shape != ref.shape:
            raise AssertionError(f"stream {stream.shape} vs batch "
                                 f"{ref.shape}")
        err = float(np.abs(stream - ref).max())
        scale = max(1.0, float(np.abs(ref).max()))
        worst = max(worst, err / scale)
        log(f"frozen-norm {cls.__name__} of utterance {j} "
            f"({len(ys[j]) / SR:.2f} s): logits max_abs_err vs the batch "
            f"forward ({label}) {err:.3e} (scale {scale:.2f}, tolerance "
            f"{STREAM_TOL * scale:.3e})")
        if not err <= STREAM_TOL * scale:
            raise AssertionError("the stream disagrees with the batch "
                                 "forward")
    return worst


@contextlib.contextmanager
def relu_inputs(replay=None):
    """Record the input of every ReLU call (a CNN block's pre-activation)
    in call order; with ``replay``, such a record of another run, each ReLU
    keeps the positions where the replayed input was positive in place of
    its own."""
    import torch.nn.functional as F

    relu, seen = F.relu, []

    def recorded(x, inplace=False):
        seen.append(x.detach().clone())
        if replay is None:
            return relu(x)
        return x * (replay[len(seen) - 1] > 0)

    F.relu = recorded
    try:
        yield seen
    finally:
        F.relu = relu


def relu_flips(torch, model, lengths, pre, ref_pre) -> list:
    """Per ReLU block: (block index, sign changes of the pre-activation
    over the valid frames between two runs, valid positions, (C,) changes
    by channel)."""
    blocks = [i for i, b in enumerate(model.blocks)
              if b.relu and not b.use_glu]
    if len(blocks) != len(pre) or len(pre) != len(ref_pre):
        raise AssertionError(f"{len(pre)} and {len(ref_pre)} ReLU calls for "
                             f"{len(blocks)} ReLU blocks")
    lens, i, rows = lengths, 0, []
    for k, block in enumerate(model.blocks):
        lens = block.out_lengths(lens)
        if k not in blocks:
            continue
        a, b = pre[i], ref_pre[i]
        i += 1
        valid = (torch.arange(a.shape[-1], device=a.device)[None, :]
                 < lens[:, None])[:, None, :]
        flips = ((a > 0) != (b > 0)) & valid
        rows.append((k, int(flips.sum()), int(valid.sum()) * a.shape[1],
                     flips.sum((0, 2))))
    return rows


def cnn_step_grads(torch, model, batch, jitter, spect=None):
    """A ConvStack's step_grads from ``batch`` (or from ``spect``, the
    featurized batch): the dropout's keep masks from one seed in every
    run -> (loss, grads by name, grad norm, spect)."""
    from deepspeech_tpu_torch.ops import fp32_matmul
    from deepspeech_tpu_torch.train.optim import global_norm
    from deepspeech_tpu_torch.train.step import StepConfig, _loss, featurize

    flags = []
    hook = model.blocks[0].conv.weight.register_hook(
        lambda g: flags.append(torch.backends.cudnn.allow_tf32))
    model.train()
    names, params = zip(*model.named_parameters())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with fp32_matmul():
        if spect is None:
            spect, lengths = featurize(batch, StepConfig(), jitter)
        else:
            lengths = 1 + batch["audio_lengths"] // StepConfig().audio_conf.hop
        logits, _, out_lens = model(spect, lengths, gen)
        loss, _ = _loss(logits, out_lens, batch)
        grads = torch.autograd.grad(loss, params)
    hook.remove()
    if flags != [False]:
        raise AssertionError(f"cuDNN TF32 during the backward: {flags}")
    return (loss.detach(), dict(zip(names, grads)), global_norm(grads),
            spect.detach())


def phase_cnn_train(torch, variant: str, floor: dict, **kw):
    """One f32 train step of a CNN at BATCH x 7.5 s: loss, grad norm and
    every gradient against the plain path, its launches (K1, K8, K9 once
    each), 5 steps and a profiled one -> (model, meta, ms per step)."""
    from deepspeech_tpu_torch.audio.features import make_window
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.ops.cuda import stft
    from deepspeech_tpu_torch.train.optim import build_optimizer
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 descale_audio,
                                                 make_train_step)

    rng = np.random.default_rng(SEED + 50 + len(variant))
    model, meta = build_model(variant, CLASSES, device="cuda", **kw)
    random_weights(model, rng)
    batch = train_batch(torch, rng, LABELS, BATCH)
    jitter = torch.from_numpy(rng.uniform(-0.5, 0.5, BATCH).astype(
        np.float32)).cuda()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    loss, grads, norm, spect = cnn_step_grads(torch, model, batch, jitter)
    model.load_state_dict(init)
    with plain_path():
        with relu_inputs() as ref_pre:
            ref_loss, ref_grads, ref_norm, ref_spect = cnn_step_grads(
                torch, model, batch, jitter)
        model.load_state_dict(init)
        with relu_inputs() as same_pre:
            _, same_grads, _, _ = cnn_step_grads(torch, model, batch,
                                                 jitter, spect)
        # K1's spectrogram with the plain spectrogram's ReLU pattern: what
        # stays of the gap without the sign changes
        model.load_state_dict(init)
        with relu_inputs(ref_pre):
            _, kept_grads, _, _ = cnn_step_grads(torch, model, batch,
                                                 jitter, spect)
    model.load_state_dict(init)
    torch.cuda.synchronize()
    rel_loss = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    rel_norm = abs(norm.item() - ref_norm.item()) / ref_norm.item()
    spect_err = max_err(spect, ref_spect)[0]
    conf = StepConfig().audio_conf
    window = make_window(conf.window, conf.n_fft)
    audio = descale_audio(batch)
    mag = stft.stft_mag(audio, conf.n_fft, conf.hop, window)
    ref_mag = stft.plain(audio, conf.n_fft, conf.hop, window)
    mag_ok = bool(((mag - ref_mag).abs() <= STFT_TOL["atol"]
                   + STFT_TOL["rtol"] * ref_mag.abs()).all())
    worst = max((max_err(grads[k], same_grads[k])[0]
                 / max_err(grads[k], same_grads[k])[1], k) for k in grads)
    whole = max((max_err(grads[k], ref_grads[k])[0]
                 / max_err(grads[k], ref_grads[k])[1], k) for k in grads)
    gap = max((max_err(same_grads[k], ref_grads[k])[0]
               / max_err(same_grads[k], ref_grads[k])[1], k) for k in grads)
    kept = max((max_err(kept_grads[k], ref_grads[k])[0]
                / max_err(kept_grads[k], ref_grads[k])[1], k) for k in grads)
    lengths = 1 + batch["audio_lengths"] // StepConfig().audio_conf.hop
    changes = relu_flips(torch, model, lengths, same_pre, ref_pre)
    del ref_pre, same_pre
    log(f"{variant}: ReLU sign changes between K1's and the plain "
        f"spectrogram's runs (plain path), by block: "
        + ", ".join(f"{k}: {n} of {v}" for k, n, v, _ in changes[:6])
        + (f", ... ({sum(n for _, n, _, _ in changes)} in all "
           f"{len(changes)} blocks)" if len(changes) > 6 else ""))
    # the worst gradient element of the gap, and the sign changes in its
    # output channel of its block against that block's channel mean
    name = gap[1]
    diff = (same_grads[name] - ref_grads[name]).abs()
    channel = int(np.unravel_index(int(diff.argmax()), diff.shape)[0])
    block = int(name.split(".")[1]) if name.startswith("blocks.") else None
    row = next((r for r in changes if r[0] == block), None)
    where = (f"{int(row[3][channel])} sign changes in that channel of block "
             f"{block} against {float(row[3].float().mean()):.3f} a channel"
             if row is not None and channel < len(row[3]) else
             "not in a ReLU block")
    log(f"{variant}: from K1's spectrogram through the plain path the "
        f"gradients are apart by {gap[0]:.3e} x scale ({name}, output "
        f"channel {channel}: {where}); with the plain spectrogram's ReLU "
        f"pattern replayed, by {kept[0]:.3e} x scale ({kept[1]}; tolerance "
        f"{CNN_PATTERN_TOL})")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{variant} ({len(model.blocks)} blocks, {n_params / 1e6:.2f} M "
        f"parameters) train step vs plain path: loss {loss.item():.4f} / "
        f"{ref_loss.item():.4f} (rel {rel_loss:.2e}), grad norm "
        f"{norm.item():.4f} / {ref_norm.item():.4f} (rel {rel_norm:.2e}); "
        f"K1's magnitudes {'within' if mag_ok else 'outside'} {STFT_TOL} "
        f"(max_abs_err {max_err(mag, ref_mag)[0]:.2e}; the "
        f"log-spectrograms' {spect_err:.2e}); from the same spectrogram "
        f"{len(grads)} grads, worst {worst[1]} at {worst[0]:.2e} x scale "
        f"(tolerances {CNN_LOSS_TOL}, {CNN_GRAD_TOL} x scale); through the "
        f"whole plain path worst {whole[1]} at {whole[0]:.2e}")
    if not (rel_loss <= CNN_LOSS_TOL and rel_norm <= CNN_LOSS_TOL
            and mag_ok and worst[0] <= CNN_GRAD_TOL
            and kept[0] <= CNN_PATTERN_TOL):
        raise AssertionError(f"{variant} train step disagrees with plain")
    zero = [k for k, g in grads.items() if not g.abs().max().item() > 0]
    if zero:
        raise AssertionError(f"parameters without a gradient: {zero}")
    optimizer = build_optimizer("sgd", lr=3e-4, momentum=0.9, max_norm=100.0)
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, optimizer, StepConfig())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    times = []
    for i in range(5):
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(state, batch, generator=gen)
        end.record()
        end.synchronize()
        counts = read_counts()
        if counts != expect_counts(stft_mag=1, ctc_alpha=1, ctc_beta=1):
            raise AssertionError(f"{variant} train step launches {counts}")
        times.append(start.elapsed_time(end))
        if not np.isfinite(m["loss"].item()) or bool(m["step_skipped"]):
            raise AssertionError(f"{variant} step {i}: loss "
                                 f"{m['loss'].item()}")
        log(f"{variant} train step {i + 1}: loss {m['loss'].item():.4f}, "
            f"grad norm {m['grad_norm'].item():.3f}, {times[-1]:.3f} ms")
    ms = float(np.median(times[1:]))
    audio_s = float(batch["audio_lengths"].sum().item()) / SR
    log(f"{variant} train path: launches {counts}; {ms:.3f} ms per step "
        f"(median of steps 2-5, CUDA events, f32) for {audio_s:.2f} s of "
        f"audio = {audio_s / (ms / 1e3):.1f} audio-s/s")
    profile_run(torch, f"{variant} train step",
                lambda: step(state, batch, generator=gen), ms, floor)
    return model.eval(), meta, dict(
        step_ms=ms, grad_gap=gap[0], grad_gap_pattern_replayed=kept[0],
        relu_sign_changes=sum(n for _, n, _, _ in changes))


def phase_cnn(torch, floor: dict) -> dict:
    """The CNN zoo on the card: the train step of ``cnn`` (width 256,
    epilog 800, 6 repeats) and ``cnn_jasper``; ``cnn_residual`` through
    the pool (running SE), its texts held to one stream each and its
    logits to the pool through the plain versions; the stream of ``cnn``
    (no SE) with frozen normalization held to the batch forward;
    transcribe --chunk-seconds 0.96 --se-mode two_pass on cnn_jasper, its
    launches, and its logits and text against the batch forward (which
    the second pass runs)."""
    from deepspeech_tpu_torch.audio.features import (AudioConf,
                                                     featurize_batch)
    from deepspeech_tpu_torch.audio.io import save_wav
    from deepspeech_tpu_torch.cli.transcribe import main
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.serve import CNNStreamingTranscriber, StreamPool
    from deepspeech_tpu_torch.text.labels import Labels
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    out = {}
    cnn, _, out["cnn"] = phase_cnn_train(
        torch, "cnn", floor, hidden_size=HIDDEN, hidden_layers=LAYERS,
        cnn_width=256)
    jasper, jmeta, out["cnn_jasper"] = phase_cnn_train(
        torch, "cnn_jasper", floor)

    conf, labels = AudioConf(), Labels(LABELS)
    chunk = int(SERVE_CHUNK_S * SR / conf.hop)
    rng = np.random.default_rng(SEED + 60)
    residual, _ = build_model("cnn_residual", CLASSES, HIDDEN, LAYERS,
                              cnn_width=256, device="cuda")
    random_weights(residual, rng)
    residual.eval()
    ys = serve_utterances(rng, SERVE_SLOTS)
    pool = StreamPool(residual, labels, conf, chunk_frames=chunk,
                      slots=SERVE_SLOTS, collect_logits=True)
    reset_counts()
    t0 = time.perf_counter()
    ticks = []
    got = drive_pool(pool, ys, ticks.append)
    dt = time.perf_counter() - t0
    counts = read_counts()
    if counts != expect_counts(stft_mag=len(ticks)):
        raise AssertionError(f"cnn_residual pool launches {counts}")

    def single(j):
        st = CNNStreamingTranscriber(residual, labels, conf,
                                     chunk_frames=chunk)
        st.feed(ys[j])
        st.finish()
        return st.texts[0], st.collected_logits()[0]

    hold_texts("cnn_residual pool", got, single)
    audio_s = sum(len(y) for y in ys) / SR
    log(f"cnn_residual pool (running SE, {SERVE_SLOTS} slots): {len(ticks)} "
        f"ticks, launches {counts}, {audio_s / dt:.1f} audio-s/s (host "
        f"clock); texts held to one stream each")
    # the pool on the card against the same pool through the plain versions
    with plain_path():
        plain = drive_pool(StreamPool(residual, labels, conf,
                                      chunk_frames=chunk, slots=SERVE_SLOTS,
                                      collect_logits=True), ys)
    hold_texts("cnn_residual pool vs plain path", got,
               lambda j: plain[j][:2])
    out["residual_pool_vs_plain_rel_err"] = max(
        float(np.abs(got[j][1] - plain[j][1]).max())
        / max(1.0, float(np.abs(plain[j][1]).max())) for j in got)
    log(f"cnn_residual pool vs the pool through the plain versions: logits "
        f"worst {out['residual_pool_vs_plain_rel_err']:.3e} x scale "
        f"(tolerance {STREAM_TOL}); texts held")

    # the streamed path itself: cnn has no SE, so its stream under a frozen
    # normalization is the batch forward's function
    out["cnn_frozen_norm_rel_err"] = hold_frozen_stream(
        torch, cnn, CNNStreamingTranscriber, ys, (0, SERVE_SLOTS - 1),
        chunk, expect_counts(stft_mag=1), "cuDNN, f32")

    y = synthetic_audio(rng, AUDIO_S)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "jasper.ckpt")
        ckpt.save(path, ckpt.package_from_model(jasper, jmeta, LABELS,
                                                conf.to_dict()))
        wav = os.path.join(d, "req.wav")
        save_wav(wav, y, SR)
        reset_counts()
        text, dt = transcribe_once(main, path, wav, "--chunk-seconds",
                                   str(SERVE_CHUNK_S), "--se-mode",
                                   "two_pass")
        torch.cuda.synchronize()
        counts = read_counts()
    reset_counts()
    st = CNNStreamingTranscriber(jasper, labels, conf, chunk_frames=chunk,
                                 se_mode="two_pass")
    st.feed(y)
    st.finish()
    torch.cuda.synchronize()
    direct = read_counts()  # K1 once a chunk, once for the second pass
    yt = torch.from_numpy(y).cuda()[None]
    with torch.no_grad():
        spect, frames = featurize_batch(
            yt, torch.tensor([len(y)], device="cuda"), conf)
        ref, _, lens = jasper(spect, frames)
    ref = ref[0, :int(lens[0])].cpu().numpy()
    stream = st.collected_logits()[0]
    err = float(np.abs(stream - ref).max()) if stream.shape == ref.shape \
        else float("inf")
    from deepspeech_tpu_torch.decoders import GreedyDecoder
    want = GreedyDecoder(LABELS).decode_ids(ref.argmax(-1)[None],
                                            [ref.shape[0]])[0][0][0]
    log(f"transcribe --chunk-seconds {SERVE_CHUNK_S} --se-mode two_pass on "
        f"cnn_jasper ({AUDIO_S / SR} s): {dt:.3f} s (host clock, checkpoint "
        f"load included), launches {counts}; logits max_abs_err vs the batch "
        f"forward {err:.3e} (the second pass runs it); text "
        f"{'equals' if text == want else 'differs from'} the batch greedy "
        f"text")
    if (not err <= STREAM_TOL * max(1.0, float(np.abs(ref).max()))
            or text != want or counts != direct
            or counts != expect_counts(stft_mag=counts["stft_mag"])
            or counts["stft_mag"] < 2):
        raise AssertionError("two_pass transcribe disagrees with the batch "
                             "forward")
    return out


# the multi-GPU phase: 3 steps a run; the time-sliced and NCCL step times
# over MULTI_TIMED steps after the first
MULTI_STEPS, MULTI_TIMED = 3, 4
# a rank's step against the single-process step on the same rows: the
# loss and the grad norm relative at STEP_LOSS_TOL, each parameter's change
# from its init at STEP_GRAD_TOL x max|the reference's change| (phase 12's
# kernel-vs-plain tolerances: the kernels are the same, the sums over the
# two shards' rows and the BN moments' sums run in other orders). After the
# first step the two runs' weights differ by that round-off, which the bf16
# roundings of the next steps carry on, so the later steps' loss and grad
# norm drift apart: held at MULTI_DRIFT_TOL (seen up to 2.39e-3 at step 3
# on an NVIDIA H100 80GB HBM3, 700.00 W; in f32, tests/test_torch_cuda.py
# holds two steps of a small model at 1e-4 and shows where a Hardtanh
# clamp flips)
MULTI_DRIFT_TOL = 1e-2


def gru_spec(hidden: int) -> dict:
    """The bf16 6 x BiGRU-<hidden> of the multi-GPU phases."""
    return dict(rnn_type="gru", hidden_size=hidden, bidirectional=True,
                compute_dtype="bfloat16")


def mesh_order_norm(torch, model, k: int):
    """-> a ``global_norm`` of ``model``'s gradients in the order of the
    ranks of a data 1 x model ``k`` mesh (``train/step.py:
    _reduce_over_mesh``): on each rank the squares of its slices of the
    sharded parameters (``param_spec``), each summed alone and then in the
    parameter order; the ranks' sums in the order of gloo's all-reduce of
    one element, x0 + (x1 + (x2 + x3)); the replicated parameters' squares
    in the parameter order, plus that."""
    from deepspeech_tpu_torch.parallel.mesh import param_spec, shard_dim

    dims = [shard_dim(param_spec(n, p.shape, k))
            for n, p in model.named_parameters()]

    def norm(grads):
        zero = grads[0].new_zeros((), dtype=torch.float32)
        ranks = []
        for r in range(k):
            acc = zero
            for g, d in zip(grads, dims):
                if d is not None:
                    n = g.shape[d] // k
                    part = g.narrow(d, r * n, n).contiguous()
                    acc = acc + torch.sum(part * part)
            ranks.append(acc)
        sharded = ranks[-1]
        for acc in reversed(ranks[:-1]):
            sharded = acc + sharded
        replicated = sum((torch.sum(g * g) for g, d in zip(grads, dims)
                          if d is None), zero)
        return torch.sqrt(replicated + sharded)

    return norm


@contextlib.contextmanager
def train_step_norm(norm):
    """The train step's ``global_norm`` replaced by ``norm`` inside (kept
    where ``norm`` is None)."""
    from deepspeech_tpu_torch.train import step as step_module

    kept = step_module.global_norm
    step_module.global_norm = norm or kept
    try:
        yield
    finally:
        step_module.global_norm = kept


def multi_gpu_reference(torch, spec: dict, batch_size: int, seed: int,
                        path: str, deterministic: bool = False,
                        model_norm: int = 1) -> dict:
    """The single-process train step of the model ``spec`` names
    (``build_model``'s keywords: 6 layers, CLASSES, seeded weights) on
    ``batch_size`` x 7.5 s, MULTI_STEPS times with the augmentation (and a
    CNN's dropout) drawn from a generator seeded with SEED, under cuDNN's
    deterministic algorithms where ``deterministic``, its grad norm summed
    as a data 1 x model ``model_norm`` mesh sums it where ``model_norm``
    > 1 (``mesh_order_norm``: the clip then scales the gradients as on the
    ranks); saved to ``path``
    (the spec, the init, the batch, each step's loss, grad norm and
    parameters, on the host, and ``deterministic``) for the ranks -> its
    first step's metrics and the median time of steps 2-MULTI_STEPS (CUDA
    events)."""
    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.train.optim import build_optimizer
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_train_step)

    rng = np.random.default_rng(seed)
    model, _ = build_model(num_classes=CLASSES, hidden_layers=LAYERS,
                           device="cuda", **spec)
    random_weights(model, np.random.default_rng(seed))
    batch = train_batch(torch, rng, LABELS, batch_size)
    init = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}
    optimizer = build_optimizer("sgd", lr=3e-4, momentum=0.9, max_norm=100.0)
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, optimizer, StepConfig())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    norm = (mesh_order_norm(torch, model, model_norm) if model_norm > 1
            else None)
    steps, times = [], []
    for _ in range(MULTI_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with cudnn_deterministic(torch, deterministic), train_step_norm(norm):
            start.record()
            m = step(state, batch, generator=gen)
            end.record()
            end.synchronize()
        times.append(start.elapsed_time(end))
        steps.append(dict(loss=m["loss"].item(),
                          grad_norm=m["grad_norm"].item(),
                          params={k: p.detach().to("cpu", copy=True)
                                  for k, p in model.named_parameters()}))
    torch.save(dict(spec=spec, init=init,
                    batch={k: v.cpu() for k, v in batch.items()},
                    steps=steps, deterministic=deterministic), path)
    return dict(steps[0], ms=float(np.median(times[1:])))


def reference_model(torch, ref: dict):
    """The model of a ``multi_gpu_reference`` file with its init loaded, on
    the current card."""
    from deepspeech_tpu_torch.models import build_model

    model, _ = build_model(num_classes=CLASSES, hidden_layers=LAYERS,
                           device="cuda", **ref["spec"])
    model.load_state_dict(ref["init"])
    return model


def replica_digests(torch, tensors) -> dict:
    """{name: SHA-256 of the tensor's bytes}: a replicated leaf's bits, to
    hold the ranks of a model group bit-equal."""
    import hashlib

    return {n: hashlib.sha256(t.detach().contiguous().cpu().view(
        torch.uint8).numpy().tobytes()).hexdigest() for n, t in tensors}


HELD = ("stft_mag", "gru_layer", "gru_bwd", "ctc_alpha", "ctc_beta")


def rank_steps(torch, mesh, path: str, held: tuple = (), extra: int = 0,
               tols: dict | None = None) -> dict:
    """On this rank: the reference's model, sharded onto ``mesh`` by the
    JAX rule, stepped on its data shard's rows with the generator seeded
    as the reference's, each of the reference's steps held to it, then
    ``extra`` steps more; the launches and collectives of the first step,
    every step's time (CUDA events), each sharded tensor and momentum
    checked to be this rank's 1/model of the whole, the digests of the
    replicated parameters' gradients as the backward makes them in the
    first step (before the model group's broadcast) and of every
    replicated parameter and buffer after the steps
    (``replica_digests``). ``held``: the wrappers whose first-step
    launches are recorded and each held to its plain version on this
    rank's own inputs (``hold_recorded``), with their directions and rows
    (``held_shapes``). ``tols``: {"loss", "norm", "change"}: (the first
    step's, the later steps') bounds of the loss and the grad norm
    relative and of each parameter's error over its change; by default
    phase 12's, the later steps' looser (the reference itself drifts
    between runs under cuDNN's default algorithms). With the reference's
    ``deterministic`` set, the steps run under cuDNN's deterministic
    algorithms as it did."""
    ref = torch.load(path, mmap=True)
    tols = tols or dict(loss=(STEP_LOSS_TOL, MULTI_DRIFT_TOL),
                        norm=(STEP_LOSS_TOL, MULTI_DRIFT_TOL),
                        change=(STEP_GRAD_TOL, STEP_GRAD_TOL))
    with cudnn_deterministic(torch, ref["deterministic"]):
        return _rank_steps(torch, mesh, ref, held, extra, tols)


def _rank_steps(torch, mesh, ref, held, extra, tols) -> dict:
    from deepspeech_tpu_torch.parallel import (shard_dims, shard_slice,
                                               shard_state)
    from deepspeech_tpu_torch.train.optim import build_optimizer
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_train_step)

    model = reference_model(torch, ref)
    optimizer = build_optimizer("sgd", lr=3e-4, momentum=0.9, max_norm=100.0)
    state = shard_state(TrainState.create(model, optimizer), mesh)
    dims = shard_dims(model)
    step = make_train_step(model, optimizer, StepConfig(), mesh)
    batch = mesh.data_rows({k: v.cuda() for k, v in ref["batch"].items()})
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = dict(loss_rel=[], norm_rel=[], param_worst=[], ms=[])
    replicated = [(n, p) for n, p in model.named_parameters()
                  if n not in dims]
    raw: dict = {}
    hooks = [p.register_hook(lambda g, n=n: raw.update(
        replica_digests(torch, [(n, g)]))) for n, p in replicated]
    for k, want in enumerate(ref["steps"] + [None] * extra):
        first = k == 0
        with (recorded(held) if first and held
              else contextlib.nullcontext({})) as calls:
            if first:
                reset_counts()
                mesh.counts.clear()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = step(state, batch, generator=gen)
            end.record()
            end.synchronize()
        if first:
            for h in hooks:
                h.remove()
            out["raw_replicas"] = raw
            out["launches"] = read_counts()
            out["collectives"] = dict(mesh.counts)
            shapes = held_shapes(calls)
            out["held"] = {k: dict(shapes[k], launches=n, max_abs_err=e)
                           for k, (n, e) in hold_recorded(torch,
                                                          calls).items()}
            del calls
        out["ms"].append(start.elapsed_time(end))
        if want is None:
            continue
        out["loss_rel"].append(abs(m["loss"].item() - want["loss"])
                               / abs(want["loss"]))
        out["norm_rel"].append(abs(m["grad_norm"].item() - want["grad_norm"])
                               / want["grad_norm"])
        worst = 0.0
        for name, p in model.named_parameters():
            full, init = want["params"][name], ref["init"][name]
            if name in dims:
                full = shard_slice(full, dims[name], mesh)
                init = shard_slice(init, dims[name], mesh)
            moved = (full - init).abs().max().item()
            err = (p.detach().cpu() - full).abs().max().item()
            worst = max(worst, err / max(moved, 1e-30))
        out["param_worst"].append(worst)
        at = 0 if first else 1
        if bool(m["step_skipped"]) or not (
                out["loss_rel"][-1] <= tols["loss"][at]
                and out["norm_rel"][-1] <= tols["norm"][at]
                and worst <= tols["change"][at]):
            raise AssertionError(
                f"rank {mesh.rank} step {k + 1} against the single-process "
                f"step: loss rel {out['loss_rel'][-1]}, grad norm rel "
                f"{out['norm_rel'][-1]}, parameters {worst} of their change, "
                f"skipped {bool(m['step_skipped'])} (bounds {tols})")
    # each sharded tensor and its momentum: this rank's 1/model of the whole
    params = [n for n, _ in model.named_parameters()]
    for name, dim in dims.items():
        whole = ref["init"][name].shape
        trace = state.opt_state["trace"][params.index(name)]
        for what, t in (("parameter", dict(model.named_parameters())[name]),
                        ("momentum", trace)):
            shape = list(whole)
            shape[dim] //= mesh.model
            if list(t.shape) != shape or whole[dim] % mesh.model:
                raise AssertionError(f"rank {mesh.rank}: {what} of {name} "
                                     f"{tuple(t.shape)}, whole {whole}")
    out["sharded"] = {n: [d, list(ref["init"][n].shape)]
                      for n, d in dims.items()}
    out["replicas"] = replica_digests(
        torch, replicated + list(model.named_buffers()))
    out["replicated_grad_bytes"] = sum(4 * p.numel() for _, p in replicated)
    return out


def rank_main(argv) -> int:
    """A rank process of phase_multi_gpu or phase_mesh_model: ``--rank
    <job> <rank> <world> <backend> <dir>``. Job ``gloo``: data 2 on the
    default model, then model 2 on config 4; ``nccl``: data 2 alone, a
    card a rank; ``mesh4`` (4 ranks): model 4 on the default model;
    ``mesh2``: model 2 on the unidirectional LSTM-800, model 2 on
    ``cnn``, then data 2 at --steps-per-dispatch MESH_SPD_K against k 1
    (``spd_mesh_ranks``). Its results go to ``<dir>/<job>_<rank>.json``."""
    import datetime

    import torch

    from deepspeech_tpu_torch.parallel import make_mesh

    job, rank, world, backend, d = (argv[0], int(argv[1]), int(argv[2]),
                                    argv[3], argv[4])
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        backend, init_method="file://" + os.path.join(d, f"rdv_{job}"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=300))
    try:
        out = {"device": torch.cuda.get_device_name(dev)}
        if job == "mesh4":
            out["m4"] = rank_steps(
                torch, make_mesh(data=1, model=4, device=dev),
                os.path.join(d, "m4.pt"), MESH_HELD["m4"], tols=MESH_TOLS)
        elif job == "mesh2":
            for key in ("lstm", "cnn"):
                out[key] = rank_steps(
                    torch, make_mesh(data=1, model=2, device=dev),
                    os.path.join(d, f"{key}.pt"), MESH_HELD[key],
                    tols=MESH_TOLS)
            out["spd"] = spd_mesh_ranks(
                torch, make_mesh(data=2, device=dev),
                os.path.join(d, "m4.pt"), MESH_SPD_K)
        else:
            out["dp"] = rank_steps(torch, make_mesh(data=2, device=dev),
                                   os.path.join(d, "dp.pt"),
                                   HELD if job == "gloo" else ())
        if job == "gloo":
            out["tp"] = rank_steps(
                torch, make_mesh(data=1, model=2, device=dev),
                os.path.join(d, "tp.pt"), HELD)
        with open(os.path.join(d, f"{job}_{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def run_ranks(job: str, backend: str, d: str, timeout: int = 600,
              world: int = 2) -> list:
    """``world`` rank processes of this script on ``job``; every one
    stopped before this returns or raises -> their results."""
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", job, str(r),
         str(world), backend, d], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{job} rank {r} exited {p.returncode}:\n"
                                 + text[-6000:])
    results = []
    for r in range(world):
        with open(os.path.join(d, f"{job}_{r}.json")) as f:
            results.append(json.load(f))
    return results


def nccl_world_one(torch, d: str) -> dict:
    """The data-parallel step at world size 1 over NCCL (every collective of
    the path issued on the card) on phase 12's model and batch: its steps
    held to the single-process steps, the median of steps 2 to
    MULTI_TIMED + 1 (CUDA events); first the loader's padding exchange,
    on the host over the mesh's gloo group."""
    import datetime

    from deepspeech_tpu_torch.parallel import (equalize_batch_padding,
                                               make_mesh)

    torch.distributed.init_process_group(
        "nccl", init_method="file://" + os.path.join(d, "rdv_nccl1"),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(device="cuda:0")
        # the loader's padding exchange: on the host over gloo, beside NCCL
        host = {"audio": np.zeros((2, 5), np.int16), "valid": np.ones(2)}
        padded, n_valid = equalize_batch_padding(host, mesh)
        if (padded["audio"].shape != (2, 5) or n_valid != 2
                or mesh.counts["pad"] != 1):
            raise AssertionError(f"padding exchange over "
                                 f"{mesh.groups['host']}: {n_valid} rows")
        out = rank_steps(torch, mesh, os.path.join(d, "dp.pt"),
                         extra=MULTI_TIMED + 1 - MULTI_STEPS)
        out["spd"] = spd_mesh_ranks(torch, mesh, os.path.join(d, "dp.pt"),
                                    SPD_K)
    finally:
        torch.distributed.destroy_process_group()
    return dict(out, ms=float(np.median(out["ms"][1:])))


def spd_mesh_run(torch, mesh, ref: dict, host: list, k: int | None
                 ) -> dict:
    """The reference's model sharded onto ``mesh`` through ``host``'s
    batches (this rank's data rows), under cuDNN's deterministic
    algorithms, the generator seeded with SEED: ``k`` None a
    ``train_step`` a batch, else groups of up to ``k`` batches of one
    shape through ``make_multi_train_step(..., mesh)`` -> its launches,
    collectives, metrics, state, momentum, generator state, whether the
    lanes were captured and the graph cache's counts."""
    from deepspeech_tpu_torch.parallel import shard_state
    from deepspeech_tpu_torch.train.optim import build_optimizer
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_multi_train_step,
                                                 make_train_step)

    model = reference_model(torch, ref)
    opt = build_optimizer("sgd", lr=3e-4, momentum=0.9, max_norm=100.0)
    state = shard_state(TrainState.create(model, opt), mesh)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = [mesh.data_rows(b) for b in host]
    with cudnn_deterministic(torch):
        reset_counts()
        mesh.counts.clear()
        if k is None:
            step = make_train_step(model, opt, StepConfig(), mesh)
            ms = [step(state, {n: torch.from_numpy(v).cuda()
                               for n, v in b.items()}, generator=gen)
                  for b in rows]
            m = {n: torch.stack([x[n] for x in ms]) for n in
                 ("loss", "grad_norm", "step_skipped")}
            multi = None
        else:
            multi = make_multi_train_step(model, opt, StepConfig(), mesh)
            parts = [multi(state, stacked, gen, live)
                     for stacked, live in spd_groups(torch, rows, k)]
            m = {n: torch.cat([x[n] for x in parts]) for n in
                 ("loss", "grad_norm", "step_skipped")}
        torch.cuda.synchronize()
    graphs = getattr(multi, "graphs", None)
    return dict(launches=read_counts(), collectives=dict(mesh.counts),
                metrics=m, state={n: v.clone() for n, v in
                                  model.state_dict().items()},
                opt=[t.clone() for t in state.opt_state["trace"]],
                gen=gen.get_state(), captured=getattr(multi, "captured",
                                                      None),
                graphs=None if graphs is None else graphs.stats())


def spd_mesh_ranks(torch, mesh, path: str, k: int) -> dict:
    """--steps-per-dispatch ``k`` on this rank of ``mesh``: the reference's
    model through ``k`` batches of its shape (at k 2 then one of a shorter
    bucket: a full group, and a short one after the bucket switch) by
    ``spd_mesh_run`` with ``k`` and with one ``train_step`` a batch: the
    metrics, state, momentum and generator held bit-equal, the launches
    and the mesh's collectives equal (a replay counts what it runs) ->
    the readings."""
    ref = torch.load(path, mmap=True)
    rng = np.random.default_rng(SEED + 70)
    batch = ref["batch"]["audio"].shape[0]
    host = (spd_batches(torch, rng, k if k > 2 else 2, AUDIO_S, batch)
            + ([] if k > 2 else spd_batches(torch, rng, 1,
                                            SPD_SHORT_AUDIO, batch)))
    eager = spd_mesh_run(torch, mesh, ref, host, None)
    multi = spd_mesh_run(torch, mesh, ref, host, k)
    unequal = ([n for n in eager["metrics"] if not torch.equal(
        multi["metrics"][n], eager["metrics"][n])]
        + [n for n, v in eager["state"].items()
           if not torch.equal(multi["state"][n], v)]
        + [f"trace {i}" for i, (a, b) in enumerate(zip(multi["opt"],
                                                      eager["opt"]))
           if not torch.equal(a, b)]
        + ([] if torch.equal(multi["gen"], eager["gen"]) else ["generator"]))
    if (unequal or multi["launches"] != eager["launches"]
            or multi["collectives"] != eager["collectives"]
            or eager["metrics"]["step_skipped"].any()):
        raise AssertionError(
            f"rank {mesh.rank}, --steps-per-dispatch {k} on data "
            f"{mesh.data} x model {mesh.model} against a train_step a "
            f"batch: {unequal} differ; launches {multi['launches']} / "
            f"{eager['launches']}; collectives {multi['collectives']} / "
            f"{eager['collectives']}")
    return dict(batches=len(host), captured=multi["captured"],
                graphs=multi["graphs"], launches=multi["launches"],
                collectives=multi["collectives"])


def phase_multi_gpu(torch, step12: dict) -> dict:
    """Multi-GPU training (``parallel/``) on this machine's card(s): two
    rank processes of this script on cuda:0 over gloo (its all_reduce and
    broadcast take CUDA tensors, through the host; NCCL refuses two ranks
    on one device): data 2 on the default model (phase 12's batch of 20,
    10 rows a rank) and model 2 on config 4 (6 x BiGRU-1600, batch 64,
    each rank one direction of every layer), each rank's every step held
    to the single-process step (``multi_gpu_reference``) and its launches
    counted, the model-2 ranks' K2 and K5 D=1 launches each held to its
    plain version; then the data-parallel step at world size 1 over NCCL
    against phase 12's step time; where the machine has two cards, data 2
    over NCCL a card a rank. -> the phase's figures."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    out: dict = {}
    dp_seed, tp_seed = SEED + 6, SEED + 26  # phase 12's and phase 20's
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ref_dp = multi_gpu_reference(torch, gru_spec(HIDDEN), BATCH,
                                     dp_seed, os.path.join(d, "dp.pt"))
        ref_tp = multi_gpu_reference(torch, gru_spec(WIDE),
                                     WIDE_BATCH["gru"], tp_seed,
                                     os.path.join(d, "tp.pt"))
        gc.collect()
        torch.cuda.empty_cache()
        log(f"multi-GPU references (single process, {MULTI_STEPS} steps "
            f"each): default model loss {ref_dp['loss']:.4f}, config 4 "
            f"loss {ref_tp['loss']:.4f} "
            f"({time.perf_counter() - t0:.1f} s)")
        log("multi-GPU: one card, and NCCL refuses two ranks on one "
            "device, so the two ranks run over gloo on CUDA tensors of "
            "cuda:0 (gloo stages each all-reduce through the host)")
        b, h = WIDE_BATCH["gru"], WIDE
        out["variants"] = {
            "data 2, K2 D=2": fused_variant(torch, "gru", BATCH // 2,
                                            HIDDEN),
            "data 2, K5 D=2": bwd_variant_name(torch, BATCH // 2, HIDDEN, 2),
            "model 2, K2 D=1": fused_variant(torch, "gru", b, h, ndir=1),
            "model 2, K5 D=1": bwd_variant_name(torch, b, h, 1)}
        log(f"bf16 recurrence variants the rules pick on each rank: "
            f"{out['variants']} (data 2: B {BATCH // 2}, H {HIDDEN}; "
            f"model 2: B {b}, H {h})")
        t0 = time.perf_counter()
        ranks = run_ranks("gloo", "gloo", d)
        log(f"two gloo ranks ran in {time.perf_counter() - t0:.1f} s")
        want = {"dp": expect_counts(stft_mag=1, ctc_alpha=1, ctc_beta=1,
                                    gru_fwd=LAYERS, gru_fwd_res=LAYERS,
                                    gru_bwd=LAYERS, **conv_launches(steps=1))}
        want["tp"] = want["dp"]
        for key, label in (("dp", f"data 2: 6 x BiGRU-{HIDDEN}, batch "
                                  f"{BATCH}"),
                           ("tp", f"model 2: 6 x BiGRU-{WIDE}, batch "
                                  f"{WIDE_BATCH['gru']}")):
            for r, res in enumerate(ranks):
                got = res[key]
                if got["launches"] != want[key]:
                    raise AssertionError(f"{label} rank {r}: launches "
                                         f"{got['launches']}, expected "
                                         f"{want[key]}")
                log(f"{label}, rank {r}: launches a step {got['launches']}; "
                    f"collectives a step {got['collectives']}; against the "
                    f"single-process step: loss rel "
                    + ", ".join(f"{x:.2e}" for x in got["loss_rel"])
                    + ", grad norm rel "
                    + ", ".join(f"{x:.2e}" for x in got["norm_rel"])
                    + ", worst parameter "
                    + ", ".join(f"{x:.2e}" for x in got["param_worst"])
                    + f" of its change (tolerances {STEP_LOSS_TOL}, after the "
                    f"first step {MULTI_DRIFT_TOL}, and "
                    f"{STEP_GRAD_TOL}; phase 12's kernels against their "
                    f"plain versions: loss rel {step12['rel_loss']:.2e}, "
                    f"grad norm rel {step12['rel_norm']:.2e}, worst grad "
                    f"{step12['grad_worst']:.2e} x scale)")
                # every launch of the rank's first step against its plain
                # version on the rank's own inputs: data 2 at the shard's
                # B 10 with D=2, model 2 at B 64 with D=1
                held, ndir = got["held"], 2 if key == "dp" else 1
                rows = [BATCH // 2] if key == "dp" else [WIDE_BATCH["gru"]]
                check_held(f"{label} rank {r}", got, HELD, ndir, rows[0])
                log(f"{label}, rank {r}: K1, K2 (D={ndir}, with "
                    f"residuals), K5 (D={ndir}), K8 and K9 launches of its "
                    f"first step at B {rows[0]}, each held to the plain "
                    f"version on its inputs: {held}"
                    + (f"; {len(got['sharded'])} tensors and their momenta "
                       "held as 1/2 of the whole (the RNN's one direction, "
                       "the head's 15 classes)" if key == "tp" else ""))
            ms = [float(np.median(res[key]["ms"][1:])) for res in ranks]
            out[key] = dict(
                ms=ms, launches=ranks[0][key]["launches"],
                collectives=ranks[0][key]["collectives"],
                loss_rel=max(x for res in ranks
                             for x in res[key]["loss_rel"]),
                norm_rel=max(x for res in ranks
                             for x in res[key]["norm_rel"]),
                param_worst=max(x for res in ranks
                                for x in res[key]["param_worst"]))
            log(f"{label}: step "
                + ", ".join(f"rank {r} {m:.1f} ms" for r, m in enumerate(ms))
                + " (median of steps 2-3, CUDA events; two ranks share one "
                "card (gloo through the host): not a scaling figure)")
            out[key]["held"] = {n: max(res[key]["held"][n]["max_abs_err"]
                                       for res in ranks) for n in HELD}
            if key == "tp":
                out[key]["replicas"] = hold_replicas(label, ranks, key)
        t0 = time.perf_counter()
        one = nccl_world_one(torch, d)
        if one["launches"] != want["dp"]:
            raise AssertionError(f"NCCL world-1 step: launches "
                                 f"{one['launches']}, expected {want['dp']}")
        spd = one["spd"]
        if not spd["captured"] or spd["graphs"] != dict(
                spd["graphs"], graphs=1, eager_steps=1, replays=SPD_K - 1):
            raise AssertionError(f"--steps-per-dispatch {SPD_K} at world "
                                 f"size 1 over NCCL: {spd}")
        log(f"--steps-per-dispatch {SPD_K} at world size 1 over NCCL: one "
            f"group of {SPD_K} batches of phase 12's shape, {SPD_K - 1} "
            f"replays of a graph whose collectives are NCCL nodes "
            f"(capture {spd['graphs']['capture_s'][0]:.3f} s); metrics, "
            f"state, momentum and generator bit-equal to a train_step a "
            f"batch under cuDNN deterministic; the mesh's collectives over "
            f"the {SPD_K} steps {spd['collectives']}, as the eager steps "
            f"count them (a replay adds its graph's)")
        out["nccl_world_1"] = dict(ms=one["ms"], single_ms=step12["ms"],
                                   reference_ms=ref_dp["ms"],
                                   collectives=one["collectives"],
                                   loss_rel=max(one["loss_rel"]),
                                   norm_rel=max(one["norm_rel"]),
                                   steps_per_dispatch=dict(
                                       k=SPD_K, collectives=spd[
                                           "collectives"],
                                       capture_s=spd["graphs"][
                                           "capture_s"]))
        log(f"data-parallel step at world size 1 over NCCL (every "
            f"collective on the card): {one['ms']:.3f} ms (median of steps "
            f"2-{MULTI_TIMED + 1}, CUDA events) against phase 12's "
            f"single-process step {step12['ms']:.3f} ms "
            f"({one['ms'] / step12['ms'] - 1:+.2%}) and this phase's "
            f"single-process reference {ref_dp['ms']:.3f} ms (steps 2-"
            f"{MULTI_STEPS}; {one['ms'] / ref_dp['ms'] - 1:+.2%}); "
            f"collectives a step "
            f"{one['collectives']}; launches {one['launches']}; against the "
            f"single-process steps: loss rel "
            + ", ".join(f"{x:.2e}" for x in one["loss_rel"])
            + ", grad norm rel "
            + ", ".join(f"{x:.2e}" for x in one["norm_rel"])
            + f" ({time.perf_counter() - t0:.1f} s)")
        if torch.cuda.device_count() >= 2:
            two = run_ranks("nccl", "nccl", d)
            ms = max(float(np.median(res["dp"]["ms"][1:])) for res in two)
            out["nccl_data_2"] = dict(ms=ms, devices=[r["device"]
                                                      for r in two])
            log(f"data 2 over NCCL on two cards ({BATCH} rows, "
                f"{BATCH // 2} a card): {ms:.3f} ms a step against "
                f"{step12['ms']:.3f} ms on one card: strong-scaling "
                f"efficiency {step12['ms'] / (2 * ms):.2%}")
        else:
            log("one card: data 2 over NCCL not run, scaling across cards "
                "not measured")
    return out


def hold_replicas(label: str, ranks: list, key: str) -> dict:
    """The ranks of one model group after their steps (``rank_steps``):
    every replicated parameter and buffer bit-equal across them (their
    digests), and the replicated parameters whose first-step gradients,
    as each rank's backward made them, differed before the model group
    broadcast them (the fault the broadcast repairs) -> the readings."""
    reps = [r[key]["replicas"] for r in ranks]
    differ = sorted(n for n in reps[0] if len({x[n] for x in reps}) > 1)
    raws = [r[key]["raw_replicas"] for r in ranks]
    raw = sorted(n for n in raws[0] if len({x[n] for x in raws}) > 1)
    if differ:
        raise AssertionError(f"{label}: replicated leaves differ across the "
                             f"model group after the steps: {differ}")
    nbytes = ranks[0][key]["replicated_grad_bytes"]
    log(f"{label}: all {len(reps[0])} replicated parameters and buffers "
        f"bit-equal across the {len(ranks)} ranks after the steps; the "
        f"first step's gradients as each rank's backward made them "
        f"differed in {len(raw)} of {len(raws[0])} replicated parameters "
        f"({', '.join(raw) or 'none'}) before the model group's broadcast "
        f"(one broadcast of {nbytes / 1e6:.3f} MB a step)")
    return dict(leaves=len(reps[0]), raw_grads_differ=raw,
                broadcast_bytes=nbytes)


# phase_mesh_model: the gloo ranks' --steps-per-dispatch (eager lanes)
MESH_SPD_K = 2
# the wrappers each case's ranks hold to plain on their first step
MESH_HELD = {"m4": HELD,
             "lstm": ("stft_mag", "lstm_layer", "lstm_bwd", "ctc_alpha",
                      "ctc_beta"),
             "cnn": ("stft_mag", "ctc_alpha", "ctc_beta")}
# the ranks' steps against the single-process step, both under cuDNN's
# deterministic algorithms: each rank at data 1 runs the same kernels on
# the same whole tensors and rows as the one process, the model group's
# broadcast hands every rank its first rank's gradients of the replicated
# parameters, and the one process sums its grad norm's squares in the
# ranks' order (``mesh_order_norm``), so the clip scales both alike. With
# the norm summed in its own order the last bit of the norm moved the
# update where the norm clips: a parameter near 1 (a BatchNorm scale)
# could round to the next f32, an ulp that is ~1e-3 of its one-step
# change, and the next steps' bf16 roundings carried it on. Readings so,
# on an NVIDIA H100 80GB HBM3 at 700 W: model 4 (clipping from step 1)
# loss 0, 0, 1.8e-6 and grad norm 6.3e-8, 6.3e-6, 6.3e-5 relative,
# parameters 8.0e-4, 3.3e-3, 5.0e-3 of their change at steps 1-3, and
# loss 0, 1.3e-5, 7.8e-6 with the conv front's tensor-core kernels; the
# LSTM (clipping at step 3) equal for two steps, then 8.2e-8 and 2.5e-4;
# `cnn` (no clip) equal at every step. In the ranks' order every rank of
# the three reads 0 at every step: loss, grad norm and parameters.
# Bounds about 5 times the readings in the one process's order, (first
# step, after):
MESH_TOLS = dict(loss=(1e-6, 1e-5), norm=(1e-6, 5e-4), change=(4e-3, 2e-2))


def phase_mesh_model(torch) -> dict:
    """The JAX rule's other shardings on the card (``parallel/``), ranks of
    this script time-sliced on cuda:0 over gloo (``run_ranks``): four
    ranks at data 1 x model 4 on the default model (bf16, phase 12's batch
    of 20; every RNN tensor gate-sharded, 1/4 a rank, and gathered whole
    before its layer; the 30-class head replicated: K1, K2 with residuals
    at D=2, K5, K8, K9); two at model 2 on the unidirectional LSTM-800
    (bf16, gate-sharded, the head 15 classes a rank: K1, K3 with
    residuals and K7 at D=1, K8, K9) and on ``cnn`` (f32, dropout 0.1, the
    head 400 input channels a rank: K1, K8, K9). Each rank's first-step
    launches of those kernels held to their plain versions on its inputs
    (``MESH_HELD``, with their directions and rows); each rank's every
    step held to the single-process step (``multi_gpu_reference``), both
    under cuDNN's deterministic algorithms, at MESH_TOLS; its launches a
    step against phase 12's, its collectives (the gathers by tag), its
    tensors 1/model of the whole, the step times (time-sliced ranks under
    deterministic algorithms: not a scaling figure), and the replicated
    leaves bit-equal across each model group (``hold_replicas``); then the
    two ranks at data 2 on the default model at --steps-per-dispatch
    MESH_SPD_K against k 1 (gloo: the lanes run eagerly, logged) -> the
    phase's figures."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    cases = {
        "m4": (gru_spec(HIDDEN), SEED + 6, 4, "data 1 x model 4: "
               f"{LAYERS} x BiGRU-{HIDDEN} bf16, batch {BATCH}",
               expect_counts(stft_mag=1, ctc_alpha=1, ctc_beta=1,
                             gru_fwd=LAYERS, gru_fwd_res=LAYERS,
                             gru_bwd=LAYERS, **conv_launches(steps=1)),
               {"gather_rnn": 4 * LAYERS, "replicas": 1, "grad_norm": 1,
                "nan": 1}),
        "lstm": (dict(rnn_type="lstm", hidden_size=HIDDEN,
                      bidirectional=False, compute_dtype="bfloat16"),
                 SEED + 16, 2, f"data 1 x model 2: {LAYERS} x "
                 f"LSTM-{HIDDEN} (unidirectional) bf16, batch {BATCH}",
                 expect_counts(stft_mag=1, ctc_alpha=1, ctc_beta=1,
                               lstm_fwd=LAYERS, lstm_fwd_res=LAYERS,
                               lstm_bwd=LAYERS, **conv_launches(steps=1)),
                 {"gather_rnn": 4 * LAYERS, "gather_head": 1,
                  "replicas": 1, "grad_norm": 1, "nan": 1}),
        "cnn": (dict(rnn_type="cnn", hidden_size=HIDDEN, cnn_width=256,
                     dropout=0.1), SEED + 56, 2, f"data 1 x model 2: cnn "
                f"(width 256, epilog {HIDDEN}, dropout 0.1) f32, batch "
                f"{BATCH}", expect_counts(stft_mag=1, ctc_alpha=1,
                                           ctc_beta=1),
                {"gather_head": 1, "replicas": 1, "grad_norm": 1,
                 "nan": 1}),
    }
    out: dict = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        refs = {key: multi_gpu_reference(torch, spec, BATCH, seed,
                                         os.path.join(d, f"{key}.pt"),
                                         deterministic=True,
                                         model_norm=model)
                for key, (spec, seed, model, *_) in cases.items()}
        gc.collect()
        torch.cuda.empty_cache()
        log(f"mesh-model references (single process, {MULTI_STEPS} steps "
            f"each, cuDNN deterministic): "
            + ", ".join(f"{k} loss {r['loss']:.4f}, {r['ms']:.1f} ms a step"
                        for k, r in refs.items())
            + f" ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        ranks = {"m4": run_ranks("mesh4", "gloo", d, world=4)}
        ranks["lstm"] = ranks["cnn"] = ranks["spd"] = run_ranks(
            "mesh2", "gloo", d)
        log(f"mesh-model ranks ran in {time.perf_counter() - t0:.1f} s "
            "(4 then 2 processes on cuda:0 over gloo)")
        for key, (spec, _, model, label, want, coll) in cases.items():
            for r, res in enumerate(ranks[key]):
                got = res[key]
                gathered = {n: v for n, v in got["collectives"].items()
                            if n.startswith("gather")}
                if got["launches"] != want or got["collectives"] != coll:
                    raise AssertionError(
                        f"{label} rank {r}: launches {got['launches']}, "
                        f"expected {want}; collectives "
                        f"{got['collectives']}, expected {coll}")
                log(f"{label}, rank {r}: launches a step {got['launches']}"
                    f" (phase 12's kernels, counted); collectives a step "
                    f"{got['collectives']} (gathers {gathered}); "
                    f"{len(got['sharded'])} tensors held as 1/{model} of "
                    f"the whole, their momenta too; against the "
                    f"single-process step: loss rel "
                    + ", ".join(f"{x:.2e}" for x in got["loss_rel"])
                    + ", grad norm rel "
                    + ", ".join(f"{x:.2e}" for x in got["norm_rel"])
                    + ", worst parameter "
                    + ", ".join(f"{x:.2e}" for x in got["param_worst"])
                    + f" of its change, both under cuDNN deterministic "
                    f"(bounds, first step and after: {MESH_TOLS})")
                ndir = 2 if key == "m4" else 1
                check_held(f"{label} rank {r}", got, MESH_HELD[key], ndir,
                           BATCH)
                log(f"{label}, rank {r}: its first step's launches of "
                    f"{', '.join(MESH_HELD[key])} at B {BATCH}"
                    + (f" (the RNN's at D={ndir} on the gathered tensors)"
                       if key != "cnn" else "")
                    + f", each held to the plain version on its inputs: "
                    f"{got['held']}")
            ms = [float(np.median(res[key]["ms"][1:])) for res in ranks[key]]
            log(f"{label}: step " + ", ".join(
                f"rank {r} {m:.1f} ms" for r, m in enumerate(ms))
                + f" (median of steps 2-{MULTI_STEPS}, CUDA events; "
                f"{model} ranks time-slice one card over gloo: not a "
                f"scaling figure; the single-process step "
                f"{refs[key]['ms']:.1f} ms)")
            out[key] = dict(
                ms=ms, single_ms=refs[key]["ms"],
                launches=ranks[key][0][key]["launches"],
                collectives=ranks[key][0][key]["collectives"],
                sharded=len(ranks[key][0][key]["sharded"]),
                loss_rel=max(x for res in ranks[key]
                             for x in res[key]["loss_rel"]),
                norm_rel=max(x for res in ranks[key]
                             for x in res[key]["norm_rel"]),
                param_worst=max(x for res in ranks[key]
                                for x in res[key]["param_worst"]),

                replicas=hold_replicas(label, ranks[key], key),
                held={n: max(res[key]["held"][n]["max_abs_err"]
                             for res in ranks[key])
                      for n in MESH_HELD[key]})
        spd = [res["spd"] for res in ranks["spd"]]
        if any(x["captured"] is not False for x in spd):
            raise AssertionError(f"gloo ranks' lanes captured: {spd}")
        log(f"--steps-per-dispatch {MESH_SPD_K} on two gloo ranks (data 2, "
            f"{LAYERS} x BiGRU-{HIDDEN} bf16, batch {BATCH}, "
            f"{spd[0]['batches']} "
            "batches: a full group, then a short one after a bucket "
            "switch): the lanes run eagerly, as the rule says for gloo "
            "(it stages each collective through the host, which a CUDA "
            "graph cannot capture); metrics, state, momentum and generator "
            "bit-equal to a train_step a batch under cuDNN deterministic, "
            f"launches {spd[0]['launches']} and collectives "
            f"{spd[0]['collectives']} equal")
        out["spd_gloo"] = dict(k=MESH_SPD_K, batches=spd[0]["batches"],
                               captured=False,
                               collectives=spd[0]["collectives"])
    return out


# --steps-per-dispatch (phase_steps_per_dispatch): groups of SPD_K batches;
# the default model runs two full groups of the train shape, then a short
# group of SPD_SHORT batches of a shorter bucket (SPD_SHORT_AUDIO samples at
# most, the bucket switch); config 4 one full group. The timings: SPD_TIMED
# steps back to back each way, and SPD_PROFILED under the profiler
SPD_K, SPD_SHORT, SPD_SHORT_AUDIO = 4, 2, 100_000
SPD_TIMED, SPD_PROFILED = 8, 4
# the replayed run against the eager run of the same batches, both with
# cuDNN's deterministic algorithms (torch.backends.cudnn.deterministic):
# the replays run the same kernels on the same state, so the steps'
# metrics, every parameter, BatchNorm buffer and optimizer tensor, the
# step and the generator's state are held equal (torch.equal). Under
# cuDNN's default algorithms two eager runs of the same batches already
# drift apart (the convolution gradients' sums in another order each run,
# carried on by the bf16 roundings of the next steps): the phase shows that
# drift, two eager runs against each other.
# What ran in the SPD_PROFILED profiled steps, eager and replayed: the
# trace's kernels of each row below, by name, held to the wrappers'
# counters over those steps (a replay's are added from its capture's). One
# kernel a wrapper launch for the variants these models run (K2 and K4
# W-resident or persistent, K5 any: its bias reduction follows every walk)
TRACED = (("K1", r"stft_(fft|dft)_kernel", ("stft_mag",)),
          ("K2 + K4", r"mma_rnn::(resident|persistent)_kernel<",
           ("gru_fwd", "gru_scan")),
          ("K5", r"mma_bwd::bias_reduce<", ("gru_bwd",)),
          ("K8", r"\bctc_alpha(_global)?[<(]", ("ctc_alpha",)),
          ("K9", r"\bctc_beta(_global)?[<(]", ("ctc_beta",)))
# the graph cache over many shapes (spd_cache): the default model, one
# eager warm-up, a capture and a replay at each of SPD_CACHE_SECONDS
# audio buckets, targets of 15 labels a second (LibriSpeech's read speech)
SPD_CACHE_SECONDS = tuple(range(2, 18))


def spd_profile(torch, one) -> tuple[list, dict]:
    """SPD_PROFILED calls of ``one`` (a train step) under the profiler,
    after one call more and a marker (a sleeping kernel) in the same
    trace, so that what the start of a window loses is not counted (in
    the whole script a window of 4 steps held 3 K1 records in each of 3
    profiles, eager and replayed; the phase alone held 4). -> (the device
    ops after the marker, the
    launch counters' moves over those calls). Where the marker is missing,
    or a row of TRACED disagrees, the trace's names and categories of that
    row's kernels before and after the marker are logged."""
    box = {}

    def fn():
        one()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        box["before"] = read_counts()
        for _ in range(SPD_PROFILED):
            one()

    events = trace_events(torch, fn)
    counted = {k: n - box["before"][k] for k, n in read_counts().items()}
    ops = device_ops(events)
    marks = [start for start, _, name in ops if "spin_kernel" in name]
    after = [op for op in ops if marks and op[0] > marks[-1]]
    traced = traced_launches(after, counted)
    if not marks or any(t != c for t, c in traced.values()):
        for row, rx, _ in TRACED:
            seen = collections.Counter(
                (e.get("cat"), bool(marks) and float(e["ts"]) > marks[-1])
                for e in events if e.get("ph") == "X"
                and re.search(rx, e.get("name", "")))
            log(f"trace of {SPD_PROFILED} steps after a warm-up: {row} "
                f"(category, after the marker): {dict(seen)}; counted "
                f"{traced[row][1]}; marker {'found' if marks else 'missing'}")
    return after, counted


def traced_launches(ops: list, counted: dict) -> dict:
    """{row of TRACED: (kernels of the row in the trace ``ops``
    (``device_busy``), launches ``counted``)}."""
    return {label: (sum(1 for _, _, name in ops if re.search(rx, name)),
                    sum(counted[c] for c in names))
            for label, rx, names in TRACED}


def spd_batches(torch, rng, n: int, audio: int, batch: int) -> list:
    """``n`` host batches (numpy, paths dropped) of ``train_batch``."""
    return [{k: v.cpu().numpy() for k, v in
             train_batch(torch, rng, LABELS, batch, audio).items()}
            for _ in range(n)]


def spd_groups(torch, host: list, k: int = SPD_K) -> list:
    """The train CLI's grouping (``pull_group``): up to ``k`` batches of
    one shape a group -> [(stacked on the card, live)]."""
    from deepspeech_tpu_torch.data import stack_microbatches

    groups, cur = [], []
    for b in host + [None]:
        if cur and (b is None or len(cur) == k or any(
                b[n].shape != cur[0][n].shape for n in ("audio", "targets"))):
            stacked, live = stack_microbatches(cur, k)
            groups.append(({k: torch.from_numpy(v).cuda()
                            for k, v in stacked.items()}, live))
            cur = []
        if b is not None:
            cur.append(b)
    return groups


@contextlib.contextmanager
def cudnn_deterministic(torch, on: bool = True):
    """cuDNN's deterministic algorithms inside (or not, ``on`` False)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def spd_run(torch, init: dict, hidden: int, host: list, how: str,
            timed: bool = True) -> dict:
    """The bf16 6 x BiGRU-<hidden> from the weights ``init`` through
    ``host``'s batches, ``how`` "eager" (``train_step`` a batch) or "replay" (SPD_K
    groups through ``make_multi_train_step``: the first batch of a shape
    eager, then a capture and replays), the generator seeded with SEED:
    its launches, its steps' metrics, the state after them; with
    ``timed`` then SPD_TIMED steps of the first shape back to back (CUDA
    events a step; the host's issue time a step against the wall time)
    and SPD_PROFILED under the profiler (the device's idle share) -> the
    run's readings."""
    import gc

    from deepspeech_tpu_torch.models import build_model
    from deepspeech_tpu_torch.train.optim import build_optimizer
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_multi_train_step,
                                                 make_train_step)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    groups = spd_groups(torch, host)
    dev_batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
                   for b in host]
    model, _ = build_model("gru", CLASSES, hidden, LAYERS,
                           bidirectional=True, compute_dtype="bfloat16",
                           device="cuda")
    model.load_state_dict(init)
    opt = build_optimizer("sgd", lr=3e-4, momentum=0.9, max_norm=100.0)
    state = TrainState.create(model, opt)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step = make_train_step(model, opt, StepConfig())
    reset_counts()
    if how == "eager":
        ms = [step(state, b, generator=gen) for b in dev_batches]
        m = {k: torch.stack([x[k] for x in ms]) for k in
             ("loss", "grad_norm", "step_skipped")}
        graphs = None
    else:
        multi = make_multi_train_step(model, opt, StepConfig())
        parts = [multi(state, stacked, gen, live) for stacked, live in groups]
        m = {k: torch.cat([x[k] for x in parts]) for k in
             ("loss", "grad_norm", "step_skipped")}
        graphs = multi.graphs
    torch.cuda.synchronize()
    run = dict(launches=read_counts(), metrics=m, init=init,
               state={k: v.clone() for k, v in model.state_dict().items()},
               opt=[t.clone() for t in state.opt_state["trace"]],
               step=int(state.step), gen=gen.get_state(),
               peak_reserved=torch.cuda.max_memory_reserved(),
               graphs=None if graphs is None else graphs.stats(),
               groups=len(groups))
    if timed:
        # the state moves on: the comparison is done
        lane = {k: v[0] for k, v in groups[0][0].items()}
        one = (lambda: graphs(lane)) if graphs else (
            lambda: step(state, dev_batches[0], generator=gen))
        one()
        torch.cuda.synchronize()
        events, issue = [], 0.0
        t0 = time.perf_counter()
        for _ in range(SPD_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t1 = time.perf_counter()
            one()
            issue += time.perf_counter() - t1
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ops, counted = spd_profile(torch, one)
        span, busy = busy_of(ops)
        traced = traced_launches(ops, counted)
        run.update(traced=traced,
            ms=float(np.median([a.elapsed_time(b) for a, b in events])),
            host_ms=1e3 * wall / SPD_TIMED, issue_ms=1e3 * issue / SPD_TIMED,
            host_idle=1.0 - issue / wall,
            device_idle=(span - busy) / span if span else None,
            device_ops=len(ops) / SPD_PROFILED)
    del model, state, opt, graphs, step
    gc.collect()
    torch.cuda.empty_cache()
    return run


def spd_gaps(torch, a: dict, b: dict) -> dict:
    """Run ``b`` against run ``a`` (``spd_run``): each step's loss and grad
    norm relative, the largest distance of a state tensor in units of
    ``a``'s change from the init, and that tensor's name."""
    gaps = {key: ((b["metrics"][key] - a["metrics"][key]).abs()
                  / a["metrics"][key].abs()).tolist()
            for key in ("loss", "grad_norm")}
    worst = (0.0, "")
    for name, want in a["state"].items():
        if not want.is_floating_point():
            continue
        moved = (want - a["init"][name]).abs().max().item()
        err = (b["state"][name] - want).abs().max().item()
        worst = max(worst, (err / max(moved, 1e-30), name))
    gaps["state"], gaps["state_name"] = worst
    return gaps


def phase_steps_per_dispatch(torch) -> dict:
    """``--steps-per-dispatch`` SPD_K on the card (``train/graph.py``): the
    default model (6 x BiGRU-800, bf16, batch 20 x 7.5 s, SGD-Nesterov,
    clip 100) through two full groups of the train shape and a short group
    of SPD_SHORT batches of a shorter bucket (the switch: a second graph),
    against the same batches eagerly; then config 4 (6 x BiGRU-1600, B 64:
    K2 layer 0, the cooperative K4 in layers 1-5, the persistent K5) over
    one full group. Each: the launches of both runs (the replays
    counted), and with cuDNN's deterministic algorithms in both the steps
    and the states held; then under cuDNN's default algorithms, as the
    train CLI runs, the per-step CUDA-event median eager against replay,
    the host's issue time and idle share, the device's idle share, the
    capture seconds of each shape, the peak reserved memory, and the
    replays' drift from the eager steps (for the default model beside a
    second eager run's, the drift's cause). -> the figures for the JSON
    line."""
    rng = np.random.default_rng(SEED + 40)
    host = (spd_batches(torch, rng, 2 * SPD_K, AUDIO_S, BATCH)
            + spd_batches(torch, rng, SPD_SHORT, SPD_SHORT_AUDIO, BATCH))
    out = {}
    for key, seed, hidden, batches, want in (
            ("default", SEED + 41, HIDDEN, host,
             expect_counts(stft_mag=1, ctc_alpha=1, ctc_beta=1,
                           gru_fwd=LAYERS, gru_fwd_res=LAYERS,
                           gru_bwd=LAYERS, **conv_launches(steps=1))),
            ("config4", SEED + 42, WIDE,
             spd_batches(torch, rng, SPD_K, AUDIO_S, WIDE_BATCH["gru"]),
             expect_counts(stft_mag=1, ctc_alpha=1, ctc_beta=1, gru_fwd=1,
                           gru_fwd_res=1, gru_scan=LAYERS - 1,
                           gru_scan_res=LAYERS - 1, gru_bwd=LAYERS,
                           **conv_launches(steps=1)))):
        label = (f"{LAYERS} x BiGRU-{hidden} bf16, batch "
                 f"{batches[0]['audio'].shape[0]}")
        model, _ = default_model(torch, seed, "gru", hidden)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        del model
        with cudnn_deterministic(torch):
            e = spd_run(torch, init, hidden, batches, "eager", timed=False)
            p = spd_run(torch, init, hidden, batches, "replay", timed=False)
        n = len(batches)
        want = {k: v * n for k, v in want.items()}
        gaps = spd_gaps(torch, e, p)
        if (p["launches"] != want or e["launches"] != want
                or p["step"] != n or e["step"] != n):
            raise AssertionError(f"{label}: launches {p['launches']} "
                                 f"(eager {e['launches']}), expected {want}; "
                                 f"steps {p['step']}, {e['step']}")
        unequal = ([k for k in e["metrics"] if not torch.equal(
            p["metrics"][k], e["metrics"][k])]
            + [k for k, v in e["state"].items()
               if not torch.equal(p["state"][k], v)]
            + [f"trace {i}" for i, (a, b) in enumerate(zip(p["opt"],
                                                          e["opt"]))
               if not torch.equal(a, b)]
            + ([] if torch.equal(p["gen"], e["gen"]) else ["generator"]))
        if unequal or e["metrics"]["step_skipped"].any():
            raise AssertionError(f"{label}: replayed steps against eager, "
                                 f"cuDNN deterministic: {unequal} differ "
                                 f"({gaps}), skipped "
                                 f"{e['metrics']['step_skipped'].tolist()}")
        # the same under cuDNN's default algorithms, as the train CLI
        # runs: timed, and the replays' drift from the eager steps beside
        # a second eager run's (the drift's cause)
        ed = spd_run(torch, init, hidden, batches, "eager")
        pd = spd_run(torch, init, hidden, batches, "replay")
        drift = {"replay": spd_gaps(torch, ed, pd)}
        if key == "default":
            drift["eager"] = spd_gaps(torch, ed, spd_run(
                torch, init, hidden, batches, "eager", timed=False))
        if pd["launches"] != want or pd["graphs"] != dict(
                p["graphs"], capture_s=pd["graphs"]["capture_s"]):
            raise AssertionError(f"{label}, cuDNN's default algorithms: "
                                 f"launches {pd['launches']}, graphs "
                                 f"{pd['graphs']}")
        traced = {row: SPD_PROFILED * sum(want[c] // n for c in names)
                  for row, _, names in TRACED}
        for how, run in (("eager", ed), ("replayed", pd)):
            bad = {row: got for row, got in run["traced"].items()
                   if got != (traced[row], traced[row])}
            if bad:
                raise AssertionError(f"{label}: {SPD_PROFILED} {how} steps "
                                     f"under the profiler, kernels in the "
                                     f"trace against the counters: {bad}")
        g = pd["graphs"]
        log(f"steps-per-dispatch {SPD_K}, {label}: {n} batches in "
            f"{p['groups']} groups, {g['graphs']} graph(s) (capture "
            f"{', '.join(f'{c:.3f}' for c in g['capture_s'])} s a shape), "
            f"{g['eager_steps']} eager steps and {g['replays']} replays; "
            f"launches {p['launches']} (the eager run's the same); with "
            f"cuDNN deterministic, the replayed steps against the eager "
            f"ones: loss rel {max(gaps['loss']):.2e}, grad norm rel "
            f"{max(gaps['grad_norm']):.2e}, worst state "
            f"{gaps['state_name']} {gaps['state']:.2e} of its change, the "
            f"generator's state equal (held equal, torch.equal)")
        for how, d in drift.items():
            run = {"replay": "replayed", "eager": "second eager"}[how]
            log(f"steps-per-dispatch {SPD_K}, {label}, cuDNN's default "
                f"algorithms: the {run} run against the eager one, step by "
                f"step: grad norm rel "
                + ", ".join(f"{x:.1e}" for x in d["grad_norm"])
                + f"; loss rel up to {max(d['loss']):.2e}; worst state "
                f"{d['state_name']} {d['state']:.2e} of its change")
        e, p = ed, pd
        log(f"steps-per-dispatch {SPD_K}, {label}: a step {e['ms']:.3f} ms "
            f"eager, {p['ms']:.3f} ms replayed (CUDA-event medians of "
            f"{SPD_TIMED} back to back, cuDNN's default algorithms; "
            f"{p['ms'] / e['ms'] - 1:+.2%}); kernels in the trace of "
            f"{SPD_PROFILED} replayed steps (counted): "
            + ", ".join(f"{row} {t} ({c})" for row, (t, c)
                        in p["traced"].items())
            + f"; host {e['host_ms']:.3f} / "
            f"{p['host_ms']:.3f} ms a step, issuing {e['issue_ms']:.3f} / "
            f"{p['issue_ms']:.3f} ms of it (host idle {e['host_idle']:.2%} / "
            f"{p['host_idle']:.2%}); device idle {e['device_idle']:.2%} / "
            f"{p['device_idle']:.2%} of {SPD_PROFILED} profiled steps "
            f"({e['device_ops']:.0f} / {p['device_ops']:.0f} device ops a "
            f"step); peak reserved {e['peak_reserved'] / 2**30:.2f} GiB "
            f"eager, {p['peak_reserved'] / 2**30:.2f} GiB with the graph "
            f"cache full")
        out[key] = dict(
            launches=p["launches"], graphs=g, traced=p["traced"],
            eager_ms=e["ms"],
            replay_ms=p["ms"], eager_host_ms=e["host_ms"],
            replay_host_ms=p["host_ms"], eager_issue_ms=e["issue_ms"],
            replay_issue_ms=p["issue_ms"], eager_host_idle=e["host_idle"],
            replay_host_idle=p["host_idle"],
            eager_device_idle=e["device_idle"],
            replay_device_idle=p["device_idle"],
            eager_peak_reserved=e["peak_reserved"],
            replay_peak_reserved=p["peak_reserved"],
            loss_rel=max(gaps["loss"]), norm_rel=max(gaps["grad_norm"]),
            state_worst=gaps["state"],
            default_drift_norm_rel={k: d["grad_norm"]
                                    for k, d in drift.items()})
    return out


def spd_cache_batch(torch, rng, seconds: int, per_s: int = 15) -> dict:
    """A batch of BATCH rows whose audio bucket (1 s, the train CLI's) is
    ``seconds``: rows of up to half a second less, each with ``per_s``
    labels a second; on the card."""
    from deepspeech_tpu_torch.data import BucketSpec, collate_batch

    samples = []
    for i in range(BATCH):
        n = seconds * SR - 160 - int(rng.integers(0, SR // 2))
        ids = rng.integers(1, CLASSES, per_s * n // SR).astype(np.int32)
        samples.append({"audio": synthetic_audio(rng, n), "target": ids,
                        "path": f"synthetic{i}"})
    out = collate_batch(samples, BATCH, BucketSpec(
        reflect_tail=160, audio_step=SR, wire_dtype="int16"))
    out.pop("paths")
    return {k: torch.from_numpy(v).cuda() for k, v in out.items()}


def spd_cache(torch) -> dict:
    """The graph cache (``train.graph.StepGraphs``) of the default model
    over the shapes of SPD_CACHE_SECONDS, no eviction: at each, one eager
    warm-up, a capture and a replay; after the warm-up and after the
    replay the allocator's reserved bytes and the card's used bytes
    (``mem_get_info``: the graph execs too; a capture empties the
    allocator's cache first, so the second reading is the graphs' pool
    and the live tensors). Then the bound cut to SPD_K graphs and 2 x
    SPD_K new shapes (the first buckets at 30 labels a second) run three
    times: a warm-up each, a capture each (the cache shrinks to the
    bound), then every shape, evicted by the others, captured again at
    once. -> the figures."""
    import gc

    from deepspeech_tpu_torch.train.graph import StepGraphs
    from deepspeech_tpu_torch.train.optim import build_optimizer
    from deepspeech_tpu_torch.train.step import (StepConfig, TrainState,
                                                 make_train_step)

    rng = np.random.default_rng(SEED + 44)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, _ = default_model(torch, SEED + 41, "gru", HIDDEN)
    opt = build_optimizer("sgd", lr=3e-4, momentum=0.9, max_norm=100.0)
    state = TrainState.create(model, opt)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    graphs = StepGraphs(make_train_step(model, opt, StepConfig()), state,
                        gen)
    graphs.max_graphs = len(SPD_CACHE_SECONDS)

    def used():
        torch.cuda.synchronize()
        free, total = torch.cuda.mem_get_info()
        return torch.cuda.memory_reserved(), total - free

    rows = []
    for sec in SPD_CACHE_SECONDS:
        b = spd_cache_batch(torch, rng, sec)
        graphs(b)
        warm = used()
        graphs(b)
        rows.append((sec, tuple(b["targets"].shape), *warm, *used()))
    full = graphs.stats()
    peak = torch.cuda.max_memory_reserved()
    n, m = len(rows), 2 * SPD_K
    graphs.max_graphs = SPD_K
    again = [spd_cache_batch(torch, rng, sec, 30)
             for sec in SPD_CACHE_SECONDS[:m]]
    for b in again * 3:
        graphs(b)
    bounded = graphs.stats()
    after = used()
    # the growth a graph, from the first graph's reading to the last's
    grown = [(rows[-1][k] - rows[0][k]) / (n - 1) for k in (4, 5)]
    for sec, tshape, res_w, dev_w, res, dev in rows:
        log(f"graph cache, 6 x BiGRU-{HIDDEN} bf16 batch {BATCH}, a {sec} s "
            f"bucket (targets {tshape[1]}): after its eager warm-up "
            f"reserved {res_w / 2**30:.3f} GiB, card used "
            f"{dev_w / 2**30:.3f} GiB; after its capture and replay "
            f"{res / 2**30:.3f} and {dev / 2**30:.3f} GiB")
    log(f"graph cache over {n} shapes ({SPD_CACHE_SECONDS[0]}-"
        f"{SPD_CACHE_SECONDS[-1]} s): captures {sum(full['capture_s']):.3f} "
        f"s in all ({min(full['capture_s']):.3f}-"
        f"{max(full['capture_s']):.3f} s each), peak reserved "
        f"{peak / 2**30:.3f} GiB; after the first graph and the last, "
        f"reserved {rows[0][4] / 2**30:.3f} and {rows[-1][4] / 2**30:.3f} "
        f"GiB ({grown[0] / 2**20:.1f} MiB a graph), card used "
        f"{rows[0][5] / 2**30:.3f} and {rows[-1][5] / 2**30:.3f} GiB "
        f"({grown[1] / 2**20:.1f} MiB a graph); the bound cut to {SPD_K}, "
        f"{m} new shapes three times: {bounded['graphs']} graphs held, "
        f"{bounded['evictions']} evictions, "
        f"{len(bounded['capture_s']) - n} captures "
        f"({sum(bounded['capture_s'][n:]):.3f} s), reserved "
        f"{after[0] / 2**30:.3f} GiB, card used {after[1] / 2**30:.3f} GiB")
    if (full["graphs"] != n or full["evictions"]
            or (bounded["graphs"], bounded["evictions"],
                len(bounded["capture_s"]), bounded["eager_steps"],
                bounded["replays"])
            != (SPD_K, n - SPD_K + 2 * m, n + 2 * m, n + m, n + 2 * m)):
        raise AssertionError(f"graph cache: {full} then {bounded}")
    out = dict(shapes=n, capture_s=full["capture_s"], peak_reserved=peak,
               reserved_per_graph=grown[0], used_per_graph=grown[1],
               rows=rows, bounded=bounded, bounded_used=after)
    del graphs, model, state, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the train CLI at --steps-per-dispatch SPD_K against k 1 (phase_spd_cli):
# bins of two shapes in this order (set by the rows' places in the epoch's
# shuffle), SPD_CLI_CKPT samples between mid-epoch checkpoints (each with a
# checkpoint anneal): the groups are A4 A4 B4 A2, each checkpoint falls
# after the same step at k 1 and k SPD_K, and the last group replays A's
# graph after three anneals
SPD_CLI_BINS = "AAAAAAAABBBBAA"
SPD_CLI_CKPT = SPD_K * BATCH
# per class: (least, most) seconds of a row and (least, most) labels
SPD_CLI_CLASS = {"A": ((6.2, 6.8), (30, 50)), "B": ((7.1, 7.4), (60, 95))}


class _LossLog:
    """An observer of the train CLI: each step's (epoch, iteration, loss)."""

    def __init__(self):
        self.losses = []

    def on_batch_end(self, epoch, iteration, loss=None, **kw):
        self.losses.append((epoch, iteration, loss))

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **kw: None
        raise AttributeError(name)


def phase_spd_cli(torch) -> dict:
    """``python -m deepspeech_tpu_torch.cli.train --steps-per-dispatch
    SPD_K`` at full width (6 x BiGRU-800, bf16, batch 20, 6.2-7.4 s), in
    process, on a synthetic manifest of SPD_CLI_BINS bins with
    ``--device-noise`` (the noise bank a step reads in place),
    ``--aug-prob-spect`` and a ``--checkpoint-anneal`` every SPD_CLI_CKPT
    samples, against the same command at k 1, both under cuDNN's
    deterministic algorithms: each step's loss and the final checkpoint's
    parameters, BatchNorm stats and optimizer state held equal, the LR
    anneals alike, the launches of both runs equal and those of 14 train
    steps plus the validations; the k SPD_K run's graphs, eager steps,
    replays and captures from its ``step_graphs`` log event, and each
    run's peak reserved memory and seconds."""
    from deepspeech_tpu_torch.audio.io import save_wav
    from deepspeech_tpu_torch.cli.train import main as train_main
    from deepspeech_tpu_torch.train import checkpoint as ckpt
    from deepspeech_tpu_torch.train.optim import tree_leaves

    rng = np.random.default_rng(SEED + 43)
    labels_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "labels.json")
    n = len(SPD_CLI_BINS) * BATCH
    # the epoch's order: AudioDataset.set_curriculum_epoch(0) shuffles the
    # rows with np.random.default_rng(0); bin j takes places j*B..(j+1)*B
    order = list(range(n))
    np.random.default_rng(0).shuffle(order)
    cls = [""] * n
    for place, row in enumerate(order):
        cls[row] = SPD_CLI_BINS[place // BATCH]
    letters = list(LABELS[2:28])
    out: dict = {}
    with tempfile.TemporaryDirectory() as d:
        rows = []
        for i, c in enumerate(cls):
            (lo, hi), (llo, lhi) = SPD_CLI_CLASS[c]
            m = int(SR * rng.uniform(lo, hi))
            text = "".join(rng.choice(letters + [" "],
                                      int(rng.integers(llo, lhi + 1))))
            text = letters[0] + text[1:-1] + letters[1]
            wav, txt = (os.path.join(d, f"u{i}.wav"),
                        os.path.join(d, f"u{i}.txt"))
            save_wav(wav, synthetic_audio(rng, m), SR)
            with open(txt, "w") as f:
                f.write(text)
            rows.append(f"{wav},{txt},{m / SR}")
        train = os.path.join(d, "train.csv")
        with open(train, "w") as f:
            f.write("\n".join(rows) + "\n")
        val = os.path.join(d, "val.csv")
        with open(val, "w") as f:
            f.write("\n".join([r for r, c in zip(rows, cls)
                               if c == "A"][:6]) + "\n")
        os.makedirs(os.path.join(d, "noise"))
        for i in range(3):
            save_wav(os.path.join(d, "noise", f"n{i}.wav"),
                     (0.5 * rng.standard_normal(SR * (4 + 3 * i))).clip(
                         -1, 1).astype(np.float32), SR)
        base = ["--train-manifest", train, "--val-manifest", val,
                "--labels-path", labels_path, "--batch-size", str(BATCH),
                "--val-batch-size", str(BATCH), "--num-workers", "4",
                "--hidden-size", str(HIDDEN), "--hidden-layers", str(LAYERS),
                "--epochs", "1", "--noise-dir",
                os.path.join(d, "noise", "*.wav"), "--device-noise",
                "--noise-prob", "0.5", "--aug-prob-spect", "0.5",
                "--checkpoint-per-samples", str(SPD_CLI_CKPT),
                "--checkpoint-anneal", "1.5", "--id", "spd"]
        runs = {}
        for k in (1, SPD_K):
            save = os.path.join(d, f"k{k}")
            losses = _LossLog()
            buf = io.StringIO()
            reset_counts()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with cudnn_deterministic(torch), contextlib.redirect_stdout(buf):
                rc = train_main(base + ["--steps-per-dispatch", str(k),
                                        "--save-folder", save,
                                        "--log-dir", save],
                                observers=[losses])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"train CLI at k {k} exited {rc}: "
                                     f"{buf.getvalue()[-2000:]}")
            for line in buf.getvalue().splitlines():
                if "anneal" in line or "step graphs" in line:
                    log(f"  train CLI (k {k}): {line.strip()}")
            with open(os.path.join(save, "spd.jsonl")) as f:
                events = [json.loads(line) for line in f]
            runs[k] = dict(
                launches=read_counts(), losses=losses.losses, seconds=dt,
                peak_reserved=torch.cuda.max_memory_reserved(),
                package=ckpt.load(os.path.join(save,
                                               "deepspeech_final.ckpt")),
                lr_find=[e["lr"] for e in events if e["event"] == "lr_find"],
                graphs=[e for e in events if e["event"] == "step_graphs"])
    one, many = runs[1], runs[SPD_K]
    steps = len(SPD_CLI_BINS)
    vals = 4  # three checkpoints' validations and the epoch's, 1 batch each
    want = expect_counts(stft_mag=steps + vals, ctc_alpha=steps + vals,
                         ctc_beta=steps, gru_fwd=(steps + vals) * LAYERS,
                         gru_fwd_res=steps * LAYERS, gru_bwd=steps * LAYERS,
                         **conv_launches(vals, steps))
    label = (f"train CLI --steps-per-dispatch {SPD_K} against 1 (6 x "
             f"BiGRU-{HIDDEN} bf16, batch {BATCH}, {steps} steps in bins "
             f"{SPD_CLI_BINS}, device noise, spectrogram masks, a checkpoint "
             f"anneal every {SPD_CLI_CKPT} samples)")
    if one["launches"] != want or many["launches"] != want:
        raise AssertionError(f"{label}: launches {many['launches']} (k 1: "
                             f"{one['launches']}), expected {want}")
    if one["losses"] != many["losses"] or len(one["losses"]) != steps:
        raise AssertionError(f"{label}: losses {many['losses']} against "
                             f"{one['losses']}")
    if one["lr_find"] != many["lr_find"] or len(one["lr_find"]) != 3:
        raise AssertionError(f"{label}: the anneals' LRs {many['lr_find']} "
                             f"against {one['lr_find']}")
    unequal = []
    for key in ("params", "batch_stats", "optim_state"):
        a = tree_leaves(one["package"][key])
        b = tree_leaves(many["package"][key])
        if len(a) != len(b) or not all(
                np.array_equal(np.asarray(x), np.asarray(y))
                for x, y in zip(a, b)):
            unequal.append(key)
    if unequal or one["package"]["step"] != steps:
        raise AssertionError(f"{label}: the final checkpoints' {unequal} "
                             f"differ (step {many['package']['step']})")
    g = many["graphs"][-1] if many["graphs"] else None
    if (g is None or g["graphs"] != 2 or g["eager_steps"] != 2
            or g["replays"] != steps - 2 or g["evictions"]):
        raise AssertionError(f"{label}: step graphs {many['graphs']}")
    log(f"{label}: the {steps} losses, the final parameters, BatchNorm "
        f"stats and optimizer state equal (under cuDNN deterministic), "
        f"the anneals alike ({many['lr_find']}); launches {many['launches']} "
        f"in both runs; {g['graphs']} graphs, {g['eager_steps']} eager "
        f"steps, {g['replays']} replays, captures "
        + ", ".join(f"{c:.3f}" for c in g["capture_s"])
        + f" s; {one['seconds']:.1f} s / {many['seconds']:.1f} s a run "
        f"(k 1 / k {SPD_K}, the validations and checkpoints included), peak "
        f"reserved {one['peak_reserved'] / 2**30:.2f} / "
        f"{many['peak_reserved'] / 2**30:.2f} GiB")
    out.update(launches=many["launches"], graphs=g,
               seconds={1: one["seconds"], SPD_K: many["seconds"]},
               peak_reserved={1: one["peak_reserved"],
                              SPD_K: many["peak_reserved"]})
    return out


def test_rank_main(argv) -> int:
    """A rank process of phase_test_multi: ``--test-rank <dir> <ports>
    <test CLI arguments>`` under torchrun's variables, the test CLI once
    for each decoder of TEST_MULTI_DECODERS (its rendezvous on the port of
    ``ports``, comma-separated, in turn; its report to
    ``<dir>/two_<decoder>.csv``); the launch counts of each run go to
    ``<dir>/test_<rank>.json``."""
    import torch

    from deepspeech_tpu_torch.cli.test import main as test_main

    d, ports, args = argv[0], argv[1].split(","), argv[2:]
    counts = {}
    for decoder, port in zip(TEST_MULTI_DECODERS, ports):
        os.environ["MASTER_PORT"] = port
        reset_counts()
        rc = test_main(args + ["--decoder", decoder, "--report-file",
                               os.path.join(d, f"two_{decoder}.csv")])
        torch.cuda.synchronize()
        if rc != 0:
            return rc
        counts[decoder] = read_counts()
    with open(os.path.join(d, f"test_{os.environ['RANK']}.json"), "w") as f:
        json.dump(counts, f)
    return 0


TEST_MULTI_UTTS, TEST_MULTI_BATCH = 20, 10
TEST_MULTI_DECODERS = ("greedy", "device_beam")


def phase_test_multi(torch) -> dict:
    """The test CLI on two gloo ranks sharing cuda:0 (NCCL refuses two
    ranks on one device; ``--dist-backend gloo``), torchrun's variables
    set by hand, against one process: the default model in f32 as a
    checkpoint, TEST_MULTI_UTTS synthetic 6.8-7.5 s utterances, batch
    TEST_MULTI_BATCH (each rank half of every bin, padded alike), greedy
    and device_beam: rank 0's stdout (the --verbose prints and both
    summaries) and the report CSV equal to one process's byte for byte;
    each rank's launches (K1 and K8 a bin, K2 six, K10 once a frame of
    each bin with the device beam) -> the figures."""
    import socket

    from deepspeech_tpu_torch.audio.features import AudioConf
    from deepspeech_tpu_torch.audio.io import save_wav
    from deepspeech_tpu_torch.cli.test import main as test_main
    from deepspeech_tpu_torch.train import checkpoint as ckpt

    rng = np.random.default_rng(SEED + 43)
    model, meta = default_model(torch, SEED + 43)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ds2.ckpt")
        ckpt.save(path, ckpt.package_from_model(model, meta, LABELS,
                                                AudioConf().to_dict()))
        del model
        rows = []
        for i in range(TEST_MULTI_UTTS):
            n = AUDIO_S - AUDIO_S // 30 * (i % 5)
            wav, txt = (os.path.join(d, f"u{i}.wav"),
                        os.path.join(d, f"u{i}.txt"))
            save_wav(wav, synthetic_audio(rng, n), SR)
            with open(txt, "w") as f:
                f.write(" ".join("".join(rng.choice(list(LABELS[2:28]),
                                                    int(rng.integers(1, 7))))
                                 for _ in range(int(rng.integers(6, 14)))))
            rows.append(f"{wav},{txt},{n / SR}")
        manifest = os.path.join(d, "manifest.csv")
        with open(manifest, "w") as f:
            f.write("\n".join(rows) + "\n")
        argv = ["--model-path", path, "--test-manifest", manifest,
                "--batch-size", str(TEST_MULTI_BATCH), "--num-workers", "4",
                "--verbose"]
        one = {}
        for decoder in TEST_MULTI_DECODERS:
            reset_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = test_main(argv + ["--decoder", decoder, "--report-file",
                                       os.path.join(d, f"one_{decoder}.csv")])
            torch.cuda.synchronize()
            if rc != 0:
                raise AssertionError(f"test CLI exited {rc}")
            one[decoder] = (buf.getvalue(), read_counts(),
                            time.perf_counter() - t0)
        ports = []
        for _ in TEST_MULTI_DECODERS:
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                ports.append(str(sock.getsockname()[1]))
        procs = []
        t0 = time.perf_counter()
        try:
            for rank in range(2):
                env = dict(os.environ, RANK=str(rank), LOCAL_RANK="0",
                           WORLD_SIZE="2", MASTER_ADDR="127.0.0.1")
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--test-rank", d, ",".join(ports), *argv,
                     "--dist-backend", "gloo"], env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        two_s = time.perf_counter() - t0
        for rank, (p, (o, e)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"test CLI rank {rank} exited "
                                     f"{p.returncode}:\n{e[-6000:]}")
        ranks = []
        for rank in range(2):
            with open(os.path.join(d, f"test_{rank}.json")) as f:
                ranks.append(json.load(f))
        # rank 0 prints both runs' lines, rank 1 none
        same_out = (outs[0][0] == "".join(o for o, _, _ in one.values())
                    and outs[1][0] == "")
        bins = -(-TEST_MULTI_UTTS // TEST_MULTI_BATCH)
        log(f"test CLI on two gloo ranks sharing cuda:0 "
            f"({TEST_MULTI_UTTS} x ~7.5 s, batch {TEST_MULTI_BATCH}, "
            f"{' and '.join(TEST_MULTI_DECODERS)}): {two_s:.2f} s with the "
            f"ranks' start-up; rank 0's stdout equal to one process's: "
            f"{same_out}")
        for decoder, (text, counts, one_s) in one.items():
            with open(os.path.join(d, f"one_{decoder}.csv"), "rb") as f, \
                    open(os.path.join(d, f"two_{decoder}.csv"), "rb") as g:
                same_csv = f.read() == g.read()
            frames = counts["topk"]
            want = expect_counts(stft_mag=bins, ctc_alpha=bins,
                                 gru_fwd=bins * LAYERS, topk=frames)
            got = [r[decoder] for r in ranks]
            summary = text.strip().splitlines()[-2:]
            log(f"test CLI --decoder {decoder}: one process {one_s:.2f} s, "
                f"launches {counts}; each rank's launches {got}; report CSV "
                f"byte-equal: {same_csv}; {summary}")
            if (not (same_csv and same_out) or counts != want
                    or any(r != want for r in got)
                    or (decoder == "device_beam") != (frames > 0)):
                raise AssertionError(
                    f"test CLI on two ranks, {decoder}: csv {same_csv}, "
                    f"stdout {same_out}, launches {counts} / {got} "
                    f"(expected {want})")
            out[decoder] = dict(one_s=one_s, launches=got, summary=summary)
        out["two_ranks_s"] = two_s
    return out


def main() -> int:
    started = time.perf_counter()
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
    train_counts: dict = {}
    lstm_train_counts: dict = {}
    wide_counts: dict = {"gru": {}, "lstm": {}}
    beam_counts: dict = {}
    def mark(what):
        log(f"[{time.perf_counter() - t0:.1f} s] {what}")

    phase_stft(torch, results)
    phase_layer_fwd(torch, results, "gru")
    floor = step_floor(torch)
    phase_layer_bwd(torch, results, "gru")
    phase_ctc(torch, results)
    phase_ctc_long(torch, results)
    mark("K1, K2, K5, K8/K9 (both routes) held to their plain versions")
    phase_topk(torch, results)
    phase_conv(torch, results)
    model, meta = phase_forward(torch, {}, floor)
    phase_cli(torch, model, meta, {})
    mark("K10, the conv kernels, the GRU forward and the transcribe CLI")
    # the beam slice: the device beam on the forward's posteriors, then the
    # transcribe and test CLIs with the beam decoders and a synthetic LM
    with tempfile.TemporaryDirectory() as lm_dir:
        from deepspeech_tpu_torch.decoders.lm_binary import convert_arpa

        arpa = os.path.join(lm_dir, "synthetic.arpa")
        dslm = os.path.join(lm_dir, "synthetic.dslm")
        write_synthetic_arpa(arpa, np.random.default_rng(SEED + 13))
        header = convert_arpa(arpa, dslm)
        log(f"synthetic LM: order {header['order']}, n-grams "
            f"{header['counts']}, {header['vocab_size']} words")
        phase_beam(torch, model, beam_counts, floor, dslm)
        mark("the device beam searches")
        phase_beam_cli(torch, model, meta, arpa, dslm)
        mark("the beam decoders through the transcribe and test CLIs")
        data_path = phase_data_path(torch, model, meta, arpa, dslm)
        mark("the data path: FLAC -> librispeech -> test four ways, KenLM, "
             "the native search and edit distance, import_torch")
    del model
    step12 = phase_train(torch, train_counts, floor)
    phase_train_augmented(torch, floor)
    phase_train_cli(torch)
    mark("the GRU train step and train CLI")
    phase_train_cli_full(torch)
    mark("the train CLI with every ported flag, and its resume")
    serve = phase_serve(torch, floor)
    mark("the serving path (the serve CLI, the pool, the frozen-norm "
         "stream)")
    cnn = phase_cnn(torch, floor)
    mark("the CNN zoo (train steps, the pool, two_pass transcribe)")
    # the LSTM cell: K3 and K7, then its inference, train and CLI paths
    phase_layer_fwd(torch, results, "lstm")
    phase_layer_bwd(torch, results, "lstm")
    phase_forward(torch, {}, floor, "lstm")
    phase_train(torch, lstm_train_counts, floor, "lstm")
    phase_train_cli(torch, "lstm")
    mark("the LSTM phases")
    # the wide models: K4 and K6 alone, then each model's forward and train
    # step, then the config-4 train CLI with curriculum sampling
    for cell, fused, wide in (("gru", 1, LAYERS - 1), ("lstm", 0, LAYERS)):
        phase_scan(torch, results, cell)
        phase_bwd_wide(torch, results, cell)
        if cell == "gru":
            phase_fused_wide(torch, results)
        b = WIDE_BATCH[cell]
        fwd = {f"{cell}_fwd": fused, f"{cell}_scan": wide}
        phase_forward(torch, {}, floor, cell, WIDE, b,
                      want=expect_counts(stft_mag=1, **fwd,
                                         **conv_launches(1)))
        phase_train(torch, wide_counts[cell], floor, cell, WIDE, b,
                    want=expect_counts(
                        stft_mag=1, ctc_alpha=1, ctc_beta=1, **fwd,
                        **conv_launches(steps=1),
                        **{f"{cell}_fwd_res": fused,
                           f"{cell}_scan_res": wide,
                           f"{cell}_bwd": LAYERS}))
        mark(f"the 6 x Bi{cell.upper()}-{WIDE} phases")
    wide_f32_counts = phase_wide_cli(torch)
    mark("the config-4 train CLI with curriculum sampling, its f32 test "
         "batch")
    multi_gpu = phase_multi_gpu(torch, step12)
    mark("multi-GPU training: data 2 and model 2 ranks on the card, NCCL "
         f"at world size 1 (and its --steps-per-dispatch {SPD_K} replays)")
    mesh_model = phase_mesh_model(torch)
    mark("the JAX rule's gate and head shardings: model 4 and model 2 ranks "
         f"on the card, --steps-per-dispatch {MESH_SPD_K} on two gloo ranks")
    spd = phase_steps_per_dispatch(torch)
    mark(f"--steps-per-dispatch {SPD_K}: replayed train steps against eager "
         "ones, the default model and config 4")
    spd_cache_out = spd_cache(torch)
    spd_cli = phase_spd_cli(torch)
    mark(f"the graph cache over {len(SPD_CACHE_SECONDS)} shapes, and the "
         f"train CLI at --steps-per-dispatch {SPD_K} against 1")
    test_multi = phase_test_multi(torch)
    mark("the test CLI on two gloo ranks against one process")

    # launches from one pass of each kernel's path: the GRU-800 train step,
    # the LSTM-800 train step, the wide models' train steps, the beam, and
    # config 4's f32 test batch for K4's f32 persistent variant (the eval
    # path's, timed for inference, its source and TPU kernel K4's)
    counts_of = {"lstm_fwd": lstm_train_counts, "lstm_bwd": lstm_train_counts,
                 "gru_scan": wide_counts["gru"],
                 "lstm_scan": wide_counts["lstm"], "topk": beam_counts,
                 "gru_scan_f32_persistent": wide_f32_counts}
    kernels = []
    for name in (*KERNELS, "gru_scan_f32_persistent"):
        r = results[name]
        counts = counts_of.get(name, train_counts)
        base = name.removesuffix("_f32_persistent")
        kernels.append({"name": name, "route": r["route"],
                        "source": SOURCES[base], "replaces": REPLACES[base],
                        "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], **r.get("extra", {})})
        # the launches of phase_steps_per_dispatch's replayed runs (the
        # default model's 10 steps and config 4's 4), eager warm-ups and
        # replays together
        replayed = sum(run["launches"][name] for run in spd.values())
        if replayed:
            kernels[-1]["launches_steps_per_dispatch"] = replayed
    # the conv front's kernels: no TPU kernel, the wide train cell's batch;
    # launches of the GRU-800 train step (phase_train)
    kernels.append({"name": "conv", "route": "cuda",
                    "source": "deepspeech_tpu_torch/csrc/conv_mma.cu",
                    "replaces": None,
                    "launches": sum(n for k, n in train_counts.items()
                                    if k.startswith("conv_")),
                    **{k: v for k, v in results["conv"].items()
                       if k not in ("route", "extra")},
                    **results["conv"]["extra"]})
    log(card)
    serve["greedy"].pop("texts")
    serve["device_beam"].pop("texts")
    log(json.dumps({"serve": serve, "cnn": cnn, "data_path": data_path,
                    "multi_gpu": multi_gpu, "mesh_model": mesh_model,
                    "steps_per_dispatch": spd,
                    "step_graph_cache": spd_cache_out,
                    "steps_per_dispatch_cli": spd_cli,
                    "test_multi": test_multi}))
    log(f"chip_smoke.py total {time.perf_counter() - started:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        raise SystemExit(rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--test-rank"]:
        raise SystemExit(test_rank_main(sys.argv[2:]))
    raise SystemExit(main())
