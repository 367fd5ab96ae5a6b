// LSTM layer forward, input projection included, one or two directions.
//
// Replaces the Pallas TPU kernel deepspeech_tpu/ops/pallas/rnn_fused.py
// (_lstm_fused_fwd_kernel, launched by _lstm_fused_fwd for
// bilstm_layer_pallas and lstm_layer_pallas), both variants: the
// projection x @ W_ih into f32 scratch (never rounded to the operand
// type), then the recurrence in torch gate order i, f, g, o with f32 state
// h and c, both biases added in f32 and f32 gates. The training variant
// (with_res=True there; c and g not null here) also writes, per direction,
// the cell stream c (T, B, H) in f32 and the activated gates (i, f, g, o)
// (T, B, 4H) in the operand type, which the backward (csrc/lstm_bwd.cu)
// reads; both are zero at steps past a row's length. Inference passes
// null and writes only h (the TPU kernel writes c in both variants, but
// nothing reads it there).
// The operand type is float or __nv_bfloat16; in bf16 the hidden dot
// rounds h_prev to bf16 (as the TPU kernel does) and every product
// accumulates in f32.
//
// Bound on the H100 at the default shape (T 376, B 20, H 800, F 1312 or
// 800, two directions): ~126 (layer 0) or 77 GFLOP of projection plus 77
// GFLOP of recurrence, ~0.16-0.21 ms at the 989 TFLOP/s bf16 tensor-core
// peak; ~95 MB of bytes, ~0.03 ms (the training variant adds ~144 MB of c
// and g, ~0.07 ms in all). So it is bound by operations; the T dependent
// steps, each a grid-wide exchange of h_prev, set the floor.
//
// Design, K2's (gru_fwd.cu) with a fourth gate and a carried cell: in bf16
// the projection on tensor cores (proj_mma.cuh) into the (D, T*B, 4H) f32
// stream, then rnn_mma.cuh's recurrence on it in the variant the wrapper's
// fixed rule chooses (W-resident persistent at H 800; streamed persistent;
// one launch a step above 64 rows). f32 keeps the SIMT design:
// proj_gemm (rnn_common.cuh) and one launch of lstm_step (lstm_step.cuh,
// shared with K6's f32) a step. chip_smoke.py and PERF.md record the times
// on the card.
#include "lstm_step.cuh"
#include "proj_mma.cuh"

// f32: x (T, B, F); w_ih (D, F, 4H); w_hh (D, H, 4H); b_ih, b_hh (D, 4H);
// lens (B) int32 <= T; scratch xp (D, T, B, 4H) f32 and state (3, D, B, H)
// f32; out (D, T, B, H) f32, zero at steps past each row's length; c
// (D, T, B, H) f32 and g (D, T, B, 4H), or both null.
DS_EXPORT int lstm_fwd_f32(const float* x, const float* w_ih,
                           const float* b_ih, const float* w_hh,
                           const float* b_hh, const int* lens, float* xp,
                           float* state, float* out, float* c, float* g,
                           int Tn, int B, int F, int H, int D, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_proj_gemm(x, w_ih, xp, Tn * B, 4 * H, F, D, st);
  if (err == cudaSuccess)
    err = lstm_recurrence(xp, w_hh, b_ih, b_hh, lens, state,
                          out, c, g, Tn, B, H, D, st);
  return static_cast<int>(err);
}

// bf16: w_pk is W_hh packed (D, NJ, NK, 4 * 32, 64) (rnn_mma.cuh); scratch
// xp (D, T, B, 4H) f32, hc (2, D, B, H) f32 (h, then c), hb (2, D, B8,
// NK * 64) bf16 and bar (1) uint32, all but xp zeroed here; variant 1 (one
// launch a step), 2 (persistent, W_hh streamed) or 3 (persistent, W_hh
// resident). g in bf16; other arguments as the f32 entry.
DS_EXPORT int lstm_fwd_bf16(const __nv_bfloat16* x,
                            const __nv_bfloat16* w_ih, const float* b_ih,
                            const __nv_bfloat16* w_pk, const float* b_hh,
                            const int* lens, float* xp, float* hc,
                            __nv_bfloat16* hb, unsigned* bar, float* out,
                            float* c, __nv_bfloat16* g, int Tn, int B, int F,
                            int H, int D, int variant, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant < 1 || variant > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = proj_mma::launch(x, w_ih, xp, Tn * B, 4 * H, F, D, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nk = (H + mma_rnn::KC - 1) / mma_rnn::KC;
  float* c_state = hc + static_cast<size_t>(D) * B * H;
  const mma_rnn::Args a{xp, w_pk, b_ih, b_hh, lens, hc, c_state, hb, bar,
                        out, g, nullptr, c, Tn, B, H, (B + 7) / 8 * 8,
                        nk * mma_rnn::KC, nk,
                        (H + mma_rnn::TJ - 1) / mma_rnn::TJ};
  return static_cast<int>(mma_rnn::recurrence<4, float>(a, D, variant, st));
}

// As gru_fwd_capacity (gru_fwd.cu), for the LSTM's kernels.
DS_EXPORT int lstm_fwd_capacity(int b, int H, int* streamed, int* resident) {
  return static_cast<int>(mma_rnn::capacity<4>(b, H, streamed, resident));
}
