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
// The operand type T is float or __nv_bfloat16; in bf16 the hidden dot
// rounds h_prev to bf16 (as the TPU kernel does) and every product
// accumulates in f32.
//
// Bound on the H100 at the default shape (T 376, B 20, H 800, F 1312 or
// 800, two directions): ~126 (layer 0) or 77 GFLOP of projection plus 77
// GFLOP of recurrence, ~0.16-0.21 ms at the 989 TFLOP/s bf16 tensor-core
// peak; ~95 MB of bytes, ~0.03 ms (the training variant adds ~144 MB of c
// and g, ~0.07 ms in all). So it is bound by operations.
// Latency floor: the T steps depend on each other and this design spends
// one launch on each, as K2 does (gru_fwd.cu); chip_smoke.py measures the
// step kernel at the least work beside K2's.
//
// Design, K2's with a fourth gate and a carried cell, simple and right
// first:
//  * proj_gemm (rnn_common.cuh): the SIMT f32-FMA GEMM K2 uses, writing the
//    (D, T*B, 4H) f32 projection stream.
//  * lstm_step (lstm_step.cuh, shared with K6 in lstm_scan.cu): one launch
//    per time step covering both directions, on the f32 projection.
// Against the bound: chip_smoke.py and PERF.md record its time on the card.
#include "lstm_step.cuh"

namespace {

template <typename T>
int lstm_fwd(const T* x, const T* w_ih, const float* b_ih, const T* w_hh,
             const float* b_hh, const int* lens, float* xp, float* state,
             float* out, float* c_out, T* g_out, int Tn, int B, int F, int H,
             int D, cudaStream_t stream) {
  cudaError_t err = launch_proj_gemm<T>(x, w_ih, xp, Tn * B, 4 * H, F, D,
                                        stream);
  if (err == cudaSuccess)
    err = lstm_recurrence<T, float>(xp, w_hh, b_ih, b_hh, lens, state, out,
                                    c_out, g_out, Tn, B, H, D, stream);
  return static_cast<int>(err);
}

}  // namespace

// x (T, B, F); w_ih (D, F, 4H); w_hh (D, H, 4H); b_ih, b_hh (D, 4H) f32;
// lens (B) int32 <= T; scratch xp (D, T, B, 4H) f32 and state (3, D, B, H)
// f32; out (D, T, B, H) f32, zero at steps past each row's length; c
// (D, T, B, H) f32 and g (D, T, B, 4H) in the operand type, or both null.
DS_EXPORT int lstm_fwd_f32(const float* x, const float* w_ih,
                           const float* b_ih, const float* w_hh,
                           const float* b_hh, const int* lens, float* xp,
                           float* state, float* out, float* c, float* g,
                           int Tn, int B, int F, int H, int D, void* stream) {
  return lstm_fwd<float>(x, w_ih, b_ih, w_hh, b_hh, lens, xp, state, out, c,
                         g, Tn, B, F, H, D, static_cast<cudaStream_t>(stream));
}

DS_EXPORT int lstm_fwd_bf16(const __nv_bfloat16* x,
                            const __nv_bfloat16* w_ih, const float* b_ih,
                            const __nv_bfloat16* w_hh, const float* b_hh,
                            const int* lens, float* xp, float* state,
                            float* out, float* c, __nv_bfloat16* g, int Tn,
                            int B, int F, int H, int D, void* stream) {
  return lstm_fwd<__nv_bfloat16>(x, w_ih, b_ih, w_hh, b_hh, lens, xp, state,
                                 out, c, g, Tn, B, F, H, D,
                                 static_cast<cudaStream_t>(stream));
}
