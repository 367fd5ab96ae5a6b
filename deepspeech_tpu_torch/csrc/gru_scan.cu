// GRU recurrence on a precomputed input projection, one or two directions
// (K4).
//
// Replaces the Pallas TPU kernel deepspeech_tpu/ops/pallas/rnn_kernel.py
// (_gru_fwd_kernel, launched by _gru_fwd for bigru_scan_pallas and
// gru_scan_pallas), both variants. The JAX package takes it for the layers
// whose W_ih and W_hh do not fit VMEM together (ops/cuda/route.py has the
// port's copy of that rule): there the projection x @ W_ih is one matmul
// outside, rounded to the operand type, and this kernel runs the r, z, n
// recurrence on it with f32 state and f32 gates, both biases added in f32
// and b_hn inside the r *. The training variant (with_res=True there; g
// and hn not null here) also writes, per direction, the gate stream
// g = (r, z, n) (T, B, 3H) and hn, the hidden n-term before the r *
// (T, B, H), in the operand type: the residuals K5 (gru_bwd.cu) reads. Both
// are zero at steps past a row's length; inference passes null and writes
// neither. The operand type T is float or __nv_bfloat16, for W_hh, the
// projection and the residuals alike.
//
// Bound on the H100 at the wide model's shape (6 x BiGRU-1600 at B 64,
// T 376): the recurrence is 2 x 2 x T x B x H x 3H = ~0.74 TFLOP of
// products, ~0.75 ms at the 989 TFLOP/s bf16 tensor-core peak; the bytes
// (xp in, h and the residuals out) take ~0.2-0.5 ms. So it is bound by
// operations. One launch a step costs ~3.5-5 us more, ~1.5 ms over 376
// steps, above that bound.
//
// Design: K2's step kernel (gru_step.cuh) with the projection read in the
// operand type. W_hh for both directions (30.7 MB in bf16, 61 MB in f32)
// no longer stays in the 50 MB L2 in f32, and the batch is tiled by RB = 8
// rows, so each W_hh column slice is read by B / 8 blocks a step.
// Against the bound: chip_smoke.py and PERF.md record its time on the card.
#include "gru_step.cuh"

namespace {

template <typename T>
int gru_scan(const T* xp, const float* b_ih, const T* w_hh,
             const float* b_hh, const int* lens, float* state, float* out,
             T* g_out, T* hn_out, int Tn, int B, int H, int D,
             cudaStream_t stream) {
  return static_cast<int>(gru_recurrence<T, T>(
      xp, w_hh, b_ih, b_hh, lens, state, out, g_out, hn_out, Tn, B, H, D,
      stream));
}

}  // namespace

// xp (D, T, B, 3H) without bias; b_ih, b_hh (D, 3H) f32; w_hh (D, H, 3H);
// lens (B) int32 <= T; scratch state (2, D, B, H) f32; out (D, T, B, H)
// f32, zero at steps past each row's length; g (D, T, B, 3H) and hn
// (D, T, B, H) in the operand type, or both null.
DS_EXPORT int gru_scan_f32(const float* xp, const float* b_ih,
                           const float* w_hh, const float* b_hh,
                           const int* lens, float* state, float* out,
                           float* g, float* hn, int Tn, int B, int H, int D,
                           void* stream) {
  return gru_scan<float>(xp, b_ih, w_hh, b_hh, lens, state, out, g, hn, Tn,
                         B, H, D, static_cast<cudaStream_t>(stream));
}

DS_EXPORT int gru_scan_bf16(const __nv_bfloat16* xp, const float* b_ih,
                            const __nv_bfloat16* w_hh, const float* b_hh,
                            const int* lens, float* state, float* out,
                            __nv_bfloat16* g, __nv_bfloat16* hn, int Tn,
                            int B, int H, int D, void* stream) {
  return gru_scan<__nv_bfloat16>(xp, b_ih, w_hh, b_hh, lens, state, out, g,
                                 hn, Tn, B, H, D,
                                 static_cast<cudaStream_t>(stream));
}
