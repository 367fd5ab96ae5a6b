// LSTM recurrence on a precomputed input projection, one or two directions
// (K6).
//
// Replaces the Pallas TPU kernel deepspeech_tpu/ops/pallas/rnn_kernel.py
// (_lstm_fwd_kernel, launched by _lstm_fwd for bilstm_scan_pallas and
// lstm_scan_pallas), both variants. The JAX package takes it for the layers
// whose W_ih and W_hh do not fit VMEM together (ops/cuda/route.py has the
// port's copy of that rule): there the projection x @ W_ih is one matmul
// outside, rounded to the operand type, and this kernel runs the i, f, g, o
// recurrence on it with f32 state h and c, both biases added in f32 and f32
// gates. The training variant (with_res=True there; c and g not null here)
// also writes, per direction, the cell stream c (T, B, H) in f32 and the
// activated gates (T, B, 4H) in the operand type: the residuals K7
// (lstm_bwd.cu) reads. Both are zero at steps past a row's length.
// Inference passes null and writes only h, as K3 does; the TPU kernel
// writes c in inference too (rnn_kernel.py:734-742), but nothing reads it
// there. The operand type T is float or __nv_bfloat16, for W_hh, the
// projection and the gate residuals alike.
//
// Bound on the H100 at the wide model's shape (6 x BiLSTM-1600 at B 20,
// T 376): the recurrence is 2 x 2 x T x B x H x 4H = ~0.31 TFLOP of
// products, ~0.31 ms at the 989 TFLOP/s bf16 tensor-core peak; the bytes
// (xp in, h and the residuals out) take ~0.1-0.2 ms. So it is bound by
// operations. One launch a step costs ~3.5-5 us more, ~1.5 ms over 376
// steps, above that bound.
//
// Design: K3's step kernel (lstm_step.cuh) with the projection read in the
// operand type. W_hh for both directions (41 MB in bf16, 82 MB in f32)
// barely stays in the 50 MB L2 in bf16 and cannot in f32.
// Against the bound: chip_smoke.py and PERF.md record its time on the card.
#include "lstm_step.cuh"

namespace {

template <typename T>
int lstm_scan(const T* xp, const float* b_ih, const T* w_hh,
              const float* b_hh, const int* lens, float* state, float* out,
              float* c_out, T* g_out, int Tn, int B, int H, int D,
              cudaStream_t stream) {
  return static_cast<int>(lstm_recurrence<T, T>(
      xp, w_hh, b_ih, b_hh, lens, state, out, c_out, g_out, Tn, B, H, D,
      stream));
}

}  // namespace

// xp (D, T, B, 4H) without bias; b_ih, b_hh (D, 4H) f32; w_hh (D, H, 4H);
// lens (B) int32 <= T; scratch state (3, D, B, H) f32; out (D, T, B, H)
// f32, zero at steps past each row's length; c (D, T, B, H) f32 and g
// (D, T, B, 4H) in the operand type, or both null.
DS_EXPORT int lstm_scan_f32(const float* xp, const float* b_ih,
                            const float* w_hh, const float* b_hh,
                            const int* lens, float* state, float* out,
                            float* c, float* g, int Tn, int B, int H, int D,
                            void* stream) {
  return lstm_scan<float>(xp, b_ih, w_hh, b_hh, lens, state, out, c, g, Tn,
                          B, H, D, static_cast<cudaStream_t>(stream));
}

DS_EXPORT int lstm_scan_bf16(const __nv_bfloat16* xp, const float* b_ih,
                             const __nv_bfloat16* w_hh, const float* b_hh,
                             const int* lens, float* state, float* out,
                             float* c, __nv_bfloat16* g, int Tn, int B, int H,
                             int D, void* stream) {
  return lstm_scan<__nv_bfloat16>(xp, b_ih, w_hh, b_hh, lens, state, out, c,
                                  g, Tn, B, H, D,
                                  static_cast<cudaStream_t>(stream));
}
