// LSTM recurrence on a precomputed input projection, one or two directions
// (K6).
//
// Replaces the Pallas TPU kernel deepspeech_tpu/ops/pallas/rnn_kernel.py
// (_lstm_fwd_kernel at :551, launched by _lstm_fwd for bilstm_scan_pallas and
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
// operations. But a step cannot start before the last one ends, and each
// step must bring W_hh (41.0 MB in bf16 for both directions) from L2 to
// the SMs again: that, not the products, is the floor of a step.
//
// Design, bf16: rnn_mma.cuh (tensor-core steps that read W_hh once a step,
// packed once a call by the wrapper; h_prev kept as a bf16 copy; one
// launch a step or one persistent cooperative launch that keeps h and c of
// each thread's pairs in registers). f32 keeps f32 products: K3's step
// kernel (lstm_step.cuh) with the projection read in f32. chip_smoke.py
// and PERF.md record the times on the card beside the bound and the
// per-step L2 floor.
#include "lstm_step.cuh"
#include "rnn_mma.cuh"

// f32: xp (D, T, B, 4H) without bias; b_ih, b_hh (D, 4H); w_hh (D, H, 4H);
// lens (B) int32 <= T; scratch state (3, D, B, H); out (D, T, B, H), zero
// at steps past each row's length; c (D, T, B, H) and g (D, T, B, 4H), or
// both null.
DS_EXPORT int lstm_scan_f32(const float* xp, const float* b_ih,
                            const float* w_hh, const float* b_hh,
                            const int* lens, float* state, float* out,
                            float* c, float* g, int Tn, int B, int H, int D,
                            void* stream) {
  return static_cast<int>(lstm_recurrence(
      xp, w_hh, b_ih, b_hh, lens, state, out, c, g, Tn, B, H, D,
      static_cast<cudaStream_t>(stream)));
}

// bf16: w_pk is W_hh packed (D, NJ, NK, 4 * 32, 64) (rnn_mma.cuh); scratch
// hc (2, D, B, H) f32 (h, then c), hb (2, D, B8, NK * 64) bf16 and bar (1)
// uint32, all zeroed here; variant 0 (the rule), 1 (one launch a step) or
// 2 (persistent). Other arguments as the f32 entry, g in bf16.
DS_EXPORT int lstm_scan_bf16(const __nv_bfloat16* xp, const float* b_ih,
                             const __nv_bfloat16* w_pk, const float* b_hh,
                             const int* lens, float* hc, __nv_bfloat16* hb,
                             unsigned* bar, float* out, float* c,
                             __nv_bfloat16* g, int Tn, int B, int H, int D,
                             int variant, void* stream) {
  const int nk = (H + mma_rnn::KC - 1) / mma_rnn::KC;
  float* c_state = hc + static_cast<size_t>(D) * B * H;
  const mma_rnn::Args a{xp, w_pk, b_ih, b_hh, lens, hc, c_state, hb, bar,
                        out, g, nullptr, c, Tn, B, H, (B + 7) / 8 * 8,
                        nk * mma_rnn::KC, nk,
                        (H + mma_rnn::TJ - 1) / mma_rnn::TJ};
  return static_cast<int>(mma_rnn::recurrence<4>(
      a, D, variant, static_cast<cudaStream_t>(stream)));
}
