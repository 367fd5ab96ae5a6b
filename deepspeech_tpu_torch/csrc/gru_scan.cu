// GRU recurrence on a precomputed input projection, one or two directions
// (K4).
//
// Replaces the Pallas TPU kernel deepspeech_tpu/ops/pallas/rnn_kernel.py
// (_gru_fwd_kernel at :123, launched by _gru_fwd for bigru_scan_pallas and
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
// operations. But a step cannot start before the last one ends, and each
// step must bring W_hh (30.7 MB in bf16 for both directions) from L2 to
// the SMs again: that, not the products, is the floor of a step.
//
// Design, bf16: rnn_mma.cuh (tensor-core steps that read W_hh once a step,
// packed once a call by the wrapper; h_prev kept as a bf16 copy; one
// launch a step or one persistent cooperative launch). f32 keeps f32
// products: K2's step kernel (gru_step.cuh) with the projection read in
// f32, the batch tiled by RB = 8 rows. chip_smoke.py and PERF.md record
// the times on the card beside the bound and the per-step L2 floor.
#include "gru_step.cuh"
#include "rnn_mma.cuh"

// f32: xp (D, T, B, 3H) without bias; b_ih, b_hh (D, 3H); w_hh (D, H, 3H);
// lens (B) int32 <= T; scratch state (2, D, B, H); out (D, T, B, H), zero
// at steps past each row's length; g (D, T, B, 3H) and hn (D, T, B, H), or
// both null.
DS_EXPORT int gru_scan_f32(const float* xp, const float* b_ih,
                           const float* w_hh, const float* b_hh,
                           const int* lens, float* state, float* out,
                           float* g, float* hn, int Tn, int B, int H, int D,
                           void* stream) {
  return static_cast<int>(gru_recurrence<float, float>(
      xp, w_hh, b_ih, b_hh, lens, state, out, g, hn, Tn, B, H, D,
      static_cast<cudaStream_t>(stream)));
}

// bf16: w_pk is W_hh packed (D, NJ, NK, 3 * 32, 64) (rnn_mma.cuh); scratch
// h (D, B, H) f32, hb (2, D, B8, NK * 64) bf16 and bar (1) uint32, all
// zeroed here; variant 0 (the rule), 1 (one launch a step) or 2
// (persistent). Other arguments as the f32 entry, g and hn in bf16.
DS_EXPORT int gru_scan_bf16(const __nv_bfloat16* xp, const float* b_ih,
                            const __nv_bfloat16* w_pk, const float* b_hh,
                            const int* lens, float* h, __nv_bfloat16* hb,
                            unsigned* bar, float* out, __nv_bfloat16* g,
                            __nv_bfloat16* hn, int Tn, int B, int H, int D,
                            int variant, void* stream) {
  const int nk = (H + mma_rnn::KC - 1) / mma_rnn::KC;
  const mma_rnn::Args a{xp, w_pk, b_ih, b_hh, lens, h, nullptr, hb, bar,
                        out, g, hn, nullptr, Tn, B, H, (B + 7) / 8 * 8,
                        nk * mma_rnn::KC, nk,
                        (H + mma_rnn::TJ - 1) / mma_rnn::TJ};
  return static_cast<int>(mma_rnn::recurrence<3>(
      a, D, variant, static_cast<cudaStream_t>(stream)));
}
