// GRU layer forward, input projection included, one or two directions.
//
// Replaces the Pallas TPU kernel deepspeech_tpu/ops/pallas/rnn_fused.py
// (_gru_fused_fwd_kernel, launched by _gru_fused_fwd for bigru_layer_pallas
// and gru_layer_pallas), both variants: the projection x @ W_ih into f32
// scratch, then the r, z, n recurrence with f32 state and f32 gates, both
// biases added in f32 and b_hn inside the r *. The training variant
// (with_res=True there; g and hn not null here) also writes, per direction,
// the gate stream g = (r, z, n) (T, B, 3H) and hn, the hidden n-term before
// the r * (T, B, H), in the operand type, as the TPU kernel stashes them for
// the backward (csrc/gru_bwd.cu); both are zero at steps past a row's
// length. Inference passes null and writes neither.
// The operand type is float or __nv_bfloat16; in bf16 the hidden dot
// rounds h_prev to bf16 (as the TPU kernel does) and every product
// accumulates in f32; the projection is never rounded to bf16.
//
// Bound on the H100 at the default shape (T 376, B 20, H 800, F 1312 or
// 800, two directions): ~95 (layer 0) or 58 GFLOP of projection plus 58
// GFLOP of recurrence, ~0.12-0.15 ms at the 989 TFLOP/s bf16 tensor-core
// peak; ~90 MB of bytes, ~0.03 ms (the training variant adds ~96 MB of g
// and hn, ~0.06 ms in all). So it is bound by operations. But the T steps
// depend on each other: a step cannot take less than one grid-wide
// exchange of h_prev.
//
// Design, bf16 (all on tensor cores):
//  * the projection: proj_mma.cuh, a hand-written mma.sync GEMM writing
//    the (D, T*B, 3H) f32 stream;
//  * the recurrence: rnn_mma.cuh (K4's design, on the f32 stream), in one
//    of three variants the wrapper chooses by a fixed rule
//    (ops/cuda/recurrence.py: fwd_variant): W-resident persistent (each
//    block's slice of W_hh in shared memory for the whole call; H 800),
//    streamed persistent (W_hh from L2 once a step; the wide GRU's layer 0
//    at H 1600, B 64), or one launch a step (batches above 64 rows).
//    W_hh comes packed by ops/cuda/recurrence.py:pack_w_hh.
// f32 keeps the SIMT design: proj_gemm (rnn_common.cuh, f32 FMA) and one
// launch of gru_step (gru_step.cuh, shared with K4's f32) a step.
// chip_smoke.py and PERF.md record each variant's time on the card beside
// the bound, cuDNN's layer and the per-step floor of a grid barrier.
#include "gru_step.cuh"
#include "proj_mma.cuh"

namespace {

__global__ void empty_kernel() {}

// A persistent grid that does nothing but `steps` grid barriers.
__global__ void __launch_bounds__(mma_rnn::THREADS, 1)
    sync_kernel(unsigned* bar, int steps) {
  const unsigned nblocks = gridDim.x * gridDim.y;
  for (int s = 0; s < steps; ++s)
    mma_rnn::grid_sync_release(bar, (s + 1) * nblocks);
}

}  // namespace

// f32: x (T, B, F); w_ih (D, F, 3H); w_hh (D, H, 3H); b_ih, b_hh (D, 3H);
// lens (B) int32 <= T; scratch xp (D, T, B, 3H) f32 and state (2, D, B, H)
// f32; out (D, T, B, H) f32, zero at steps past each row's length; g
// (D, T, B, 3H) and hn (D, T, B, H), or both null.
DS_EXPORT int gru_fwd_f32(const float* x, const float* w_ih,
                          const float* b_ih, const float* w_hh,
                          const float* b_hh, const int* lens, float* xp,
                          float* state, float* out, float* g, float* hn,
                          int Tn, int B, int F, int H, int D, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_proj_gemm(x, w_ih, xp, Tn * B, 3 * H, F, D, st);
  if (err == cudaSuccess)
    err = gru_recurrence(xp, w_hh, b_ih, b_hh, lens, state,
                         out, g, hn, Tn, B, H, D, st);
  return static_cast<int>(err);
}

// bf16: w_pk is W_hh packed (D, NJ, NK, 3 * 32, 64) (rnn_mma.cuh); scratch
// xp (D, T, B, 3H) f32, h (D, B, H) f32, hb (2, D, B8, NK * 64) bf16 and
// bar (1) uint32, all but xp zeroed here; variant 1 (one launch a step), 2
// (persistent, W_hh streamed) or 3 (persistent, W_hh resident). g and hn
// in bf16; other arguments as the f32 entry.
DS_EXPORT int gru_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w_ih,
                           const float* b_ih, const __nv_bfloat16* w_pk,
                           const float* b_hh, const int* lens, float* xp,
                           float* h, __nv_bfloat16* hb, unsigned* bar,
                           float* out, __nv_bfloat16* g, __nv_bfloat16* hn,
                           int Tn, int B, int F, int H, int D, int variant,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant < 1 || variant > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = proj_mma::launch(x, w_ih, xp, Tn * B, 3 * H, F, D, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nk = (H + mma_rnn::KC - 1) / mma_rnn::KC;
  const mma_rnn::Args a{xp, w_pk, b_ih, b_hh, lens, h, nullptr, hb, bar,
                        out, g, hn, nullptr, Tn, B, H, (B + 7) / 8 * 8,
                        nk * mma_rnn::KC, nk,
                        (H + mma_rnn::TJ - 1) / mma_rnn::TJ};
  return static_cast<int>(mma_rnn::recurrence<3, float>(a, D, variant, st));
}

// How many blocks of the streamed and of the W-resident persistent kernel
// can be resident at once for a batch of b rows and H units (the latter 0
// where its shared memory exceeds a block's), for the wrapper's rule.
DS_EXPORT int gru_fwd_capacity(int b, int H, int* streamed, int* resident) {
  return static_cast<int>(mma_rnn::capacity<3>(b, H, streamed, resident));
}

// The bf16 projection GEMM alone: c (D, M, N) f32 = x (M, K) @ w (D, K, N)
// (K2's and K3's first part; chip_smoke.py times it beside cuBLAS).
DS_EXPORT int proj_mma_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                            float* c, int M, int N, int K, int D,
                            void* stream) {
  return static_cast<int>(proj_mma::launch(x, w, c, M, N, K, D,
                                           static_cast<cudaStream_t>(stream)));
}

// n launches of an empty kernel from a host loop, as the one-launch-a-step
// variants issue their steps: the launch gap under every such step
// (chip_smoke.py times it for the latency floor).
DS_EXPORT int empty_launches(int n, void* stream) {
  for (int i = 0; i < n; ++i) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// One cooperative launch of `blocks` blocks doing nothing but `steps` grid
// barriers on bar (1) uint32, zeroed here: the launch-free floor under a
// step of the persistent variants (chip_smoke.py times it).
DS_EXPORT int grid_sync_steps(int blocks, int steps, unsigned* bar,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bar, 0, sizeof(unsigned), st);
  void* params[] = {&bar, &steps};
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(sync_kernel),
                                      dim3(blocks), dim3(mma_rnn::THREADS),
                                      params, 0, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
