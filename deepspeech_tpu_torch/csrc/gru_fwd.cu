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
// The operand type T is float or __nv_bfloat16; in bf16 the hidden dot
// rounds h_prev to bf16 (as the TPU kernel does) and every product
// accumulates in f32; the projection is never rounded to bf16.
//
// Bound on the H100 at the default shape (T 376, B 20, H 800, F 1312 or
// 800, two directions): ~95 (layer 0) or 58 GFLOP of projection plus 58
// GFLOP of recurrence, ~0.12-0.15 ms at the 989 TFLOP/s bf16 tensor-core
// peak; ~90 MB of bytes, ~0.03 ms (the training variant adds ~96 MB of g
// and hn, ~0.06 ms in all). So it is bound by operations.
// Latency floor: the T steps depend on each other, and this design spends
// one launch on each. A step cannot take less than the gap between two
// launches from the host loop plus one dependent read of h_prev from L2,
// one H-long dot and one reduction. chip_smoke.py measures both: an empty
// launch every ~2.4-3.4 us, and this kernel at the least work (B 1, H 16)
// ~3.6-4.4 us a step. So one layer's 376 steps take at least ~1.5 ms, and
// the 2,256 steps of a 6 x BiGRU forward at least ~8-10 ms.
//
// Design, simple and right first:
//  * proj_gemm (rnn_common.cuh): a tiled SIMT GEMM (128 x 128 x 8 tiles,
//    8 x 8 per thread, f32 FMA) writing the (D, T*B, 3H) f32 projection
//    stream. It uses no tensor cores yet: a wgmma version is later work.
//  * gru_step (gru_step.cuh, shared with K4 in gru_scan.cu): one launch per
//    time step covering both directions, on the f32 projection.
// Against the bound: on an H100 SXM at 700 W a bf16 layer-0 call takes
// ~9.7-9.9 ms, ~85x the bound, with or without the residuals; a step takes
// ~15 us of kernel time, ~4x the least-work step, and the SIMT projection
// ~2.4-2.6 ms a layer (chip_smoke.py; PERF.md).
#include "gru_step.cuh"

namespace {

__global__ void empty_kernel() {}

template <typename T>
int gru_fwd(const T* x, const T* w_ih, const float* b_ih, const T* w_hh,
            const float* b_hh, const int* lens, float* xp, float* state,
            float* out, T* g_out, T* hn_out, int Tn, int B, int F, int H,
            int D, cudaStream_t stream) {
  cudaError_t err = launch_proj_gemm<T>(x, w_ih, xp, Tn * B, 3 * H, F, D,
                                        stream);
  if (err == cudaSuccess)
    err = gru_recurrence<T, float>(xp, w_hh, b_ih, b_hh, lens, state, out,
                                   g_out, hn_out, Tn, B, H, D, stream);
  return static_cast<int>(err);
}

}  // namespace

// x (T, B, F); w_ih (D, F, 3H); w_hh (D, H, 3H); b_ih, b_hh (D, 3H) f32;
// lens (B) int32 <= T; scratch xp (D, T, B, 3H) f32 and state (2, D, B, H)
// f32; out (D, T, B, H) f32, zero at steps past each row's length; g
// (D, T, B, 3H) and hn (D, T, B, H) in the operand type, or both null.
DS_EXPORT int gru_fwd_f32(const float* x, const float* w_ih,
                          const float* b_ih, const float* w_hh,
                          const float* b_hh, const int* lens, float* xp,
                          float* state, float* out, float* g, float* hn,
                          int Tn, int B, int F, int H, int D, void* stream) {
  return gru_fwd<float>(x, w_ih, b_ih, w_hh, b_hh, lens, xp, state, out, g,
                        hn, Tn, B, F, H, D, static_cast<cudaStream_t>(stream));
}

DS_EXPORT int gru_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w_ih,
                           const float* b_ih, const __nv_bfloat16* w_hh,
                           const float* b_hh, const int* lens, float* xp,
                           float* state, float* out, __nv_bfloat16* g,
                           __nv_bfloat16* hn, int Tn, int B, int F, int H,
                           int D, void* stream) {
  return gru_fwd<__nv_bfloat16>(x, w_ih, b_ih, w_hh, b_hh, lens, xp, state,
                                out, g, hn, Tn, B, F, H, D,
                                static_cast<cudaStream_t>(stream));
}

// n launches of an empty kernel from a host loop, as gru_fwd issues its
// steps: the launch gap under every step of the recurrence (chip_smoke.py
// times it for the K2 latency floor).
DS_EXPORT int empty_launches(int n, void* stream) {
  for (int i = 0; i < n; ++i) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
