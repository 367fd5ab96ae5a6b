// CTC alpha (forward) and beta (backward) recursions in log space.
//
// Replace the Pallas TPU kernels deepspeech_tpu/ops/pallas/ctc_kernel.py
// _ctc_alpha_kernel (ctc_alpha here) and _ctc_beta_kernel (ctc_beta), both
// launched by ctc_loss_pallas through _ctc_fwd / _ctc_bwd. Over the
// S = 2L + 1 states of the blank-extended label sequence of one utterance:
//   alpha_t(s) = logaddexp(alpha_{t-1}(s), alpha_{t-1}(s-1),
//                          alpha_{t-1}(s-2) + skip(s)) + emit_t(s) + valid(s)
//   beta_t(s)  = logaddexp(beta_{t+1}(s), beta_{t+1}(s+1),
//                          beta_{t+1}(s+2) + skip(s+2)) + emit_t(s) + valid(s)
// (beta at the last valid frame starts from the end-state indicator), each
// clamped at -1e30 and frozen past the utterance's logit length, with the
// -inf guards of the TPU kernels in the same order, so that impossible
// alignments and frozen rows come out as they do there. ctc_beta writes
// beta + emit, the backward mass including the frame's emission, which the
// wrapper turns into the state occupancy gamma. The emission gather and the
// occupancy scatter stay outside (ops/ctc.py), as the JAX package keeps its
// one-hot einsums outside Pallas.
//
// Bound on the H100 at the default shape (B 20, T 376, L 150, S 301): each
// kernel reads the (B, T, S) f32 emissions once and writes (B, T, S) f32
// once, 18 MB, ~0.005 ms at 3.35 TB/s; ~10 operations a state and frame
// (three exp, one log) are 23 MFLOP, far below that. So the bytes bound it;
// in this design the T frames are a chain inside one block per utterance,
// so latency does: one __syncthreads and one dependent shared-memory read a
// frame, ~376 of them back to back.
//
// Design: one block per batch row with one thread per state (a thread takes
// several states when S > 1024); alpha or beta lives in shared memory,
// double-buffered, so each frame needs one __syncthreads. The loop ends at
// the row's logit length; the frozen frames past it are filled after the
// loop with no further synchronisation.
#include "common.cuh"

namespace {

constexpr float NEG = -1e30f;

// max that propagates NaN, as jnp.maximum and torch.maximum do (fmaxf
// would drop it, and a NaN row must stay NaN so that its loss is not
// finite and its gradient is zeroed)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float m = nanmax(nanmax(a, b), c);
  const bool dead = m <= NEG;
  const float ms = dead ? 0.f : m;
  const float s = expf(a - ms) + expf(b - ms) + expf(c - ms);
  return dead ? NEG : ms + logf(s);
}

// emit, alphas (B, T, S) f32; skip, valid (B, S) f32 (0 or -1e30);
// lens (B) int32; grid (B), dynamic shared memory 2 * S floats.
__global__ void ctc_alpha(const float* __restrict__ emit,
                          const float* __restrict__ skip,
                          const float* __restrict__ valid,
                          const int* __restrict__ lens,
                          float* __restrict__ alphas, int Tn, int S) {
  extern __shared__ float sm[];
  float* prev = sm;
  float* cur = sm + S;
  const int b = blockIdx.x;
  const int len = min(max(lens[b], 0), Tn);
  const size_t base = static_cast<size_t>(b) * Tn * S;
  const float* em = emit + base;
  float* out = alphas + base;
  const float* sk = skip + static_cast<size_t>(b) * S;
  const float* va = valid + static_cast<size_t>(b) * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    prev[s] = (s < 2 ? 0.f : NEG) + va[s];
  __syncthreads();
  for (int t = 0; t < len; ++t) {
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      float nw = prev[s];
      if (t > 0) {
        const float diag = s >= 1 ? prev[s - 1] : NEG;
        const float skp = (s >= 2 ? prev[s - 2] : NEG) + sk[s];
        nw = logaddexp3(nw, diag, skp);
      }
      nw = nanmax(nw + em[static_cast<size_t>(t) * S + s] + va[s], NEG);
      cur[s] = nw;
      out[static_cast<size_t>(t) * S + s] = nw;
    }
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  for (int t = len; t < Tn; ++t)
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      out[static_cast<size_t>(t) * S + s] = prev[s];
}

// emit, betas (B, T, S) f32; skip, valid, end (B, S) f32; lens (B) int32;
// grid (B), dynamic shared memory 2 * S floats. betas holds beta + emit,
// -1e30 at frames past the length.
__global__ void ctc_beta(const float* __restrict__ emit,
                         const float* __restrict__ skip,
                         const float* __restrict__ valid,
                         const float* __restrict__ end,
                         const int* __restrict__ lens,
                         float* __restrict__ betas, int Tn, int S) {
  extern __shared__ float sm[];
  float* prev = sm;
  float* cur = sm + S;
  const int b = blockIdx.x;
  const int len = min(max(lens[b], 0), Tn);
  const size_t base = static_cast<size_t>(b) * Tn * S;
  const float* em = emit + base;
  float* out = betas + base;
  const float* sk = skip + static_cast<size_t>(b) * S;
  const float* va = valid + static_cast<size_t>(b) * S;
  const float* en = end + static_cast<size_t>(b) * S;
  for (int t = len; t < Tn; ++t)
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      out[static_cast<size_t>(t) * S + s] = NEG;
  for (int s = threadIdx.x; s < S; s += blockDim.x) prev[s] = NEG;
  __syncthreads();
  for (int t = len - 1; t >= 0; --t) {
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      float bh;
      if (t == len - 1) {
        bh = en[s];
      } else {
        const float diag = s + 1 < S ? prev[s + 1] : NEG;
        const float skp = s + 2 < S ? prev[s + 2] + sk[s + 2] : NEG + NEG;
        bh = logaddexp3(prev[s], diag, skp);
      }
      bh = nanmax(bh + em[static_cast<size_t>(t) * S + s] + va[s], NEG);
      cur[s] = bh;
      out[static_cast<size_t>(t) * S + s] = bh;
    }
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
}

int threads_for(int S) { return S >= 1024 ? 1024 : ((S + 31) / 32) * 32; }

int launch_setup(const void* fn, int S) {
  const int smem = 2 * S * static_cast<int>(sizeof(float));
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace

DS_EXPORT int ctc_alpha_f32(const float* emit, const float* skip,
                            const float* valid, const int* lens,
                            float* alphas, int B, int Tn, int S,
                            void* stream) {
  int err = launch_setup(reinterpret_cast<const void*>(ctc_alpha), S);
  if (err != 0) return err;
  ctc_alpha<<<B, threads_for(S), 2 * S * sizeof(float),
              static_cast<cudaStream_t>(stream)>>>(emit, skip, valid, lens,
                                                   alphas, Tn, S);
  return static_cast<int>(cudaGetLastError());
}

DS_EXPORT int ctc_beta_f32(const float* emit, const float* skip,
                           const float* valid, const float* end,
                           const int* lens, float* betas, int B, int Tn,
                           int S, void* stream) {
  int err = launch_setup(reinterpret_cast<const void*>(ctc_beta), S);
  if (err != 0) return err;
  ctc_beta<<<B, threads_for(S), 2 * S * sizeof(float),
             static_cast<cudaStream_t>(stream)>>>(emit, skip, valid, end,
                                                  lens, betas, Tn, S);
  return static_cast<int>(cudaGetLastError());
}
