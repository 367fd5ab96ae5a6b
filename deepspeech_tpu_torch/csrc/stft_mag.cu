// |STFT| magnitude: (B, S) f32 waveforms -> (B, n_bins, T) f32.
//
// Replaces the Pallas TPU kernel deepspeech_tpu/ops/pallas/stft_kernel.py
// (_kernel, launched by stft_magnitude_pallas): reflect padding, framing,
// the DFT with the analysis window folded into the cos/sin matrices, and
// sqrt(re^2 + im^2). The TPU kernel frames through k = n_fft/hop row-shifted
// views, a lane-alignment rule of the TPU; here a block frames by index and
// reflects the padded edges by index, so no padded copy of the batch exists.
//
// Bound on the H100: the function is |STFT|, which a real FFT computes
// exactly in f32 with ~7.6k operations a frame (2.5 N log2 N, the window
// and the magnitude): 0.11 GFLOP at 20 x 7.5 s, ~1.7 us at 67 TFLOP/s of
// non-tensor f32, while its ~19 MB of input and output take ~5.8 us at
// 3.35 TB/s. So the function is bound by bytes, at ~6 us. This design runs
// the DFT instead, T*n_bins*n_fft*2 FMAs in true f32 (the normalization's
// log1p(mag * 2^20) rules out TF32 and bf16): 3.1 GFLOP, whose op floor,
// ~46 us, belongs to the design and not to the function.
//
// Design: one block per (utterance, tile of FT frames); the tile's samples
// are staged in shared memory; one thread per frequency bin keeps FT frames'
// re/im sums in registers and walks n_fft in steps of 4, reading the
// window-folded cos/sin rows from global memory (412 KB at n_fft 320: more
// than a block's shared memory, but L2-resident and shared by all blocks)
// and the samples as float4 broadcasts from shared memory, so each pair of
// coefficient loads feeds 2*FT FMAs. The output tile is transposed through
// shared memory so that the (B, n_bins, T) stores are row-contiguous.
// Simple and right first: no tensor cores, no slab staging of the matrices.
// On an H100 SXM at 700 W it takes ~0.15 ms of kernel time at 20 x 7.5 s
// (0.17-0.19 ms by CUDA events): ~3.5x its DFT's op floor and ~30x the
// function's bound; cuFFT through torch.stft takes ~0.09 ms. An FFT inside
// the kernel is the way to the bound (chip_smoke.py; PERF.md, "H100 port").
#include "common.cuh"

namespace {

constexpr int FT = 16;  // frames per block

__global__ void stft_mag_kernel(const float* __restrict__ y,
                                const float* __restrict__ cosw,
                                const float* __restrict__ sinw,
                                float* __restrict__ out, int S, int T,
                                int n_fft, int hop, int n_bins, int pad) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FT;
  const int span = (FT - 1) * hop + n_fft;
  const int span4 = (span + 3) & ~3;
  float* tile = xs + span4;
  const float* yb = y + static_cast<size_t>(b) * S;

  // Stage the tile's samples. Padded position p maps to y[p - pad],
  // reflected about both edges (np.pad mode="reflect"); positions that only
  // frames past T would read are zero.
  for (int i = threadIdx.x; i < span4; i += blockDim.x) {
    float v = 0.f;
    if (i < span) {
      int j = t0 * hop + i - pad;
      if (j < 0) j = -j;
      if (j >= S) j = 2 * (S - 1) - j;
      if (j >= 0 && j < S) v = yb[j];
    }
    xs[i] = v;
  }
  __syncthreads();

  const int k = threadIdx.x;
  float re[FT], im[FT];
#pragma unroll
  for (int f = 0; f < FT; ++f) re[f] = im[f] = 0.f;
  if (k < n_bins) {
    for (int n = 0; n < n_fft; n += 4) {
      const float c0 = cosw[(n + 0) * n_bins + k];
      const float c1 = cosw[(n + 1) * n_bins + k];
      const float c2 = cosw[(n + 2) * n_bins + k];
      const float c3 = cosw[(n + 3) * n_bins + k];
      const float s0 = sinw[(n + 0) * n_bins + k];
      const float s1 = sinw[(n + 1) * n_bins + k];
      const float s2 = sinw[(n + 2) * n_bins + k];
      const float s3 = sinw[(n + 3) * n_bins + k];
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        const float4 v = *reinterpret_cast<const float4*>(xs + f * hop + n);
        re[f] = fmaf(v.x, c0, re[f]);
        re[f] = fmaf(v.y, c1, re[f]);
        re[f] = fmaf(v.z, c2, re[f]);
        re[f] = fmaf(v.w, c3, re[f]);
        im[f] = fmaf(v.x, s0, im[f]);
        im[f] = fmaf(v.y, s1, im[f]);
        im[f] = fmaf(v.z, s2, im[f]);
        im[f] = fmaf(v.w, s3, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FT; ++f)
      tile[k * FT + f] = sqrtf(re[f] * re[f] + im[f] * im[f]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_bins * FT; i += blockDim.x) {
    const int kk = i / FT;
    const int t = t0 + i % FT;
    if (t < T) out[(static_cast<size_t>(b) * n_bins + kk) * T + t] = tile[i];
  }
}

}  // namespace

// y (B, S), cosw/sinw (n_fft, n_bins) window-folded, out (B, n_bins, T).
// Needs n_fft % 4 == 0, hop % 4 == 0, n_bins <= 1024 and pad < S; the
// Python wrapper checks these.
DS_EXPORT int stft_mag_f32(const float* y, const float* cosw,
                           const float* sinw, float* out, int B, int S, int T,
                           int n_fft, int hop, int n_bins, int pad,
                           void* stream) {
  const int threads = (n_bins + 31) / 32 * 32;
  const int span4 = ((FT - 1) * hop + n_fft + 3) & ~3;
  const size_t smem = (static_cast<size_t>(span4) + n_bins * FT) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stft_mag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + FT - 1) / FT, B);
  stft_mag_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, cosw, sinw, out, S, T, n_fft, hop, n_bins, pad);
  return static_cast<int>(cudaGetLastError());
}
