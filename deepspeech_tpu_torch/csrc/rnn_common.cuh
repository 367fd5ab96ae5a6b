// Pieces shared by the recurrent-layer kernels (gru_fwd.cu, gru_bwd.cu,
// lstm_fwd.cu, lstm_bwd.cu): the f32 input-projection GEMM of the forward
// kernels, the sigmoid, and the column staging of the backward step
// kernels.
#pragma once

#include "common.cuh"

namespace {

constexpr int GBM = 128, GBN = 128, GBK = 8;  // projection GEMM tile

// C[d] (M x N, f32) = A (M x K) @ W[d] (K x N); grid (N/GBN, M/GBM, D).
// A tiled SIMT GEMM (128 x 128 x 8 tiles, 8 x 8 per thread, f32 FMA), the
// f32 projection of K2 and K3 (no TF32); their bf16 projection runs on
// tensor cores (proj_mma.cuh).
__global__ void __launch_bounds__(256)
proj_gemm(const float* __restrict__ A, const float* __restrict__ W,
          float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[GBK][GBM];
  __shared__ __align__(16) float Bs[GBK][GBN];
  const float* Wd = W + static_cast<size_t>(blockIdx.z) * K * N;
  float* Cd = C + static_cast<size_t>(blockIdx.z) * M * N;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GBK) {
#pragma unroll
    for (int i = tid; i < GBM * GBK; i += 256) {
      const int r = i / GBK, c = i % GBK;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? A[static_cast<size_t>(m) * K + k] : 0.f;
    }
#pragma unroll
    for (int i = tid; i < GBK * GBN; i += 256) {
      const int r = i / GBN, c = i % GBN;
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < K && n < N) ? Wd[static_cast<size_t>(k) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (n < N) Cd[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

// Launch proj_gemm for the (D, M, N) f32 projection stream of x (M x K).
inline cudaError_t launch_proj_gemm(const float* x, const float* w, float* c,
                                    int M, int N, int K, int D,
                                    cudaStream_t stream) {
  const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM, D);
  proj_gemm<<<grid, 256, 0, stream>>>(x, w, c, M, N, K);
  return cudaGetLastError();
}

__device__ __forceinline__ float ds_sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The f32 backward step kernels stage 8 batch rows of a gate-gradient
// column side by side, so the dot reads them in two 16-byte loads.
constexpr int STAGE_ROWS = 8;

// The STAGE_ROWS staged values of one column, as f32.
__device__ __forceinline__ void load_column(const float* p,
                                            float v[STAGE_ROWS]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// Stores the STAGE_ROWS values of one column side by side (16-byte aligned).
__device__ __forceinline__ void store_column(float* p,
                                             const float v[STAGE_ROWS]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

}  // namespace
