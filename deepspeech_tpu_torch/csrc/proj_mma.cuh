// The input projection of K2 (gru_fwd.cu) and K3 (lstm_fwd.cu) in bf16, on
// tensor cores: C[d] (M x N, f32) = A (M x K) @ W[d] (K x N) with A = x
// (T * B, F) and W = w_ih (D, F, G * H), both bf16 and row-major. The sums
// are f32 and C is written unrounded: the f32 stream the recurrence reads,
// as the TPU kernel's f32 xp scratch holds it (rnn_fused.py). It is not
// cuBLAS: the TPU kernel computes this product in its own body.
//
// Bound (H100 SXM, 989 TFLOP/s bf16 dense): the default layer 0 (M 7,520,
// N 2,400 (GRU) or 3,200 (LSTM), K 1,312, D 2) is 94.7 or 126 GFLOP,
// ~0.10-0.13 ms; its bytes (x once, W once, C once in f32: ~165-220 MB)
// take ~0.05-0.07 ms. So it is bound by operations.
//
// Design: output tiles of BM 128 x BN 128, K in chunks of BK 32 through a
// STAGES-deep cp.async ring in shared memory, 8 warps of 64 x 32 each (2
// along M, 4 along N), mma.sync.m16n8k16 with bf16 operands and f32
// accumulators (rnn_mma.cuh's helpers). The A tile is read by ldmatrix,
// the W tile (K x N, row-major) by ldmatrix.trans, which gives the
// column-major B fragment. Row pitches of BK + 8 and BN + 8 elements (80
// and 272 bytes) put the 8 rows of one ldmatrix on distinct banks.
// Ragged edges: where a row is a whole number of 16-byte pieces (K, or N,
// a multiple of 8 and the base 16-byte aligned) each piece is wholly inside
// or outside the matrix and goes by cp.async, with zero source bytes (a
// zero fill) outside; otherwise the tile is staged element by element.
#pragma once

#include <cstdint>

#include "rnn_mma.cuh"

namespace proj_mma {

using mma_rnn::cp_async_commit;
using mma_rnn::cp_async_wait;
using mma_rnn::ldmatrix_x4;
using mma_rnn::mma_bf16;
using mma_rnn::smem_addr;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int AP = BK + 8;  // A row pitch (elements)
constexpr int WP = BN + 8;  // W row pitch (elements)
constexpr int STAGE = BM * AP + BK * WP;  // bf16 elements a stage
constexpr size_t SMEM = size_t(STAGES) * STAGE * 2;

// A 16-byte copy into shared memory; `in` false copies no source bytes and
// fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16_fill(unsigned dst,
                                                const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) of the row-major
// (nrows x ncols) matrix src into dst (pitch P), zero outside the matrix.
template <int ROWS, int COLS, int P>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src,
                                          __nv_bfloat16* dst, int nrows,
                                          int ncols, int r0, int c0,
                                          bool vec) {
  constexpr int PIECES = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * PIECES; i += THREADS) {
    const int r = i / PIECES, c = (i % PIECES) * 8;
    const int row = r0 + r, col = c0 + c;
    __nv_bfloat16* d = dst + r * P + c;
    if (vec) {
      const bool in = row < nrows && col < ncols;
      cp_async16_fill(smem_addr(d),
                      in ? src + static_cast<size_t>(row) * ncols + col : src,
                      in);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (row < nrows && col + e < ncols)
                   ? src[static_cast<size_t>(row) * ncols + col + e]
                   : __float2bfloat16(0.f);
    }
  }
}

// Grid (ceil(N / BN), ceil(M / BM), D); vec_a, vec_w: the rows of A, W are
// whole 16-byte pieces.
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const __nv_bfloat16* __restrict__ A,
            const __nv_bfloat16* __restrict__ W, float* __restrict__ C,
            int M, int N, int K, bool vec_a, bool vec_w) {
  extern __shared__ __align__(16) char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const __nv_bfloat16* Wd = W + static_cast<size_t>(blockIdx.z) * K * N;
  float* Cd = C + static_cast<size_t>(blockIdx.z) * M * N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, wn = warp >> 1;  // rows wm * 64, cols wn * 32
  const int nkt = (K + BK - 1) / BK;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load_stage = [&](int kt) {
    __nv_bfloat16* st = ring + (kt % STAGES) * STAGE;
    load_tile<BM, BK, AP>(A, st, M, K, m0, kt * BK, vec_a);
    load_tile<BK, BN, WP>(Wd, st + BM * AP, K, N, kt * BK, n0, vec_w);
  };
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nkt) load_stage(i);
    cp_async_commit();
  }
  // ldmatrix addresses: lane l gives row l & 7 of matrix l >> 3
  const int q = lane >> 3, r8 = lane & 7;
  const int a_off = (wm * 64 + (q & 1) * 8 + r8) * AP + (q >> 1) * 8;
  const int w_off = BM * AP + ((q & 1) * 8 + r8) * WP + wn * 32
                    + (q >> 1) * 8;
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nkt) load_stage(kt + STAGES - 1);
    cp_async_commit();
    const unsigned st = smem_addr(ring + (kt % STAGES) * STAGE);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[4][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], st + 2 * (a_off + i * 16 * AP + kk));
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(bf[j], st + 2 * (w_off + kk * WP + j * 16));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(acc[i][2 * j], af[i], bf[j][0], bf[j][1]);
          mma_bf16(acc[i][2 * j + 1], af[i], bf[j][2], bf[j][3]);
        }
    }
  }
  cp_async_wait<0>();

  const int gid = lane >> 2, tig = lane & 3;
  const bool pairs = (N & 1) == 0;  // (m, n), (m, n + 1) 8-byte aligned
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + i * 16 + gid + h * 8;
        if (m >= M || n >= N) continue;
        float* c = Cd + static_cast<size_t>(m) * N + n;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(c) = make_float2(v0, v1);
        } else {
          c[0] = v0;
          if (n + 1 < N) c[1] = v1;
        }
      }
    }
}

// C (D, M, N) f32 = A (M, K) @ W (D, K, N), bf16 operands.
inline cudaError_t launch(const __nv_bfloat16* A, const __nv_bfloat16* W,
                          float* C, int M, int N, int K, int D,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  const bool vec_a = K % 8 == 0
                     && reinterpret_cast<std::uintptr_t>(A) % 16 == 0;
  const bool vec_w = N % 8 == 0
                     && reinterpret_cast<std::uintptr_t>(W) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, D);
  gemm_kernel<<<grid, THREADS, SMEM, stream>>>(A, W, C, M, N, K, vec_a,
                                               vec_w);
  return cudaGetLastError();
}

}  // namespace proj_mma
