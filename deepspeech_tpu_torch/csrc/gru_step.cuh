// The f32 GRU recurrence of K2 (gru_fwd.cu, on its f32 projection
// scratch) and K4 (gru_scan.cu, on its f32 projection): the r, z, n gates
// with f32 state and f32 gate math, both biases added in f32 and b_hn
// inside the r *, torch gate order. In bf16 both run rnn_mma.cuh instead.
//
//  * gru_step: one launch per time step covering both directions. A block
//    owns TJ hidden units of one direction for RB batch rows, so its shared
//    memory does not grow with B: it stages those rows of h_prev (a thread
//    a column, with no division in the loop), splits the H-long dots over
//    KS thread groups that read their W_hh rows from global memory (L2),
//    reduces the partial sums through shared memory and applies the gate
//    update. The backward direction indexes t = len_b - 1 - s directly;
//    steps past a row's length keep its state and write zeros. h
//    ping-pongs between two state buffers. The bf16 recurrences' tensor-
//    core steps, persistent variants and W_hh held in shared memory are
//    rnn_mma.cuh's.
#pragma once

#include "rnn_common.cuh"

namespace {

constexpr int TJ = 16;   // hidden units per recurrence block
constexpr int KS = 16;   // thread groups splitting each H-long dot
constexpr int RB = 8;    // batch rows per recurrence block
constexpr int STEP_THREADS = TJ * KS;

// One time step s for both directions; grid (ceil(H/TJ), ceil(B/RB), D).
// xp (D, T, B, 3H) without b_ih; w_hh (D, H, 3H); b_ih, b_hh (D, 3H);
// lens (B) int32; h_in/h_out (D, B, H); out (D, T, B, H); g_out
// (D, T, B, 3H) and hn_out (D, T, B, H), or both null; all but lens f32.
__global__ void __launch_bounds__(STEP_THREADS)
gru_step(const float* __restrict__ xp, const float* __restrict__ w_hh,
         const float* __restrict__ b_ih, const float* __restrict__ b_hh,
         const int* __restrict__ lens, const float* __restrict__ h_in,
         float* __restrict__ h_out, float* __restrict__ out,
         float* __restrict__ g_out, float* __restrict__ hn_out, int s,
         int Tn, int B, int H) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  float* hs = smem;                  // (RB, H): h_prev
  float* red = smem + RB * H;        // (KS, 3, RB, TJ) partial sums
  const int d = blockIdx.z;
  const int j0 = blockIdx.x * TJ;
  const int b0 = blockIdx.y * RB;
  const float* hprev = h_in + static_cast<size_t>(d) * B * H;
  float* hnew = h_out + static_cast<size_t>(d) * B * H;
  const float* wd = w_hh + static_cast<size_t>(d) * H * G;
  const int tid = threadIdx.x;

  // a thread stages one column a pass: RB independent row loads, no division
  const int nrows = min(RB, B - b0);
  for (int k = tid; k < H; k += STEP_THREADS) {
    float v[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r)
      v[r] = r < nrows ? hprev[(b0 + r) * H + k] : 0.f;
#pragma unroll
    for (int r = 0; r < RB; ++r) hs[r * H + k] = v[r];
  }
  __syncthreads();

  const int jl = tid % TJ, ks = tid / TJ;
  const int j = j0 + jl;
  float acc[3][RB];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[g][r] = 0.f;
  if (j < H) {
    // unrolled so that several W_hh loads from L2 are in flight at once
#pragma unroll 4
    for (int k = ks; k < H; k += KS) {
      const float* wk = wd + static_cast<size_t>(k) * G + j;
      const float wr = wk[0];
      const float wz = wk[H];
      const float wn = wk[2 * H];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float hv = hs[r * H + k];
        acc[0][r] = fmaf(hv, wr, acc[0][r]);
        acc[1][r] = fmaf(hv, wz, acc[1][r]);
        acc[2][r] = fmaf(hv, wn, acc[2][r]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int r = 0; r < RB; ++r)
      red[((ks * 3 + g) * RB + r) * TJ + jl] = acc[g][r];
  __syncthreads();

  if (tid < RB * TJ) {
    const int r = tid / TJ, jl2 = tid % TJ;
    const int b = b0 + r, jj = j0 + jl2;
    if (b < B && jj < H) {
      float hr = 0.f, hz = 0.f, hn = 0.f;
      for (int q = 0; q < KS; ++q) {
        hr += red[((q * 3 + 0) * RB + r) * TJ + jl2];
        hz += red[((q * 3 + 1) * RB + r) * TJ + jl2];
        hn += red[((q * 3 + 2) * RB + r) * TJ + jl2];
      }
      const float* bh = b_hh + d * G;
      hr += bh[jj];
      hz += bh[H + jj];
      hn += bh[2 * H + jj];
      const int len = lens[b];
      const bool valid = s < len;
      const int t = (d == 0 || !valid) ? s : len - 1 - s;
      const float hp = hprev[b * H + jj];
      const size_t row = (static_cast<size_t>(d) * Tn + t) * B + b;
      float* o = out + row * H + jj;
      float rg = 0.f, zg = 0.f, ng = 0.f;
      if (valid) {
        const float* xg = xp + row * G;
        const float* bi = b_ih + d * G;
        const float xr = xg[jj] + bi[jj];
        const float xz = xg[H + jj] + bi[H + jj];
        const float xn = xg[2 * H + jj] + bi[2 * H + jj];
        rg = ds_sigmoid(xr + hr);
        zg = ds_sigmoid(xz + hz);
        ng = tanhf(xn + rg * hn);
        const float h = (1.f - zg) * ng + zg * hp;
        hnew[b * H + jj] = h;
        *o = h;
      } else {
        hnew[b * H + jj] = hp;
        *o = 0.f;
        hn = 0.f;
      }
      if (g_out != nullptr) {
        float* gr = g_out + row * G + jj;
        gr[0] = rg;
        gr[H] = zg;
        gr[2 * H] = ng;
        hn_out[row * H + jj] = hn;
      }
    }
  }
}

// The Tn launches of gru_step after zeroing h; state (2, D, B, H) f32.
cudaError_t gru_recurrence(const float* xp, const float* w_hh,
                           const float* b_ih, const float* b_hh,
                           const int* lens, float* state, float* out,
                           float* g_out, float* hn_out, int Tn, int B, int H,
                           int D, cudaStream_t stream) {
  const size_t hsz = static_cast<size_t>(D) * B * H;
  cudaError_t err = cudaMemsetAsync(state, 0, hsz * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const size_t smem = (static_cast<size_t>(RB) * H + KS * 3 * RB * TJ) *
                      sizeof(float);
  err = cudaFuncSetAttribute(gru_step,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 sgrid((H + TJ - 1) / TJ, (B + RB - 1) / RB, D);
  for (int s = 0; s < Tn; ++s) {
    const float* h_in = state + (s & 1) * hsz;
    float* h_out = state + ((s + 1) & 1) * hsz;
    gru_step<<<sgrid, STEP_THREADS, smem, stream>>>(
        xp, w_hh, b_ih, b_hh, lens, h_in, h_out, out, g_out, hn_out, s, Tn,
        B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
