// The f32 LSTM recurrence of K3 (lstm_fwd.cu, on its f32 projection
// scratch) and K6 (lstm_scan.cu, on its f32 projection): torch gate order
// i, f, g, o with f32 state h and c, both biases added in f32 and f32
// gates. In bf16 both run rnn_mma.cuh instead.
//
//  * lstm_step: one launch per time step covering both directions. A block
//    owns TJ hidden units of one direction for RB batch rows and computes
//    all four gate columns of those units, so the c update stays inside the
//    block: c lives in a state buffer that only its owning block (and
//    thread) reads and writes, updated in place. The block stages those
//    rows of h_prev (a thread a column), splits the H-long dots over KS
//    thread groups that read their W_hh rows from global memory (L2),
//    reduces the partial sums through shared memory and applies the gate
//    update. The backward direction indexes t = len_b - 1 - s directly;
//    steps past a row's length keep its state and write zeros. h
//    ping-pongs between two state buffers, since every block reads all of
//    h_prev.
#pragma once

#include "rnn_common.cuh"

namespace {

constexpr int TJ = 16;   // hidden units per recurrence block
constexpr int KS = 16;   // thread groups splitting each H-long dot
constexpr int RB = 8;    // batch rows per recurrence block
constexpr int STEP_THREADS = TJ * KS;

// One time step s for both directions; grid (ceil(H/TJ), ceil(B/RB), D).
// xp (D, T, B, 4H) without b_ih; w_hh (D, H, 4H); b_ih, b_hh (D, 4H);
// lens (B) int32; h_in/h_out (D, B, H); c_state (D, B, H), updated in
// place; out (D, T, B, H); c_out (D, T, B, H) and g_out (D, T, B, 4H), or
// both null; all but lens f32.
__global__ void __launch_bounds__(STEP_THREADS)
lstm_step(const float* __restrict__ xp, const float* __restrict__ w_hh,
          const float* __restrict__ b_ih, const float* __restrict__ b_hh,
          const int* __restrict__ lens, const float* __restrict__ h_in,
          float* __restrict__ h_out, float* __restrict__ c_state,
          float* __restrict__ out, float* __restrict__ c_out,
          float* __restrict__ g_out, int s, int Tn, int B, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* hs = smem;                  // (RB, H): h_prev
  float* red = smem + RB * H;        // (KS, 4, RB, TJ) partial sums
  const int d = blockIdx.z;
  const int j0 = blockIdx.x * TJ;
  const int b0 = blockIdx.y * RB;
  const float* hprev = h_in + static_cast<size_t>(d) * B * H;
  float* hnew = h_out + static_cast<size_t>(d) * B * H;
  float* cst = c_state + static_cast<size_t>(d) * B * H;
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
  float acc[4][RB];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[g][r] = 0.f;
  if (j < H) {
    // unrolled so that several W_hh loads from L2 are in flight at once
#pragma unroll 4
    for (int k = ks; k < H; k += KS) {
      const float* wk = wd + static_cast<size_t>(k) * G + j;
      const float wi = wk[0];
      const float wf = wk[H];
      const float wg = wk[2 * H];
      const float wo = wk[3 * H];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float hv = hs[r * H + k];
        acc[0][r] = fmaf(hv, wi, acc[0][r]);
        acc[1][r] = fmaf(hv, wf, acc[1][r]);
        acc[2][r] = fmaf(hv, wg, acc[2][r]);
        acc[3][r] = fmaf(hv, wo, acc[3][r]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < RB; ++r)
      red[((ks * 4 + g) * RB + r) * TJ + jl] = acc[g][r];
  __syncthreads();

  if (tid < RB * TJ) {
    const int r = tid / TJ, jl2 = tid % TJ;
    const int b = b0 + r, jj = j0 + jl2;
    if (b < B && jj < H) {
      float hg[4] = {0.f, 0.f, 0.f, 0.f};
      for (int q = 0; q < KS; ++q)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          hg[g] += red[((q * 4 + g) * RB + r) * TJ + jl2];
      const float* bh = b_hh + d * G;
#pragma unroll
      for (int g = 0; g < 4; ++g) hg[g] += bh[g * H + jj];
      const int len = lens[b];
      const bool valid = s < len;
      const int t = (d == 0 || !valid) ? s : len - 1 - s;
      const size_t e = static_cast<size_t>(b) * H + jj;
      const size_t row = (static_cast<size_t>(d) * Tn + t) * B + b;
      float ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f, c = 0.f, h = 0.f;
      if (valid) {
        const float* xg = xp + row * G;
        const float* bi = b_ih + d * G;
        // (x @ W_ih + b_ih) + (h @ W_hh + b_hh), as the plain version sums
        ig = ds_sigmoid((xg[jj] + bi[jj]) + hg[0]);
        fg = ds_sigmoid((xg[H + jj] + bi[H + jj]) + hg[1]);
        gg = tanhf((xg[2 * H + jj] + bi[2 * H + jj]) + hg[2]);
        og = ds_sigmoid((xg[3 * H + jj] + bi[3 * H + jj]) + hg[3]);
        c = fg * cst[e] + ig * gg;
        h = og * tanhf(c);
        cst[e] = c;
        hnew[e] = h;
      } else {
        hnew[e] = hprev[e];
      }
      out[row * H + jj] = h;
      if (g_out != nullptr) {
        c_out[row * H + jj] = c;
        float* gr = g_out + row * G + jj;
        gr[0] = ig;
        gr[H] = fg;
        gr[2 * H] = gg;
        gr[3 * H] = og;
      }
    }
  }
}

// The Tn launches of lstm_step after zeroing h and c; state (3, D, B, H)
// f32: h ping-pongs between [0] and [1], [2] holds c.
cudaError_t lstm_recurrence(const float* xp, const float* w_hh,
                            const float* b_ih, const float* b_hh,
                            const int* lens, float* state, float* out,
                            float* c_out, float* g_out, int Tn, int B, int H,
                            int D, cudaStream_t stream) {
  const size_t hsz = static_cast<size_t>(D) * B * H;
  float* c_state = state + 2 * hsz;
  cudaError_t err = cudaMemsetAsync(state, 0, hsz * sizeof(float), stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(c_state, 0, hsz * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const size_t smem = (static_cast<size_t>(RB) * H + KS * 4 * RB * TJ) *
                      sizeof(float);
  err = cudaFuncSetAttribute(lstm_step,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 sgrid((H + TJ - 1) / TJ, (B + RB - 1) / RB, D);
  for (int s = 0; s < Tn; ++s) {
    const float* h_in = state + (s & 1) * hsz;
    float* h_out = state + ((s + 1) & 1) * hsz;
    lstm_step<<<sgrid, STEP_THREADS, smem, stream>>>(
        xp, w_hh, b_ih, b_hh, lens, h_in, h_out, c_state, out, c_out, g_out,
        s, Tn, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
