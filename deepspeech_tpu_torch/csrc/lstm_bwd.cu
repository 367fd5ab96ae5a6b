// LSTM layer backward through time, one or two directions.
//
// Replaces the Pallas TPU kernel deepspeech_tpu/ops/pallas/rnn_kernel.py
// (_lstm_bwd_kernel, launched by _lstm_bwd for the fused and unfused LSTM
// layers, the VJP of both). From the output grads and the forward's
// residuals (the activated gates g = (i, f, g, o) in the operand type T and
// the f32 cell stream c, written by csrc/lstm_fwd.cu) it computes, per
// step,
//   dh_tot = dout + dh_carried             tc = tanh(c_t)
//   do_pre = dh_tot tc o (1 - o)
//   dc_tot = dc_carried + dh_tot o (1 - tc^2)
//   di_pre = dc_tot g i (1 - i)            df_pre = dc_tot c_prev f (1 - f)
//   dg_pre = dc_tot i (1 - g^2)
//   dh_prev = [di, df, dg, do] @ W_hh^T    dc_prev = dc_tot f
// with the operand of the product rounded to T and the sum in f32. It
// writes dg = [di, df, dg, do] in T and the bias grad db = sum dg over
// (t, b), accumulated in f32 from the unrounded values; the LSTM has no
// GRU-style r term, so one dg stream serves both the x-side and the h-side
// gradients and db is the grad of both b_ih and b_hh. dW_hh, dW_ih and dx
// are large products the wrapper leaves to cuBLAS (ops/cuda/lstm.py), as
// the JAX package leaves them to XLA.
//
// The time walk mirrors K3's (lstm_fwd.cu indexes the backward direction at
// t = len - 1 - s): direction 0 walks t = T-1 .. 0 with c_prev = c[t-1]
// (0 at t = 0); direction 1 walks t = 0 .. T-1 with c_prev = c[t+1] when
// t + 1 < len, else 0. A step at t >= len writes dg = 0 and leaves the
// carried dh and dc as they were; its dout is never read.
//
// Bound on the H100 at the default shape (T 376, B 20, H 800, D 2): the
// recurrent product is 2 x 2 x 7,520 x 3,200 x 800 = 77 GFLOP, ~0.08 ms at
// the 989 TFLOP/s bf16 tensor-core peak; the streams it must move (dout
// and c f32 per direction, g and dg bf16, W_hh once) are ~300 MB, ~0.09 ms
// at 3.35 TB/s. So bytes bound it, and in this design latency does: the T
// steps depend on each other and each costs one launch.
//
// Design, bf16: rnn_mma_bwd.cuh, K5's (tensor-core steps on W_hh packed
// once a call by the wrapper and streamed once a step; the operand dg kept
// as a bf16 copy; one launch a step or one persistent cooperative launch),
// with four gates and the carried dc. chip_smoke.py and PERF.md record its
// times on the card.
//
// Design, f32 (K5's f32 design with four gates and a carried cell, simple
// and right first):
//  * bwd_first: the pointwise part of the first step, nothing carried.
//  * lstm_bwd_step, one launch per step s < T-1 for both directions: a
//    block owns TJ hidden units of one direction for RB batch rows. It
//    stages those rows of dg of step s (4H wide, read back from dg, which
//    holds exactly the operand) in shared memory, a thread a column
//    (RB row loads, then one store of the RB values side by side, so the
//    dot reads them in two 16-byte loads), splits the 4H-long
//    dots over KS thread groups that read W_hh^T from global memory (L2;
//    the wrapper passes the transpose so that neighbouring threads read
//    neighbouring units), reduces the partial sums through shared memory,
//    finishes dh_prev of step s and runs the pointwise part of step s + 1
//    at its units. The block owns the same carried dh and dc and the same
//    bias accumulator entries (per row) at every step, so no atomics are
//    needed, and dc never leaves its thread's entry.
//  * bias_reduce: one small final pass sums the accumulators over B.
#include "rnn_common.cuh"
#include "rnn_mma_bwd.cuh"

namespace {

constexpr int TJ = 16;   // hidden units per step block
constexpr int KS = 16;   // thread groups splitting each 4H-long dot
constexpr int RB = 8;    // batch rows per step block
constexpr int STEP_THREADS = TJ * KS;
static_assert(RB == STAGE_ROWS, "load_column reads RB rows");

struct BwdArgs {
  const float* dout;  // (D, T, B, H) f32
  const float* g;     // (D, T, B, 4H) f32: i, f, g, o
  const float* c;     // (D, T, B, H) f32, zero past each length
  const float* wt;    // (D, 4H, H) f32: W_hh transposed
  const int* lens;    // (B) int32
  float* dg;          // (D, T, B, 4H) f32 out
  float* acc;         // (D, B, 4H) f32: per-row db sums
  float* dh;          // (D, B, H) f32: carried dh past the length
  float* dc;          // (D, B, H) f32: carried dc
  int Tn, B, H;
};

__device__ __forceinline__ int walk_time(int d, int s, int Tn) {
  return d == 0 ? Tn - 1 - s : s;
}

// Pointwise part of step s at direction d, row b, unit k, given the carried
// dh. Writes dg at that step's time, adds to the bias accumulators and
// updates the carried dc; past the length it writes zeros and leaves dh_in
// in dh for the next launch.
__device__ __forceinline__ void bwd_point(const BwdArgs& a, int d, int b,
                                          int k, int s, float dh_in) {
  const int H = a.H, B = a.B, G = 4 * H;
  const int t = walk_time(d, s, a.Tn);
  const int len = a.lens[b];
  const size_t row = (static_cast<size_t>(d) * a.Tn + t) * B + b;
  const size_t e = (static_cast<size_t>(d) * B + b) * H + k;
  float* dgr = a.dg + row * G + k;
  if (t >= len) {
    dgr[0] = dgr[H] = dgr[2 * H] = dgr[3 * H] = 0.f;
    a.dh[e] = dh_in;
    return;
  }
  const float dh_tot = a.dout[row * H + k] + dh_in;
  const float* gr = a.g + row * G + k;
  const float i = gr[0];
  const float f = gr[H];
  const float gg = gr[2 * H];
  const float o = gr[3 * H];
  float cp = 0.f;
  if (d == 0) {
    if (t > 0) cp = a.c[(row - B) * H + k];
  } else if (t + 1 < len) {
    cp = a.c[(row + B) * H + k];
  }
  const float tc = tanhf(a.c[row * H + k]);
  const float do_pre = dh_tot * tc * o * (1.f - o);
  const float dc_tot = a.dc[e] + dh_tot * o * (1.f - tc * tc);
  const float di_pre = dc_tot * gg * i * (1.f - i);
  const float df_pre = dc_tot * cp * f * (1.f - f);
  const float dg_pre = dc_tot * i * (1.f - gg * gg);
  dgr[0] = di_pre;
  dgr[H] = df_pre;
  dgr[2 * H] = dg_pre;
  dgr[3 * H] = do_pre;
  const size_t ae = (static_cast<size_t>(d) * B + b) * G + k;
  a.acc[ae] += di_pre;
  a.acc[ae + H] += df_pre;
  a.acc[ae + 2 * H] += dg_pre;
  a.acc[ae + 3 * H] += do_pre;
  a.dc[e] = dc_tot * f;
}

// The first step (s = 0) with nothing carried; grid (ceil(H/256), B, D).
__global__ void __launch_bounds__(256) bwd_first(BwdArgs a) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < a.H) bwd_point(a, blockIdx.z, blockIdx.y, k, 0, 0.f);
}

// dh_prev of step s, then the pointwise part of step s + 1;
// grid (ceil(H/TJ), ceil(B/RB), D).
__global__ void __launch_bounds__(STEP_THREADS)
lstm_bwd_step(BwdArgs a, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = a.H, B = a.B, G = 4 * H;
  float* ds = reinterpret_cast<float*>(smem_raw);  // (4H, RB)
  float* red = reinterpret_cast<float*>(
      smem_raw + ((static_cast<size_t>(RB) * G * sizeof(float) + 15) & ~15));
  const int d = blockIdx.z;
  const int j0 = blockIdx.x * TJ;
  const int b0 = blockIdx.y * RB;
  const int t = walk_time(d, s, a.Tn);
  const int tid = threadIdx.x;

  // a thread stages one column a pass: RB independent row loads, coalesced
  // across the warp, then one vector store of the RB values side by side
  const size_t row0 = (static_cast<size_t>(d) * a.Tn + t) * B + b0;
  const int nrows = min(RB, B - b0);
  for (int c = tid; c < G; c += STEP_THREADS) {
    const float* src = a.dg + row0 * G + c;
    float v[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r)
      v[r] = r < nrows ? src[static_cast<size_t>(r) * G] : 0.f;
    store_column(ds + c * RB, v);
  }
  __syncthreads();

  const int jl = tid % TJ, ks = tid / TJ;
  const int k = j0 + jl;
  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.f;
  if (k < H) {
    const float* wd = a.wt + static_cast<size_t>(d) * G * H;
    const size_t hh = static_cast<size_t>(H) * H;
    // one column of each gate block an iteration: four independent loads
    // from L2, unrolled so that sixteen are in flight, as in K2's loop
#pragma unroll 4
    for (int c = ks; c < H; c += KS) {
      const float* wc = wd + static_cast<size_t>(c) * H + k;
      const float w0 = wc[0];
      const float w1 = wc[hh];
      const float w2 = wc[2 * hh];
      const float w3 = wc[3 * hh];
      float v0[RB], v1[RB], v2[RB], v3[RB];
      load_column(ds + c * RB, v0);
      load_column(ds + (c + H) * RB, v1);
      load_column(ds + (c + 2 * H) * RB, v2);
      load_column(ds + (c + 3 * H) * RB, v3);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        acc[r] = fmaf(v0[r], w0, acc[r]);
        acc[r] = fmaf(v1[r], w1, acc[r]);
        acc[r] = fmaf(v2[r], w2, acc[r]);
        acc[r] = fmaf(v3[r], w3, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) red[(ks * RB + r) * TJ + jl] = acc[r];
  __syncthreads();

  if (tid < RB * TJ) {
    const int r = tid / TJ, jl2 = tid % TJ;
    const int b = b0 + r, kk = j0 + jl2;
    if (b < B && kk < H) {
      float sum = 0.f;
      for (int q = 0; q < KS; ++q) sum += red[(q * RB + r) * TJ + jl2];
      const size_t e = (static_cast<size_t>(d) * B + b) * H + kk;
      const float dh_new = t < a.lens[b] ? sum : a.dh[e];
      bwd_point(a, d, b, kk, s + 1, dh_new);
    }
  }
}

// db (D, 4H) = the accumulators summed over B.
__global__ void bias_reduce(const float* __restrict__ acc,
                            float* __restrict__ db, int D, int B, int G) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D * G) return;
  const int d = i / G, c = i % G;
  float sum = 0.f;
  for (int b = 0; b < B; ++b)
    sum += acc[(static_cast<size_t>(d) * B + b) * G + c];
  db[i] = sum;
}

int lstm_bwd(const BwdArgs& a, int D, float* db, cudaStream_t stream) {
  const int H = a.H, B = a.B, G = 4 * H;
  const size_t acc_bytes = static_cast<size_t>(D) * B * G * sizeof(float);
  const size_t st_bytes = static_cast<size_t>(D) * B * H * sizeof(float);
  cudaError_t err = cudaMemsetAsync(a.acc, 0, acc_bytes, stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.dc, 0, st_bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_first<<<dim3((H + 255) / 256, B, D), 256, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem =
      ((static_cast<size_t>(RB) * G * sizeof(float) + 15) & ~15) +
      static_cast<size_t>(KS) * RB * TJ * sizeof(float);
  err = cudaFuncSetAttribute(lstm_bwd_step,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + TJ - 1) / TJ, (B + RB - 1) / RB, D);
  for (int s = 0; s + 1 < a.Tn; ++s) {
    lstm_bwd_step<<<grid, STEP_THREADS, smem, stream>>>(a, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bias_reduce<<<(D * G + 255) / 256, 256, 0, stream>>>(a.acc, db, D, B, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dout, c (D, T, B, H); g (D, T, B, 4H) and wt = W_hh^T (D, 4H, H); lens
// (B) int32 <= T; out dg (D, T, B, 4H) and db (D, 4H); scratch of
// D * B * 4H + 2 * D * B * H entries; all but lens f32.
DS_EXPORT int lstm_bwd_f32(const float* dout, const float* g, const float* c,
                           const float* wt, const int* lens, float* dg,
                           float* scratch, float* db, int Tn, int B, int H,
                           int D, void* stream) {
  const size_t acc = static_cast<size_t>(D) * B * 4 * H;
  const size_t st = static_cast<size_t>(D) * B * H;
  const BwdArgs a{dout, g, c, wt, lens, dg, scratch, scratch + acc,
                  scratch + acc + st, Tn, B, H};
  return lstm_bwd(a, D, db, static_cast<cudaStream_t>(stream));
}

// bf16: w_pk is W_hh packed (D, NJ, NK, 64, 128) (rnn_mma_bwd.cuh);
// scratch op (2, D, B8, NK * 128) bf16, bar (1) uint32 and state
// (6, D, B, H) f32, all zeroed here; variant 1 (one launch a step) or 2
// (persistent). Other arguments as the f32 entry.
DS_EXPORT int lstm_bwd_bf16(const float* dout, const __nv_bfloat16* g,
                            const float* c, const __nv_bfloat16* w_pk,
                            const int* lens, __nv_bfloat16* dg,
                            __nv_bfloat16* op, unsigned* bar, float* state,
                            float* db, int Tn, int B, int H, int D,
                            int variant, void* stream) {
  const int nk = (4 * H + mma_bwd::KC - 1) / mma_bwd::KC;
  const mma_bwd::Args a{dout, g, nullptr, c, w_pk, lens, dg, nullptr, op,
                        bar, state, Tn, B, H, (B + 7) / 8 * 8,
                        nk * mma_bwd::KC, nk,
                        (H + mma_bwd::TM - 1) / mma_bwd::TM};
  return static_cast<int>(mma_bwd::backward<4>(
      a, D, variant, db, nullptr, static_cast<cudaStream_t>(stream)));
}

// The blocks of the bf16 persistent kernel that can be resident at once
// for a batch of B rows, into *blocks.
DS_EXPORT int lstm_bwd_resident(int B, int* blocks) {
  return static_cast<int>(
      mma_bwd::resident_of<4>((B + 7) / 8 * 8, blocks));
}
