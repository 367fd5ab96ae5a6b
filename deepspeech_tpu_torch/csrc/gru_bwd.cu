// GRU layer backward through time, one or two directions.
//
// Replaces the Pallas TPU kernel deepspeech_tpu/ops/pallas/rnn_kernel.py
// (_gru_bwd_kernel, launched by _gru_bwd for the fused and unfused GRU
// layers). From the output grads and the forward's residuals (the gate
// stream g = (r, z, n) and hn, both in the operand type T, written by
// csrc/gru_fwd.cu, and the f32 outputs h) it computes, per step,
//   dh_tot = dout + dh_carried
//   dn_pre = dh_tot (1 - z)(1 - n^2)      dz_pre = dh_tot (h_prev - n) z (1 - z)
//   dr_pre = dn_pre hn r (1 - r)          dnh    = dn_pre r
//   dh_prev = dh_tot z + [dr, dz, dnh] @ W_hh^T
// with the operand of the product rounded to T and the sum in f32. It
// writes dg = [dr, dz, dn] and dnh in T, and the bias grads dbi = sum dg and
// dbh = sum [dr, dz, dnh] over (t, b), accumulated in f32 from the unrounded
// values. dW_hh, dW_ih and dx are large products the wrapper leaves to
// cuBLAS (ops/cuda/gru.py), as the JAX package leaves them to XLA.
//
// The time walk mirrors K2's (gru_fwd.cu indexes the backward direction at
// t = len - 1 - s): direction 0 walks t = T-1 .. 0 with h_prev = h[t-1]
// (0 at t = 0); direction 1 walks t = 0 .. T-1 with h_prev = h[t+1] when
// t + 1 < len, else 0. A step at t >= len writes dg = 0 and dnh = 0 and
// leaves the carried dh as it was; its dout is never read.
//
// Bound on the H100 at the default shape (T 376, B 20, H 800, D 2): the
// recurrent product is 2 x 2 x 7,520 x 2,400 x 800 = 58 GFLOP, ~0.06 ms at
// the 989 TFLOP/s bf16 tensor-core peak; the streams it must move (dout and
// h f32 per direction, g, hn, dg and dnh bf16, W_hh once) are ~300 MB,
// ~0.09 ms at 3.35 TB/s. So bytes bound it, and in this design latency
// does: the T steps depend on each other and each costs one launch
// (chip_smoke.py measures this kernel at the least work, B 1, H 16, at
// ~4.3-5.2 us a step).
//
// Design, bf16: rnn_mma_bwd.cuh (tensor-core steps on W_hh packed once a
// call by the wrapper and streamed once a step; the operand [dr, dz, dnh]
// kept as a bf16 copy; one launch a step or one persistent cooperative
// launch). chip_smoke.py and PERF.md record its times on the card beside
// the bound and the per-step L2 floor.
//
// Design, f32 (K2's mirror, simple and right first):
//  * bwd_first: the pointwise part of the first step, dh_carried = 0.
//  * bwd_step, one launch per step s < T-1 for both directions: a block owns
//    TJ hidden units of one direction for RB batch rows. It stages those
//    rows of [dr, dz, dnh] of step s (3H wide, read back from dg and dnh,
//    which hold exactly the operand) in shared memory, a thread a
//    column (RB row loads, then the RB values side by side in one store,
//    so the dot reads them in two 16-byte loads; the earlier
//    element-wise staging, with a division and a modulo an element, took
//    a third of the step), splits the 3H-long dots over KS
//    thread groups that read W_hh^T from global memory
//    (L2; the wrapper passes the transpose so that neighbouring threads read
//    neighbouring units), reduces the partial sums through shared memory,
//    finishes dh_prev of step s and runs the pointwise part of step s + 1 at
//    its units. The block owns the same carried dh and the same bias
//    accumulator entries (per row) at every step, so no atomics are needed.
//  * bias_reduce: one small final pass sums the accumulators over B.
// chip_smoke.py and PERF.md record its times on the card.
#include "rnn_common.cuh"
#include "rnn_mma_bwd.cuh"

namespace {

constexpr int TJ = 16;   // hidden units per step block
constexpr int KS = 16;   // thread groups splitting each 3H-long dot
constexpr int RB = 8;    // batch rows per step block
constexpr int STEP_THREADS = TJ * KS;
static_assert(RB == STAGE_ROWS, "load_column reads RB rows");

struct BwdArgs {
  const float* dout;  // (D, T, B, H) f32
  const float* g;     // (D, T, B, 3H) f32
  const float* hn;    // (D, T, B, H) f32
  const float* h;     // (D, T, B, H) f32, zero past each length
  const float* wt;    // (D, 3H, H) f32: W_hh transposed
  const int* lens;    // (B) int32
  float* dg;          // (D, T, B, 3H) f32 out
  float* dnh;         // (D, T, B, H) f32 out
  float* acc_i;       // (D, B, 3H) f32: per-row dbi sums
  float* acc_h;       // (D, B, 3H) f32: per-row dbh sums
  float* dh;          // (D, B, H) f32: carried dh past the length
  float* dhz;         // (D, B, H) f32: dh_tot * z of the pending step
  int Tn, B, H;
};

__device__ __forceinline__ int walk_time(int d, int s, int Tn) {
  return d == 0 ? Tn - 1 - s : s;
}

// Pointwise part of step s at direction d, row b, unit k, given the carried
// dh. Writes dg and dnh at that step's time, adds to the bias accumulators,
// and leaves dh_tot * z (valid step) or the carried dh (past the length)
// for the next launch.
__device__ __forceinline__ void bwd_point(const BwdArgs& a, int d, int b,
                                          int k, int s, float dh_in) {
  const int H = a.H, B = a.B, G = 3 * H;
  const int t = walk_time(d, s, a.Tn);
  const int len = a.lens[b];
  const size_t row = (static_cast<size_t>(d) * a.Tn + t) * B + b;
  const size_t e = (static_cast<size_t>(d) * B + b) * H + k;
  float* dgr = a.dg + row * G + k;
  float* dnhr = a.dnh + row * H + k;
  if (t >= len) {
    dgr[0] = dgr[H] = dgr[2 * H] = 0.f;
    *dnhr = 0.f;
    a.dh[e] = dh_in;
    return;
  }
  const float dh_tot = a.dout[row * H + k] + dh_in;
  const float* gr = a.g + row * G + k;
  const float r = gr[0];
  const float z = gr[H];
  const float n = gr[2 * H];
  const float hnv = a.hn[row * H + k];
  float hp = 0.f;
  if (d == 0) {
    if (t > 0) hp = a.h[(row - B) * H + k];
  } else if (t + 1 < len) {
    hp = a.h[(row + B) * H + k];
  }
  const float dn_pre = dh_tot * (1.f - z) * (1.f - n * n);
  const float dz_pre = dh_tot * (hp - n) * z * (1.f - z);
  const float dr_pre = dn_pre * hnv * r * (1.f - r);
  const float dnhv = dn_pre * r;
  dgr[0] = dr_pre;
  dgr[H] = dz_pre;
  dgr[2 * H] = dn_pre;
  *dnhr = dnhv;
  const size_t ae = (static_cast<size_t>(d) * B + b) * G + k;
  a.acc_i[ae] += dr_pre;
  a.acc_i[ae + H] += dz_pre;
  a.acc_i[ae + 2 * H] += dn_pre;
  a.acc_h[ae] += dr_pre;
  a.acc_h[ae + H] += dz_pre;
  a.acc_h[ae + 2 * H] += dnhv;
  a.dhz[e] = dh_tot * z;
}

// The first step (s = 0) with nothing carried; grid (ceil(H/256), B, D).
__global__ void __launch_bounds__(256) bwd_first(BwdArgs a) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < a.H) bwd_point(a, blockIdx.z, blockIdx.y, k, 0, 0.f);
}

// dh_prev of step s, then the pointwise part of step s + 1;
// grid (ceil(H/TJ), ceil(B/RB), D).
__global__ void __launch_bounds__(STEP_THREADS) bwd_step(BwdArgs a, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = a.H, B = a.B, G = 3 * H;
  float* ds = reinterpret_cast<float*>(smem_raw);  // (3H, RB)
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
    const bool gate = c < 2 * H;
    const float* src =
        gate ? a.dg + row0 * G + c : a.dnh + row0 * H + (c - 2 * H);
    const int stride = gate ? G : H;
    float v[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r)
      v[r] = r < nrows ? src[r * stride] : 0.f;
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
    // one column of each gate block an iteration: three independent loads
    // from L2, unrolled so that twelve are in flight, as in K2's loop
#pragma unroll 4
    for (int c = ks; c < H; c += KS) {
      const float* wc = wd + static_cast<size_t>(c) * H + k;
      const float w0 = wc[0];
      const float w1 = wc[static_cast<size_t>(H) * H];
      const float w2 = wc[static_cast<size_t>(2 * H) * H];
      float v0[RB], v1[RB], v2[RB];
      load_column(ds + c * RB, v0);
      load_column(ds + (c + H) * RB, v1);
      load_column(ds + (c + 2 * H) * RB, v2);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        acc[r] = fmaf(v0[r], w0, acc[r]);
        acc[r] = fmaf(v1[r], w1, acc[r]);
        acc[r] = fmaf(v2[r], w2, acc[r]);
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
      const float dh_new = t < a.lens[b] ? a.dhz[e] + sum : a.dh[e];
      bwd_point(a, d, b, kk, s + 1, dh_new);
    }
  }
}

// dbi, dbh (D, 3H) = the accumulators summed over B.
__global__ void bias_reduce(const float* __restrict__ acc_i,
                            const float* __restrict__ acc_h,
                            float* __restrict__ dbi, float* __restrict__ dbh,
                            int D, int B, int G) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D * G) return;
  const int d = i / G, c = i % G;
  float si = 0.f, sh = 0.f;
  for (int b = 0; b < B; ++b) {
    const size_t e = (static_cast<size_t>(d) * B + b) * G + c;
    si += acc_i[e];
    sh += acc_h[e];
  }
  dbi[i] = si;
  dbh[i] = sh;
}

int gru_bwd(const BwdArgs& a, int D, float* dbi, float* dbh,
            cudaStream_t stream) {
  const int H = a.H, B = a.B, G = 3 * H;
  const size_t acc_bytes = static_cast<size_t>(D) * B * G * sizeof(float);
  cudaError_t err = cudaMemsetAsync(a.acc_i, 0, acc_bytes, stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.acc_h, 0, acc_bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_first<<<dim3((H + 255) / 256, B, D), 256, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem =
      ((static_cast<size_t>(RB) * G * sizeof(float) + 15) & ~15) +
      static_cast<size_t>(KS) * RB * TJ * sizeof(float);
  err = cudaFuncSetAttribute(bwd_step,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + TJ - 1) / TJ, (B + RB - 1) / RB, D);
  for (int s = 0; s + 1 < a.Tn; ++s) {
    bwd_step<<<grid, STEP_THREADS, smem, stream>>>(a, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bias_reduce<<<(D * G + 255) / 256, 256, 0, stream>>>(a.acc_i, a.acc_h, dbi,
                                                       dbh, D, B, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dout, h (D, T, B, H); g (D, T, B, 3H), hn (D, T, B, H) and wt = W_hh^T
// (D, 3H, H); lens (B) int32 <= T; out dg (D, T, B, 3H), dnh (D, T, B, H),
// dbi and dbh (D, 3H); scratch of 2 * D * B * 3H + 2 * D * B * H entries;
// all but lens f32.
DS_EXPORT int gru_bwd_f32(const float* dout, const float* g, const float* hn,
                          const float* h, const float* wt, const int* lens,
                          float* dg, float* dnh, float* scratch, float* dbi,
                          float* dbh, int Tn, int B, int H, int D,
                          void* stream) {
  const size_t acc = static_cast<size_t>(D) * B * 3 * H;
  const size_t st = static_cast<size_t>(D) * B * H;
  const BwdArgs a{dout, g, hn, h, wt, lens, dg, dnh, scratch, scratch + acc,
                  scratch + 2 * acc, scratch + 2 * acc + st, Tn, B, H};
  return gru_bwd(a, D, dbi, dbh, static_cast<cudaStream_t>(stream));
}

// bf16: w_pk is W_hh packed (D, NJ, NK, 64, 128) (rnn_mma_bwd.cuh);
// scratch op (2, D, B8, NK * 128) bf16, bar (1) uint32 and state
// (6, D, B, H) f32, all zeroed here; variant 1 (one launch a step) or 2
// (persistent). Other arguments as the f32 entry.
DS_EXPORT int gru_bwd_bf16(const float* dout, const __nv_bfloat16* g,
                           const __nv_bfloat16* hn, const float* h,
                           const __nv_bfloat16* w_pk, const int* lens,
                           __nv_bfloat16* dg, __nv_bfloat16* dnh,
                           __nv_bfloat16* op, unsigned* bar, float* state,
                           float* dbi, float* dbh, int Tn, int B, int H,
                           int D, int variant, void* stream) {
  const int nk = (3 * H + mma_bwd::KC - 1) / mma_bwd::KC;
  const mma_bwd::Args a{dout, g, hn, h, w_pk, lens, dg, dnh, op, bar, state,
                        Tn, B, H, (B + 7) / 8 * 8, nk * mma_bwd::KC, nk,
                        (H + mma_bwd::TM - 1) / mma_bwd::TM};
  return static_cast<int>(mma_bwd::backward<3>(
      a, D, variant, dbi, dbh, static_cast<cudaStream_t>(stream)));
}

// The blocks of the bf16 persistent kernel that can be resident at once
// for a batch of B rows, into *blocks.
DS_EXPORT int gru_bwd_resident(int B, int* blocks) {
  return static_cast<int>(
      mma_bwd::resident_of<3>((B + 7) / 8 * 8, blocks));
}
