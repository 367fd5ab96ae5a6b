// The bf16 tensor-core backward through time shared by K5 (gru_bwd.cu,
// G = 3 gates) and K7 (lstm_bwd.cu, G = 4): K4/K6's design (rnn_mma.cuh)
// turned around. Each step's recurrent product
//   dh_prev[b, j] = sum_k op[b, k] * w_hh[d, j, k],   k < G * H,
// runs on mma.sync.m16n8k16 (bf16 operands, f32 sums), W_hh streamed once
// a step from L2 through a cp.async ring in shared memory; the operand op
// is [dr, dz, dnh] (GRU) or [di, df, dg, do] (LSTM), rounded to bf16. The
// pointwise part stays f32, in the arithmetic of gru_bwd.cu and
// lstm_bwd.cu (their header comments give it).
//
// Layouts (the wrapper builds them; ops/cuda/recurrence.py holds the same
// arithmetic in PyTorch, and tests/test_torch_bwd_mma.py checks it):
//  * W_hh is packed once a call into the order the clusters read it:
//    (D, NJ, NK, TM, KC) bf16, TM = 64 units a cluster, NJ = ceil(H / TM),
//    NK = ceil(G * H / KC). Tile (d, jw, kc), row jj, column kk holds
//    w_hh[d, jw * TM + jj, kc * KC + kk]: TM units (rows of W_hh), K chunk
//    kc of their G * H gate columns; zero past H and past G * H.
//  * The operand in bf16: (2, D, B8, Gk), B8 = B rounded up to 8, Gk =
//    NK * KC, zero in the padding and in every row whose step lies past its
//    length. Step s's epilogue writes copy s & 1; step s + 1's product
//    reads it. The dg (and GRU dnh) streams that cuBLAS's dx, dW_ih and
//    dW_hh read are written in time order beside it.
//  * Per (unit, row) f32 state, NSTATE values: [0] the dh carried into the
//    next product (GRU: dh_tot * z of a valid step; LSTM: 0 after a valid
//    step; both: the carried dh after a step past the length, whose
//    operand row is zero, so dh = state[0] + product in every case),
//    [1] the LSTM's carried dc, [2..5] the bias sums of the row, from the
//    unrounded values (GRU dr, dz, dn, dnh; LSTM di, df, dg, do). The one
//    thread that owns a pair keeps it in shared memory across steps (the
//    persistent variant), or in global memory, (NSTATE, D, B, H), between
//    launches; bias_reduce sums the rows at the end.
//
// Blocks: a cluster of CL = 2 blocks owns TM = 64 units of one direction
// for every batch row; grid (NJ * 2, D). Block kh of the cluster runs the
// product of all 64 units over its half of the K chunks, M = 64 times N =
// the batch (NT * 8 columns a chunk, NT in {2, 4, 8}; larger batches loop
// over chunks and stream W again) times K = G * H / 2; the two partial
// sums meet through distributed shared memory (one cluster barrier a
// step), and block kh finishes units kh * 32 .. kh * 32 + 31. Sixteen
// warps: warp w takes two m16 tiles (the unit half w & 1) and the k16
// slice w >> 1 of every KC = 128 chunk, all N; the eight K-slice partial
// sums meet in shared memory after the loop.
//
// Bytes and ring iterations decide the shape. A step brings to the SMs
// W_hh once (30.7 MB GRU, 41.0 MB LSTM at H 1600, both directions) plus
// the operand once for each cluster, B8 * Gk * 2 bytes, each block reading
// its half: operand / W = B8 / 64 (K4's was B8 / (G TJ)). At H 1600 that
// is 100 blocks and 30.7 MB of operand for the GRU at B 64 (61 MB a step),
// 15.4 MB for the LSTM at B 20 (56 MB). And each ring iteration costs a
// block barrier and a wait: KC = 128, not K4's 64, halves their number
// (38 for the GRU's 4,800 K columns, 19 a block here). On an H100 at 700 W
// (chip_smoke.py; PERF.md) blocks of 32 units with the whole K
// (twice the operand's bytes) were slower at every shape measured, and 64
// units a block without the K split (50 blocks) slower still; this shape
// reaches 27 us a step for the GRU at B 64 against a per-step L2 floor of
// 17 us (the bytes above at the warm W_hh's read rate, ~3.5 TB/s).
//
// Two variants, chosen by the wrapper's fixed rule (recurrence.py:
// bwd_variant): one launch a step (state in global memory), or one
// persistent cooperative launch with a grid barrier a step, where the
// batch fits one chunk and the grid is resident; it prefetches step
// s + 1's dout, gates, hn and h_prev (c, c_prev) before it waits.
#pragma once

#include <cooperative_groups.h>

#include "rnn_mma.cuh"

namespace mma_bwd {

namespace cg = cooperative_groups;
using mma_rnn::cp_async16;
using mma_rnn::cp_async_commit;
using mma_rnn::cp_async_wait;
using mma_rnn::grid_sync_release;
using mma_rnn::ldmatrix_x4;
using mma_rnn::load_stream;
using mma_rnn::mma_bf16;
using mma_rnn::smem_addr;
using mma_rnn::store_stream;

constexpr int CL = 2;         // blocks a cluster, splitting K
constexpr int TJ = 32;        // units a block finishes
constexpr int TM = TJ * CL;   // units a cluster: the product's M
constexpr int KC = 128;       // K (gate columns) per ring stage
constexpr int KCP = KC + 8;   // padded smem row: 272 B, so the 8 rows of one
                              // ldmatrix hit distinct banks
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MG = 2;                    // warps splitting M
constexpr int KSPLIT = WARPS / MG;       // warps splitting a chunk's K
static_assert(KSPLIT * 16 == KC, "16 warps: 2 unit groups x 8 k16 slices");
constexpr int NSTATE = 6;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of one block

struct Args {
  const float* dout;        // (D, T, B, H) f32
  const __nv_bfloat16* g;   // (D, T, B, G*H) the forward's gates
  const __nv_bfloat16* hn;  // GRU: (D, T, B, H); LSTM: null
  const float* hc;          // GRU: h (D, T, B, H); LSTM: c; f32
  const __nv_bfloat16* w;   // packed W_hh, (D, NJ, NK, TM, KC)
  const int* lens;          // (B)
  __nv_bfloat16* dg;        // (D, T, B, G*H) out
  __nv_bfloat16* dnh;       // GRU: (D, T, B, H) out; LSTM: null
  __nv_bfloat16* op;        // (2, D, B8, Gk) the operand copies
  unsigned* bar;            // grid-barrier counter (persistent variant)
  float* state;             // (NSTATE, D, B, H) f32
  int Tn, B, H, B8, Gk, NK, NJ;
};

// Shared memory of one block: the ring (as many stages as fit, at most 6),
// after the product the K-split partial sums (KSPLIT, NC, TM + 4) f32 on
// the same bytes, and the state of the block's (unit, row) pairs,
// (NSTATE, NC, TJ) f32.
template <int NT>
struct Smem {
  static constexpr int NC = NT * 8;
  static constexpr int MP = TM + 4;
  static constexpr int STAGE = (TM + NC) * KCP;  // bf16 elements a stage
  static constexpr size_t STATE = size_t(NSTATE) * NC * TJ * 4;
  static constexpr int FIT = int((SMEM_MAX - STATE) / (size_t(STAGE) * 2));
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr size_t RING = size_t(STAGES) * STAGE * 2;
  static constexpr size_t RED = size_t(KSPLIT) * NC * MP * 4;
  static constexpr size_t WORK = RING > RED ? RING : RED;
  static constexpr size_t BYTES = WORK + STATE;
  static_assert(STAGES >= 3 && BYTES <= SMEM_MAX, "shared memory");
};

__device__ __forceinline__ int walk_time(int d, int s, int Tn) {
  return d == 0 ? Tn - 1 - s : s;
}

// The block's rank in its cluster, and a barrier of the cluster.
__device__ __forceinline__ int cluster_rank() {
  return static_cast<int>(cg::this_cluster().block_rank());
}

__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// One ring stage: the W tile kc of tile group (jw, d), TM rows of KC, and
// rows [n0, n0 + NC) of the operand copy's K chunk kc (rows past B8 are
// left unloaded: their columns are never read back).
template <int NT>
__device__ __forceinline__ void load_stage(const Args& a,
                                           const __nv_bfloat16* op_in,
                                           __nv_bfloat16* stage, int d,
                                           int jw, int n0, int kc) {
  using S = Smem<NT>;
  constexpr int PIECES = KC / 8;  // 16-byte pieces a row
  const __nv_bfloat16* wt =
      a.w + ((static_cast<size_t>(d) * a.NJ + jw) * a.NK + kc) * TM * KC;
  for (int i = threadIdx.x; i < TM * PIECES; i += THREADS) {
    const int row = i / PIECES, col = (i % PIECES) * 8;
    cp_async16(smem_addr(stage + row * KCP + col), wt + i * 8);
  }
  __nv_bfloat16* os = stage + TM * KCP;
  const int rows = min(S::NC, a.B8 - n0);
  const __nv_bfloat16* src =
      op_in + (static_cast<size_t>(d) * a.B8 + n0) * a.Gk + kc * KC;
  for (int i = threadIdx.x; i < rows * PIECES; i += THREADS) {
    const int row = i / PIECES, col = (i % PIECES) * 8;
    cp_async16(smem_addr(os + row * KCP + col),
               src + static_cast<size_t>(row) * a.Gk + col);
  }
}

// The recurrent products of tile group (jw, d) over K chunks [k0, k1) for
// the batch chunk at n0 into `red`: red[ks][n][m] = sum over warp ks's K
// slices of op[n0 + n, k] * w_hh[d, jw * TM + m, k]. Ends with a
// __syncthreads, so `red` may be read.
template <int NT>
__device__ __forceinline__ void product(const Args& a,
                                        const __nv_bfloat16* op_in,
                                        char* smem, int d, int jw, int n0,
                                        int k0, int k1) {
  using S = Smem<NT>;
  constexpr int STAGES = S::STAGES;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  constexpr int MT = TM / 16 / MG;  // m16 tiles a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mg = warp % MG, ks = warp / MG;
  const int nact = (min(S::NC, a.B8 - n0) + 7) / 8;  // n tiles with rows
  const int nk = k1 - k0;
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  // ldmatrix x4 addresses, in elements within a stage: lane l gives row
  // l & 7 of matrix l >> 3
  const int q = lane >> 3, r8 = lane & 7;
  const int a_off = (mg * MT * 16 + (q & 1) * 8 + r8) * KCP + ks * 16
                    + (q >> 1) * 8;
  const int b_off = TM * KCP + ((q >> 1) * 8 + r8) * KCP + ks * 16
                    + (q & 1) * 8;

  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nk)
      load_stage<NT>(a, op_in, ring + i * S::STAGE, d, jw, n0, k0 + i);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = kc + STAGES - 1;
    if (nxt < nk)
      load_stage<NT>(a, op_in, ring + (nxt % STAGES) * S::STAGE, d, jw,
                         n0, k0 + nxt);
    cp_async_commit();
    const unsigned st = smem_addr(ring + (kc % STAGES) * S::STAGE);
    unsigned af[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      ldmatrix_x4(af[m], st + 2 * (a_off + m * 16 * KCP));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (2 * np < nact) {
        unsigned bf[4];
        ldmatrix_x4(bf, st + 2 * (b_off + np * 16 * KCP));
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][2 * np], af[m], bf[0], bf[1]);
          mma_bf16(acc[m][2 * np + 1], af[m], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: `red` takes its bytes

  float* red = reinterpret_cast<float*>(smem);
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int mm = (mg * MT + m) * 16 + gid;
      float* p = red + (ks * S::NC + n * 8 + 2 * tig) * S::MP + mm;
      p[0] = acc[m][n][0];
      p[S::MP] = acc[m][n][1];
      p[8] = acc[m][n][2];
      p[S::MP + 8] = acc[m][n][3];
    }
  __syncthreads();
}

// What one thread reads for its NP (unit, row) pairs of a chunk, loaded
// before the product (the next step's, in the persistent variant, before
// the grid barrier): unit j0 + tid % TJ, row n0 + tid / TJ + (THREADS /
// TJ) p, with j0 the block's first unit.
template <int G, int NT>
struct Pairs {
  static constexpr int NP = NT * 8 * TJ / THREADS;  // pairs a thread
  static constexpr int RS = THREADS / TJ;           // row stride
  int len[NP];      // the row's length; -1 where the pair lies outside
  float dout[NP];
  float gv[NP][G];  // the forward's gates
  float x1[NP];     // GRU: hn; LSTM: c
  float x2[NP];     // GRU: h_prev; LSTM: c_prev
};

template <int G, int NT>
__device__ __forceinline__ void load_pairs(const Args& a, int j0, int n0,
                                           Pairs<G, NT>& q) {
  const int j = j0 + threadIdx.x % TJ;
#pragma unroll
  for (int p = 0; p < q.NP; ++p) {
    const int b = n0 + threadIdx.x / TJ + q.RS * p;
    q.len[p] = (j < a.H && b < a.B) ? a.lens[b] : -1;
  }
}

template <int G, int NT>
__device__ __forceinline__ void prefetch(const Args& a, int s, int d, int j0,
                                         int n0, Pairs<G, NT>& q) {
  const int GH = G * a.H;
  const int j = j0 + threadIdx.x % TJ;
  const int t = walk_time(d, s, a.Tn);
#pragma unroll
  for (int p = 0; p < q.NP; ++p) {
    if (t >= q.len[p]) continue;  // past the length, or outside
    const int b = n0 + threadIdx.x / TJ + q.RS * p;
    const size_t row = (static_cast<size_t>(d) * a.Tn + t) * a.B + b;
    q.dout[p] = __ldcs(a.dout + row * a.H + j);
    const __nv_bfloat16* gr = a.g + row * GH + j;
#pragma unroll
    for (int g = 0; g < G; ++g) q.gv[p][g] = load_stream(gr + g * a.H);
    // the neighbour in the walk's past: h[t-1] / h[t+1] (c likewise)
    const bool has_prev = d == 0 ? t > 0 : t + 1 < q.len[p];
    const size_t prev = d == 0 ? row - a.B : row + a.B;
    if constexpr (G == 3) {
      q.x1[p] = load_stream(a.hn + row * a.H + j);
      q.x2[p] = has_prev ? __ldcs(a.hc + prev * a.H + j) : 0.f;
    } else {  // each c is read twice: as c_t and as a neighbour's c_prev
      q.x1[p] = a.hc[row * a.H + j];
      q.x2[p] = has_prev ? a.hc[prev * a.H + j] : 0.f;
    }
  }
}

// The state values k0.. of the thread's pairs between shared memory (`st`,
// NSTATE x NC x TJ) and a.state.
template <int G, int NT, bool STORE>
__device__ __forceinline__ void state_io(const Args& a, float* st, int d,
                                         int j0, int n0, int k0,
                                         const Pairs<G, NT>& q) {
  constexpr int NC = NT * 8;
  const int jl = threadIdx.x % TJ, j = j0 + jl;
#pragma unroll
  for (int p = 0; p < q.NP; ++p) {
    if (q.len[p] < 0) continue;
    const int n = threadIdx.x / TJ + q.RS * p, b = n0 + n;
#pragma unroll
    for (int k = k0; k < NSTATE; ++k) {
      float* s = st + (k * NC + n) * TJ + jl;
      float* g = a.state + ((static_cast<size_t>(k) * gridDim.y + d) * a.B
                            + b) * a.H + j;
      if (STORE)
        *g = *s;
      else
        *s = *g;
    }
  }
}

// dh of step s - 1's product (the K-split sums of the cluster's blocks at
// column m0 of `red`, or nothing at s = 0), then the pointwise part of step
// s at the thread's pairs: dg (and dnh) in time order, the operand copy
// op_out, the state.
template <int G, int NT>
__device__ __forceinline__ void epilogue(const Args& a, const float* red,
                                         float* st, __nv_bfloat16* op_out,
                                         int s, int d, int j0, int m0,
                                         int n0, const Pairs<G, NT>& q) {
  using S = Smem<NT>;
  constexpr int NC = S::NC;
  const int GH = G * a.H;
  const int jl = threadIdx.x % TJ, j = j0 + jl;
  const int t = walk_time(d, s, a.Tn);
  const float* peer = red == nullptr ? nullptr
      : cg::this_cluster().map_shared_rank(red, cluster_rank() ^ 1);
#pragma unroll
  for (int p = 0; p < q.NP; ++p) {
    if (q.len[p] < 0) continue;
    const int n = threadIdx.x / TJ + q.RS * p, b = n0 + n;
    float* sp = st + n * TJ + jl;  // state k at sp[k * NC * TJ]
    float dh = sp[0];
    if (red != nullptr) {
      const int e = n * S::MP + m0 + jl;
#pragma unroll
      for (int ks = 0; ks < KSPLIT; ++ks) dh += red[ks * NC * S::MP + e];
#pragma unroll
      for (int ks = 0; ks < KSPLIT; ++ks) dh += peer[ks * NC * S::MP + e];
    }
    const size_t row = (static_cast<size_t>(d) * a.Tn + t) * a.B + b;
    __nv_bfloat16* dgr = a.dg + row * GH + j;
    __nv_bfloat16* opr = op_out + (static_cast<size_t>(d) * a.B8 + b) * a.Gk
                         + j;
    if (t >= q.len[p]) {  // past the length: zeros, dh carried as it was
#pragma unroll
      for (int g = 0; g < G; ++g) {
        store_stream(dgr + g * a.H, 0.f);
        opr[g * a.H] = __float2bfloat16(0.f);
      }
      if constexpr (G == 3) store_stream(a.dnh + row * a.H + j, 0.f);
      sp[0] = dh;
      continue;
    }
    const float dh_tot = q.dout[p] + dh;
    float gp[G];   // the gate grads (dg)
    float opv[G];  // the operand (GRU: dnh in place of dn)
    if constexpr (G == 3) {
      const float r = q.gv[p][0], z = q.gv[p][1], nn = q.gv[p][2];
      const float dn = dh_tot * (1.f - z) * (1.f - nn * nn);
      const float dz = dh_tot * (q.x2[p] - nn) * z * (1.f - z);
      const float dr = dn * q.x1[p] * r * (1.f - r);
      gp[0] = opv[0] = dr;
      gp[1] = opv[1] = dz;
      gp[2] = dn;
      opv[2] = dn * r;
      store_stream(a.dnh + row * a.H + j, opv[2]);
      sp[0] = dh_tot * z;
      sp[5 * NC * TJ] += opv[2];
    } else {
      const float i = q.gv[p][0], f = q.gv[p][1], gg = q.gv[p][2],
                  o = q.gv[p][3];
      const float tc = tanhf(q.x1[p]);
      const float dc_tot = sp[NC * TJ] + dh_tot * o * (1.f - tc * tc);
      gp[0] = dc_tot * gg * i * (1.f - i);
      gp[1] = dc_tot * q.x2[p] * f * (1.f - f);
      gp[2] = dc_tot * i * (1.f - gg * gg);
      gp[3] = dh_tot * tc * o * (1.f - o);
#pragma unroll
      for (int g = 0; g < 4; ++g) opv[g] = gp[g];
      sp[NC * TJ] = dc_tot * f;
      sp[0] = 0.f;
      sp[5 * NC * TJ] += gp[3];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      store_stream(dgr + g * a.H, gp[g]);
      opr[g * a.H] = __float2bfloat16(opv[g]);
    }
#pragma unroll
    for (int g = 0; g < 3; ++g) sp[(2 + g) * NC * TJ] += gp[g];
  }
}

// Where block (blockIdx.x, d) works: its tile group jw, its rank kh in
// the cluster, its first unit j0 (column m0 = kh * TJ of the group's
// partial sums) and its K chunks [k0, k1).
struct Place {
  int jw, kh, j0, m0, k0, k1;
  __device__ __forceinline__ explicit Place(const Args& a) {
    kh = cluster_rank();
    jw = blockIdx.x / CL;
    m0 = kh * TJ;
    j0 = jw * TM + m0;
    const int share = (a.NK + CL - 1) / CL;
    k0 = min(a.NK, kh * share);
    k1 = min(a.NK, k0 + share);
  }
};

// Step s of the walk, one launch: grid (NJ * CL, D); batches above NT * 8
// rows loop over chunks. Step 0 has no product.
template <int G, int NT>
__global__ void __launch_bounds__(THREADS, 1) step_kernel(Args a, int s) {
  using S = Smem<NT>;
  extern __shared__ __align__(16) char smem[];
  float* st = reinterpret_cast<float*>(smem + S::WORK);
  const Place at(a);
  const int d = blockIdx.y;
  const size_t osz = static_cast<size_t>(gridDim.y) * a.B8 * a.Gk;
  const __nv_bfloat16* op_in = a.op + ((s + 1) & 1) * osz;
  __nv_bfloat16* op_out = a.op + (s & 1) * osz;
  Pairs<G, NT> q;
  for (int n0 = 0; n0 < a.B8; n0 += S::NC) {
    // in flight during the product
    load_pairs<G, NT>(a, at.j0, n0, q);
    prefetch<G, NT>(a, s, d, at.j0, n0, q);
    state_io<G, NT, false>(a, st, d, at.j0, n0, 0, q);
    if (s > 0) {
      product<NT>(a, op_in, smem, d, at.jw, n0, at.k0, at.k1);
      cluster_sync();  // the peer's sums are in
    }
    epilogue<G, NT>(a, s > 0 ? reinterpret_cast<float*>(smem) : nullptr,
                        st, op_out, s, d, at.j0, at.m0, n0, q);
    state_io<G, NT, true>(a, st, d, at.j0, n0, 0, q);
    // every `red` of the cluster is read before the next chunk's ring loads
    // (and before a block leaves)
    cluster_sync();
  }
}

// All steps in one cooperative launch (B8 <= NT * 8, every block
// resident): the state stays in shared memory; between steps, the next
// step's inputs are loaded before a grid barrier. The bias sums go to
// a.state at the end.
template <int G, int NT>
__global__ void __launch_bounds__(THREADS, 1) persistent_kernel(Args a) {
  using S = Smem<NT>;
  extern __shared__ __align__(16) char smem[];
  float* st = reinterpret_cast<float*>(smem + S::WORK);
  const Place at(a);
  const int d = blockIdx.y;
  const unsigned nblocks = gridDim.x * gridDim.y;
  const size_t osz = static_cast<size_t>(gridDim.y) * a.B8 * a.Gk;
  Pairs<G, NT> q;
  load_pairs<G, NT>(a, at.j0, 0, q);
  for (int i = threadIdx.x; i < NSTATE * S::NC * TJ; i += THREADS)
    st[i] = 0.f;
  __syncthreads();
  prefetch<G, NT>(a, 0, d, at.j0, 0, q);
  for (int s = 0; s < a.Tn; ++s) {
    if (s > 0) {
      product<NT>(a, a.op + ((s + 1) & 1) * osz, smem, d, at.jw, 0,
                      at.k0, at.k1);
      cluster_sync();  // the peer's sums are in
    }
    epilogue<G, NT>(a, s > 0 ? reinterpret_cast<float*>(smem) : nullptr,
                        st, a.op + (s & 1) * osz, s, d, at.j0, at.m0, 0, q);
    if (s + 1 == a.Tn) break;
    prefetch<G, NT>(a, s + 1, d, at.j0, 0, q);
    // every block's operand for step s is written, and every block has
    // read the copy and the partial sums the next step overwrites
    grid_sync_release(a.bar, (s + 1) * nblocks);
  }
  cluster_sync();  // the peer has read our sums
  state_io<G, NT, true>(a, st, d, at.j0, 0, 2, q);
}

// The bias grads from the per-row sums of a.state: GRU dbi = (dr, dz, dn)
// and dbh = (dr, dz, dnh); LSTM db = (di, df, dg, do); (D, G*H) f32.
template <int G>
__global__ void bias_reduce(const float* __restrict__ state,
                            float* __restrict__ db0, float* __restrict__ db1,
                            int D, int B, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D * G * H) return;
  const int d = i / (G * H), g = i % (G * H) / H, j = i % H;
  auto sum = [&](int k) {
    float v = 0.f;
    for (int b = 0; b < B; ++b)
      v += state[((static_cast<size_t>(k) * D + d) * B + b) * H + j];
    return v;
  };
  db0[i] = sum(2 + g);
  if (G == 3) db1[i] = sum(g == 2 ? 5 : 2 + g);
}

template <int G, int NT>
cudaError_t set_smem() {
  const int smem = static_cast<int>(Smem<NT>::BYTES);
  cudaError_t err = cudaFuncSetAttribute(
      step_kernel<G, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(persistent_kernel<G, NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  return err;
}

// A launch of grid (NJ * CL, D) in clusters of CL blocks, cooperative or
// not.
struct Config {
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg{};
  Config(int nj, int D, size_t smem, bool cooperative, cudaStream_t stream) {
    cfg.gridDim = dim3(nj * CL, D);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cooperative ? 2 : 1;
  }
};

// variant 1: one launch a step; 2: persistent (refused where the batch
// does not fit one chunk; a cooperative launch refuses a grid that is not
// resident).
template <int G, int NT>
cudaError_t launch(const Args& a, int D, int variant, cudaStream_t stream) {
  const size_t smem = Smem<NT>::BYTES;
  cudaError_t err = set_smem<G, NT>();
  if (err != cudaSuccess) return err;
  if (variant == 2) {
    if (a.B8 > NT * 8) return cudaErrorInvalidValue;
    Config c(a.NJ, D, smem, true, stream);
    err = cudaLaunchKernelEx(&c.cfg, persistent_kernel<G, NT>, a);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  if (variant != 1) return cudaErrorInvalidValue;
  Config c(a.NJ, D, smem, false, stream);
  for (int s = 0; s < a.Tn; ++s) {
    err = cudaLaunchKernelEx(&c.cfg, step_kernel<G, NT>, a, s);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// How many blocks of the persistent kernel can be resident at once, for
// the wrapper's rule.
template <int G, int NT>
cudaError_t resident(int* blocks) {
  Config c(1, 1, Smem<NT>::BYTES, false, nullptr);
  int clusters = 0;
  cudaError_t err = set_smem<G, NT>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, persistent_kernel<G, NT>,
                                         &c.cfg);
  *blocks = clusters * CL;
  return err;
}

// NT is the least of 2, 4, 8 n-tiles whose chunk holds B8 (8 above 64).
template <int G>
cudaError_t resident_of(int b8, int* blocks) {
  if (b8 <= 16) return resident<G, 2>(blocks);
  if (b8 <= 32) return resident<G, 4>(blocks);
  return resident<G, 8>(blocks);
}

// Zero the operand copies, the state and the barrier, run the Tn steps,
// then reduce the bias sums into db0 (and db1, GRU).
template <int G>
cudaError_t backward(const Args& a, int D, int variant, float* db0,
                     float* db1, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      a.op, 0, 2 * static_cast<size_t>(D) * a.B8 * a.Gk * 2, stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(
        a.state, 0,
        static_cast<size_t>(NSTATE) * D * a.B * a.H * sizeof(float), stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(a.bar, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  if (a.B8 <= 16)
    err = launch<G, 2>(a, D, variant, stream);
  else if (a.B8 <= 32)
    err = launch<G, 4>(a, D, variant, stream);
  else
    err = launch<G, 8>(a, D, variant, stream);
  if (err != cudaSuccess) return err;
  const int n = D * G * a.H;
  bias_reduce<G><<<(n + 255) / 256, 256, 0, stream>>>(a.state, db0, db1, D,
                                                      a.B, a.H);
  return cudaGetLastError();
}

}  // namespace mma_bwd
