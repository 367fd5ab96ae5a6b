// The bf16 tensor-core recurrence shared by K4 (gru_scan.cu, G = 3 gates)
// and K6 (lstm_scan.cu, G = 4): the hidden product h_prev @ W_hh of every
// step on mma.sync.m16n8k16 (bf16 operands, f32 accumulators), W_hh
// streamed once a step from L2 through a cp.async ring in shared memory,
// the gate update on f32 state with both biases added in f32 (the GRU's
// b_hn inside the r *), torch gate order.
//
// Layouts (the wrapper builds them; ops/cuda/recurrence.py holds the same
// arithmetic in PyTorch, and tests/test_torch_wide.py checks it):
//  * W_hh is packed once a call into the order the blocks read it:
//    (D, NJ, NK, G * TJ, KC) bf16, NJ = ceil(H / TJ), NK = ceil(H / KC).
//    Tile (d, jb, kc) holds, row g * TJ + jj, column kk, the element
//    w_hh[d, kc * KC + kk, g * H + jb * TJ + jj]: the gate rows of W_hh^T
//    for the TJ units of block jb, gate-major ([r | z | n] or
//    [i | f | g | o] of the same units), K chunk kc; zero past H.
//  * h_prev in the operand type: (2, D, B8, Hk) bf16, B8 = B rounded up
//    to 8, Hk = NK * KC, zero in the padding; the step reads copy s & 1
//    and writes copy (s + 1) & 1, rounded as ds_round_to does. The f32
//    state (D, B, H) (and the LSTM's c) is read and written in place by
//    the one thread that owns each (unit, row).
//
// A block owns TJ = 32 units of one direction for every batch row: grid
// (NJ, D). Its M = G * TJ gate rows times N = the batch (NT * 8 columns a
// chunk, NT in {2, 4, 8}; larger batches loop over chunks and stream W
// again) times K = H. Sixteen warps: warp w takes the 16 units w & 1, the
// k16 slice (w >> 1) & 3 of every KC = 64 chunk and the N half w >> 3, all
// gates, so each W_hh element is read from shared memory twice and each h
// element twice a step. The four K-slice partial sums meet in shared
// memory (`red`, aliased on the ring after the loop): splitting M or N
// further would make more warps read each W chunk (16x its bytes with N
// alone, ~5 us a step at 128 B/clk), so the K split and one ~0.1 MB
// reduction are the cheaper way. The epilogue gives each thread fixed
// (unit, row) pairs, lane = unit, so a warp writes 32 consecutive units of
// one row; it reads nothing from global memory (the projection, lengths,
// biases and state are loaded before the product). Sixteen warps, not
// eight: the products and the epilogue have twice the warps to hide their
// latency.
//
// What bounds a step (6 x BiGRU-1600 at B 64, 6 x BiLSTM-1600 at B 20):
//  * the L2 bytes: W_hh once a step (30.7 MB GRU, 41.0 MB LSTM, both
//    directions) plus h_prev, B8 * Hk * 2 bytes for each of the NJ * D
//    blocks: 100 x 205 KB = 20.5 MB (GRU) and 100 x 77 KB = 7.7 MB (LSTM,
//    B8 24). TJ = 32 keeps them below W_hh's bytes: h / W = B8 / (TJ * G)
//    = 0.67 and 0.19 (TJ = 16 would read 41 MB of h for the GRU); 100
//    blocks on 132 SMs, one each, each streaming ~0.5 MB a step through a
//    6-stage ring of ~23 KB stages. At the read rate of the warm packed W_hh
//    (chip_smoke.py measures it: ~3-3.6 TB/s, near the HBM rate, so W_hh
//    does not seem to stay in L2 from step to step) these bytes take
//    ~14-16 us, about two thirds of a step; an evict_last policy on the W
//    loads did not help.
//  * the products: 2 * 2 * B * H * G * H = 2.0 and 0.8 GFLOP a step, ~2 and
//    ~1 us on mma.sync at a third of the 989 TFLOP/s peak; they, the
//    K-split reduction and the epilogue are not yet hidden behind the
//    streaming.
//  * the launch floor: one launch a step (~2-4 us), or, in the persistent
//    variant, one grid barrier a step. The persistent variant
//    (cudaLaunchCooperativeKernel, no more blocks than are resident) keeps
//    the f32 h (and c) of its pairs in registers across steps and loads
//    step s + 1's projection before it waits at the barrier; the per-step
//    variant loads each step's projection before its product. A fixed
//    rule chooses: persistent where the batch fits one chunk (B8 <= 64) and
//    the grid is resident at once; else one launch a step.
#pragma once

#include "rnn_common.cuh"

namespace mma_rnn {

constexpr int TJ = 32;              // hidden units per block
constexpr int KC = 64;              // K (h columns) per ring stage
constexpr int KCP = KC + 8;         // padded smem row: 144 B, so the 8 rows
                                    // of one ldmatrix hit distinct banks
constexpr int STAGES = 6;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int UG = TJ / 16;         // unit groups of 16 (one m16 tile each)
constexpr int KSPLIT = KC / 16;     // warps splitting a chunk's K
constexpr int NSPLIT = WARPS / (UG * KSPLIT);  // warps splitting its N
static_assert(NSPLIT == 2, "16 warps: 2 unit groups x 4 k16 slices x 2");

struct Args {
  const __nv_bfloat16* xp;   // (D, T, B, G*H) projection, without b_ih
  const __nv_bfloat16* w;    // packed W_hh, (D, NJ, NK, G*TJ, KC)
  const float* b_ih;         // (D, G*H)
  const float* b_hh;         // (D, G*H)
  const int* lens;           // (B)
  float* h;                  // (D, B, H) f32 state
  float* c;                  // (D, B, H) f32 cell state (LSTM)
  __nv_bfloat16* hb;         // (2, D, B8, Hk) h_prev in the operand type
  unsigned* bar;             // grid-barrier counter (persistent variant)
  float* out;                // (D, T, B, H)
  __nv_bfloat16* g_out;      // (D, T, B, G*H) gates, or null
  __nv_bfloat16* hn_out;     // GRU: (D, T, B, H) hn, or null
  float* c_out;              // LSTM: (D, T, B, H) c, or null
  int Tn, B, H, B8, Hk, NK, NJ;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(unsigned r[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) @ b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float d[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid barrier of a cooperative launch, the pattern of cooperative groups'
// grid sync: a block barrier, one fenced arrival on the counter (zeroed
// before the launch), a spin until `target` blocks have arrived.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(bar) : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

// Shared memory of one block: the ring, and after the product the K-split
// partial sums (KSPLIT, NT * 8, MP) f32 on the same bytes. MP = G * TJ + 4
// makes the fragment stores and the epilogue's reads conflict-free.
template <int G, int NT>
struct Smem {
  static constexpr int M = G * TJ;
  static constexpr int NC = NT * 8;
  static constexpr int MP = M + 4;
  static constexpr int STAGE = (M + NC) * KCP;  // bf16 elements a stage
  static constexpr size_t RING = size_t(STAGES) * STAGE * 2;
  static constexpr size_t RED = size_t(KSPLIT) * NC * MP * 4;
  static constexpr size_t BYTES = RING > RED ? RING : RED;
};

// The projection and the outputs pass through once: they are read and
// written with the streaming (evict-first) cache hints.
__device__ __forceinline__ float load_stream(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.cs.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return __bfloat162float(__ushort_as_bfloat16(v));
}

__device__ __forceinline__ void store_stream(float* p, float v) {
  __stcs(p, v);
}

__device__ __forceinline__ void store_stream(__nv_bfloat16* p, float v) {
  const unsigned short u = __bfloat16_as_ushort(__float2bfloat16(v));
  asm volatile("st.global.cs.u16 [%0], %1;\n" ::"l"(p), "h"(u) : "memory");
}

// The W half of a stage: tile kc of block (jb, d), G * TJ rows of KC.
template <int G, int NT>
__device__ __forceinline__ void load_w(const Args& a, __nv_bfloat16* stage,
                                       int d, int jb, int kc) {
  using S = Smem<G, NT>;
  constexpr int PIECES = KC / 8;  // 16-byte pieces a row
  const __nv_bfloat16* wt =
      a.w + ((static_cast<size_t>(d) * a.NJ + jb) * a.NK + kc) * S::M * KC;
  for (int i = threadIdx.x; i < S::M * PIECES; i += THREADS) {
    const int row = i / PIECES, col = (i % PIECES) * 8;
    cp_async16(smem_addr(stage + row * KCP + col), wt + i * 8);
  }
}

// The h half: rows [n0, n0 + NT*8) of h_prev's K chunk kc (rows past B8
// are left unloaded: their columns are never read back).
template <int G, int NT>
__device__ __forceinline__ void load_h(const Args& a,
                                       const __nv_bfloat16* hb_in,
                                       __nv_bfloat16* stage, int d, int n0,
                                       int kc) {
  using S = Smem<G, NT>;
  constexpr int PIECES = KC / 8;
  __nv_bfloat16* hs = stage + S::M * KCP;
  const int rows = min(S::NC, a.B8 - n0);
  const __nv_bfloat16* hsrc = hb_in
      + (static_cast<size_t>(d) * a.B8 + n0) * a.Hk + kc * KC;
  for (int i = threadIdx.x; i < rows * PIECES; i += THREADS) {
    const int row = i / PIECES, col = (i % PIECES) * 8;
    cp_async16(smem_addr(hs + row * KCP + col),
               hsrc + static_cast<size_t>(row) * a.Hk + col);
  }
}

// The hidden products of block (jb, d) for the batch chunk at n0 into
// `red`: red[ks][n][g * TJ + j] = sum over warp ks's K slices of
// h_prev[n0 + n, k] * w_hh[k, g * H + jb * TJ + j]. Ends with a
// __syncthreads, so `red` may be read.
template <int G, int NT>
__device__ __forceinline__ void product(const Args& a, const
                                        __nv_bfloat16* hb_in, char* smem,
                                        int d, int jb, int n0) {
  using S = Smem<G, NT>;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  constexpr int NTW = NT / NSPLIT;  // N tiles a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ug = warp % UG, ks = warp / UG % KSPLIT, nh = warp / UG / KSPLIT;
  // the warp's N tiles that hold rows
  const int nact = (min(S::NC, a.B8 - n0) + 7) / 8 - nh * NTW;
  float acc[G][NTW][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][n][e] = 0.f;

  // ldmatrix x4 addresses, in elements within a stage: lane l gives row
  // l & 7 of matrix l >> 3
  const int q = lane >> 3, r8 = lane & 7;
  const int a_off = (ug * 16 + (q & 1) * 8 + r8) * KCP + ks * 16
                    + (q >> 1) * 8;
  const int b_off = S::M * KCP + (nh * NTW * 8 + (q >> 1) * 8 + r8) * KCP
                    + ks * 16 + (q & 1) * 8;

  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < a.NK) {
      load_w<G, NT>(a, ring + i * S::STAGE, d, jb, i);
      load_h<G, NT>(a, hb_in, ring + i * S::STAGE, d, n0, i);
    }
    cp_async_commit();
  }
  for (int kc = 0; kc < a.NK; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = kc + STAGES - 1;
    if (nxt < a.NK) {
      __nv_bfloat16* st = ring + (nxt % STAGES) * S::STAGE;
      load_w<G, NT>(a, st, d, jb, nxt);
      load_h<G, NT>(a, hb_in, st, d, n0, nxt);
    }
    cp_async_commit();
    const unsigned st = smem_addr(ring + (kc % STAGES) * S::STAGE);
    unsigned af[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
      ldmatrix_x4(af[g], st + 2 * (a_off + g * TJ * KCP));
    if constexpr (NTW == 1) {
      if (nact > 0) {
        unsigned bf[2];
        ldmatrix_x2(bf, st + 2 * b_off);
#pragma unroll
        for (int g = 0; g < G; ++g) mma_bf16(acc[g][0], af[g], bf[0], bf[1]);
      }
    } else {
#pragma unroll
      for (int np = 0; np < NTW / 2; ++np) {
        if (2 * np < nact) {
          unsigned bf[4];
          ldmatrix_x4(bf, st + 2 * (b_off + np * 16 * KCP));
#pragma unroll
          for (int g = 0; g < G; ++g) {
            mma_bf16(acc[g][2 * np], af[g], bf[0], bf[1]);
            mma_bf16(acc[g][2 * np + 1], af[g], bf[2], bf[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: `red` takes its bytes

  float* red = reinterpret_cast<float*>(smem);
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int m = g * TJ + ug * 16 + gid;
      float* p = red + (ks * S::NC + (nh * NTW + n) * 8 + 2 * tig) * S::MP
                 + m;
      p[0] = acc[g][n][0];
      p[S::MP] = acc[g][n][1];
      p[8] = acc[g][n][2];
      p[S::MP + 8] = acc[g][n][3];
    }
  __syncthreads();
}

// What one thread keeps for its NP (unit, row) pairs of a chunk: unit
// jb * TJ + lane, row n0 + warp + 16 p. Loaded before the product, so the
// epilogue reads nothing from global memory but the K-split sums.
template <int G, int NT>
struct Pairs {
  static constexpr int NP = NT * 8 / WARPS;  // pairs a thread
  int len[NP];     // the row's length; -1 where the pair lies outside
  float bi[G];     // b_ih of the unit
  float bh[G];     // b_hh of the unit
  float x[NP][G];  // the step's projection + b_ih; 0 past the length
  float h[NP];     // f32 state
  float c[NP];     // LSTM cell state
};

template <int G, int NT>
__device__ __forceinline__ void load_pairs(const Args& a, int d, int jb,
                                           int n0, Pairs<G, NT>& q) {
  const int GH = G * a.H;
  const int jj = jb * TJ + (threadIdx.x & 31);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    q.bi[g] = jj < a.H ? a.b_ih[d * GH + g * a.H + jj] : 0.f;
    q.bh[g] = jj < a.H ? a.b_hh[d * GH + g * a.H + jj] : 0.f;
  }
#pragma unroll
  for (int p = 0; p < q.NP; ++p) {
    const int b = n0 + (threadIdx.x >> 5) + WARPS * p;
    q.len[p] = (jj < a.H && b < a.B) ? a.lens[b] : -1;
  }
}

// The projection of step s for the thread's pairs, widened to f32 with
// b_ih added; read once, so it does not displace W_hh in L2.
template <int G, int NT>
__device__ __forceinline__ void load_x(const Args& a, int s, int d, int jb,
                                       int n0, Pairs<G, NT>& q) {
  const int GH = G * a.H;
  const int jj = jb * TJ + (threadIdx.x & 31);
#pragma unroll
  for (int p = 0; p < q.NP; ++p) {
    const int b = n0 + (threadIdx.x >> 5) + WARPS * p;
#pragma unroll
    for (int g = 0; g < G; ++g) q.x[p][g] = 0.f;
    if (s < q.len[p]) {
      const int t = d == 0 ? s : q.len[p] - 1 - s;
      const __nv_bfloat16* x =
          a.xp + ((static_cast<size_t>(d) * a.Tn + t) * a.B + b) * GH + jj;
#pragma unroll
      for (int g = 0; g < G; ++g)
        q.x[p][g] = load_stream(x + g * a.H) + q.bi[g];
    }
  }
}

// The f32 state of the pairs from or to a.h / a.c (the per-step variant).
template <int G, int NT, bool STORE>
__device__ __forceinline__ void state_io(const Args& a, int d, int jb,
                                         int n0, Pairs<G, NT>& q) {
  const int jj = jb * TJ + (threadIdx.x & 31);
#pragma unroll
  for (int p = 0; p < q.NP; ++p) {
    if (q.len[p] < 0) continue;
    const int b = n0 + (threadIdx.x >> 5) + WARPS * p;
    const size_t e = (static_cast<size_t>(d) * a.B + b) * a.H + jj;
    if (STORE) {
      a.h[e] = q.h[p];
      if (G == 4) a.c[e] = q.c[p];
    } else {
      q.h[p] = a.h[e];
      q.c[p] = G == 4 ? a.c[e] : 0.f;
    }
  }
}

// The gate update of the thread's pairs for step s: the K-split sums plus
// b_hh, the gates in f32, h (and c) in q, h in the operand type for the
// next step's product, out and the residuals.
template <int G, int NT>
__device__ __forceinline__ void epilogue(const Args& a, const float* red,
                                         __nv_bfloat16* hb_out, int s,
                                         int d, int jb, int n0,
                                         Pairs<G, NT>& q) {
  using S = Smem<G, NT>;
  const int GH = G * a.H;
  const int j = threadIdx.x & 31, jj = jb * TJ + j;
#pragma unroll
  for (int p = 0; p < q.NP; ++p) {
    if (q.len[p] < 0) continue;
    const int n = (threadIdx.x >> 5) + WARPS * p;
    const int b = n0 + n;
    float hg[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float v = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSPLIT; ++ks)
        v += red[(ks * S::NC + n) * S::MP + g * TJ + j];
      hg[g] = v + q.bh[g];
    }
    const bool valid = s < q.len[p];
    const int t = (d == 0 || !valid) ? s : q.len[p] - 1 - s;
    const size_t row = (static_cast<size_t>(d) * a.Tn + t) * a.B + b;
    const float* x = q.x[p];
    const float hp = q.h[p];
    float h = hp;
    float gate[G];
#pragma unroll
    for (int g = 0; g < G; ++g) gate[g] = 0.f;
    float extra = 0.f;  // GRU: hn; LSTM: c
    if constexpr (G == 3) {
      if (valid) {
        gate[0] = ds_sigmoid(x[0] + hg[0]);
        gate[1] = ds_sigmoid(x[1] + hg[1]);
        gate[2] = tanhf(x[2] + gate[0] * hg[2]);
        h = (1.f - gate[1]) * gate[2] + gate[1] * hp;
        extra = hg[2];
      }
    } else {
      if (valid) {
        gate[0] = ds_sigmoid(x[0] + hg[0]);
        gate[1] = ds_sigmoid(x[1] + hg[1]);
        gate[2] = tanhf(x[2] + hg[2]);
        gate[3] = ds_sigmoid(x[3] + hg[3]);
        q.c[p] = gate[1] * q.c[p] + gate[0] * gate[2];
        h = gate[3] * tanhf(q.c[p]);
        extra = q.c[p];
      }
    }
    q.h[p] = h;
    hb_out[(static_cast<size_t>(d) * a.B8 + b) * a.Hk + jj] =
        __float2bfloat16(h);
    store_stream(a.out + row * a.H + jj, valid ? h : 0.f);
    if (a.g_out != nullptr) {
      __nv_bfloat16* gr = a.g_out + row * GH + jj;
#pragma unroll
      for (int g = 0; g < G; ++g) store_stream(gr + g * a.H, gate[g]);
      if constexpr (G == 3)
        store_stream(a.hn_out + row * a.H + jj, extra);
      else
        store_stream(a.c_out + row * a.H + jj, extra);
    }
  }
}

// One launch a step: grid (NJ, D); batches above NT * 8 rows loop over
// chunks.
template <int G, int NT>
__global__ void __launch_bounds__(THREADS, 1) step_kernel(Args a, int s) {
  extern __shared__ __align__(16) char smem[];
  const int jb = blockIdx.x, d = blockIdx.y;
  const size_t hsz = static_cast<size_t>(gridDim.y) * a.B8 * a.Hk;
  const __nv_bfloat16* hb_in = a.hb + (s & 1) * hsz;
  __nv_bfloat16* hb_out = a.hb + ((s + 1) & 1) * hsz;
  Pairs<G, NT> q;
  for (int n0 = 0; n0 < a.B8; n0 += NT * 8) {
    // in flight during the product
    load_pairs<G, NT>(a, d, jb, n0, q);
    load_x<G, NT>(a, s, d, jb, n0, q);
    state_io<G, NT, false>(a, d, jb, n0, q);
    product<G, NT>(a, hb_in, smem, d, jb, n0);
    epilogue<G, NT>(a, reinterpret_cast<float*>(smem), hb_out, s, d, jb, n0,
                    q);
    state_io<G, NT, true>(a, d, jb, n0, q);
    __syncthreads();  // `red` is read before the next chunk's ring loads
  }
}

// All steps in one cooperative launch (B8 <= NT * 8, every block
// resident): h and c of the thread's pairs stay in registers; between
// steps, the next step's projection is loaded before a grid barrier.
template <int G, int NT>
__global__ void __launch_bounds__(THREADS, 1) persistent_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int jb = blockIdx.x, d = blockIdx.y;
  const unsigned nblocks = gridDim.x * gridDim.y;
  const size_t hsz = static_cast<size_t>(gridDim.y) * a.B8 * a.Hk;
  Pairs<G, NT> q;
  load_pairs<G, NT>(a, d, jb, 0, q);
#pragma unroll
  for (int p = 0; p < q.NP; ++p) q.h[p] = q.c[p] = 0.f;
  load_x<G, NT>(a, 0, d, jb, 0, q);
  for (int s = 0; s < a.Tn; ++s) {
    const __nv_bfloat16* hb_in = a.hb + (s & 1) * hsz;
    __nv_bfloat16* hb_out = a.hb + ((s + 1) & 1) * hsz;
    product<G, NT>(a, hb_in, smem, d, jb, 0);
    epilogue<G, NT>(a, reinterpret_cast<float*>(smem), hb_out, s, d, jb, 0,
                    q);
    if (s + 1 == a.Tn) break;
    load_x<G, NT>(a, s + 1, d, jb, 0, q);
    // every block's h for step s is written
    grid_sync(a.bar, (s + 1) * nblocks);
  }
}

// variant: 0 the fixed rule, 1 one launch a step, 2 persistent.
template <int G, int NT>
cudaError_t launch(const Args& a, int D, int variant, cudaStream_t stream) {
  const size_t smem = Smem<G, NT>::BYTES;
  const dim3 grid(a.NJ, D);
  cudaError_t err = cudaFuncSetAttribute(
      step_kernel<G, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(persistent_kernel<G, NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (variant == 0) {  // the rule: persistent where one chunk holds B and
                       // the whole grid is resident at once
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, persistent_kernel<G, NT>, THREADS, smem);
    if (err != cudaSuccess) return err;
    variant = (a.B8 <= NT * 8 && a.NJ * D <= per_sm * sms) ? 2 : 1;
  }
  if (variant == 2) {
    if (a.B8 > NT * 8) return cudaErrorInvalidValue;
    Args copy = a;
    void* params[] = {&copy};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(persistent_kernel<G, NT>), grid,
        dim3(THREADS), params, smem, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  for (int s = 0; s < a.Tn; ++s) {
    step_kernel<G, NT><<<grid, THREADS, smem, stream>>>(a, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Zero the state, both h copies and the barrier, then run the Tn steps.
// NT is the least of 2, 4, 8 n-tiles whose chunk holds B8 (8 above 64).
template <int G>
cudaError_t recurrence(Args a, int D, int variant, cudaStream_t stream) {
  const size_t hsz = static_cast<size_t>(D) * a.B * a.H;
  cudaError_t err = cudaMemsetAsync(a.h, 0, hsz * sizeof(float), stream);
  if (err == cudaSuccess && a.c != nullptr)
    err = cudaMemsetAsync(a.c, 0, hsz * sizeof(float), stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(a.hb, 0,
                          2 * static_cast<size_t>(D) * a.B8 * a.Hk * 2,
                          stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(a.bar, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  if (a.B8 <= 16) return launch<G, 2>(a, D, variant, stream);
  if (a.B8 <= 32) return launch<G, 4>(a, D, variant, stream);
  return launch<G, 8>(a, D, variant, stream);
}

}  // namespace mma_rnn
