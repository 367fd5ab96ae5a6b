// The bf16 tensor-core recurrence shared by K4 (gru_scan.cu, G = 3 gates)
// and K6 (lstm_scan.cu, G = 4), on their bf16 projection, and by K2
// (gru_fwd.cu) and K3 (lstm_fwd.cu), on their f32 projection stream (the
// stream's type XT is a template parameter of the kernels): the hidden
// product h_prev @ W_hh of every step on mma.sync.m16n8k16 (bf16 operands,
// f32 accumulators), the gate update on f32 state with both biases added
// in f32 (the GRU's b_hn inside the r *), torch gate order. W_hh is either
// streamed once a step from L2 through a cp.async ring in shared memory
// (the step and persistent variants below) or, in the W-resident
// persistent variant (resident_kernel, further down), held in shared
// memory for the whole call.
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
//    and writes copy (s + 1) & 1, rounded to nearest even. The f32
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
//    variant loads each step's projection before its product. K4/K6's
//    fixed rule chooses: persistent where the batch fits one chunk
//    (B8 <= 64) and the grid is resident at once; else one launch a step.
//    K2/K3's rule (ops/cuda/recurrence.py: fwd_variant) puts the
//    W-resident variant first, where its slices fit and its grid is
//    resident.
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
  const void* xp;            // (D, T, B, G*H) projection, without b_ih: XT
                             // of the kernels, bf16 (K4, K6) or f32 (K2, K3)
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

// The grid barrier of the persistent kernels (a cooperative launch; the
// counter is zeroed before it), the pattern of CUTLASS's GenericBarrier:
// the block barrier orders the block's writes before thread 0's release
// reduction, which makes them visible at gpu scope with no separate fence
// and returns nothing to wait for; thread 0's acquire load that sees
// `target` arrivals, then the block barrier, order every thread's later
// accesses after every block's writes. That covers what the generic proxy
// reads and writes after it: loads, the non-bulk cp.async of the streamed
// forward's and the backward's rings (h_prev's or the operand's copy from
// the other blocks) and the ring's stores over `red`, which the backward's
// peer read through distributed shared memory before its arrival. A kernel
// that reads what it guards through bulk copies (the async proxy: the
// W-resident forward below, gru_scan.cu's f32 persistent scan) issues
// fence.proxy.async before it. On the H100 it takes ~0.95 us a step on
// grids of 100 and 104 blocks, against ~1.29 us for cooperative groups'
// fence, atomicAdd, spin and fence (PERF.md §6).
__device__ __forceinline__ void grid_sync_release(unsigned* bar,
                                                  unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar)
                 : "memory");
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(bar) : "memory");
    } while (seen < target);
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

__device__ __forceinline__ float load_stream(const float* p) {
  return __ldcs(p);
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

// What one thread keeps for its NP (unit, row) pairs of a chunk of NC batch
// rows in a block of UJ units: unit jb * UJ + tid % UJ, row n0 + tid / UJ
// + RS p (the streamed variants' UJ = TJ = 32 gives unit = lane, row = warp
// + 16 p). Loaded before the product, so the epilogue reads nothing from
// global memory but the K-split sums.
template <int G_, int NC_, int UJ_>
struct Pairs {
  static constexpr int G = G_, NC = NC_, UJ = UJ_;
  static constexpr int RS = THREADS / UJ;        // row stride
  static constexpr int NP = (NC + RS - 1) / RS;  // pairs a thread
  int len[NP];     // the row's length; -1 where the pair lies outside
  float bi[G];     // b_ih of the unit
  float bh[G];     // b_hh of the unit
  float x[NP][G];  // the step's projection, without b_ih; 0 past the
                   // length
  float h[NP];     // f32 state
  float c[NP];     // LSTM cell state
  __device__ __forceinline__ static int unit() { return threadIdx.x % UJ; }
  __device__ __forceinline__ static int row(int p) {
    return threadIdx.x / UJ + RS * p;
  }
};

template <class Q>
__device__ __forceinline__ void load_pairs(const Args& a, int d, int jb,
                                           int n0, Q& q) {
  const int GH = Q::G * a.H;
  const int jj = jb * Q::UJ + Q::unit();
#pragma unroll
  for (int g = 0; g < Q::G; ++g) {
    q.bi[g] = jj < a.H ? a.b_ih[d * GH + g * a.H + jj] : 0.f;
    q.bh[g] = jj < a.H ? a.b_hh[d * GH + g * a.H + jj] : 0.f;
  }
#pragma unroll
  for (int p = 0; p < Q::NP; ++p) {
    const int n = Q::row(p), b = n0 + n;
    q.len[p] = (jj < a.H && n < Q::NC && b < a.B) ? a.lens[b] : -1;
  }
}

// The projection of step s for the thread's pairs (XT: bf16 for K4/K6, f32
// for K2/K3), widened to f32 without b_ih (the epilogue adds it, so that no
// instruction waits for the load before the grid barrier); read once, so
// it does not displace W_hh in L2.
template <typename XT, class Q>
__device__ __forceinline__ void load_x(const Args& a, int s, int d, int jb,
                                       int n0, Q& q) {
  const int GH = Q::G * a.H;
  const int jj = jb * Q::UJ + Q::unit();
  const XT* xp = static_cast<const XT*>(a.xp);
#pragma unroll
  for (int p = 0; p < Q::NP; ++p) {
    const int b = n0 + Q::row(p);
#pragma unroll
    for (int g = 0; g < Q::G; ++g) q.x[p][g] = 0.f;
    if (s < q.len[p]) {
      const int t = d == 0 ? s : q.len[p] - 1 - s;
      const XT* x =
          xp + ((static_cast<size_t>(d) * a.Tn + t) * a.B + b) * GH + jj;
#pragma unroll
      for (int g = 0; g < Q::G; ++g)
        q.x[p][g] = load_stream(x + g * a.H);
    }
  }
}

// The f32 state of the pairs from or to a.h / a.c (the per-step variant).
template <bool STORE, class Q>
__device__ __forceinline__ void state_io(const Args& a, int d, int jb,
                                         int n0, Q& q) {
  const int jj = jb * Q::UJ + Q::unit();
#pragma unroll
  for (int p = 0; p < Q::NP; ++p) {
    if (q.len[p] < 0) continue;
    const int b = n0 + Q::row(p);
    const size_t e = (static_cast<size_t>(d) * a.B + b) * a.H + jj;
    if (STORE) {
      a.h[e] = q.h[p];
      if (Q::G == 4) a.c[e] = q.c[p];
    } else {
      q.h[p] = a.h[e];
      q.c[p] = Q::G == 4 ? a.c[e] : 0.f;
    }
  }
}

// The gate update of the thread's pairs for step s: the KS K-split sums
// (red[(ks * NC + n) * MP + g * UJ + j]) plus b_hh, the gates in f32, h
// (and c) in q, h in the operand type for the next step's product, out and
// the residuals. b_ih is added here to load_x's projection: (x + b_ih) + hg.
// A pair past its row's length holds b_ih, which no gate reads.
template <int KS, int MP, class Q>
__device__ __forceinline__ void epilogue(const Args& a, const float* red,
                                         __nv_bfloat16* hb_out, int s,
                                         int d, int jb, int n0, Q& q) {
  constexpr int G = Q::G;
  const int GH = G * a.H;
  const int j = Q::unit(), jj = jb * Q::UJ + j;
#pragma unroll
  for (int p = 0; p < Q::NP; ++p) {
    if (q.len[p] < 0) continue;
    const int n = Q::row(p);
    const int b = n0 + n;
    float hg[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float v = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        v += red[(ks * Q::NC + n) * MP + g * Q::UJ + j];
      hg[g] = v + q.bh[g];
    }
    const bool valid = s < q.len[p];
    const int t = (d == 0 || !valid) ? s : q.len[p] - 1 - s;
    const size_t row = (static_cast<size_t>(d) * a.Tn + t) * a.B + b;
    float x[G];
#pragma unroll
    for (int g = 0; g < G; ++g) x[g] = q.x[p][g] + q.bi[g];
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
template <typename XT, int G, int NT>
__global__ void __launch_bounds__(THREADS, 1) step_kernel(Args a, int s) {
  using S = Smem<G, NT>;
  extern __shared__ __align__(16) char smem[];
  const int jb = blockIdx.x, d = blockIdx.y;
  const size_t hsz = static_cast<size_t>(gridDim.y) * a.B8 * a.Hk;
  const __nv_bfloat16* hb_in = a.hb + (s & 1) * hsz;
  __nv_bfloat16* hb_out = a.hb + ((s + 1) & 1) * hsz;
  Pairs<G, S::NC, TJ> q;
  for (int n0 = 0; n0 < a.B8; n0 += S::NC) {
    // in flight during the product
    load_pairs(a, d, jb, n0, q);
    load_x<XT>(a, s, d, jb, n0, q);
    state_io<false>(a, d, jb, n0, q);
    product<G, NT>(a, hb_in, smem, d, jb, n0);
    epilogue<KSPLIT, S::MP>(a, reinterpret_cast<float*>(smem), hb_out, s, d,
                            jb, n0, q);
    state_io<true>(a, d, jb, n0, q);
    __syncthreads();  // `red` is read before the next chunk's ring loads
  }
}

// All steps in one cooperative launch (B8 <= NT * 8, every block
// resident): h and c of the thread's pairs stay in registers; between
// steps, the next step's projection is loaded before a grid barrier.
template <typename XT, int G, int NT>
__global__ void __launch_bounds__(THREADS, 1) persistent_kernel(Args a) {
  using S = Smem<G, NT>;
  extern __shared__ __align__(16) char smem[];
  const int jb = blockIdx.x, d = blockIdx.y;
  const unsigned nblocks = gridDim.x * gridDim.y;
  const size_t hsz = static_cast<size_t>(gridDim.y) * a.B8 * a.Hk;
  Pairs<G, S::NC, TJ> q;
  load_pairs(a, d, jb, 0, q);
#pragma unroll
  for (int p = 0; p < q.NP; ++p) q.h[p] = q.c[p] = 0.f;
  load_x<XT>(a, 0, d, jb, 0, q);
  for (int s = 0; s < a.Tn; ++s) {
    const __nv_bfloat16* hb_in = a.hb + (s & 1) * hsz;
    __nv_bfloat16* hb_out = a.hb + ((s + 1) & 1) * hsz;
    product<G, NT>(a, hb_in, smem, d, jb, 0);
    epilogue<KSPLIT, S::MP>(a, reinterpret_cast<float*>(smem), hb_out, s, d,
                            jb, 0, q);
    if (s + 1 == a.Tn) break;
    load_x<XT>(a, s + 1, d, jb, 0, q);
    // every block's h for step s is written
    grid_sync_release(a.bar, (s + 1) * nblocks);
  }
}

// The W-resident persistent variant (K2 and K3, where the slices fit: H 800
// at B8 <= 64). A block owns RJ = 16 units of one direction; the blocks of
// a direction form clusters of RCL, grid (RCL ceil(ceil(H / RJ) / RCL), D)
// (a block past H, which pads the last cluster, owns no unit). Each block
// loads its slice of the packed W_hh (the G * RJ gate rows of its units,
// gate-major, every K column; half of a pack_w_hh tile's row set) into
// shared memory once a call. A step then brings only h_prev's bf16 copy
// (B8 rows of the K columns) from L2: each block of a cluster fetches every
// RCL-th row with bulk copies (TMA) multicast into the staging rows of all
// the cluster's blocks, in HCH column groups, each completing on its own
// mbarrier, so that the products start as each group arrives. Then the
// product from the resident slice, the epilogue, the grid barrier.
//
// Why the multicast: every block needs all of h_prev, so 100 blocks each
// reading it alone send 100 x 24 x 800 x 2 bytes = 3.84 MB of requests to
// L2 a step for 77 KB of data, and no step can start before they are
// served; clusters of RCL cut the requests RCL-fold. chip_stamps.py
// measures where a step's time goes.
//
// Shared memory of a block, in rows of KW = 16 ceil(H / 16) columns at a
// pitch of KW + 8 elements (8 KW / 16 + 4 words, an odd multiple of 4: the
// 8 rows of one ldmatrix land on distinct banks):
//   W slice   G * RJ * (KW + 8) * 2 bytes;
//   h staging NC * (KW + 8) * 2 bytes (NC = NT * 8, the batch chunk), which
//             the K-split sums, KS * NC * (G * RJ + 4) * 4 bytes, take
//             over after the product;
//   HCH mbarriers.
// At H 800 and B 20 (NT 4): GRU 77,568 + 53,248 + 16 = 130,832 bytes, LSTM
// 103,424 + 69,632 + 16 = 173,072; at B8 64 (NT 8) 181,008 and 206,864;
// all below the 232,448 bytes a block may have. The grid is 104 blocks on
// 132 SMs. At H 1600 the GRU's slice alone is 154,368 bytes and the grid
// 200 blocks, so the wide GRU's layer 0 takes the streamed persistent
// variant.
// RJ = 16 rather than the streamed variants' TJ = 32: 32 units of the LSTM
// take 128 rows x 1,616 bytes = 206,848 bytes, which leaves no room for
// h_prev beside them.
// Warps: MG = 2 groups along M (group 0 the first ceil(G / 2) gate tiles
// of the block's 16 units, group 1 the rest) times KS along K (the k16
// steps ks, ks + KS, ...) times WN along the batch (NTW n tiles each;
// WN = 1 up to 32 rows), so a step reads each W element from shared
// memory WN times and h_prev MG times. The KS partial sums of each output
// meet in KS slots of shared memory, which the epilogue adds.
constexpr int RJ = 16;   // units a block
constexpr int RCL = 4;   // blocks a cluster, sharing each step's h_prev
constexpr int HCH = 2;   // column groups of a step's h_prev load

// Phase stamps of a step, for chip_stamps.py: built with -DDS_STEP_STAMPS,
// thread 0 of blocks 0 and 24 of direction 0 records clock64() at
// STAMP_POINTS points of steps STAMP_FIRST .. STAMP_FIRST + STAMP_STEPS - 1
// (ds_read_stamps copies them out); otherwise the stamps compile to
// nothing.
#ifdef DS_STEP_STAMPS
constexpr int STAMP_FIRST = 100, STAMP_STEPS = 64, STAMP_POINTS = 5 + HCH;
__device__ long long stamps[2][STAMP_STEPS][STAMP_POINTS];
#define DS_STAMP(step, k)                                                  \
  do {                                                                     \
    if (threadIdx.x == 0 && blockIdx.y == 0                                \
        && (blockIdx.x == 0 || blockIdx.x == 24) && (step) >= STAMP_FIRST  \
        && (step) < STAMP_FIRST + STAMP_STEPS)                             \
      stamps[blockIdx.x == 24][(step) - STAMP_FIRST][k] = clock64();       \
  } while (0)
#else
#define DS_STAMP(step, k) ((void)0)
#endif

template <int G, int NT>
struct ResShape {
  static constexpr int M = G * RJ;
  static constexpr int NC = NT * 8;
  static constexpr int MP = M + 4;
  static constexpr int MG = 2;                // warp groups along M
  static constexpr int GM = (G + 1) / 2;      // gate tiles of group 0
  static constexpr int WN = NT >= 8 ? 2 : 1;  // warps along N
  static constexpr int NTW = NT / WN;         // n tiles a warp: 2, 4, 4
  static constexpr int KS = WARPS / (MG * WN);  // warps along K: 8, 8, 4
  static_assert(NTW % 2 == 0, "n tiles in ldmatrix.x4 pairs");
  static constexpr size_t RED = size_t(KS) * NC * MP * 4;
  __host__ __device__ static int kw(int H) { return (H + 15) / 16 * 16; }
  __host__ __device__ static size_t w_bytes(int H) {
    return size_t(M) * (kw(H) + 8) * 2;
  }
  // the staging rows or the sums: the mbarriers follow
  __host__ __device__ static size_t work_bytes(int H) {
    const size_t hs = size_t(NC) * (kw(H) + 8) * 2;
    return hs > RED ? hs : RED;
  }
  __host__ __device__ static size_t bytes(int H) {
    return w_bytes(H) + work_bytes(H) + HCH * 8;
  }
};

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of bulk copies on the barrier.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` from global memory to the same shared-memory offset `dst` of
// every block in `mask` of the cluster, completing on each one's `bar`.
__device__ __forceinline__ void bulk_multicast(unsigned dst, const void* src,
                                               unsigned bytes, unsigned bar,
                                               unsigned short mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// The block's W slice from the packed W_hh: row g * RJ + jj, column k holds
// tile (d, jb / 2, k / KC) row g * TJ + (jb & 1) * RJ + jj, column k % KC.
template <int G>
__device__ __forceinline__ void load_w_slice(const Args& a,
                                             __nv_bfloat16* ws, int d,
                                             int jb, int kw) {
  const int pitch = kw + 8, pieces = kw / 8;  // 16-byte pieces a row
  const size_t tile = size_t(G) * TJ * KC;    // elements of a packed tile
  const __nv_bfloat16* wt =
      a.w + (static_cast<size_t>(d) * a.NJ + jb / 2) * a.NK * tile;
  for (int i = threadIdx.x; i < G * RJ * pieces; i += THREADS) {
    const int r = i / pieces, col = (i % pieces) * 8;
    const int g = r / RJ, jj = r % RJ;
    cp_async16(smem_addr(ws + r * pitch + col),
               wt + (col / KC) * tile + (g * TJ + (jb & 1) * RJ + jj) * KC
                   + col % KC);
  }
}

// The first column of group c of a step's h_prev load (c = HCH: KW).
__device__ __forceinline__ int group_col(int c, int kw) {
  return c * (kw / 16) / HCH * 16;
}

// Step s's h_prev into the staging rows of the cluster: thread 0 arms each
// group's barrier with the group's bytes (all B8 rows), and lane 0 of each
// warp fetches some of this block's rows (rank, rank + RCL, ...) of each
// group, multicast to the cluster. The bulk copies of one warp issue one
// after another, so they are few (HCH = 2 groups of row pieces) and spread
// over the warps.
__device__ __forceinline__ void fetch_h(const Args& a,
                                        const __nv_bfloat16* hb_in,
                                        __nv_bfloat16* hs, unsigned bars,
                                        int d, int kw) {
  const int pitch = kw + 8;
  if (threadIdx.x == 0) {
    for (int c = 0; c < HCH; ++c)
      mbar_expect(bars + 8 * c,
                  a.B8 * (group_col(c + 1, kw) - group_col(c, kw)) * 2);
  }
  if ((threadIdx.x & 31) != 0) return;
  const int rank = static_cast<int>(cluster_ctarank());
  const int rows = (a.B8 - rank + RCL - 1) / RCL;
  const __nv_bfloat16* src = hb_in + static_cast<size_t>(d) * a.B8 * a.Hk;
  for (int i = threadIdx.x >> 5; i < rows * HCH; i += WARPS) {
    const int r = rank + RCL * (i / HCH), c = i % HCH;
    const int c0 = group_col(c, kw), c1 = group_col(c + 1, kw);
    if (c1 > c0)
      bulk_multicast(smem_addr(hs + r * pitch + c0),
                     src + static_cast<size_t>(r) * a.Hk + c0,
                     (c1 - c0) * 2, bars + 8 * c, (1u << RCL) - 1);
  }
}

// Step s's hidden products of block (jb, d) from the resident slice `ws`
// and the staging rows `hs` (h_prev, arriving on the group barriers of
// parity s & 1), into `red` (which aliases `hs`): red[ks][n][g * RJ + j]
// = the sum over k16 steps ks, ks + KS, ... of h_prev[n, k] *
// w_hh[k, g * H + jb * RJ + j]. Ends with a __syncthreads, so `red` may be
// read.
template <int G, int NT>
__device__ __forceinline__ void res_product(const Args& a,
                                            const __nv_bfloat16* ws,
                                            const __nv_bfloat16* hs,
                                            float* red, unsigned bars,
                                            int s, int kw) {
  using R = ResShape<G, NT>;
  constexpr int NTW = R::NTW, KS = R::KS;
  const int pitch = kw + 8;
  constexpr int GM = R::GM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mg = warp / (WARPS / R::MG), wr = warp % (WARPS / R::MG);
  const int wn = wr % R::WN, ks = wr / R::WN;
  const int g0 = mg * GM, ng = mg == 0 ? GM : G - GM;  // the warp's gates
  const int nact = a.B8 / 8 - wn * NTW;  // the warp's n tiles with rows
  float acc[GM][NTW][4];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][n][e] = 0.f;
  // ldmatrix addresses, in elements: lane l gives row l & 7 of matrix l >> 3
  const int q = lane >> 3, r8 = lane & 7;
  const unsigned wa = smem_addr(ws) + 2 * (((q & 1) * 8 + r8) * pitch
                                           + (q >> 1) * 8);
  const unsigned ha = smem_addr(hs) + 2 * ((wn * NTW * 8 + (q >> 1) * 8
                                            + r8) * pitch + (q & 1) * 8);
  for (int c = 0; c < HCH; ++c) {
    mbar_wait(bars + 8 * c, s & 1);  // group c is in every staging row
    DS_STAMP(s, 2 + c);
    if (nact <= 0) continue;
    const int k0 = group_col(c, kw) / 16, k1 = group_col(c + 1, kw) / 16;
    for (int kk = k0 + ((ks - k0) % KS + KS) % KS; kk < k1; kk += KS) {
      unsigned af[GM][4];
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < ng)
          ldmatrix_x4(af[g], wa + 2 * ((g0 + g) * RJ * pitch + kk * 16));
#pragma unroll
      for (int np = 0; np < NTW / 2; ++np) {
        if (2 * np >= nact) continue;
        unsigned bf[4];
        ldmatrix_x4(bf, ha + 2 * (np * 16 * pitch + kk * 16));
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= ng) continue;
          mma_bf16(acc[g][2 * np], af[g], bf[0], bf[1]);
          if (2 * np + 1 < nact)
            mma_bf16(acc[g][2 * np + 1], af[g], bf[2], bf[3]);
        }
      }
    }
  }
  __syncthreads();  // every warp has read `hs`: `red` takes its bytes
  DS_STAMP(s, 2 + HCH);
  const int gid = lane >> 2, tig = lane & 3;
  float* base = red + (ks * R::NC + wn * NTW * 8 + 2 * tig) * R::MP
                + g0 * RJ + gid;
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      if (g >= ng || n >= nact) continue;
      float* p = base + n * 8 * R::MP + g * RJ;
      p[0] = acc[g][n][0];
      p[R::MP] = acc[g][n][1];
      p[8] = acc[g][n][2];
      p[R::MP + 8] = acc[g][n][3];
    }
  __syncthreads();
}

// All steps in one cooperative launch in clusters of RCL, with W_hh
// resident (B8 <= NT * 8, every block resident): as persistent_kernel, on
// RJ units a block.
template <typename XT, int G, int NT>
__global__ void __launch_bounds__(THREADS, 1) resident_kernel(Args a) {
  using R = ResShape<G, NT>;
  extern __shared__ __align__(16) char smem[];
  const int jb = blockIdx.x, d = blockIdx.y;
  const int kw = R::kw(a.H);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  char* work = smem + R::w_bytes(a.H);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(work);
  float* red = reinterpret_cast<float*>(work);
  const unsigned bars = smem_addr(work + R::work_bytes(a.H));
  const unsigned nblocks = gridDim.x * gridDim.y;
  const size_t hsz = static_cast<size_t>(gridDim.y) * a.B8 * a.Hk;
  if (jb * RJ < a.H) load_w_slice<G>(a, ws, d, jb, kw);
  cp_async_commit();
  if (threadIdx.x == 0) {
    for (int c = 0; c < HCH; ++c) mbar_init(bars + 8 * c, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  Pairs<G, R::NC, RJ> q;
  load_pairs(a, d, jb, 0, q);
#pragma unroll
  for (int p = 0; p < q.NP; ++p) q.h[p] = q.c[p] = 0.f;
  load_x<XT>(a, 0, d, jb, 0, q);
  cp_async_wait<0>();
  // the W slice is in, and every barrier of the cluster is initialised
  // before any block multicasts into it
  cluster_barrier();
  for (int s = 0; s < a.Tn; ++s) {
    const __nv_bfloat16* hb_in = a.hb + (s & 1) * hsz;
    __nv_bfloat16* hb_out = a.hb + ((s + 1) & 1) * hsz;
    DS_STAMP(s, 0);
    fetch_h(a, hb_in, hs, bars, d, kw);
    DS_STAMP(s, 1);
    res_product<G, NT>(a, ws, hs, red, bars, s, kw);
    DS_STAMP(s, 3 + HCH);
    epilogue<R::KS, R::MP>(a, red, hb_out, s, d, jb, 0, q);
    DS_STAMP(s, 4 + HCH);
    if (s + 1 == a.Tn) break;
    // in flight through the barrier
    load_x<XT>(a, s + 1, d, jb, 0, q);
    // the generic writes of this step, h_prev's copy in global memory and
    // `red` in shared memory, are read or overwritten by the next step's
    // bulk copies (the async proxy)
    asm volatile("fence.proxy.async;\n" ::: "memory");
    // every block's h for step s is written, and every block has read its
    // sums
    grid_sync_release(a.bar, (s + 1) * nblocks);
  }
  cluster_barrier();  // no block leaves while its cluster may copy into it
}

// The W-resident kernel's launch: grid (RCL ceil(ceil(H / RJ) / RCL), D) in
// clusters of RCL, cooperative or not (the occupancy query).
struct ResConfig {
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg{};
  ResConfig(int H, int D, size_t smem, bool cooperative,
            cudaStream_t stream) {
    const int nj = (H + RJ - 1) / RJ;
    cfg.gridDim = dim3((nj + RCL - 1) / RCL * RCL, D);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = RCL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cooperative ? 2 : 1;
  }
};

// The resident kernel's shared memory, set as its dynamic limit; an error
// where it exceeds what a block may have.
template <typename XT, int G, int NT>
cudaError_t res_smem(int H, size_t* smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *smem = ResShape<G, NT>::bytes(H);
  if (*smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(resident_kernel<XT, G, NT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

// variant 3: refused where the batch does not fit one chunk or the slice
// and its staging exceed a block's shared memory; the cooperative launch
// refuses a grid that is not resident. No fallback.
template <typename XT, int G, int NT>
cudaError_t launch_resident(const Args& a, int D, cudaStream_t stream) {
  if (a.B8 > ResShape<G, NT>::NC) return cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t err = res_smem<XT, G, NT>(a.H, &smem);
  if (err != cudaSuccess) return err;
  ResConfig c(a.H, D, smem, true, stream);
  err = cudaLaunchKernelEx(&c.cfg, resident_kernel<XT, G, NT>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// variant: 0 the fixed rule of K4/K6 (persistent where one chunk holds B
// and the grid is resident at once, else one launch a step), 1 one launch
// a step, 2 persistent with W_hh streamed, 3 persistent with W_hh resident
// (K2/K3's wrappers choose by recurrence.py:fwd_variant).
template <typename XT, int G, int NT>
cudaError_t launch(const Args& a, int D, int variant, cudaStream_t stream) {
  if (variant == 3) return launch_resident<XT, G, NT>(a, D, stream);
  const size_t smem = Smem<G, NT>::BYTES;
  const dim3 grid(a.NJ, D);
  cudaError_t err = cudaFuncSetAttribute(
      step_kernel<XT, G, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(persistent_kernel<XT, G, NT>,
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
          &per_sm, persistent_kernel<XT, G, NT>, THREADS, smem);
    if (err != cudaSuccess) return err;
    variant = (a.B8 <= NT * 8 && a.NJ * D <= per_sm * sms) ? 2 : 1;
  }
  if (variant == 2) {
    if (a.B8 > NT * 8) return cudaErrorInvalidValue;
    Args copy = a;
    void* params[] = {&copy};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(persistent_kernel<XT, G, NT>), grid,
        dim3(THREADS), params, smem, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  if (variant != 1) return cudaErrorInvalidValue;
  for (int s = 0; s < a.Tn; ++s) {
    step_kernel<XT, G, NT><<<grid, THREADS, smem, stream>>>(a, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Zero the state, both h copies and the barrier, then run the Tn steps.
// NT is the least of 2, 4, 8 n-tiles whose chunk holds B8 (8 above 64).
// XT is the projection stream's type.
template <int G, typename XT = __nv_bfloat16>
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
  if (a.B8 <= 16) return launch<XT, G, 2>(a, D, variant, stream);
  if (a.B8 <= 32) return launch<XT, G, 4>(a, D, variant, stream);
  return launch<XT, G, 8>(a, D, variant, stream);
}

// How many blocks of the streamed persistent kernel and of the W-resident
// kernel (in clusters of RCL) can be resident at once for a batch of b rows
// and H units (the latter 0 where its shared memory exceeds a block's): the
// inputs of the wrappers' rule (recurrence.py: fwd_variant).
template <int G, int NT>
cudaError_t capacity_of(int H, int* streamed, int* resident) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t s2 = Smem<G, NT>::BYTES;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(persistent_kernel<float, G, NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s2));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, persistent_kernel<float, G, NT>, THREADS, s2);
  if (err != cudaSuccess) return err;
  *streamed = per_sm * sms;
  *resident = 0;
  size_t s3 = 0;
  if (res_smem<float, G, NT>(H, &s3) != cudaSuccess) {
    cudaGetLastError();  // the slice does not fit: no resident block
    return cudaSuccess;
  }
  ResConfig c(H, 1, s3, false, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters,
                                       resident_kernel<float, G, NT>, &c.cfg);
  if (err == cudaSuccess) *resident = clusters * RCL;
  return err;
}

template <int G>
cudaError_t capacity(int b, int H, int* streamed, int* resident) {
  const int b8 = (b + 7) / 8 * 8;
  if (b8 <= 16) return capacity_of<G, 2>(H, streamed, resident);
  if (b8 <= 32) return capacity_of<G, 4>(H, streamed, resident);
  return capacity_of<G, 8>(H, streamed, resident);
}

}  // namespace mma_rnn

#ifdef DS_STEP_STAMPS
// The phase stamps of the last W-resident launch, (2, STAMP_STEPS,
// STAMP_POINTS) int64, for chip_stamps.py.
DS_EXPORT int ds_read_stamps(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, mma_rnn::stamps,
                                               sizeof(mma_rnn::stamps)));
}
#endif
