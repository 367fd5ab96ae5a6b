// The DS2 conv front's products in bf16 configurations
// (models/ds2.py:ConvFrontend), on tensor cores: the forward of both
// convs, the input gradient (dgrad) of the second and the weight gradient
// (wgrad) of both, as implicit GEMMs on mma.sync.m16n8k16 with bf16
// operands and f32 sums. It replaces no TPU kernel: the JAX package's conv
// front is banded einsums that XLA lowers (deepspeech_tpu/ops/
// banded_conv.py: bf16 operands, f32 results). No library conv takes bf16
// in and gives f32 out, and conv1's im2col at batch 64 would be ~25 GB, so
// the products are written here (ops/cuda/conv.py wraps them).
//
// Geometry (NCHW at every entry point; T is the frames after conv0, T_in
// the spectrogram's):
//  * conv0: x (B, 1, 161, T_in) -> (B, 32, 81, T), kernel 41 x 11, stride
//    (2, 2), padding (20, 5);
//  * conv1: h (B, 32, 81, T) -> (B, 32, 41, T), kernel 21 x 11, stride
//    (2, 1), padding (10, 5).
//
// Numbers: both forward operands are bf16 values, so every product is
// exact in f32 and the forward equals the f32 conv of the rounded
// operands up to the order of the f32 sums. The gradients read dy (f32)
// as hi + lo, two bf16 terms split in registers as dy is staged
// (hi = bf16(dy), lo = bf16(dy - hi)): 16 significant bits, whose error
// lies ~2^-8 under the bf16 rounding the results get (dx and dw are
// rounded to bf16 as the backward of the model's bf16 rounding rounds
// them). The weight gradient's sum over (b, row, frame) is split across
// blocks into partial sums in scratch that a second launch adds in a fixed
// order: no atomics, the same bits on every run.
//
// Bound (H100 SXM, 989 TFLOP/s bf16 dense): a train step of the wide cell
// (B 64, T ~637) is ~886 GFLOP forward, ~791 dgrad, ~886 wgrad; with the
// split the gradients' tensor work doubles, 4.24 TFLOP, ~4.3 ms. The bytes
// are a few hundred MB. So the products are bound by operations; the
// design keeps every operand tile in shared memory and reads it many
// times:
//  * fprop0: a block is one output row and 128 frames, 4 warps of 32
//    frames x 32 channels. The 41 input rows' 272 frames (bf16, rounded as
//    they are staged) and all of conv0's weights sit in shared memory; a
//    k16 step is one kernel row (11 taps padded to 16), and A's pairs are
//    32-bit loads at even frame offsets (time stride 2).
//  * rowconv (fprop1 and dgrad1): a block is one output row and 128
//    frames. Stages of (kernel row j, half of the input channels) walk a
//    cp.async ring of two weight buffers; the input row's 140 frames are
//    staged channels-last through registers (loads for stage s + 1 in
//    flight while stage s computes), so each of the 11 taps in time is an
//    ldmatrix of rows shifted by the tap. dgrad is the same walk over dy
//    with the kernel flipped in time and the rows split by parity: an even
//    output row reads kernel rows 20, 18, .., 0 of consecutive dy rows, an
//    odd one 19, .., 1 (ops/cuda/conv.py packs both).
//  * wgrad: a block owns the whole weight slice of one kernel row (conv1)
//    or the whole kernel (conv0, 8 warps) for one split of the (b, row,
//    64-frame chunk) items; dy's chunk sits in shared memory as hi and lo
//    rows (A, by ldmatrix), x's as two copies offset by one frame (conv1),
//    so every tap's pair of frames is one aligned 32-bit load, or as 41
//    rows read in pairs of 16-bit loads (conv0, time stride 2). An item's
//    loads go straight from registers to shared memory: held across the
//    compute (as rowconv's are) they pushed both kernels to 255 registers
//    and spills, ~1.15x slower on the card; other blocks on the SM cover
//    the loads instead.
#include <cstdint>
#include <type_traits>

#include "rnn_mma.cuh"

namespace conv_mma {

using mma_rnn::cp_async16;
using mma_rnn::cp_async_commit;
using mma_rnn::cp_async_wait;
using mma_rnn::ldmatrix_x4;
using mma_rnn::mma_bf16;
using mma_rnn::smem_addr;

constexpr int NC = 32;        // output channels of both convs, inputs of conv1
constexpr int THREADS = 128;  // 4 warps (wgrad0: 8)
constexpr int TT = 128;       // output frames a block (fprop, dgrad)

// conv0: 1 -> 32, 41 x 11, stride (2, 2), padding (20, 5)
constexpr int K0H = 41, K0W = 11, F0IN = 161, F0OUT = 81;
constexpr int K0WP = 16;              // a kernel row's taps, padded: one k16
constexpr int K0 = K0H * K0WP;        // 656: packed weights (32, K0)
constexpr int W0P = K0 + 8;           // their smem pitch: 1,328 B
constexpr int X0W = 2 * TT + 16;      // input frames a block: 272
constexpr size_t SMEM_F0 = (size_t(K0H) * X0W + size_t(NC) * W0P) * 2;

// conv1: 32 -> 32, 21 x 11, stride (2, 1), padding (10, 5)
constexpr int K1H = 21, K1W = 11, F1IN = 81, F1OUT = 41;
constexpr int CH = 16;                // input channels a rowconv stage
constexpr int CP = CH + 8;            // channels-last pitch: 48 B
constexpr int XR = TT + 12;           // a stage's frames, t0 - 6 on
constexpr int WST = K1W * NC * CP;    // a weight stage in smem (elements)
constexpr int WSTG = K1W * NC * CH;   // and in the packed tensor

// wgrad
constexpr int TK = 64;                // frames an item
constexpr int DYP = TK + 8;           // dy hi/lo pitch: 144 B
constexpr int XCP = 88;               // conv1 x copies' pitch: 44 words
constexpr int X0WG = 2 * TK + 12;     // conv0 x frames an item: 140
constexpr int N0 = K0H * K0W;         // 451 = conv0's (kh, kw)
constexpr int N0T = (N0 + 7) / 8;     // its n8 tiles: 57
constexpr int G0T = 8;                // wgrad0 tiles a warp (8 warps)

__device__ __forceinline__ unsigned pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo))
         | (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// dy = hi + lo to 16 significant bits: hi = bf16(dy), lo = bf16(dy - hi)
__device__ __forceinline__ void split(float v, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// ---------------------------------------------------------------- fprop0
// out (B, 32, 81, T) f32 = conv0(bf16(x), w) + bias; w packed (32, K0)
// bf16, w[n][kh * 16 + kw] (zero at kw >= 11). Grid (ceil(T / TT), 81, B).
__global__ void __launch_bounds__(THREADS)
fprop0_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ out, int Tin,
              int T) {
  extern __shared__ __align__(16) char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + K0H * X0W;
  const int t0 = blockIdx.x * TT, fo = blockIdx.y, b = blockIdx.z;
  for (int i = threadIdx.x; i < NC * (K0 / 8); i += THREADS) {
    const int n = i / (K0 / 8), p = i % (K0 / 8);
    cp_async16(smem_addr(ws + n * W0P + p * 8), w + n * K0 + p * 8);
  }
  cp_async_commit();
  // xs[r][p] = bf16(x[2 fo - 20 + r][2 t0 - 5 + p]), zero outside
  const float* xb = x + static_cast<size_t>(b) * F0IN * Tin;
  const int r0 = 2 * fo - 20, p0 = 2 * t0 - 5;
  for (int i = threadIdx.x; i < K0H * X0W / 2; i += THREADS) {
    const int r = i / (X0W / 2), p = 2 * (i % (X0W / 2));
    const int row = r0 + r, f = p0 + p;
    float v0 = 0.f, v1 = 0.f;
    if (row >= 0 && row < F0IN) {
      const float* src = xb + static_cast<size_t>(row) * Tin;
      if (f >= 0 && f < Tin) v0 = src[f];
      if (f + 1 >= 0 && f + 1 < Tin) v1 = src[f + 1];
    }
    reinterpret_cast<__nv_bfloat162*>(xs + r * X0W)[p / 2] =
        __floats2bfloat162_rn(v0, v1);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3, q = lane >> 3, r8 = lane & 7;
  float acc[2][4][4] = {};
  const unsigned wa = smem_addr(ws + (r8 + (q >> 1) * 8) * W0P + (q & 1) * 8);
  for (int kh = 0; kh < K0H; ++kh) {
    unsigned bf[2][4];
    ldmatrix_x4(bf[0], wa + 2 * (kh * K0WP));
    ldmatrix_x4(bf[1], wa + 2 * (16 * W0P + kh * K0WP));
    const unsigned* row = reinterpret_cast<const unsigned*>(xs + kh * X0W);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      // A (frame t, tap k) = xs[kh][2 t + k]: the word t + k / 2
      const int t = warp * 32 + mt * 16 + gid;
      unsigned a[4];
      a[0] = row[t + tig];
      a[1] = row[t + 8 + tig];
      a[2] = row[t + tig + 4];
      a[3] = row[t + 8 + tig + 4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_bf16(acc[mt][2 * h], a, bf[h][0], bf[h][1]);
        mma_bf16(acc[mt][2 * h + 1], a, bf[h][2], bf[h][3]);
      }
    }
  }
  float* ob = out + (static_cast<size_t>(b) * NC * F0OUT + fo) * T;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + warp * 32 + mt * 16 + gid + 8 * h;
        const int n = nt * 8 + 2 * tig;
        if (t >= T) continue;
        ob[static_cast<size_t>(n) * F0OUT * T + t] = acc[mt][nt][2 * h]
                                                     + bias[n];
        ob[static_cast<size_t>(n + 1) * F0OUT * T + t] =
            acc[mt][nt][2 * h + 1] + bias[n + 1];
      }
}

// --------------------------------------------------------------- rowconv
// out[b][n][r][t] = sum over (j, tap, c) of in[b][c][base(r) + j][t + tap
// - 5] * w[par(r)][j][c / 16][tap][n][c % 16] (+ bias[n] in the forward).
//  * forward (DGRAD false): in = h (B, 32, 81, T) bf16, out (B, 32, 41, T)
//    f32; base = 2 r - 10, j < 21, one parity.
//  * dgrad (DGRAD true): in = dy (B, 32, 41, T) f32, split hi + lo as it is
//    staged; out = dx (B, 32, 81, T) bf16; base = floor((r - 9) / 2), j < 11
//    - (r & 1), the parity r & 1.
// w packed (NPAR, NJ, 2, 11, 32, 16) bf16. Grid (ceil(T / TT), Rout, B).
template <bool DGRAD>
__global__ void __launch_bounds__(THREADS)
rowconv_kernel(const void* __restrict__ in_, const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias, void* __restrict__ out_,
               int Rin, int Rout, int T, int NJ) {
  using InT = typename std::conditional<DGRAD, float, __nv_bfloat16>::type;
  constexpr int XP = XR / 2;                 // frame pairs a stage: 70
  constexpr int XITS = (XP + 15) / 16;       // 4 warps x 4 pairs an it
  extern __shared__ __align__(16) char smem[];
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xh = wbuf + 2 * WST;        // (XR, CP) channels-last
  __nv_bfloat16* xl = xh + XR * CP;          // dgrad: the lo terms
  const InT* in = static_cast<const InT*>(in_);
  const int t0 = blockIdx.x * TT, r = blockIdx.y, b = blockIdx.z;
  const int base = DGRAD ? ((r - 9) >> 1) : 2 * r - 10;
  const int nj = DGRAD ? 11 - (r & 1) : K1H, par = DGRAD ? (r & 1) : 0;
  const int j0 = max(0, -base), j1 = min(nj, Rin - base);
  const int ns = 2 * max(0, j1 - j0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3, q = lane >> 3, r8 = lane & 7;
  const int cpair = lane & 7;  // staging: channels 2 cpair, 2 cpair + 1

  InT v[XITS][4];  // (c, f), (c, f + 1), (c + 1, f), (c + 1, f + 1)
  auto load_x = [&](int s) {
    const int row = base + j0 + s / 2, ch = s & 1;
    const InT* src = in + ((static_cast<size_t>(b) * NC + ch * CH + 2 * cpair)
                           * Rin + row) * static_cast<size_t>(T);
    const size_t cstride = static_cast<size_t>(Rin) * T;
#pragma unroll
    for (int it = 0; it < XITS; ++it) {
      const int fp = 4 * (warp + 4 * it) + (lane >> 3);
      const int f = t0 - 6 + 2 * fp;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ff = f + (e & 1);
        v[it][e] = (fp < XP && ff >= 0 && ff < T)
                       ? src[(e >> 1) * cstride + ff] : zero<InT>();
      }
    }
  };
  auto store_x = [&]() {
#pragma unroll
    for (int it = 0; it < XITS; ++it) {
      const int fp = 4 * (warp + 4 * it) + (lane >> 3);
      if (fp >= XP) continue;
      unsigned* h0 = reinterpret_cast<unsigned*>(xh + 2 * fp * CP) + cpair;
      if constexpr (DGRAD) {
        unsigned* l0 = reinterpret_cast<unsigned*>(xl + 2 * fp * CP) + cpair;
        __nv_bfloat16 hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(v[it][e], hi[e], lo[e]);
        h0[0] = pack2(hi[0], hi[2]);
        h0[CP / 2] = pack2(hi[1], hi[3]);
        l0[0] = pack2(lo[0], lo[2]);
        l0[CP / 2] = pack2(lo[1], lo[3]);
      } else {
        h0[0] = pack2(v[it][0], v[it][2]);
        h0[CP / 2] = pack2(v[it][1], v[it][3]);
      }
    }
  };
  auto load_w = [&](int s) {
    const int j = j0 + s / 2, ch = s & 1;
    const __nv_bfloat16* src =
        w + ((static_cast<size_t>(par) * NJ + j) * 2 + ch) * WSTG;
    __nv_bfloat16* dst = wbuf + (s & 1) * WST;
    for (int i = threadIdx.x; i < K1W * NC * 2; i += THREADS) {
      const int row = i >> 1, half = i & 1;
      cp_async16(smem_addr(dst + row * CP + half * 8),
                 src + row * CH + half * 8);
    }
  };

  float acc[2][4][4] = {};
  if (ns > 0) {
    load_w(0);
    cp_async_commit();
    load_x(0);
  }
  // ldmatrix rows: B (n, c) of tap kw, A (frame, c) shifted by the tap
  const int b_off = (r8 + (q >> 1) * 8) * CP + (q & 1) * 8;
  const int a_off = (warp * 32 + (lane & 15) + 1) * CP + (lane >> 4) * 8;
  for (int s = 0; s < ns; ++s) {
    __syncthreads();  // stage s - 1 done: x tile and buffer (s + 1) & 1 free
    store_x();
    if (s + 1 < ns) {
      load_w(s + 1);
      cp_async_commit();
      load_x(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned wb = smem_addr(wbuf + (s & 1) * WST);
    const unsigned xa = smem_addr(xh), xla = smem_addr(xl);
#pragma unroll
    for (int kw = 0; kw < K1W; ++kw) {
      unsigned bf[2][4];
      ldmatrix_x4(bf[0], wb + 2 * (kw * NC * CP + b_off));
      ldmatrix_x4(bf[1], wb + 2 * (kw * NC * CP + 16 * CP + b_off));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int off = 2 * (a_off + (mt * 16 + kw) * CP);
        unsigned a[4];
        ldmatrix_x4(a, xa + off);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_bf16(acc[mt][2 * h], a, bf[h][0], bf[h][1]);
          mma_bf16(acc[mt][2 * h + 1], a, bf[h][2], bf[h][3]);
        }
        if constexpr (DGRAD) {
          ldmatrix_x4(a, xla + off);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma_bf16(acc[mt][2 * h], a, bf[h][0], bf[h][1]);
            mma_bf16(acc[mt][2 * h + 1], a, bf[h][2], bf[h][3]);
          }
        }
      }
    }
  }
  const size_t plane = static_cast<size_t>(Rout) * T;
  const size_t ob = (static_cast<size_t>(b) * NC * Rout + r) * T;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + warp * 32 + mt * 16 + gid + 8 * h;
        const int n = nt * 8 + 2 * tig;
        if (t >= T) continue;
        const size_t o = ob + n * plane + t;
        if constexpr (DGRAD) {
          __nv_bfloat16* out = static_cast<__nv_bfloat16*>(out_);
          out[o] = __float2bfloat16_rn(acc[mt][nt][2 * h]);
          out[o + plane] = __float2bfloat16_rn(acc[mt][nt][2 * h + 1]);
        } else {
          float* out = static_cast<float*>(out_);
          out[o] = acc[mt][nt][2 * h] + bias[n];
          out[o + plane] = acc[mt][nt][2 * h + 1] + bias[n + 1];
        }
      }
}

// The dy chunk of one wgrad item: rows (32 channels) of TK frames from
// frame f0 of dy's row `row` (rows R), split into hi and lo rows of pitch
// DYP. NT threads; each holds TK * NC / NT values between load and store.
template <int NT>
struct DyChunk {
  static constexpr int PER = TK * NC / NT;
  float v[PER];
  __device__ __forceinline__ void load(const float* dy, int b, int row, int R,
                                       int f0, int T) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + NT * i, c = e / TK, f = f0 + e % TK;
      v[i] = f < T ? dy[((static_cast<size_t>(b) * NC + c) * R + row)
                        * static_cast<size_t>(T) + f]
                   : 0.f;
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* hi,
                                        __nv_bfloat16* lo) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + NT * i, at = (e / TK) * DYP + e % TK;
      split(v[i], hi[at], lo[at]);
    }
  }
};

// ---------------------------------------------------------------- wgrad1
// part[s][co][kh][kw][c] (f32) = the sum over split s's items (b, fo,
// 64-frame chunk) of dy[b][co][fo][t] * h[b][c][2 fo + kh - 10][t + kw -
// 5]. Grid (S, 21): block (s, kh) takes items s, s + S, ... of the rows
// fo whose input row lies inside h. Warp w owns channels 8 w .. 8 w + 7,
// every co and every tap: 2 x 11 tiles of 16 x 8.
__global__ void __launch_bounds__(THREADS)
wgrad1_kernel(const float* __restrict__ dy, const __nv_bfloat16* __restrict__ x,
              float* __restrict__ part, int B, int T, int S) {
  __shared__ __align__(16) __nv_bfloat16 dyh[NC * DYP];
  __shared__ __align__(16) __nv_bfloat16 dyl[NC * DYP];
  __shared__ __align__(16) __nv_bfloat16 x0[NC * XCP];  // frames f0 - 6 ..
  __shared__ __align__(16) __nv_bfloat16 x1[NC * XCP];  // frames f0 - 5 ..
  constexpr int XPAIRS = 40;  // 80 frames a channel, f0 - 6 .. f0 + 73
  constexpr int XPER = NC * XPAIRS / THREADS;
  const int s = blockIdx.x, kh = blockIdx.y;
  const int fo_lo = max(0, (11 - kh) >> 1);
  const int fo_hi = min(F1OUT, (F1IN - 1 + 10 - kh) / 2 + 1);
  const int nfo = fo_hi - fo_lo, ntc = (T + TK - 1) / TK;
  const int items = B * nfo * ntc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  DyChunk<THREADS> d;
  unsigned xv[XPER];
  auto load = [&](int i) {
    const int b = i / (nfo * ntc), rem = i % (nfo * ntc);
    const int fo = fo_lo + rem / ntc, f0 = (rem % ntc) * TK;
    d.load(dy, b, fo, F1OUT, f0, T);
    const int row = 2 * fo + kh - 10;
#pragma unroll
    for (int k = 0; k < XPER; ++k) {
      const int e = threadIdx.x + THREADS * k, c = e / XPAIRS;
      const int f = f0 - 6 + 2 * (e % XPAIRS);
      const __nv_bfloat16* src =
          x + ((static_cast<size_t>(b) * NC + c) * F1IN + row) * T;
      const __nv_bfloat16 z = __float2bfloat16(0.f);
      xv[k] = pack2(f >= 0 && f < T ? src[f] : z,
                    f + 1 >= 0 && f + 1 < T ? src[f + 1] : z);
    }
  };
  auto store = [&]() {
    d.store(dyh, dyl);
#pragma unroll
    for (int k = 0; k < XPER; ++k) {
      const int e = threadIdx.x + THREADS * k, c = e / XPAIRS;
      const int p = 2 * (e % XPAIRS);
      reinterpret_cast<unsigned*>(x0 + c * XCP)[p / 2] = xv[k];
      if (p > 0) x1[c * XCP + p - 1] = __ushort_as_bfloat16(xv[k] & 0xffff);
      x1[c * XCP + p] = __ushort_as_bfloat16(xv[k] >> 16);
    }
  };

  float acc[2][K1W][4] = {};
  const int c = warp * 8 + gid;
  const unsigned* x0w = reinterpret_cast<const unsigned*>(x0 + c * XCP);
  const unsigned* x1w = reinterpret_cast<const unsigned*>(x1 + c * XCP);
  const int a_off = (lane & 15) * DYP + (lane >> 4) * 8;
  for (int i = s; i < items; i += S) {
    load(i);
    __syncthreads();
    store();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldmatrix_x4(ah[mt], smem_addr(dyh + a_off + mt * 16 * DYP + kk));
        ldmatrix_x4(al[mt], smem_addr(dyl + a_off + mt * 16 * DYP + kk));
      }
      const int tl = kk + 2 * tig;
#pragma unroll
      for (int kw = 0; kw < K1W; ++kw) {
        // frames f0 + tl + kw - 5 (+ 1): x0's word (tl + kw + 1) / 2 for
        // odd kw, x1's (tl + kw) / 2 for even; b1 8 frames on
        const unsigned* xw = (kw & 1) ? x0w : x1w;
        const int at = (tl + kw + (kw & 1)) >> 1;
        const unsigned b0 = xw[at], b1 = xw[at + 4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][kw], ah[mt], b0, b1);
          mma_bf16(acc[mt][kw], al[mt], b0, b1);
        }
      }
    }
  }
  float* pb = part + static_cast<size_t>(s) * NC * K1H * K1W * NC;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kw = 0; kw < K1W; ++kw)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = mt * 16 + gid + 8 * h, cc = warp * 8 + 2 * tig;
        *reinterpret_cast<float2*>(
            pb + ((static_cast<size_t>(co) * K1H + kh) * K1W + kw) * NC + cc) =
            make_float2(acc[mt][kw][2 * h], acc[mt][kw][2 * h + 1]);
      }
}

// ---------------------------------------------------------------- wgrad0
// part[s][co][kh * 11 + kw] (f32) = the sum over split s's items (b, fo,
// 64-frame chunk) of dy[b][co][fo][t] * bf16(x[b][2 fo + kh - 20][2 t + kw
// - 5]), x f32 rounded as it is staged. Grid (S); 8 warps; warp w owns the n8 tiles w, w + 8, .. of the
// 451 columns (kh, kw).
constexpr int W0THREADS = 256;
__global__ void __launch_bounds__(W0THREADS)
wgrad0_kernel(const float* __restrict__ dy, const float* __restrict__ x,
              float* __restrict__ part, int B, int Tin, int T, int S) {
  __shared__ __align__(16) __nv_bfloat16 dyh[NC * DYP];
  __shared__ __align__(16) __nv_bfloat16 dyl[NC * DYP];
  __shared__ __align__(16) __nv_bfloat16 xs[K0H * X0WG];
  constexpr int XPER = (K0H * X0WG + W0THREADS - 1) / W0THREADS;
  const int s = blockIdx.x;
  const int ntc = (T + TK - 1) / TK, items = B * F0OUT * ntc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  DyChunk<W0THREADS> d;
  __nv_bfloat16 xv[XPER];
  auto load = [&](int i) {
    const int b = i / (F0OUT * ntc), rem = i % (F0OUT * ntc);
    const int fo = rem / ntc, f0 = (rem % ntc) * TK;
    d.load(dy, b, fo, F0OUT, f0, T);
    const float* xb = x + static_cast<size_t>(b) * F0IN * Tin;
#pragma unroll
    for (int k = 0; k < XPER; ++k) {
      const int e = threadIdx.x + W0THREADS * k;
      const int row = 2 * fo - 20 + e / X0WG, f = 2 * f0 - 5 + e % X0WG;
      xv[k] = __float2bfloat16_rn(
          (e < K0H * X0WG && row >= 0 && row < F0IN && f >= 0 && f < Tin)
              ? xb[static_cast<size_t>(row) * Tin + f] : 0.f);
    }
  };
  auto store = [&]() {
    d.store(dyh, dyl);
#pragma unroll
    for (int k = 0; k < XPER; ++k) {
      const int e = threadIdx.x + W0THREADS * k;
      if (e < K0H * X0WG) xs[e] = xv[k];
    }
  };

  // this lane's column of each tile: xs offset kh * X0WG + kw
  int col[G0T];
#pragma unroll
  for (int g = 0; g < G0T; ++g) {
    const int n = min((warp + 8 * g) * 8 + gid, N0 - 1);
    col[g] = (n / K0W) * X0WG + n % K0W;
  }
  float acc[2][G0T][4] = {};
  const int a_off = (lane & 15) * DYP + (lane >> 4) * 8;
  for (int i = s; i < items; i += S) {
    load(i);
    __syncthreads();
    store();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldmatrix_x4(ah[mt], smem_addr(dyh + a_off + mt * 16 * DYP + kk));
        ldmatrix_x4(al[mt], smem_addr(dyl + a_off + mt * 16 * DYP + kk));
      }
      const int p = 2 * (kk + 2 * tig);  // frame 2 t of the pair's first t
#pragma unroll
      for (int g = 0; g < G0T; ++g) {
        if (warp + 8 * g >= N0T) break;
        const __nv_bfloat16* xr = xs + col[g] + p;
        const unsigned b0 = pack2(xr[0], xr[2]), b1 = pack2(xr[16], xr[18]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][g], ah[mt], b0, b1);
          mma_bf16(acc[mt][g], al[mt], b0, b1);
        }
      }
    }
  }
  float* pb = part + static_cast<size_t>(s) * NC * N0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int g = 0; g < G0T; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = mt * 16 + gid + 8 * (e >> 1);
        const int n = (warp + 8 * g) * 8 + 2 * tig + (e & 1);
        if (warp + 8 * g < N0T && n < N0)
          pb[static_cast<size_t>(co) * N0 + n] = acc[mt][g][e];
      }
}

// ---------------------------------------------------------------- reduce
// dw (32, Cin, KH, KW) f32 = bf16-rounded sum over s, in order, of the S
// partial sums. conv1's partials are (S, 32, 21, 11, 32): one thread a
// partial element, read in their order, written transposed; conv0's are
// (S, 32, 451), dw's order.
template <bool CONV1>
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ part, float* __restrict__ dw, int S) {
  constexpr int N = CONV1 ? NC * K1H * K1W * NC : NC * N0;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float sum = 0.f;
  for (int k = 0; k < S; ++k) sum += part[static_cast<size_t>(k) * N + i];
  int o = i;
  if (CONV1) {
    const int c = i % NC, kw = (i / NC) % K1W, kh = (i / (NC * K1W)) % K1H;
    const int co = i / (NC * K1W * K1H);
    o = ((co * NC + c) * K1H + kh) * K1W + kw;
  }
  dw[o] = __bfloat162float(__float2bfloat16_rn(sum));
}

template <typename K>
cudaError_t smem_attr(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

constexpr size_t rowconv_smem(bool dgrad) {
  return (size_t(2) * WST + size_t(dgrad ? 2 : 1) * XR * CP) * 2;
}

}  // namespace conv_mma

using namespace conv_mma;

// conv0's forward: out (B, 32, 81, T) f32 from x (B, 1, 161, Tin) f32
// (rounded to bf16 as it is staged), w packed (32, 656) bf16, bias (32) f32.
DS_EXPORT int conv0_fprop_bf16(const float* x, const __nv_bfloat16* w,
                               const float* bias, float* out, int B, int Tin,
                               int T, void* stream) {
  cudaError_t err = smem_attr(fprop0_kernel, SMEM_F0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + TT - 1) / TT, F0OUT, B);
  fprop0_kernel<<<grid, THREADS, SMEM_F0, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, out, Tin, T);
  return static_cast<int>(cudaGetLastError());
}

// conv1's forward: out (B, 32, 41, T) f32 from h (B, 32, 81, T) bf16, w
// packed (1, 21, 2, 11, 32, 16) bf16, bias (32) f32.
DS_EXPORT int conv1_fprop_bf16(const __nv_bfloat16* h, const __nv_bfloat16* w,
                               const float* bias, float* out, int B, int T,
                               void* stream) {
  const size_t smem = rowconv_smem(false);
  cudaError_t err = smem_attr(rowconv_kernel<false>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + TT - 1) / TT, F1OUT, B);
  rowconv_kernel<false><<<grid, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      h, w, bias, out, F1IN, F1OUT, T, K1H);
  return static_cast<int>(cudaGetLastError());
}

// conv1's input gradient: dx (B, 32, 81, T) bf16 from dy (B, 32, 41, T)
// f32 and w packed (2, 11, 2, 11, 32, 16) bf16 (per output-row parity,
// flipped in time).
DS_EXPORT int conv1_dgrad_bf16(const float* dy, const __nv_bfloat16* w,
                               __nv_bfloat16* dx, int B, int T,
                               void* stream) {
  const size_t smem = rowconv_smem(true);
  cudaError_t err = smem_attr(rowconv_kernel<true>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + TT - 1) / TT, F1IN, B);
  rowconv_kernel<true><<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      dy, w, nullptr, dx, F1OUT, F1IN, T, 11);
  return static_cast<int>(cudaGetLastError());
}

// conv0's weight-gradient partials: part (S, 32, 451) f32 from dy (B, 32,
// 81, T) f32 and x (B, 1, 161, Tin) f32 (rounded to bf16 as it is staged).
DS_EXPORT int conv0_wgrad_bf16(const float* dy, const float* x,
                               float* part, int B, int Tin, int T, int S,
                               void* stream) {
  wgrad0_kernel<<<S, W0THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      dy, x, part, B, Tin, T, S);
  return static_cast<int>(cudaGetLastError());
}

// conv1's weight-gradient partials: part (S, 32, 21, 11, 32) f32 from dy
// (B, 32, 41, T) f32 and h (B, 32, 81, T) bf16.
DS_EXPORT int conv1_wgrad_bf16(const float* dy, const __nv_bfloat16* h,
                               float* part, int B, int T, int S,
                               void* stream) {
  const dim3 grid(S, K1H);
  wgrad1_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      dy, h, part, B, T, S);
  return static_cast<int>(cudaGetLastError());
}

// The second pass of either weight gradient: dw (32, Cin, KH, KW) f32,
// each value bf16-rounded, from the S partials of conv `conv` (0 or 1).
DS_EXPORT int conv_wgrad_reduce(const float* part, float* dw, int conv, int S,
                                void* stream) {
  const int n = conv ? NC * K1H * K1W * NC : NC * N0;
  const dim3 grid((n + 255) / 256);
  auto s = static_cast<cudaStream_t>(stream);
  if (conv)
    reduce_kernel<true><<<grid, 256, 0, s>>>(part, dw, S);
  else
    reduce_kernel<false><<<grid, 256, 0, s>>>(part, dw, S);
  return static_cast<int>(cudaGetLastError());
}
