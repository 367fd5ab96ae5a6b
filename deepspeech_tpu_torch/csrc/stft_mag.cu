// |STFT| magnitude: (B, S) f32 waveforms -> (B, n_bins, T) f32.
//
// Replaces the Pallas TPU kernel deepspeech_tpu/ops/pallas/stft_kernel.py
// (_kernel, launched by stft_magnitude_pallas): reflect padding, framing,
// the analysis window, the transform and sqrt(re^2 + im^2). The TPU kernel
// runs the DFT as a product on its matrix unit, framing through
// k = n_fft/hop row-shifted views; here a block frames by index and
// reflects the padded edges by index, so no padded copy of the batch exists.
//
// Bound on the H100: |STFT| is computed exactly in f32 by a real FFT,
// ~7.6k operations a frame at n_fft 320 (2.5 N log2 N, the window and the
// magnitude): 0.11 GFLOP at 20 x 7.5 s, ~1.7 us at 67 TFLOP/s of
// non-tensor f32, while its ~19 MB of input and output take ~5.8 us at
// 3.35 TB/s. So the function is bound by bytes.
//
// Two routes, chosen by the wrapper from n_fft alone (ops/cuda/stft.py):
//
// FFT (stft_mag_fft_f32), where n_fft / 2 = M = 2^a 3^b 5^c (n_fft 160,
// 200, 320, 400, 480, 512, ...). One block of 256 threads per (utterance,
// tile of ft frames; ft 16 at n_fft 320, 940 blocks at 20 x 7.5 s). The
// block stages the tile's (ft-1) hop + n_fft samples once (16-byte loads
// for interior tiles), then runs ft M-point complex FFTs of
// z[m] = x[2m] w[2m] + i x[2m+1] w[2m+1] (the window applied on the load
// from shared memory): a Stockham (autosort) FFT whose stages each take a
// radix R1 R2 <= 16 in registers (M 160 = (4 4)(2 5): two passes through
// shared memory, not four), ping-ponging between two frame buffers padded
// one slot in 16 against bank conflicts. The real spectrum follows by the
// even/odd split X[k] = E[k] + W_N^k O[k], E and O from Z[k] and
// conj(Z[M-k]); a warp takes one bin of consecutive frames, so the
// (B, n_bins, T) stores run along T straight from the last frame buffer,
// whose odd frame stride keeps those reads conflict-free. Twiddles (each
// stage's, its in-register DFT's, and W_N^k) are computed on the host in
// float64, rounded once to f32 and staged in shared memory; the radix-3/5
// butterflies' constants are f32 literals of cos/sin(2 pi / R). All of it
// is true f32 (no TF32, no fast-math): the normalization's
// log1p(mag * 2^20) magnifies small errors. ~48 KB of shared memory and 64
// registers a thread: 4 blocks an SM. On the card (PERF.md, section 6) the
// staging and the magnitude pass take about two thirds of the time, each
// pass through shared memory the rest; a copy of the same bytes takes
// about a third.
//
// DFT (stft_mag_dft_f32), for every other n_fft (448 = 2^6 7, ...): one
// thread per bin keeps DFT_FT frames' re/im sums in registers and walks
// n_fft in steps of 4, reading the window-folded cos/sin rows from global
// memory (L2-resident) and the samples as float4 broadcasts from shared
// memory: T n_bins n_fft 2 FMAs, ~30x the function's bound at n_fft 320.
//
// Times on the card: PERF.md section 6 (chip_smoke.py phase 3).
#include <cstdint>

#include "common.cuh"

namespace {

// ---- the FFT route ----

constexpr int FFT_THREADS = 256;

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// Point i of a frame is stored at pidx(i): one slot of padding after every
// 16 points, so that a first stage of radix 16, whose butterflies write 16
// consecutive points each, spreads its lanes over the banks.
__host__ __device__ __forceinline__ int pidx(int i) { return i + (i >> 4); }

// Frame stride of the frame buffers, in complex points: odd, so that the
// magnitude pass, which reads one bin of consecutive frames a warp, meets
// no bank conflict.
__host__ __device__ inline int frame_stride(int m) { return pidx(m) | 1; }

// Byte offsets of the FFT route's shared memory: the window, the twiddles,
// frame buffer A and region B (frame buffer B, which first holds the staged
// samples).
struct FftSmem {
  int win, tw, a, b, total;
};

__host__ __device__ inline FftSmem fft_smem(int n_fft, int hop, int ft,
                                            int ntw) {
  const int buf = ft * frame_stride(n_fft / 2) * 8;
  int region_b = ((ft - 1) * hop + n_fft) * 4;
  if (buf > region_b) region_b = buf;
  FftSmem s;
  s.win = 0;
  s.tw = align16(n_fft * 4);
  s.a = s.tw + align16(ntw * 8);
  s.b = s.a + align16(buf);
  s.total = s.b + align16(region_b);
  return s;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
// -i a
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

// In-place R-point forward DFT: a[q] <- sum_r a[r] exp(-2 pi i q r / R).
template <int R>
__device__ __forceinline__ void butterfly(float2 (&a)[R]);

template <>
__device__ __forceinline__ void butterfly<2>(float2 (&a)[2]) {
  const float2 t = a[0];
  a[0] = cadd(t, a[1]);
  a[1] = csub(t, a[1]);
}

template <>
__device__ __forceinline__ void butterfly<3>(float2 (&a)[3]) {
  constexpr float S3 = 0.866025403784438647f;  // sin(2 pi / 3)
  const float2 t = cadd(a[1], a[2]);
  const float2 d = csub(a[1], a[2]);
  const float2 m = make_float2(a[0].x - 0.5f * t.x, a[0].y - 0.5f * t.y);
  const float2 r = make_float2(S3 * d.y, -S3 * d.x);  // -i S3 d
  a[0] = cadd(a[0], t);
  a[1] = cadd(m, r);
  a[2] = csub(m, r);
}

template <>
__device__ __forceinline__ void butterfly<4>(float2 (&a)[4]) {
  const float2 s02 = cadd(a[0], a[2]), d02 = csub(a[0], a[2]);
  const float2 s13 = cadd(a[1], a[3]), d13 = mul_mi(csub(a[1], a[3]));
  a[0] = cadd(s02, s13);
  a[2] = csub(s02, s13);
  a[1] = cadd(d02, d13);
  a[3] = csub(d02, d13);
}

template <>
__device__ __forceinline__ void butterfly<5>(float2 (&a)[5]) {
  constexpr float C1 = 0.309016994374947424f;   // cos(2 pi / 5)
  constexpr float C2 = -0.809016994374947424f;  // cos(4 pi / 5)
  constexpr float S1 = 0.951056516295153572f;   // sin(2 pi / 5)
  constexpr float S2 = 0.587785252292473129f;   // sin(4 pi / 5)
  const float2 t1 = cadd(a[1], a[4]), t2 = cadd(a[2], a[3]);
  const float2 d1 = csub(a[1], a[4]), d2 = csub(a[2], a[3]);
  const float2 m1 = make_float2(a[0].x + C1 * t1.x + C2 * t2.x,
                                a[0].y + C1 * t1.y + C2 * t2.y);
  const float2 m2 = make_float2(a[0].x + C2 * t1.x + C1 * t2.x,
                                a[0].y + C2 * t1.y + C1 * t2.y);
  const float2 n1 = mul_mi(make_float2(S1 * d1.x + S2 * d2.x,
                                       S1 * d1.y + S2 * d2.y));
  const float2 n2 = mul_mi(make_float2(S2 * d1.x - S1 * d2.x,
                                       S2 * d1.y - S1 * d2.y));
  a[0] = cadd(a[0], cadd(t1, t2));
  a[1] = cadd(m1, n1);
  a[4] = csub(m1, n1);
  a[2] = cadd(m2, n2);
  a[3] = csub(m2, n2);
}

// In-register DFT of R = R1 R2 points, in place: R2 DFTs of R1 points
// (point s2 + R2 r1), the internal twiddles exp(-2 pi i s2 q1 / R)
// (itw[(s2 - 1) (R1 - 1) + q1 - 1], from the host's table), then R1 DFTs of
// R2 points. Output q = q1 + R1 q2 is left in a[slot(q)] = a[q2 + R2 q1].
template <int R1, int R2>
struct RegDft {
  static __host__ __device__ constexpr int slot(int q) {
    return q / R1 + R2 * (q % R1);
  }
  static __device__ __forceinline__ void run(float2 (&a)[R1 * R2],
                                             const float2* __restrict__ itw) {
#pragma unroll
    for (int s2 = 0; s2 < R2; ++s2) {
      float2 c[R1];
#pragma unroll
      for (int r1 = 0; r1 < R1; ++r1) c[r1] = a[s2 + R2 * r1];
      butterfly<R1>(c);
#pragma unroll
      for (int q1 = 0; q1 < R1; ++q1)
        a[s2 + R2 * q1] = s2 > 0 && q1 > 0
                              ? cmul(c[q1], itw[(s2 - 1) * (R1 - 1) + q1 - 1])
                              : c[q1];
    }
#pragma unroll
    for (int q1 = 0; q1 < R1; ++q1) {
      float2 d[R2];
#pragma unroll
      for (int s2 = 0; s2 < R2; ++s2) d[s2] = a[s2 + R2 * q1];
      butterfly<R2>(d);
#pragma unroll
      for (int q2 = 0; q2 < R2; ++q2) a[q2 + R2 * q1] = d[q2];
    }
  }
};

template <int R1>
struct RegDft<R1, 1> {
  static __host__ __device__ constexpr int slot(int q) { return q; }
  static __device__ __forceinline__ void run(float2 (&a)[R1],
                                             const float2* __restrict__) {
    butterfly<R1>(a);
  }
};

// One Stockham stage of radix R = R1 R2 over ft frames of m points, after
// stages whose radices multiply to ns: butterfly j (< m/R) of a frame reads
// points j + r m/R, twiddles them by exp(-2 pi i r k / (ns R)), k = j mod ns
// (tw[k (R-1) + r - 1]), takes their DFT in registers and writes points
// (j - k) R + k + q ns. The first stage (ns 1, no twiddles) reads the
// windowed samples instead: point n of frame f is
// xs[f hop + 2n] w[2n] + i xs[f hop + 2n + 1] w[2n + 1]. A thread steps
// through its (frame, butterfly) pairs without dividing.
template <int R1, int R2, bool FIRST>
__device__ __forceinline__ void fft_stage(const float2* __restrict__ src,
                                          const float* __restrict__ xs,
                                          const float* __restrict__ win,
                                          float2* __restrict__ dst,
                                          const float2* __restrict__ tw,
                                          const float2* __restrict__ itw,
                                          int m, int ns, int ft, int hop) {
  constexpr int R = R1 * R2;
  const int mr = m / R;
  const int fs = frame_stride(m);
  const int df = blockDim.x / mr;
  const int dj = blockDim.x - df * mr;
  const bool ns_pow2 = (ns & (ns - 1)) == 0;
  int f = threadIdx.x / mr;
  int j = threadIdx.x - f * mr;
  for (; f < ft; f += df, j += dj) {
    if (j >= mr) {
      j -= mr;
      if (++f >= ft) break;
    }
    float2 a[R];
    int k = 0;
    if (FIRST) {
      const float* x = xs + f * hop;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int n = 2 * (j + r * mr);
        const float2 v = *reinterpret_cast<const float2*>(x + n);
        const float2 w = *reinterpret_cast<const float2*>(win + n);
        a[r] = make_float2(v.x * w.x, v.y * w.y);
      }
    } else {
      const float2* s = src + f * fs;
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = s[pidx(j + r * mr)];
      k = ns_pow2 ? j & (ns - 1) : j % ns;
      const float2* w = tw + k * (R - 1) - 1;
#pragma unroll
      for (int r = 1; r < R; ++r) a[r] = cmul(a[r], w[r]);
    }
    RegDft<R1, R2>::run(a, itw);
    float2* d = dst + f * fs;
    const int base = (j - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q)
      d[pidx(base + q * ns)] = a[RegDft<R1, R2>::slot(q)];
  }
}

// The stages the wrapper's plan makes: its base radices (fours, a two,
// threes, fives) paired in order where their product is at most 16, else
// alone.
template <bool FIRST>
__device__ __forceinline__ void fft_stage_r(int r1, int r2,
                                            const float2* src,
                                            const float* xs, const float* win,
                                            float2* dst, const float2* tw,
                                            const float2* itw, int m, int ns,
                                            int ft, int hop) {
#define DS_STAGE(A, B)                                                      \
  case A * 8 + B:                                                           \
    fft_stage<A, B, FIRST>(src, xs, win, dst, tw, itw, m, ns, ft, hop);     \
    break;
  switch (r1 * 8 + r2) {
    DS_STAGE(4, 4) DS_STAGE(4, 2) DS_STAGE(4, 3) DS_STAGE(2, 3)
    DS_STAGE(2, 5) DS_STAGE(3, 3) DS_STAGE(3, 5) DS_STAGE(4, 1)
    DS_STAGE(2, 1) DS_STAGE(3, 1) DS_STAGE(5, 1)
    default: break;
  }
#undef DS_STAGE
}

// y (B, S), win (n_fft), tw (ntw complex: for each stage its twiddles, then
// its internal twiddles; then W_N^k for k = 0 .. M), out (B, M + 1, T);
// grid (ceil(T / ft), B), ft a power of two <= 32. plan: stage s's radices
// R1 in bits 6s .. 6s+2 and R2 in bits 6s+3 .. 6s+5, 0 past the last stage.
__global__ void __launch_bounds__(FFT_THREADS)
    stft_fft_kernel(const float* __restrict__ y, const float* __restrict__ win,
                    const float2* __restrict__ tw, float* __restrict__ out,
                    int S, int T, int n_fft, int hop, int pad, int plan,
                    int ft, int ntw) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const FftSmem L = fft_smem(n_fft, hop, ft, ntw);
  float* swin = reinterpret_cast<float*>(base + L.win);
  float2* stw = reinterpret_cast<float2*>(base + L.tw);
  float2* buf_a = reinterpret_cast<float2*>(base + L.a);
  float2* buf_b = reinterpret_cast<float2*>(base + L.b);
  float* xs = reinterpret_cast<float*>(base + L.b);
  const int m = n_fft / 2;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * ft;
  const int span = (ft - 1) * hop + n_fft;  // a multiple of 4
  const float* yb = y + static_cast<size_t>(b) * S;

  for (int i = threadIdx.x; i < n_fft; i += blockDim.x) swin[i] = win[i];
  for (int i = threadIdx.x; i < ntw; i += blockDim.x) stw[i] = tw[i];
  // Stage the tile's samples. Padded position p maps to y[p - pad],
  // reflected about both edges (np.pad mode="reflect"); positions that only
  // frames past T would read are zero.
  const int j0 = t0 * hop - pad;
  if (j0 >= 0 && j0 + span <= S &&
      (reinterpret_cast<uintptr_t>(yb + j0) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(yb + j0);
    float4* d4 = reinterpret_cast<float4*>(xs);
    for (int i = threadIdx.x; i < span / 4; i += blockDim.x)
      d4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      int j = j0 + i;
      if (j < 0) j = -j;
      if (j >= S) j = 2 * (S - 1) - j;
      xs[i] = (j >= 0 && j < S) ? yb[j] : 0.f;
    }
  }
  __syncthreads();

  int ns = 1, off = 0;
  const float2* src = buf_a;
  float2* dst = buf_a;
  for (int s = 0;; ++s) {
    const int r1 = (plan >> (6 * s)) & 7;
    const int r2 = (plan >> (6 * s + 3)) & 7;
    if (r1 == 0) break;
    const int r = r1 * r2;
    const float2* itw = stw + off + ns * (r - 1);
    if (s == 0)
      fft_stage_r<true>(r1, r2, nullptr, xs, swin, dst, nullptr, itw, m, 1,
                        ft, hop);
    else
      fft_stage_r<false>(r1, r2, src, nullptr, nullptr, dst, stw + off, itw,
                         m, ns, ft, hop);
    __syncthreads();
    off += ns * (r - 1) + (r1 - 1) * (r2 - 1);
    ns *= r;
    src = dst;
    dst = dst == buf_a ? buf_b : buf_a;
  }

  // X[k] = E[k] + W_N^k O[k], E = (Z[k] + conj Z[M-k]) / 2,
  // O = (Z[k] - conj Z[M-k]) / 2i, indices mod M. Thread (f, k) has f fixed
  // (ft divides the block), so a warp stores one bin of consecutive frames:
  // the (B, n_bins, T) stores run along T.
  const float2* wpost = stw + off;
  const int nb = m + 1;
  const int f = threadIdx.x % ft;
  const int t = t0 + f;
  if (t >= T) return;
  const float2* z = src + f * frame_stride(m);
  float* o_ptr = out + static_cast<size_t>(b) * nb * T + t;
  for (int k = threadIdx.x / ft; k < nb; k += blockDim.x / ft) {
    const float2 zk = z[pidx(k == m ? 0 : k)];
    const float2 zm = z[pidx(k == 0 ? 0 : m - k)];
    const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
    const float2 o = make_float2(0.5f * (zk.y + zm.y), 0.5f * (zm.x - zk.x));
    const float2 x = cadd(e, cmul(o, wpost[k]));
    o_ptr[static_cast<size_t>(k) * T] = sqrtf(x.x * x.x + x.y * x.y);
  }
}

// ---- the DFT route ----

constexpr int DFT_FT = 16;  // frames a block

__global__ void stft_dft_kernel(const float* __restrict__ y,
                                const float* __restrict__ cosw,
                                const float* __restrict__ sinw,
                                float* __restrict__ out, int S, int T,
                                int n_fft, int hop, int n_bins, int pad) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * DFT_FT;
  const int span = (DFT_FT - 1) * hop + n_fft;
  const int span4 = (span + 3) & ~3;
  float* tile = xs + span4;
  const float* yb = y + static_cast<size_t>(b) * S;

  // Stage the tile's samples. Padded position p maps to y[p - pad],
  // reflected about both edges (np.pad mode="reflect"); positions that only
  // frames past T would read are zero.
  for (int i = threadIdx.x; i < span4; i += blockDim.x) {
    float v = 0.f;
    if (i < span) {
      int j = t0 * hop + i - pad;
      if (j < 0) j = -j;
      if (j >= S) j = 2 * (S - 1) - j;
      if (j >= 0 && j < S) v = yb[j];
    }
    xs[i] = v;
  }
  __syncthreads();

  const int k = threadIdx.x;
  float re[DFT_FT], im[DFT_FT];
#pragma unroll
  for (int f = 0; f < DFT_FT; ++f) re[f] = im[f] = 0.f;
  if (k < n_bins) {
    for (int n = 0; n < n_fft; n += 4) {
      const float c0 = cosw[(n + 0) * n_bins + k];
      const float c1 = cosw[(n + 1) * n_bins + k];
      const float c2 = cosw[(n + 2) * n_bins + k];
      const float c3 = cosw[(n + 3) * n_bins + k];
      const float s0 = sinw[(n + 0) * n_bins + k];
      const float s1 = sinw[(n + 1) * n_bins + k];
      const float s2 = sinw[(n + 2) * n_bins + k];
      const float s3 = sinw[(n + 3) * n_bins + k];
#pragma unroll
      for (int f = 0; f < DFT_FT; ++f) {
        const float4 v = *reinterpret_cast<const float4*>(xs + f * hop + n);
        re[f] = fmaf(v.x, c0, re[f]);
        re[f] = fmaf(v.y, c1, re[f]);
        re[f] = fmaf(v.z, c2, re[f]);
        re[f] = fmaf(v.w, c3, re[f]);
        im[f] = fmaf(v.x, s0, im[f]);
        im[f] = fmaf(v.y, s1, im[f]);
        im[f] = fmaf(v.z, s2, im[f]);
        im[f] = fmaf(v.w, s3, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < DFT_FT; ++f)
      tile[k * DFT_FT + f] = sqrtf(re[f] * re[f] + im[f] * im[f]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_bins * DFT_FT; i += blockDim.x) {
    const int kk = i / DFT_FT;
    const int t = t0 + i % DFT_FT;
    if (t < T) out[(static_cast<size_t>(b) * n_bins + kk) * T + t] = tile[i];
  }
}

}  // namespace

// The DFT route. y (B, S), cosw/sinw (n_fft, n_bins) window-folded, out
// (B, n_bins, T). Needs n_fft % 4 == 0, hop % 4 == 0, n_bins <= 1024 and
// pad < S; the Python wrapper checks these.
DS_EXPORT int stft_mag_dft_f32(const float* y, const float* cosw,
                               const float* sinw, float* out, int B, int S,
                               int T, int n_fft, int hop, int n_bins, int pad,
                               void* stream) {
  const int threads = (n_bins + 31) / 32 * 32;
  const int span4 = ((DFT_FT - 1) * hop + n_fft + 3) & ~3;
  const size_t smem = (static_cast<size_t>(span4) + n_bins * DFT_FT) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stft_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + DFT_FT - 1) / DFT_FT, B);
  stft_dft_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, cosw, sinw, out, S, T, n_fft, hop, n_bins, pad);
  return static_cast<int>(cudaGetLastError());
}

// The FFT route. y (B, S), win (n_fft), tw (ntw complex, from the wrapper's
// fft_twiddles), out (B, n_fft / 2 + 1, T); plan and ft from the wrapper's
// fft_plan and fft_frames_per_block. Needs n_fft and hop divisible by 4 and
// pad < S; the Python wrapper checks these.
DS_EXPORT int stft_mag_fft_f32(const float* y, const float* win,
                               const float* tw, float* out, int B, int S,
                               int T, int n_fft, int hop, int pad, int plan,
                               int ft, int ntw, void* stream) {
  const FftSmem L = fft_smem(n_fft, hop, ft, ntw);
  cudaError_t err = cudaFuncSetAttribute(
      stft_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + ft - 1) / ft, B);
  stft_fft_kernel<<<grid, FFT_THREADS, L.total,
                    static_cast<cudaStream_t>(stream)>>>(
      y, win, reinterpret_cast<const float2*>(tw), out, S, T, n_fft, hop, pad,
      plan, ft, ntw);
  return static_cast<int>(cudaGetLastError());
}
