// GRU recurrence on a precomputed input projection, one or two directions
// (K4).
//
// Replaces the Pallas TPU kernel deepspeech_tpu/ops/pallas/rnn_kernel.py
// (_gru_fwd_kernel at :123, launched by _gru_fwd for bigru_scan_pallas and
// gru_scan_pallas), both variants. The JAX package takes it for the layers
// whose W_ih and W_hh do not fit VMEM together (ops/cuda/route.py has the
// port's copy of that rule): there the projection x @ W_ih is one matmul
// outside, rounded to the operand type, and this kernel runs the r, z, n
// recurrence on it with f32 state and f32 gates, both biases added in f32
// and b_hn inside the r *. The training variant (with_res=True there; g
// and hn not null here) also writes, per direction, the gate stream
// g = (r, z, n) (T, B, 3H) and hn, the hidden n-term before the r *
// (T, B, H), in the operand type: the residuals K5 (gru_bwd.cu) reads. Both
// are zero at steps past a row's length; inference passes null and writes
// neither. The operand type T is float or __nv_bfloat16, for W_hh, the
// projection and the residuals alike.
//
// Bound on the H100 at the wide model's shape (6 x BiGRU-1600 at B 64,
// T 376): the recurrence is 2 x 2 x T x B x H x 3H = ~0.74 TFLOP of
// products, ~0.75 ms at the 989 TFLOP/s bf16 tensor-core peak; the bytes
// (xp in, h and the residuals out) take ~0.2-0.5 ms. So it is bound by
// operations. But a step cannot start before the last one ends, and each
// step must bring W_hh (30.7 MB in bf16 for both directions) from L2 to
// the SMs again: that, not the products, is the floor of a step.
//
// In f32 the products stay f32 FMAs (no TF32: the eval's f32 programs are
// held to f32 references). A step at B 64, H 1600, D 2 is 2 x 64 x 1600 x
// 4800 x 2 = 1.97 GFLOP, 29 us at the H100's 67 TFLOP/s outside the
// tensor cores; W_hh is 61.4 MB in f32, more than the 50 MB L2, and its
// read alone takes ~11-18 us a step. So an f32 step is bound by the FMA
// rate, if W_hh is read once a step for the whole batch.
//
// Design, bf16: rnn_mma.cuh (tensor-core steps that read W_hh once a step,
// packed once a call by the wrapper; h_prev kept as a bf16 copy; one
// launch a step or one persistent cooperative launch).
//
// Design, f32 (f32_scan below): one persistent cooperative launch a call
// for both directions, a grid barrier between steps (rnn_mma.cuh's
// grid_sync_release). A block owns TJ = 25 units of one direction for every
// batch row (<= 64), so each W_hh value it reads feeds B FMAs and W_hh is
// read once a step (grid (ceil(H / 25), D): 128 blocks at H 1600, D 2, one
// on each SM). The wrapper packs W_hh once a call into the blocks' order
// (ops/cuda/recurrence.py: pack_w_hh_f32), so that a block's K chunk of
// 32 rows is one contiguous run; the first chunks of its slice stay in
// shared memory for the whole call (as many as fit beside the ring: 11 of
// 50 at H 1600), the rest stream each step from L2 through a ring of bulk
// copies (TMA) beside h_prev's chunk. h_prev lives in global memory
// transposed, (2, D, Hk, P) f32 with P = the batch rounded to 8, + 4, so
// that a chunk of it is one bulk copy too and the warps read it without
// bank conflicts. Eight warps, one for each 8 batch rows; in a warp 8
// lanes split K and 4 take 20 of the block's 75 columns (padded to 80),
// so a thread keeps 8 x 20 sums, and the 8 K-lanes' sums meet by
// shuffles. The epilogue adds both biases in f32 and keeps the f32 state
// in shared memory. On the H100 a step at B 64, H 1600, D 2 takes
// ~62 us, 2.1x the product floor: the FMAs issue at about 55% of the
// rate (255 registers a thread), and W_hh and h_prev's streams alone take
// ~30 us a step, overlapped. One launch a step (gru_step.cuh, K2's f32
// step kernel, the batch tiled by RB = 8 rows, so W_hh is read
// ceil(B / 8) times a step, spread over the whole card) stays for batches
// above 64 rows or of one 8-row block, grids that are not resident at
// once, and grids of fewer than 48 blocks a direction, where each
// persistent block's walk over all of H's chunks takes longer than the
// step kernel's step (48 is interpolated: 32 blocks were measured slower,
// 64 faster); the wrapper's rule (recurrence.py: scan_f32_variant)
// chooses. chip_smoke.py and PERF.md
// record the times on the card beside the bound and the per-step floors.
#include "gru_step.cuh"
#include "rnn_mma.cuh"

// The f32 persistent variant. Layouts (the wrapper builds them):
//  * W_hh packed (D, NJ, Hk, ROW) f32, Hk = NK * KC: row k of block jb
//    holds, at g * TJ + u, w_hh[d, k, g * H + jb * TJ + u]; zero past H in
//    k and in the units, and in the columns from 3 * TJ on.
//  * h_prev transposed (2, D, Hk, P) f32: copy s & 1 is read by step s,
//    copy (s + 1) & 1 written; element (k, b) at k * P + b; zero past H and
//    past B (the rows are never written there).
// Warp w takes the 8 batch rows from 8 w; lane l the K rows kl, kl + 8, ...
// of every chunk (kl = l & 7) and the 20 columns from 20 (l >> 3) of the
// block's 3 * TJ = 75, padded to 80. So a thread keeps 8 x 20 sums and
// each k brings two 16-byte h loads and five W loads for 160 FMAs: shared
// memory delivers 128 bytes a clock to the SM's 128 FMA lanes, and a tile
// of r rows x c columns needs 4 (r + c) / (r c) bytes an FMA, 0.7 of that
// rate here. (A tile of 4 rows x 25 columns in 12 warps, 1.16 of it, ran
// a step within 1% of this one on the H100: the FMAs' issue sets the
// pace.) A quarter-warp's 16-byte reads are 8 k rows at one offset: the
// pitches, P (P / 4 odd) and ROW (ROW / 4 = 21), put them on the 8 bank
// groups, one wavefront each.
namespace f32_scan {

constexpr int TJ = 25;             // hidden units a block
constexpr int RT = 8;              // batch rows a thread
constexpr int CT = 20;             // columns a thread
constexpr int ROW = 84;            // floats of a packed row: 4 x CT + 4
constexpr int KC = 32;             // K rows a chunk
constexpr int KL = 8;              // lanes splitting K
constexpr int NB = 64;             // batch rows at most
constexpr int WARPS = NB / RT;     // one a block of RT rows
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 4;
constexpr int PAIRS = NB * TJ;     // (row, unit) pairs of a block
constexpr int PT = (PAIRS + THREADS - 1) / THREADS;  // pairs a thread
constexpr int WCHUNK = KC * ROW;   // floats of a W chunk
constexpr int STAGE = WCHUNK + KC * (NB + 4);  // W chunk, then h chunk
constexpr int RED_P = 32 / KL * CT;  // row pitch of the sums: 80
static_assert(32 / KL * CT >= 3 * TJ && ROW / 4 % 2 == 1, "tiling");
static_assert(NB * RED_P <= STAGES * STAGE, "the sums alias the ring");

// Shared memory, in bytes: the mbarriers (full[STAGES], empty[STAGES], the
// resident slice's), the lengths, b_ih and b_hh of the block's units, the
// f32 state and the step's projection of each pair, the ring (whose bytes
// the K-lane sums take after the product), then the resident chunks.
constexpr size_t OFF_LENS = 128;
constexpr size_t OFF_BIAS = OFF_LENS + NB * 4;
constexpr size_t OFF_HST = OFF_BIAS + 608;  // 2 x 3 x TJ floats, padded
constexpr size_t OFF_XS = OFF_HST + PAIRS * 4;
constexpr size_t OFF_RING = OFF_XS + 3 * PAIRS * 4;
constexpr size_t OFF_WRES = OFF_RING + size_t(STAGES) * STAGE * 4;
static_assert(OFF_RING % 16 == 0 && OFF_WRES % 16 == 0, "16-byte copies");

struct Args {
  const float* xp;    // (D, T, B, 3H) projection, without b_ih
  const float* w;     // packed W_hh
  const float* b_ih;  // (D, 3H)
  const float* b_hh;  // (D, 3H)
  const int* lens;    // (B)
  float* hT;          // (2, D, Hk, P) h_prev, transposed
  unsigned* bar;      // grid-barrier counter
  float* out;         // (D, T, B, H)
  float* g_out;       // (D, T, B, 3H) gates, or null
  float* hn_out;      // (D, T, B, H) hn, or null
  int Tn, B, H;
  int NJ, NK, Hk, P;  // blocks a direction, K chunks, rows of hT, its pitch
  int NR;             // K chunks of W_hh resident in shared memory
  int NRA;            // warps that hold rows
};

__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Chunk c of the step into ring stage st: h_prev's KC rows, and the W
// chunk unless it is resident; both complete on the stage's full barrier.
__device__ __forceinline__ void issue_chunk(const Args& a, char* smem,
                                            const float* hin,
                                            const float* wsl, int c,
                                            int st) {
  using mma_rnn::smem_addr;
  const unsigned full = smem_addr(smem) + 8 * st;
  const float* ring = reinterpret_cast<const float*>(smem + OFF_RING)
                      + st * STAGE;
  const unsigned hbytes = KC * a.P * 4;
  const bool stream_w = c >= a.NR;
  mma_rnn::mbar_expect(full, hbytes + (stream_w ? WCHUNK * 4 : 0));
  bulk_load(smem_addr(ring + WCHUNK), hin + static_cast<size_t>(c) * KC * a.P,
            hbytes, full);
  if (stream_w)
    bulk_load(smem_addr(ring), wsl + static_cast<size_t>(c) * WCHUNK,
              WCHUNK * 4, full);
}

// Step s's projection of the thread's pairs (e = tid + THREADS q: row
// e / TJ, unit e % TJ), raw, into xs[g * PAIRS + e]: read only by this
// thread's epilogue.
__device__ __forceinline__ void prefetch_x(const Args& a, float* xs,
                                           const int* lens_s, int s, int d,
                                           int jb) {
  const int GH = 3 * a.H;
#pragma unroll
  for (int q = 0; q < PT; ++q) {
    const int e = threadIdx.x + THREADS * q;
    const int b = e / TJ, jj = jb * TJ + e % TJ;
    if (e >= PAIRS || b >= a.B || jj >= a.H || s >= lens_s[b]) continue;
    const int t = d == 0 ? s : lens_s[b] - 1 - s;
    const float* x =
        a.xp + ((static_cast<size_t>(d) * a.Tn + t) * a.B + b) * GH + jj;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      cp_async4(mma_rnn::smem_addr(xs + g * PAIRS + e), x + g * a.H);
  }
  mma_rnn::cp_async_commit();
}

// The thread's sums over one chunk: w at its columns of the chunk's first
// row, h at its rows of the chunk's first row. Unrolled by two, so that
// the next k's loads are in flight during this k's FMAs.
__device__ __forceinline__ void chunk_product(const float* w, const float* h,
                                              int P, int kl,
                                              float acc[RT][CT]) {
#pragma unroll 2
  for (int i = 0; i < KC / KL; ++i) {
    const int k = i * KL + kl;
    float hv[RT], wv[CT];
#pragma unroll
    for (int c = 0; c < RT / 4; ++c) {
      const float4 v = reinterpret_cast<const float4*>(h + k * P)[c];
      hv[4 * c] = v.x, hv[4 * c + 1] = v.y, hv[4 * c + 2] = v.z,
      hv[4 * c + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < CT / 4; ++c) {
      const float4 v = reinterpret_cast<const float4*>(w + k * ROW)[c];
      wv[4 * c] = v.x, wv[4 * c + 1] = v.y, wv[4 * c + 2] = v.z,
      wv[4 * c + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int u = 0; u < CT; ++u)
        acc[r][u] = fmaf(hv[r], wv[u], acc[r][u]);
  }
}

// All steps of block (jb, d) in one cooperative launch; grid (NJ, D).
__global__ void __launch_bounds__(THREADS, 1) persistent_kernel(Args a) {
  using mma_rnn::cp_async_wait;
  using mma_rnn::grid_sync_release;
  using mma_rnn::mbar_expect;
  using mma_rnn::mbar_init;
  using mma_rnn::mbar_wait;
  using mma_rnn::smem_addr;
  using mma_rnn::store_stream;
  extern __shared__ __align__(16) char smem[];
  const int jb = blockIdx.x, d = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned bars = smem_addr(smem);  // full, empty, resident
  const unsigned wbar = bars + 16 * STAGES;
  int* lens_s = reinterpret_cast<int*>(smem + OFF_LENS);
  float* bias = reinterpret_cast<float*>(smem + OFF_BIAS);  // b_ih, b_hh
  float* hst = reinterpret_cast<float*>(smem + OFF_HST);
  float* xs = reinterpret_cast<float*>(smem + OFF_XS);
  float* ring = reinterpret_cast<float*>(smem + OFF_RING);
  float* red = ring;
  float* wres = reinterpret_cast<float*>(smem + OFF_WRES);
  const unsigned nblocks = gridDim.x * gridDim.y;
  const size_t hsz = static_cast<size_t>(gridDim.y) * a.Hk * a.P;
  const float* wsl = a.w + (static_cast<size_t>(d) * a.NJ + jb) * a.Hk * ROW;
  const int GH = 3 * a.H;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (STAGES + st), a.NRA);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int b = tid; b < NB; b += THREADS) lens_s[b] = b < a.B ? a.lens[b] : 0;
  for (int i = tid; i < 3 * TJ; i += THREADS) {
    const int jj = jb * TJ + i % TJ, col = d * GH + i / TJ * a.H + jj;
    bias[i] = jj < a.H ? a.b_ih[col] : 0.f;
    bias[3 * TJ + i] = jj < a.H ? a.b_hh[col] : 0.f;
  }
  for (int e = tid; e < PAIRS; e += THREADS) hst[e] = 0.f;
  __syncthreads();
  if (tid == 0 && a.NR > 0) {
    const unsigned bytes = a.NR * WCHUNK * 4;
    mbar_expect(wbar, bytes);
    bulk_load(smem_addr(wres), wsl, bytes, wbar);
  }

  const int kl = lane % KL, co = lane / KL * CT, ho = warp * RT;
  const bool active = warp < a.NRA;  // warp-uniform
  const int nfill = min(STAGES, a.NK);
  for (int s = 0; s < a.Tn; ++s) {
    const float* hin = a.hT + (s & 1) * hsz
                       + static_cast<size_t>(d) * a.Hk * a.P;
    float* hout = a.hT + ((s + 1) & 1) * hsz
                  + static_cast<size_t>(d) * a.Hk * a.P;
    if (tid == 0)
      for (int c = 0; c < nfill; ++c)
        issue_chunk(a, smem, hin, wsl, c, (s * a.NK + c) % STAGES);
    // lands during the product; the epilogue waits for it
    prefetch_x(a, xs, lens_s, s, d, jb);
    if (s == 0 && a.NR > 0) mbar_wait(wbar, 0);
    float acc[RT][CT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int u = 0; u < CT; ++u) acc[r][u] = 0.f;
    if (active) {
      for (int c = 0; c < a.NK; ++c) {
        const int i = s * a.NK + c, st = i % STAGES;
        if (tid == 0 && c >= 1 && c - 1 + STAGES < a.NK) {
          // refill the stage of chunk c - 1 once every warp has read it
          const int sj = (i - 1) % STAGES;
          mbar_wait(bars + 8 * (STAGES + sj), ((i - 1) / STAGES) & 1);
          issue_chunk(a, smem, hin, wsl, c - 1 + STAGES, sj);
        }
        __syncwarp();  // warp 0 computes converged
        mbar_wait(bars + 8 * st, (i / STAGES) & 1);
        const float* stage = ring + st * STAGE;
        const float* w = c < a.NR ? wres + c * WCHUNK : stage;
        chunk_product(w + co, stage + WCHUNK + ho, a.P, kl, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 * (STAGES + st));
      }
      // the 8 K-lanes' sums, in the same order in every lane
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int u = 0; u < CT; ++u) {
          float v = acc[r][u];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          acc[r][u] = v;
        }
    }
    __syncthreads();  // every warp is done with the ring: the sums take it
    if (active && kl == 0)
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int u = 0; u < CT; ++u)
          red[(ho + r) * RED_P + co + u] = acc[r][u];
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int q = 0; q < PT; ++q) {
      const int e = tid + THREADS * q;
      const int b = e / TJ, u = e % TJ, jj = jb * TJ + u;
      if (e >= PAIRS || b >= a.B || jj >= a.H) continue;
      const float* rs = red + b * RED_P + u;
      const float hr = rs[0] + bias[3 * TJ + u];
      const float hz = rs[TJ] + bias[4 * TJ + u];
      float hn = rs[2 * TJ] + bias[5 * TJ + u];
      const int len = lens_s[b];
      const bool valid = s < len;
      const int t = (d == 0 || !valid) ? s : len - 1 - s;
      const size_t row = (static_cast<size_t>(d) * a.Tn + t) * a.B + b;
      const float hp = hst[e];
      float h = hp, rg = 0.f, zg = 0.f, ng = 0.f;
      if (valid) {
        const float xr = xs[e] + bias[u];
        const float xz = xs[PAIRS + e] + bias[TJ + u];
        const float xn = xs[2 * PAIRS + e] + bias[2 * TJ + u];
        rg = ds_sigmoid(xr + hr);
        zg = ds_sigmoid(xz + hz);
        ng = tanhf(xn + rg * hn);
        h = (1.f - zg) * ng + zg * hp;
      } else {
        hn = 0.f;
      }
      hst[e] = h;
      hout[static_cast<size_t>(jj) * a.P + b] = h;
      store_stream(a.out + row * a.H + jj, valid ? h : 0.f);
      if (a.g_out != nullptr) {
        float* gr = a.g_out + row * GH + jj;
        store_stream(gr, rg);
        store_stream(gr + a.H, zg);
        store_stream(gr + 2 * a.H, ng);
        store_stream(a.hn_out + row * a.H + jj, hn);
      }
    }
    if (s + 1 == a.Tn) break;
    // h_prev's copy in global memory and the ring's bytes, written here
    // through the generic proxy, are read or overwritten next by bulk
    // copies (the async proxy)
    asm volatile("fence.proxy.async;\n" ::: "memory");
    grid_sync_release(a.bar, (s + 1) * nblocks);
  }
}

// The resident chunks (as many as fit a block's shared memory beside the
// rest, at most NK) and the block's shared memory, set as the kernel's
// dynamic limit.
inline cudaError_t plan(int H, int* nr, size_t* smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (static_cast<size_t>(optin) < OFF_WRES) return cudaErrorInvalidValue;
  const int nk = (H + KC - 1) / KC;
  const int room = static_cast<int>((optin - OFF_WRES) / (WCHUNK * 4));
  *nr = nk < room ? nk : room;
  *smem = OFF_WRES + static_cast<size_t>(*nr) * WCHUNK * 4;
  return cudaFuncSetAttribute(persistent_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

// How many blocks can be resident at once at H units.
inline cudaError_t capacity(int H, int* blocks) {
  int nr = 0, dev = 0, sms = 0, per_sm = 0;
  size_t smem = 0;
  cudaError_t err = plan(H, &nr, &smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, persistent_kernel, THREADS, smem);
  if (err == cudaSuccess) *blocks = per_sm * sms;
  return err;
}

// Zero both h_prev copies and the barrier, then the cooperative launch:
// refused (no fallback) above NB rows, or where the grid is not resident.
// No steps launch nothing: the kernel's copy of the resident W_hh chunks
// is waited for only inside the step loop.
inline cudaError_t launch(Args a, int D, cudaStream_t stream) {
  if (a.B < 1 || a.B > NB) return cudaErrorInvalidValue;
  if (a.Tn == 0) return cudaSuccess;
  a.NJ = (a.H + TJ - 1) / TJ;
  a.NK = (a.H + KC - 1) / KC;
  a.Hk = a.NK * KC;
  a.NRA = (a.B + RT - 1) / RT;
  a.P = a.NRA * RT + 4;
  size_t smem = 0;
  cudaError_t err = plan(a.H, &a.NR, &smem);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(a.hT, 0,
                          2 * static_cast<size_t>(D) * a.Hk * a.P * 4, stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(a.bar, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(persistent_kernel),
                                    dim3(a.NJ, D), dim3(THREADS), params, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace f32_scan

// f32, one launch a step: xp (D, T, B, 3H) without bias; b_ih, b_hh
// (D, 3H); w_hh (D, H, 3H); lens (B) int32 <= T; scratch state (2, D, B,
// H); out (D, T, B, H), zero at steps past each row's length; g (D, T, B,
// 3H) and hn (D, T, B, H), or both null.
DS_EXPORT int gru_scan_f32(const float* xp, const float* b_ih,
                           const float* w_hh, const float* b_hh,
                           const int* lens, float* state, float* out,
                           float* g, float* hn, int Tn, int B, int H, int D,
                           void* stream) {
  return static_cast<int>(gru_recurrence(
      xp, w_hh, b_ih, b_hh, lens, state, out, g, hn, Tn, B, H, D,
      static_cast<cudaStream_t>(stream)));
}

// f32, one persistent launch: w_pk is W_hh packed (D, NJ, Hk, 84); scratch
// hT (2, D, Hk, P) f32 and bar (1) uint32, both zeroed here (Hk = H rounded
// up to 32, P = B rounded up to 8, + 4). Refused above 64 rows or where
// the grid (ceil(H / 25), D) is not resident at once. Other arguments as
// gru_scan_f32.
DS_EXPORT int gru_scan_f32_persistent(const float* xp, const float* b_ih,
                                      const float* w_pk, const float* b_hh,
                                      const int* lens, float* hT,
                                      unsigned* bar, float* out, float* g,
                                      float* hn, int Tn, int B, int H, int D,
                                      void* stream) {
  f32_scan::Args a{xp, w_pk, b_ih, b_hh, lens, hT, bar, out, g, hn,
                   Tn, B, H, 0, 0, 0, 0, 0, 0};
  return static_cast<int>(
      f32_scan::launch(a, D, static_cast<cudaStream_t>(stream)));
}

// How many blocks of the f32 persistent kernel can be resident at once at
// H units: the input of the wrapper's rule (recurrence.py:
// scan_f32_variant).
DS_EXPORT int gru_scan_f32_capacity(int H, int* blocks) {
  return static_cast<int>(f32_scan::capacity(H, blocks));
}

// The f32 persistent variant's layout constants, which the wrapper's
// packing and scratch shapes repeat (recurrence.py: F32_TJ, F32_ROW,
// F32_KC, F32_RB, F32_CHUNK): TJ, ROW, KC, RT, NB into out[0..4].
DS_EXPORT int gru_scan_f32_layout(int* out) {
  const int v[] = {f32_scan::TJ, f32_scan::ROW, f32_scan::KC, f32_scan::RT,
                   f32_scan::NB};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// bf16: w_pk is W_hh packed (D, NJ, NK, 3 * 32, 64) (rnn_mma.cuh); scratch
// h (D, B, H) f32, hb (2, D, B8, NK * 64) bf16 and bar (1) uint32, all
// zeroed here; variant 0 (the rule), 1 (one launch a step) or 2
// (persistent). Other arguments as the f32 entry, g and hn in bf16.
DS_EXPORT int gru_scan_bf16(const __nv_bfloat16* xp, const float* b_ih,
                            const __nv_bfloat16* w_pk, const float* b_hh,
                            const int* lens, float* h, __nv_bfloat16* hb,
                            unsigned* bar, float* out, __nv_bfloat16* g,
                            __nv_bfloat16* hn, int Tn, int B, int H, int D,
                            int variant, void* stream) {
  const int nk = (H + mma_rnn::KC - 1) / mma_rnn::KC;
  const mma_rnn::Args a{xp, w_pk, b_ih, b_hh, lens, h, nullptr, hb, bar,
                        out, g, hn, nullptr, Tn, B, H, (B + 7) / 8 * 8,
                        nk * mma_rnn::KC, nk,
                        (H + mma_rnn::TJ - 1) / mma_rnn::TJ};
  return static_cast<int>(mma_rnn::recurrence<3>(
      a, D, variant, static_cast<cudaStream_t>(stream)));
}
