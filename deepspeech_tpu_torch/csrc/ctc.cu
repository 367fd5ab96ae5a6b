// CTC alpha (forward, with the loss) and beta (backward, with the logit
// gradient) recursions in log space.
//
// Replace the Pallas TPU kernels deepspeech_tpu/ops/pallas/ctc_kernel.py
// _ctc_alpha_kernel (ctc_alpha here) and _ctc_beta_kernel together with
// _ctc_bwd's closed-form gradient (ctc_beta), launched by ctc_loss_pallas
// through _ctc_fwd / _ctc_bwd. Over the S = 2L + 1 states of the
// blank-extended label sequence ext of one utterance, with the emission
// emit_t(s) = lp[t][ext[s]] of the f32 log-probs lp (T, C):
//   alpha_t(s) = logaddexp(alpha_{t-1}(s), alpha_{t-1}(s-1),
//                          alpha_{t-1}(s-2) + skip(s)) + emit_t(s) + valid(s)
//   beta_t(s)  = logaddexp(beta_{t+1}(s), beta_{t+1}(s+1),
//                          beta_{t+1}(s+2) + skip(s+2)) + emit_t(s) + valid(s)
// (beta at the last valid frame starts from the end-state indicator), each
// clamped at -1e30 and frozen past the utterance's logit length, with the
// -inf guards of the TPU kernels in the same order, so that impossible
// alignments, NaN rows and frozen rows come out as they do there. skip,
// valid and end come from ext and the target length in the prologue.
// ctc_alpha also writes the loss, -log(alpha at the two end states).
// ctc_beta writes the gradient of the loss w.r.t. the logits, scaled by the
// incoming grad g:
//   gamma_t(s) = exp(min(alpha_t(s) + beta_t(s) - emit_t(s) + loss, 0))
//                where that is > -80 and the loss is finite, else 0
//   dlogits[t][c] = (exp(lp[t][c]) - sum_{s: ext[s] = c} gamma_t(s)) * g
// on frames below the length, 0 * g past it, and 0 on a row whose loss is
// not finite (even where g is not finite); and, when the caller passes a
// buffer, beta + emit, the TPU kernel's own output.
//
// Bound on the H100 at the train shape (B 20, T 376, C 30, L 150, S 301):
// K8 reads the log-probs (0.9 MB) and writes the alphas (9 MB), K9 reads
// the log-probs and alphas and writes the dlogits (0.9 MB): ~10 MB each,
// ~0.003 ms at 3.35 TB/s; ~12-20 operations a state and frame are far
// below that. Inside a kernel the T frames are a chain of dependent steps
// in one block per utterance, so latency bounds it: a frame is three
// shared-memory reads of the previous row, three expf and a logf, one
// shared-memory read of the emission, and one __syncthreads. The floor of
// that chain is ctc_chain_floor below, the same block doing only the
// barrier and one logaddexp3 a frame; chip_smoke.py times it.
//
// Design: one block per batch row, one thread a state (NPT states a thread
// when S > 1024); each thread keeps its states' class id and skip / valid /
// end bits in one register word, loaded once. alpha or beta lives in
// shared memory, double-buffered, so a frame needs one barrier. The row's
// log-probs (and, for K9, the alphas) are staged into shared memory by
// cp.async through a ring of RING chunks of CH frames, AHEAD chunks ahead
// of the chain, for any T; a thread waits for its copies only at the end
// of a chunk, by which time they landed long before. So no global load
// sits on the frame chain: the emission is a shared-memory read
// lp[t][ext[s]], and the alpha rows go out by coalesced stores that the
// chain never waits on. K9's gradient lags the chain: in the step of frame
// t the chain threads also form gamma of frame t + 1 (from registers and
// the staged alpha row), which does not depend on this frame's chain, and
// store it at the state's place in a row sorted by class; two reduction
// warps with no state of their own sum frame t + 2's row, the blank
// segment by a warp reduction and each label class's contiguous segment
// by one lane, and write its dlogits row. No atomics are used, global or
// shared. expf and logf are the accurate library versions: no fast
// intrinsic is used (with __expf and __logf the dlogits' error took up
// most of chip_smoke.py's tolerance, CTC_TOL).
//
// Shared memory: K8 2S + RING CH C floats, K9 4S + RING CH (C + S) floats
// and 2C + 1 + S ints; the wrapper picks CH (ops/cuda/ctc.py:ring_plan).
//
// Two routes, chosen before the launch by a fixed rule on (S, C)
// (ops/cuda/ctc.py:route): the staged ring above wherever ring_plan fits
// one block's shared memory (K9 up to S ~4,400 at C 30, K8 up to ~27,000),
// and the global route otherwise (ctc_alpha_global, ctc_beta_global). The
// global route keeps every row of per-state values in global memory (L2):
// K8's previous and current alpha rows are the alphas output itself; K9's
// beta rows, its two sorted gamma rows, the state words and the class sort
// sit in a workspace the wrapper allocates, and its alphas are read from
// the alphas input. Only the log-prob ring stays in shared memory (RING CH
// C floats). The frame chain is the ring route's, with each thread walking
// its states by a stride, so any S is taken: both routes run one copy of
// the per-state arithmetic (alpha_trans, beta_trans, emit_clamp, gamma_of,
// end_loss), of K9's prologue (fill_past, place_states) and of its
// reduction warps (reduce_frames), and differ only in where the per-state
// rows live.
#include "common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int RING = 4;          // stages of the staging ring
constexpr int AHEAD = RING - 2;  // chunks staged ahead of the chain

// a state's register word: class id, then the valid / skip(s) / skip(s+2)
// / end flags
constexpr unsigned CLS = (1u << 28) - 1;
constexpr unsigned VALID = 1u << 28, SKIP = 1u << 29, SKIP2 = 1u << 30,
                   END = 1u << 31;

// max that propagates NaN, as jnp.maximum and torch.maximum do (fmaxf
// would drop it, and a NaN row must stay NaN so that its loss is not
// finite and its gradient is zeroed)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float m = nanmax(nanmax(a, b), c);
  const bool dead = m <= NEG;
  const float ms = dead ? 0.f : m;
  const float s = expf(a - ms) + expf(b - ms) + expf(c - ms);
  return dead ? NEG : ms + logf(s);
}

__device__ __forceinline__ float flag(unsigned w, unsigned bit) {
  return (w & bit) ? 0.f : NEG;
}

// ext[0] is the blank, so it stands for the blank before state 0 as well
__device__ unsigned state_word(const int* ext, int s, int S, int tl) {
  const int cls = ext[s];
  unsigned w = static_cast<unsigned>(cls) & CLS;
  if (s < 2 * tl + 1) w |= VALID;
  if ((s & 1) && cls != ext[s >= 2 ? s - 2 : 0]) w |= SKIP;
  if ((s & 1) && s + 2 < S && ext[s + 2] != cls) w |= SKIP2;
  if (s == 2 * tl || (s == 2 * tl - 1 && tl > 0)) w |= END;
  return w;
}

// The per-state arithmetic both routes share; prev is the previous row in
// shared memory (the ring route) or global memory (the global route).
// alpha before frame 0: the two start states, where valid
__device__ __forceinline__ float alpha_seed(int s, unsigned w) {
  return (s < 2 ? 0.f : NEG) + flag(w, VALID);
}

__device__ __forceinline__ float alpha_trans(const float* prev, int s,
                                             unsigned w) {
  const float diag = s >= 1 ? prev[s - 1] : NEG;
  const float skp = (s >= 2 ? prev[s - 2] : NEG) + flag(w, SKIP);
  return logaddexp3(prev[s], diag, skp);
}

__device__ __forceinline__ float beta_trans(const float* prev, int s, int S,
                                            unsigned w) {
  const float diag = s + 1 < S ? prev[s + 1] : NEG;
  const float skp = s + 2 < S ? prev[s + 2] + flag(w, SKIP2) : NEG + NEG;
  return logaddexp3(prev[s], diag, skp);
}

// a transition plus the emission e, masked by valid and clamped at -1e30
__device__ __forceinline__ float emit_clamp(float x, float e, unsigned w) {
  return nanmax(x + e + flag(w, VALID), NEG);
}

// gamma from alpha, beta + emit and the emit of one state and frame
__device__ __forceinline__ float gamma_of(float a, float be, float em,
                                          float lossb, bool ok) {
  const float lg = a + be - em + lossb;
  return (ok && lg > -80.f) ? expf(fminf(lg, 0.f)) : 0.f;
}

// -log(alpha_last(2 tl) + alpha_last(2 tl - 1)), +inf where both are dead
__device__ __forceinline__ float end_loss(float eb, float el) {
  const float m = nanmax(eb, el);
  const bool dead = m <= NEG;
  const float ms = dead ? 0.f : m;
  const float sum = expf(eb - ms) + expf(el - ms);
  return dead ? __int_as_float(0x7f800000) : -(ms + logf(sum));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
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

// Stage chunk j of a row of `width` floats a frame into ring stage
// j % RING. Forward, chunk j holds frames [j CH, j CH + CH); reverse, the
// CH frames below len - j CH. Frame f sits at slot f - base, base the
// chunk's lowest frame before clipping to [0, len); thread tid of the nthr
// copying threads copies every nthr-th float.
__device__ void stage_chunk(float* ring, const float* src, int width, int j,
                            int CH, int len, bool reverse, int tid,
                            int nthr) {
  const int base = reverse ? len - (j + 1) * CH : j * CH;
  const int f0 = max(base, 0), f1 = min(base + CH, len);
  if (f0 >= f1) return;
  float* dst = ring + static_cast<size_t>(j % RING) * CH * width +
               static_cast<size_t>(f0 - base) * width;
  const float* s = src + static_cast<size_t>(f0) * width;
  const int n = (f1 - f0) * width;
  for (int k = tid; k < n; k += nthr) cp_async4(dst + k, s + k);
}

// One frame of K8: alpha_t into cur and the alphas row t (FIRST: frame 0,
// the seed plus the emission, no transition).
template <int NPT, bool FIRST>
__device__ __forceinline__ void alpha_frame(const float* prev, float* cur,
                                            const float* em,
                                            const unsigned* w, float* out,
                                            int t, int S, int nthr) {
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int s = threadIdx.x + i * nthr;
    if (s >= S) continue;
    const float nw =
        emit_clamp(FIRST ? prev[s] : alpha_trans(prev, s, w[i]),
                   em[w[i] & CLS], w[i]);
    cur[s] = nw;
    out[static_cast<size_t>(t) * S + s] = nw;
  }
}

// lp (B, T, C) f32; ext (B, S), tls, lens (B) int32; alphas (B, T, S) and
// loss (B) f32 out. Grid (B), dynamic shared memory (2 S + RING CH C)
// floats.
template <int NPT>
__global__ void __launch_bounds__(1024)
    ctc_alpha(const float* __restrict__ lp, const int* __restrict__ ext,
              const int* __restrict__ tls, const int* __restrict__ lens,
              float* __restrict__ alphas, float* __restrict__ loss, int Tn,
              int S, int C, int CH) {
  extern __shared__ float sm[];
  float* prev = sm;
  float* cur = sm + S;
  float* ring = sm + 2 * S;
  const int b = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int len = min(max(lens[b], 0), Tn);
  const int tl = tls[b];
  const float* row = lp + static_cast<size_t>(b) * Tn * C;
  float* out = alphas + static_cast<size_t>(b) * Tn * S;
  unsigned w[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int s = tid + i * nthr;
    w[i] = s < S ? state_word(ext + static_cast<size_t>(b) * S, s, S, tl)
                 : 0u;
    if (s < S) prev[s] = alpha_seed(s, w[i]);
  }
  for (int j = 0; j < AHEAD; ++j) {
    stage_chunk(ring, row, C, j, CH, len, false, tid, nthr);
    cp_async_commit();
  }
  cp_async_wait<AHEAD - 1>();
  __syncthreads();
  int j = 0, q = 0;  // the chunk and the frame's slot in it
  for (int t = 0; t < len; ++t) {
    if (q == 0) {
      stage_chunk(ring, row, C, j + AHEAD, CH, len, false, tid, nthr);
      cp_async_commit();
    }
    const float* em = ring + static_cast<size_t>((j % RING) * CH + q) * C;
    if (t == 0)
      alpha_frame<NPT, true>(prev, cur, em, w, out, 0, S, nthr);
    else
      alpha_frame<NPT, false>(prev, cur, em, w, out, t, S, nthr);
    if (++q == CH) {  // the next chunk must have landed before its frame
      q = 0;
      ++j;
      cp_async_wait<AHEAD - 1>();
    }
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  cp_async_wait<0>();
  for (int t = len; t < Tn; ++t)
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int s = tid + i * nthr;
      if (s < S) out[static_cast<size_t>(t) * S + s] = prev[s];
    }
  if (tid == 0)
    loss[b] = end_loss(prev[min(max(2 * tl, 0), S - 1)],
                       tl > 0 ? prev[min(2 * tl - 1, S - 1)] : NEG);
}

// One warp sorts the row's valid label states (1, 3, ..., 2 nl - 1) by
// class, stably: a histogram, an exclusive scan into begin (C + 1), then
// the placement, 32 states at a time with __match_any_sync: label state s
// of rank k in the order goes to posn[s] = base + k. cursor (C) is scratch.
__device__ void sort_labels(const int* ex, int nl, int C, int base,
                            int* begin, int* cursor, int* posn, int lane) {
  for (int c = lane; c < C; c += 32) cursor[c] = 0;
  __syncwarp();
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < nl; k0 += 32) {
      const int k = k0 + lane;
      const bool active = k < nl;
      const unsigned mask = __ballot_sync(0xffffffffu, active);
      int c = 0;
      unsigned m = 0;
      if (active) {
        c = ex[2 * k + 1];
        m = __match_any_sync(mask, c);
        if (pass == 1)
          posn[2 * k + 1] =
              base + cursor[c] + __popc(m & ((1u << lane) - 1));
      }
      __syncwarp();
      if (active && lane == __ffs(m) - 1) cursor[c] += __popc(m);
      __syncwarp();
    }
    if (pass == 1) break;
    // exclusive scan of the counts: each lane a block of classes
    const int per = (C + 31) / 32;
    const int lo = min(lane * per, C), hi = min(lo + per, C);
    int sum = 0;
    for (int c = lo; c < hi; ++c) sum += cursor[c];
    int incl = sum;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, k);
      if (lane >= k) incl += v;
    }
    int run = incl - sum;
    for (int c = lo; c < hi; ++c) {
      const int n = cursor[c];
      begin[c] = cursor[c] = run;
      run += n;
    }
    if (lane == 31) begin[C] = incl;
    __syncwarp();
  }
}

// The sum of a class's segment of the sorted gamma row, in order.
__device__ __forceinline__ float segment_sum(const float* gs, int lo, int hi) {
  float o = 0.f;
#pragma unroll 4
  for (int k = lo; k < hi; ++k) o += gs[k];
  return o;
}

// K9's frames past the length: dlogits `past` (0 times g, as the closed
// form's frame mask is applied before the scaling), betas -1e30.
__device__ __forceinline__ void fill_past(float* dl, float* bo, int len,
                                          int Tn, int C, int S, float past) {
  for (size_t k = static_cast<size_t>(len) * C + threadIdx.x;
       k < static_cast<size_t>(Tn) * C; k += blockDim.x)
    dl[k] = past;
  if (bo)
    for (size_t k = static_cast<size_t>(len) * S + threadIdx.x;
         k < static_cast<size_t>(Tn) * S; k += blockDim.x)
      bo[k] = NEG;
}

// K9's reduction warps in the prologue: warp 0 places the blank states
// (none past nl), warp 1 sorts the label states by class.
__device__ __forceinline__ void place_states(const int* ex, int S, int nl,
                                             int C, int nb, int* begin,
                                             int* cursor, int* posn,
                                             int warp, int lane) {
  if (warp == 0) {
    for (int s = lane; s < S; s += 32)
      if (!(s & 1) || s > 2 * nl) posn[s] = s <= 2 * nl ? s / 2 : -1;
  } else {
    sort_labels(ex, nl, C, nb, begin, cursor, posn, lane);
  }
}

// K9's reduction warps over the frames: for frame t + 2 in the step of
// frame t, warp 0 sums the blank segment of the sorted gamma row (lane-
// strided partial sums and a butterfly, then any label of the blank's
// class) into the blank's dlogit, warp 1 each other class's contiguous
// segment into its dlogit. gam holds the two sorted rows by frame parity,
// lring the staged log-prob rows; one __syncthreads a frame, as the chain
// threads' walk.
__device__ __forceinline__ void reduce_frames(
    const float* lring, const float* gam, float* dl, const int* begin,
    int len, int CH, int C, int S, int nb, int blank, int warp, int lane,
    bool ok, float gb) {
  int j2 = 0, q2 = 0;  // the chunk and place of frame t + 2
  // the segment of the blank (warp 0) or of class `lane` (warp 1), read
  // once; classes past the 32nd read theirs each frame
  const int own = warp == 0 ? blank : lane;
  const int lo0 = own < C ? nb + begin[own] : 0;
  const int hi0 = own < C ? nb + begin[own + 1] : 0;
  for (int r = 0; r < len + 2; ++r) {
    const int t = len - 1 - r;
    if (t + 2 < len) {  // frame t + 2: its gamma row is complete
      const float* lt =
          lring + static_cast<size_t>((j2 % RING) * CH + CH - 1 - q2) * C;
      const float* gs = gam + static_cast<size_t>(t & 1) * S;
      float* d = dl + static_cast<size_t>(t + 2) * C;
      if (warp == 0) {
        const float p = expf(lt[blank]);
        float bs = 0.f;
#pragma unroll 4
        for (int k = lane; k < nb; k += 32) bs += gs[k];
#pragma unroll
        for (int k = 16; k > 0; k >>= 1)
          bs += __shfl_xor_sync(0xffffffffu, bs, k);
        if (lane == 0)
          d[blank] = ok ? (p - (bs + segment_sum(gs, lo0, hi0))) * gb : 0.f;
      } else {
        if (lane < C && lane != blank) {
          const float p = expf(lt[lane]);
          d[lane] = ok ? (p - segment_sum(gs, lo0, hi0)) * gb : 0.f;
        }
        for (int c = lane + 32; c < C; c += 32)
          if (c != blank) {
            const float p = expf(lt[c]);
            const float o = segment_sum(gs, nb + begin[c], nb + begin[c + 1]);
            d[c] = ok ? (p - o) * gb : 0.f;
          }
      }
      if (++q2 == CH) {
        q2 = 0;
        ++j2;
      }
    }
    __syncthreads();
  }
}

// One frame of K9's chain threads: beta of frame t (STEP; FIRST: the
// row's last valid frame, which starts from the end states) and, beside
// it, gamma of frame t + 1 (GRAD) at each state's place in the sorted row
// gr. Both in one straight block, so that the compiler can interleave the
// gamma, which does not depend on this frame's chain, into the chain's
// stalls.
template <int NPT, bool STEP, bool FIRST, bool GRAD>
__device__ __forceinline__ void beta_frame(
    const float* prev, float* cur, float* gr, const float* lt,
    const float* a1, const unsigned* w, const int* pos, float* be1,
    float* em1, float* bo, int t, int S, int NC, bool ok, float lossb) {
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int s = threadIdx.x + i * NC;
    if (s >= S) continue;
    const float gm = GRAD ? gamma_of(a1[s], be1[i], em1[i], lossb, ok) : 0.f;
    if (STEP) {
      const float e = lt[w[i] & CLS];
      const float bh = emit_clamp(
          FIRST ? flag(w[i], END) : beta_trans(prev, s, S, w[i]), e, w[i]);
      cur[s] = bh;
      if (bo) bo[static_cast<size_t>(t) * S + s] = bh;
      be1[i] = bh;
      em1[i] = e;
    }
    if (GRAD && pos[i] >= 0) gr[pos[i]] = gm;
  }
}

// lp (B, T, C), alphas (B, T, S), loss, g (B) f32; ext (B, S), tls, lens
// (B) int32; dlogits (B, T, C) f32 out; betas (B, T, S) f32 out, beta +
// emit and -1e30 past the length, or null to skip those stores. Grid (B),
// NC chain threads (NPT states each) and two reduction warps. Dynamic
// shared memory: (4 S + RING CH (C + S)) floats, then (2 C + 1 + S) ints.
//
// In the step of frame t the chain threads compute beta_t (the chain) and,
// beside it, gamma of frame t + 1 from registers and the staged alpha row.
// Each stores its gamma at its state's place in a row sorted by class (the
// nb = tl + 1 blank states first, then the label states by class, stably,
// from a sort in the prologue), one of two rows by frame parity. The
// reduction warps, which hold no state, sum frame t + 2's sorted row: the
// first the blank segment (lane-strided partial sums and a butterfly, then
// any label of the blank's class) into the blank's dlogit, the second each
// other class's contiguous segment into its dlogit. One __syncthreads a
// frame orders all three.
template <int NPT>
__global__ void __launch_bounds__(1024)
    ctc_beta(const float* __restrict__ lp, const int* __restrict__ ext,
             const int* __restrict__ tls, const int* __restrict__ lens,
             const float* __restrict__ alphas, const float* __restrict__ loss,
             const float* __restrict__ g, float* __restrict__ dlogits,
             float* __restrict__ betas, int Tn, int S, int C, int CH,
             int NC) {
  extern __shared__ float sm[];
  float* prev = sm;
  float* cur = sm + S;
  float* gam = sm + 2 * S;  // two sorted gamma rows, by frame parity
  float* lring = sm + 4 * S;
  float* aring = lring + static_cast<size_t>(RING) * CH * C;
  int* begin = reinterpret_cast<int*>(aring +
                                      static_cast<size_t>(RING) * CH * S);
  int* cursor = begin + C + 1;
  int* posn = cursor + C;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int len = min(max(lens[b], 0), Tn);
  const int tl = tls[b];
  const float lossb = loss[b], gb = g[b];
  const bool ok = isfinite(lossb);
  const float* row = lp + static_cast<size_t>(b) * Tn * C;
  const float* arow = alphas + static_cast<size_t>(b) * Tn * S;
  const int* ex = ext + static_cast<size_t>(b) * S;
  float* dl = dlogits + static_cast<size_t>(b) * Tn * C;
  float* bo = betas ? betas + static_cast<size_t>(b) * Tn * S : nullptr;

  fill_past(dl, bo, len, Tn, C, S, ok ? 0.f * gb : 0.f);
  const bool chain = tid < NC;
  const int lane = tid & 31, warp = (tid - NC) >> 5;  // warp: reduction's
  const int nl = max(min(tl, (S - 1) / 2), 0);  // valid label states
  const int nb = nl + 1;                        // valid blank states
  if (chain) {
    for (int j = 0; j < AHEAD; ++j) {
      stage_chunk(lring, row, C, j, CH, len, true, tid, NC);
      stage_chunk(aring, arow, S, j, CH, len, true, tid, NC);
      cp_async_commit();
    }
    for (int s = tid; s < S; s += NC) prev[s] = NEG;
  } else {
    place_states(ex, S, nl, C, nb, begin, cursor, posn, warp, lane);
  }
  __syncthreads();

  unsigned w[NPT];
  int pos[NPT];
  float be1[NPT] = {}, em1[NPT] = {};  // frame t + 1's beta + emit, emit
  if (chain) {
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int s = tid + i * NC;
      w[i] = s < S ? state_word(ex, s, S, tl) : 0u;
      pos[i] = s < S ? posn[s] : -1;
    }
    cp_async_wait<AHEAD - 1>();
  }
  __syncthreads();

  if (chain) {
    const float* a1 = aring;  // frame t + 1's staged alpha row
    int j = 0, q = 0;  // the chunk and the frame's place in it, from the top
    for (int r = 0; r < len; ++r) {
      const int t = len - 1 - r;
      if (q == 0) {
        stage_chunk(lring, row, C, j + AHEAD, CH, len, true, tid, NC);
        stage_chunk(aring, arow, S, j + AHEAD, CH, len, true, tid, NC);
        cp_async_commit();
      }
      const size_t slot = static_cast<size_t>((j % RING) * CH + CH - 1 - q);
      float* gr = gam + ((t + 1) & 1) * S;
      if (r == 0)
        beta_frame<NPT, true, true, false>(prev, cur, gr, lring + slot * C,
                                           a1, w, pos, be1, em1, bo, t, S,
                                           NC, ok, lossb);
      else
        beta_frame<NPT, true, false, true>(prev, cur, gr, lring + slot * C,
                                           a1, w, pos, be1, em1, bo, t, S,
                                           NC, ok, lossb);
      a1 = aring + slot * S;
      if (++q == CH) {  // the next chunk must have landed
        q = 0;
        ++j;
        cp_async_wait<AHEAD - 1>();
      }
      __syncthreads();
      float* tmp = prev;
      prev = cur;
      cur = tmp;
    }
    if (len > 0)  // gamma of frame 0
      beta_frame<NPT, false, false, true>(prev, cur, gam, lring, a1, w, pos,
                                          be1, em1, bo, -1, S, NC, ok, lossb);
    __syncthreads();
    __syncthreads();
    cp_async_wait<0>();
  } else {
    reduce_frames(lring, gam, dl, begin, len, CH, C, S, nb, ex[0], warp,
                  lane, ok, gb);
  }
}

// The global route of K8: alpha row t is out row t, read back as frame
// t + 1's previous row; words (S) holds the state words. Dynamic shared
// memory: the log-prob ring, RING CH C floats.
__global__ void __launch_bounds__(1024)
    ctc_alpha_global(const float* __restrict__ lp, const int* __restrict__ ext,
                     const int* __restrict__ tls, const int* __restrict__ lens,
                     float* alphas, float* __restrict__ loss, unsigned* words,
                     int Tn, int S, int C, int CH) {
  extern __shared__ float ring[];
  const int b = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int len = min(max(lens[b], 0), Tn);
  const int tl = tls[b];
  const float* row = lp + static_cast<size_t>(b) * Tn * C;
  float* out = alphas + static_cast<size_t>(b) * Tn * S;
  unsigned* wd = words + static_cast<size_t>(b) * S;
  const int* ex = ext + static_cast<size_t>(b) * S;
  for (int s = tid; s < S; s += nthr) wd[s] = state_word(ex, s, S, tl);
  for (int j = 0; j < AHEAD; ++j) {
    stage_chunk(ring, row, C, j, CH, len, false, tid, nthr);
    cp_async_commit();
  }
  cp_async_wait<AHEAD - 1>();
  __syncthreads();
  int j = 0, q = 0;  // the chunk and the frame's slot in it
  for (int t = 0; t < len; ++t) {
    if (q == 0) {
      stage_chunk(ring, row, C, j + AHEAD, CH, len, false, tid, nthr);
      cp_async_commit();
    }
    const float* em = ring + static_cast<size_t>((j % RING) * CH + q) * C;
    const float* prev = out + static_cast<size_t>(t > 0 ? t - 1 : 0) * S;
    float* cur = out + static_cast<size_t>(t) * S;
    for (int s = tid; s < S; s += nthr) {
      const unsigned w = wd[s];
      cur[s] = emit_clamp(t == 0 ? alpha_seed(s, w) : alpha_trans(prev, s, w),
                          em[w & CLS], w);
    }
    if (++q == CH) {
      q = 0;
      ++j;
      cp_async_wait<AHEAD - 1>();
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  // frames past the length hold the last row (the seed where len is 0)
  const float* last = len > 0 ? out + static_cast<size_t>(len - 1) * S
                              : nullptr;
  for (int t = len; t < Tn; ++t)
    for (int s = tid; s < S; s += nthr)
      out[static_cast<size_t>(t) * S + s] =
          last ? last[s] : alpha_seed(s, wd[s]);
  __syncthreads();
  if (tid == 0) {  // the last row (the seed where T is 0)
    const int ib = min(max(2 * tl, 0), S - 1), il = min(2 * tl - 1, S - 1);
    const float* fin = out + static_cast<size_t>(max(Tn - 1, 0)) * S;
    loss[b] = end_loss(Tn > 0 ? fin[ib] : alpha_seed(ib, wd[ib]),
                       tl <= 0  ? NEG
                       : Tn > 0 ? fin[il]
                                : alpha_seed(il, wd[il]));
  }
}

// The workspace of K9's global route, per row, in 4-byte words: the beta
// rows prev and cur, two sorted gamma rows (S each), the state words and
// the sorted places (S each), begin (C + 1) and cursor (C).
__host__ __device__ inline size_t beta_ws_words(int S, int C) {
  return 6 * static_cast<size_t>(S) + 2 * static_cast<size_t>(C) + 1;
}

// The global route of K9: ctc_beta's walk with its per-state rows in the
// workspace ws and the alphas read from global memory; the chain threads
// walk their states by a stride of NC. Dynamic shared memory: the log-prob
// ring, RING CH C floats.
__global__ void __launch_bounds__(1024)
    ctc_beta_global(const float* __restrict__ lp, const int* __restrict__ ext,
                    const int* __restrict__ tls, const int* __restrict__ lens,
                    const float* __restrict__ alphas,
                    const float* __restrict__ loss,
                    const float* __restrict__ g, float* __restrict__ dlogits,
                    float* __restrict__ betas, unsigned* ws, int Tn, int S,
                    int C, int CH, int NC) {
  extern __shared__ float lring[];
  const int b = blockIdx.x, tid = threadIdx.x;
  unsigned* base = ws + static_cast<size_t>(b) * beta_ws_words(S, C);
  float* prev = reinterpret_cast<float*>(base);
  float* cur = prev + S;
  float* gam = prev + 2 * static_cast<size_t>(S);
  unsigned* wd = base + 4 * static_cast<size_t>(S);
  int* posn = reinterpret_cast<int*>(base + 5 * static_cast<size_t>(S));
  int* begin = posn + S;
  int* cursor = begin + C + 1;
  const int len = min(max(lens[b], 0), Tn);
  const int tl = tls[b];
  const float lossb = loss[b], gb = g[b];
  const bool ok = isfinite(lossb);
  const float* row = lp + static_cast<size_t>(b) * Tn * C;
  const float* arow = alphas + static_cast<size_t>(b) * Tn * S;
  const int* ex = ext + static_cast<size_t>(b) * S;
  float* dl = dlogits + static_cast<size_t>(b) * Tn * C;
  float* bo = betas ? betas + static_cast<size_t>(b) * Tn * S : nullptr;

  fill_past(dl, bo, len, Tn, C, S, ok ? 0.f * gb : 0.f);
  const bool chain = tid < NC;
  const int lane = tid & 31, warp = (tid - NC) >> 5;
  const int nl = max(min(tl, (S - 1) / 2), 0);
  const int nb = nl + 1;
  if (chain) {
    for (int j = 0; j < AHEAD; ++j) {
      stage_chunk(lring, row, C, j, CH, len, true, tid, NC);
      cp_async_commit();
    }
    for (int s = tid; s < S; s += NC) {
      prev[s] = NEG;
      wd[s] = state_word(ex, s, S, tl);
    }
  } else {
    place_states(ex, S, nl, C, nb, begin, cursor, posn, warp, lane);
  }
  __syncthreads();
  if (chain) cp_async_wait<AHEAD - 1>();
  __syncthreads();

  if (chain) {
    const float* l1 = lring;  // frame t + 1's staged log-prob row
    int j = 0, q = 0;
    for (int r = 0; r < len; ++r) {
      const int t = len - 1 - r;
      if (q == 0) {
        stage_chunk(lring, row, C, j + AHEAD, CH, len, true, tid, NC);
        cp_async_commit();
      }
      const float* lt =
          lring + static_cast<size_t>((j % RING) * CH + CH - 1 - q) * C;
      float* gr = gam + static_cast<size_t>((t + 1) & 1) * S;
      const float* a1 = arow + static_cast<size_t>(t + 1) * S;
      for (int s = tid; s < S; s += NC) {
        const unsigned w = wd[s];
        if (r > 0) {  // gamma of frame t + 1, beside the chain
          const int p = posn[s];
          if (p >= 0) gr[p] = gamma_of(a1[s], prev[s], l1[w & CLS], lossb, ok);
        }
        const float bh = emit_clamp(
            r == 0 ? flag(w, END) : beta_trans(prev, s, S, w), lt[w & CLS],
            w);
        cur[s] = bh;
        if (bo) bo[static_cast<size_t>(t) * S + s] = bh;
      }
      l1 = lt;
      if (++q == CH) {
        q = 0;
        ++j;
        cp_async_wait<AHEAD - 1>();
      }
      __syncthreads();
      float* tmp = prev;
      prev = cur;
      cur = tmp;
    }
    if (len > 0)  // gamma of frame 0
      for (int s = tid; s < S; s += NC) {
        const int p = posn[s];
        if (p >= 0)
          gam[p] = gamma_of(arow[s], prev[s], l1[wd[s] & CLS], lossb, ok);
      }
    __syncthreads();
    __syncthreads();
    cp_async_wait<0>();
  } else {
    reduce_frames(lring, gam, dl, begin, len, CH, C, S, nb, ex[0], warp,
                  lane, ok, gb);
  }
}

// The chain's floor: the same block does, for T frames, only one
// logaddexp3 on shared memory and the barrier. out (B, S) f32 takes the
// last row so that the work is not dropped.
__global__ void __launch_bounds__(1024)
    ctc_chain_floor(float* __restrict__ out, int Tn, int S) {
  extern __shared__ float sm[];
  float* prev = sm;
  float* cur = sm + S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) prev[s] = -s;
  __syncthreads();
  for (int t = 0; t < Tn; ++t) {
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      cur[s] = logaddexp3(prev[s], s >= 1 ? prev[s - 1] : NEG,
                          s >= 2 ? prev[s - 2] : NEG);
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    out[static_cast<size_t>(blockIdx.x) * S + s] = prev[s];
}

int threads_for(int S) { return S >= 1024 ? 1024 : ((S + 31) / 32) * 32; }

// K9's chain threads: one a state, up to what its reduction warps leave
int chain_threads(int S) { return min(threads_for(S), 1024 - 64); }

// states a thread: the power of two that covers S on `threads`
int npt_for(int S, int threads) {
  const int need = (S + threads - 1) / threads;
  int n = 1;
  while (n < need) n *= 2;
  return n;
}

int allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int N>
int alpha_launch(const float* lp, const int* ext, const int* tls,
                 const int* lens, float* alphas, float* loss, int B, int Tn,
                 int S, int C, int CH, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(S) +
                       static_cast<size_t>(RING) * CH * C) * sizeof(float);
  const int err = allow_smem(reinterpret_cast<const void*>(ctc_alpha<N>),
                             smem);
  if (err != 0) return err;
  ctc_alpha<N><<<B, threads_for(S), smem, stream>>>(lp, ext, tls, lens,
                                                    alphas, loss, Tn, S, C, CH);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int beta_launch(const float* lp, const int* ext, const int* tls,
                const int* lens, const float* alphas, const float* loss,
                const float* g, float* dlogits, float* betas, int B, int Tn,
                int S, int C, int CH, cudaStream_t stream) {
  const size_t smem =
      (4 * static_cast<size_t>(S) + static_cast<size_t>(RING) * CH * (C + S) +
       2 * static_cast<size_t>(C) + 1 + S) * sizeof(float);
  const int err = allow_smem(reinterpret_cast<const void*>(ctc_beta<N>),
                             smem);
  if (err != 0) return err;
  const int nc = chain_threads(S);
  ctc_beta<N><<<B, nc + 64, smem, stream>>>(
      lp, ext, tls, lens, alphas, loss, g, dlogits, betas, Tn, S, C, CH, nc);
  return static_cast<int>(cudaGetLastError());
}

int global_launch(const float* lp, const int* ext, const int* tls,
                  const int* lens, float* alphas, float* loss, unsigned* words,
                  int B, int Tn, int S, int C, int CH, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(RING) * CH * C * sizeof(float);
  const int err = allow_smem(reinterpret_cast<const void*>(ctc_alpha_global),
                             smem);
  if (err != 0) return err;
  ctc_alpha_global<<<B, threads_for(S), smem, stream>>>(
      lp, ext, tls, lens, alphas, loss, words, Tn, S, C, CH);
  return static_cast<int>(cudaGetLastError());
}

int beta_global_launch(const float* lp, const int* ext, const int* tls,
                       const int* lens, const float* alphas,
                       const float* loss, const float* g, float* dlogits,
                       float* betas, unsigned* ws, int B, int Tn, int S,
                       int C, int CH, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(RING) * CH * C * sizeof(float);
  const int err = allow_smem(reinterpret_cast<const void*>(ctc_beta_global),
                             smem);
  if (err != 0) return err;
  const int nc = chain_threads(S);
  ctc_beta_global<<<B, nc + 64, smem, stream>>>(lp, ext, tls, lens, alphas,
                                                loss, g, dlogits, betas, ws,
                                                Tn, S, C, CH, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Only states-a-thread counts of 1-32 are built: S up to 32,768, beyond
// what the shared memory of one block holds.
#define DS_NPT_SWITCH(NPT, CALL)                                \
  switch (NPT) {                                        \
    case 1: return CALL(1);                                    \
    case 2: return CALL(2);                                    \
    case 4: return CALL(4);                                    \
    case 8: return CALL(8);                                    \
    case 16: return CALL(16);                                  \
    case 32: return CALL(32);                                  \
    default: return static_cast<int>(cudaErrorInvalidValue);   \
  }

DS_EXPORT int ctc_alpha_f32(const float* lp, const int* ext, const int* tls,
                            const int* lens, float* alphas, float* loss,
                            int B, int Tn, int S, int C, int CH,
                            void* stream) {
#define CALL(N)                                                        \
  alpha_launch<N>(lp, ext, tls, lens, alphas, loss, B, Tn, S, C, CH, \
                  static_cast<cudaStream_t>(stream))
  DS_NPT_SWITCH(npt_for(S, threads_for(S)), CALL)
#undef CALL
}

DS_EXPORT int ctc_beta_f32(const float* lp, const int* ext, const int* tls,
                           const int* lens, const float* alphas,
                           const float* loss, const float* g, float* dlogits,
                           float* betas, int B, int Tn, int S, int C, int CH,
                           void* stream) {
#define CALL(N)                                                           \
  beta_launch<N>(lp, ext, tls, lens, alphas, loss, g, dlogits, betas, B, \
                 Tn, S, C, CH, static_cast<cudaStream_t>(stream))
  DS_NPT_SWITCH(npt_for(S, chain_threads(S)), CALL)
#undef CALL
}

// The global routes: words (B, S) and ws (B, 6 S + 2 C + 1) are 4-byte
// scratch the caller allocates (ops/cuda/ctc.py).
DS_EXPORT int ctc_alpha_global_f32(const float* lp, const int* ext,
                                   const int* tls, const int* lens,
                                   float* alphas, float* loss, void* words,
                                   int B, int Tn, int S, int C, int CH,
                                   void* stream) {
  return global_launch(lp, ext, tls, lens, alphas, loss,
                       static_cast<unsigned*>(words), B, Tn, S, C, CH,
                       static_cast<cudaStream_t>(stream));
}

DS_EXPORT int ctc_beta_global_f32(const float* lp, const int* ext,
                                  const int* tls, const int* lens,
                                  const float* alphas, const float* loss,
                                  const float* g, float* dlogits, float* betas,
                                  void* ws, int B, int Tn, int S, int C,
                                  int CH, void* stream) {
  return beta_global_launch(lp, ext, tls, lens, alphas, loss, g, dlogits,
                            betas, static_cast<unsigned*>(ws), B, Tn, S, C,
                            CH, static_cast<cudaStream_t>(stream));
}

// Only chip_smoke.py calls this: the frame chain's floor (see above).
DS_EXPORT int ctc_chain_floor_f32(float* out, int B, int Tn, int S,
                                  void* stream) {
  const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
  const int err = allow_smem(reinterpret_cast<const void*>(ctc_chain_floor),
                             smem);
  if (err != 0) return err;
  ctc_chain_floor<<<B, threads_for(S), smem,
                    static_cast<cudaStream_t>(stream)>>>(out, Tn, S);
  return static_cast<int>(cudaGetLastError());
}
