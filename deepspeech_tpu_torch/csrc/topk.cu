// Total-order top-k of the beam search's merged candidates, one row a block.
//
// Replaces the Pallas TPU kernel deepspeech_tpu/ops/pallas/topk_kernel.py
// _topk_kernel (launched by _topk_pallas through topk_total_order, called by
// decoders/beam_device.py once per time step). For each row of R rows of n
// float32 scores it returns the k largest in lax.top_k's order: descending by
// the bitwise total order of float32 (+0.0 above -0.0, positive NaNs above
// +inf, negative NaNs below -inf), ties by ascending index, and the values
// with the input's own bits (-0.0 and NaN payloads kept).
//
// Keys: the float's bits map to the monotone int32 key of the TPU kernel,
// u ^ (0x7fffffff & (u >> 31)), moved to unsigned order; a candidate becomes
// the 64-bit composite key (that key << 32) | ~index. Every composite key is
// distinct and "descending composite" is "descending key, then ascending
// index", so the top k is exactly the set of keys >= the k-th largest one:
// ties, floods of -inf and NaNs need no special case. The value is rebuilt
// from the key (the map is self-inverse) and stored as raw bits.
//
// Bound on the H100 at the beam's shapes (R 20 rows, n = K (C + 1)): the
// function reads R n 4 bytes and writes R k 8 bytes, 26 KB at width 10 and
// 338 KB at width 128, 8-101 ns at 3.35 TB/s; one comparison a candidate is
// far below any compute bound. What bounds a kernel here is its chain of
// block-wide barriers on R of the 132 SMs.
//
// Two routes, chosen by the wrapper from k (ops/cuda/topk.py):
//
// Selection (topk_select_f32), k <= 256: each thread holds its KPT <= 16
// keys in registers (index p blockDim + tid). A radix select on the 64-bit
// key, most significant byte first: each pass builds a 256-bin histogram of
// the keys that still match the decided prefix (warp-aggregated through
// __match_any_sync), and one warp's suffix scan finds the digit at which
// the count from the top reaches the k still needed; the pass stops the
// search once the keys left with that prefix are exactly the ones needed.
// Rows whose k-th value is unique stop within the 4 passes of the value
// word; ties at the threshold (the beam's early steps: ~31 finite of 3,968,
// the rest -inf) read the index's low two bytes too (its high two are
// 0xffff for rows below 65,536), 6 passes at most, two barriers each (the
// histograms are double-buffered). The selected keys are
// compacted by warp offsets into shared memory, and each is written to its
// rank, the count of selected keys above it (k^2 comparisons).
//
// Bitonic (topk_bitonic_f32), k > 256: the row sorted whole in shared
// memory, the first k written.
//
// The bitonic route pads with the composite key 0, below every real key;
// the selection needs no padding. The TPU kernel pads with -inf at indices
// past the row, which a real -inf outranks but a negative NaN does not, so
// rows with negative NaNs among their top k differ there from lax.top_k;
// neither route here does.
//
// Times on the card: PERF.md section 6 (chip_smoke.py phase 7).
#include <cstdint>

#include "common.cuh"

namespace {

// float32 bits -> a key whose unsigned order is the float's total order
__device__ __forceinline__ uint32_t ordered_bits(float v) {
  const int32_t u = __float_as_int(v);
  const int32_t key = u ^ (0x7fffffff & (u >> 31));
  return static_cast<uint32_t>(key) ^ 0x80000000u;
}

// inverse of ordered_bits, as the float's raw bits
__device__ __forceinline__ int32_t bits_of(uint32_t ordered) {
  const int32_t key = static_cast<int32_t>(ordered ^ 0x80000000u);
  return key ^ (0x7fffffff & (key >> 31));
}

// the composite key of score v at index i: distinct for every i
__device__ __forceinline__ unsigned long long composite(float v, int i) {
  return (static_cast<unsigned long long>(ordered_bits(v)) << 32) |
         static_cast<uint32_t>(~i);
}

// The bitonic route. score (R, n) f32 -> vals (R, k) f32 (written as int32
// bits), idx (R, k) int32; grid (R), block min(npad / 2, 1024), dynamic
// shared memory npad * 8. The row is padded to npad = 2^m with the composite
// key 0, below every real key, and sorted by a bitonic network
// (m (m + 1) / 2 stages, one __syncthreads each); the first k are written.
__global__ void topk_rows(const float* __restrict__ score,
                          int32_t* __restrict__ vals,
                          int32_t* __restrict__ idx, int n, int npad, int k) {
  extern __shared__ unsigned long long keys[];
  const size_t row = blockIdx.x;
  const float* s = score + row * n;
  for (int i = threadIdx.x; i < npad; i += blockDim.x)
    keys[i] = i < n ? composite(s[i], i) : 0ull;
  __syncthreads();
  const int half = npad >> 1;
  for (int size = 2; size <= npad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        // p-th pair: i with a 0 at the stride bit, j = i with a 1 there
        const int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        const int j = i | stride;
        const unsigned long long a = keys[i], b = keys[j];
        const bool desc = (i & size) == 0;  // the last merge: all descending
        if ((a < b) == desc) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const unsigned long long c = keys[i];
    vals[row * k + i] = bits_of(static_cast<uint32_t>(c >> 32));
    idx[row * k + i] = static_cast<int32_t>(~static_cast<uint32_t>(c));
  }
}


constexpr unsigned FULL = 0xffffffffu;

// The selection route. score (R, n) f32 -> vals (R, k) f32 (written as int32
// bits), idx (R, k) int32, k <= 256; grid (R), block of a multiple of 32
// threads with blockDim KPT >= n.
template <int KPT>
__global__ void __launch_bounds__(1024)
    topk_select(const float* __restrict__ score, int32_t* __restrict__ vals,
                int32_t* __restrict__ idx, int n, int k) {
  __shared__ unsigned hist[2][256];
  __shared__ unsigned long long cand[256];
  __shared__ int s_digit, s_above, s_count, s_fill;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t row = blockIdx.x;
  const float* s = score + row * n;

  unsigned long long key[KPT];
#pragma unroll
  for (int p = 0; p < KPT; ++p) {
    const int i = p * nt + tid;
    key[p] = i < n ? composite(s[i], i) : 0ull;
  }
  for (int i = tid; i < 256; i += nt) hist[0][i] = 0;
  if (tid == 0) s_fill = 0;
  __syncthreads();

  // Invariant: the keys above the threshold are those whose digits decided
  // so far (key & mask) exceed prefix, plus `need` of those equal to it.
  // The index word's top two bytes, ~index >> 16, are 0xffff for every
  // index below 65,536: no pass is spent on them.
  unsigned long long prefix = 0, mask = 0;
  int need = k;
  for (int shift = 56, cur = 0; shift >= 0; cur ^= 1) {
#pragma unroll
    for (int p = 0; p < KPT; ++p) {
      const bool live = p * nt + tid < n && (key[p] & mask) == prefix;
      const unsigned live_lanes = __ballot_sync(FULL, live);
      if (live) {
        const unsigned d = static_cast<unsigned>(key[p] >> shift) & 0xffu;
        const unsigned peers = __match_any_sync(live_lanes, d);
        if (lane == __ffs(peers) - 1) atomicAdd(&hist[cur][d], __popc(peers));
      }
    }
    __syncthreads();
    for (int i = tid; i < 256; i += nt) hist[cur ^ 1][i] = 0;  // next pass
    if (tid < 32) {
      // lane l holds digits 255 - 8l down to 248 - 8l
      unsigned c[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = hist[cur][255 - 8 * lane - i];
        sum += c[i];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned hit =
          __ballot_sync(FULL, incl >= static_cast<unsigned>(need));
      if (lane == __ffs(hit) - 1) {
        unsigned above = incl - sum;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (above + c[i] >= static_cast<unsigned>(need)) {
            s_digit = 255 - 8 * lane - i;
            s_above = static_cast<int>(above);
            s_count = static_cast<int>(c[i]);
            break;
          }
          above += c[i];
        }
      }
    }
    __syncthreads();
    need -= s_above;
    prefix |= static_cast<unsigned long long>(s_digit) << shift;
    mask |= 0xffull << shift;
    if (s_count == need) break;  // every key left with this prefix is needed
    if (shift == 32) {
      prefix |= 0xffff0000ull;
      mask |= 0xffff0000ull;
      shift = 8;
    } else {
      shift -= 8;
    }
  }

  // Compact the k selected keys (in no order) into cand by warp offsets.
  int mine = 0;
#pragma unroll
  for (int p = 0; p < KPT; ++p)
    mine += p * nt + tid < n && (key[p] & mask) >= prefix;
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  int warp_base = 0;
  if (lane == 31 && incl > 0) warp_base = atomicAdd(&s_fill, incl);
  int pos = __shfl_sync(FULL, warp_base, 31) + incl - mine;
#pragma unroll
  for (int p = 0; p < KPT; ++p)
    if (p * nt + tid < n && (key[p] & mask) >= prefix) cand[pos++] = key[p];
  __syncthreads();

  // Each selected key goes to its rank: the count of selected keys above it.
  for (int c = tid; c < k; c += nt) {
    const unsigned long long me = cand[c];
    int rank = 0;
    for (int j = 0; j < k; ++j) rank += cand[j] > me;
    vals[row * k + rank] = bits_of(static_cast<uint32_t>(me >> 32));
    idx[row * k + rank] = static_cast<int32_t>(~static_cast<uint32_t>(me));
  }
}

}  // namespace

// The bitonic route: npad = n rounded up to a power of two, npad * 8 bytes
// of shared memory at most 232,448 (the wrapper's rule).
DS_EXPORT int topk_bitonic_f32(const float* score, float* vals, int* idx,
                               int R, int n, int npad, int k, void* stream) {
  const int smem = npad * static_cast<int>(sizeof(unsigned long long));
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        reinterpret_cast<const void*>(topk_rows),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err != 0) return err;
  }
  const int threads = npad / 2 < 1024 ? npad / 2 : 1024;
  topk_rows<<<R, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      score, reinterpret_cast<int32_t*>(vals), idx, n, npad, k);
  return static_cast<int>(cudaGetLastError());
}

// The selection route: threads a multiple of 32 with threads * kpt >= n,
// kpt one of 1, 2, 4, 8, 16, k <= 256 (the wrapper's rule).
DS_EXPORT int topk_select_f32(const float* score, float* vals, int* idx,
                              int R, int n, int k, int threads, int kpt,
                              void* stream) {
  auto* v = reinterpret_cast<int32_t*>(vals);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (kpt) {
    case 1: topk_select<1><<<R, threads, 0, st>>>(score, v, idx, n, k); break;
    case 2: topk_select<2><<<R, threads, 0, st>>>(score, v, idx, n, k); break;
    case 4: topk_select<4><<<R, threads, 0, st>>>(score, v, idx, n, k); break;
    case 8: topk_select<8><<<R, threads, 0, st>>>(score, v, idx, n, k); break;
    case 16:
      topk_select<16><<<R, threads, 0, st>>>(score, v, idx, n, k);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
