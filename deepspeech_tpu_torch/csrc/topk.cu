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
// Design: the float's bits map to the monotone int32 key of the TPU kernel,
// u ^ (0x7fffffff & (u >> 31)), moved to unsigned order; the row becomes
// 64-bit composite keys, the key in the high word and ~index in the low word,
// so every key is distinct and "descending composite" is "descending key,
// then ascending index". The row is padded to a power of two npad in shared
// memory and sorted by a bitonic network (log2(npad) (log2(npad) + 1) / 2
// stages of npad / 2 compare-exchanges, one __syncthreads each); the first k
// are written back, the value rebuilt from the key (the map is self-inverse)
// and stored as raw bits. Padding is the composite key 0, below every real
// key: the TPU kernel pads with -inf at indices past the row, which a real
// -inf outranks but a negative NaN does not, so rows with negative NaNs among
// their top k differ there from lax.top_k; here they do not.
//
// Bound on the H100 at the beam's shapes (R 20 rows, n = K (C + 1)): the
// function reads R n 4 bytes and writes R k 8 bytes, 26 KB at width 10 and
// 338 KB at width 128, 8-101 ns at 3.35 TB/s. The network does ~npad log2^2
// (npad) / 4 compares a row, far below any compute bound; what bounds this
// design is its chain of 45 (npad 512) to 78 (npad 4,096) block-wide
// barriers with a shared-memory round trip each, on R of the 132 SMs. A
// selection instead of a full sort (radix select, warp-level merges) is the
// way under that.
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

// score (R, n) f32 -> vals (R, k) f32 (written as int32 bits), idx (R, k)
// int32; grid (R), block min(npad / 2, 1024), dynamic shared memory npad * 8.
__global__ void topk_rows(const float* __restrict__ score,
                          int32_t* __restrict__ vals,
                          int32_t* __restrict__ idx, int n, int npad, int k) {
  extern __shared__ unsigned long long keys[];
  const size_t row = blockIdx.x;
  const float* s = score + row * n;
  for (int i = threadIdx.x; i < npad; i += blockDim.x)
    keys[i] = i < n ? (static_cast<unsigned long long>(ordered_bits(s[i]))
                       << 32) | static_cast<uint32_t>(~i)
                    : 0ull;
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

}  // namespace

DS_EXPORT int topk_f32(const float* score, float* vals, int* idx, int R,
                       int n, int npad, int k, void* stream) {
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
