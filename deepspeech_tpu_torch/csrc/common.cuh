// Shared helpers for the port's kernels: a C entry point returns the CUDA
// error of its launch (0 when none), and the Python wrapper raises on it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define DS_EXPORT extern "C" __attribute__((visibility("default")))

DS_EXPORT const char* ds_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float ds_to_float(float v) { return v; }
__device__ __forceinline__ float ds_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// An f32 value stored in the operand type T (round to nearest even).
template <typename T>
__device__ __forceinline__ T ds_from_float(float v);
template <>
__device__ __forceinline__ float ds_from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 ds_from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round an f32 value to the operand type T and back (identity for float).
template <typename T>
__device__ __forceinline__ float ds_round_to(float v);
template <>
__device__ __forceinline__ float ds_round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float ds_round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
