// Shared helpers for the port's kernels: a C entry point returns the CUDA
// error of its launch (0 when none), and the Python wrapper raises on it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define DS_EXPORT extern "C" __attribute__((visibility("default")))

DS_EXPORT const char* ds_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
