// Shared helpers for the port's CUDA kernels (one shared library per .cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Each library exports this so its Python wrapper can word a CUDA error.
extern "C" const char* rnnt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Load a weight element as float.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round a float to the weight type (round to nearest even), and back.
template <typename W>
__device__ __forceinline__ W from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename W>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<W>(v));
}

// The error of the launch just made, or of an earlier asynchronous one.
static inline int launch_status(cudaError_t launch) {
  if (launch != cudaSuccess) return static_cast<int>(launch);
  return static_cast<int>(cudaGetLastError());
}
