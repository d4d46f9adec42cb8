// Shared helpers for the port's CUDA kernels: float <-> storage-type
// conversion, the dtype codes the C entry points take, and the reflect
// index of the conv bodies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace v2v {

// dtype codes passed by the Python wrappers (kernels/build.py::DTYPE_CODES)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// the body a 7x7 conv launch runs (ops/conv7.py::TENSOR_CORES,
// CUDA_CORES): bf16 always on the tensor cores; f32 on either, as
// ops/conv7.py::conv7_body picks
enum Body : int { kTensorCores = 1, kCudaCores = 2 };

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// The reflect pad's source index (i < 0 -> -i, i >= n -> 2n-2-i); only
// ragged-tile lanes, whose outputs are masked, land outside and are clamped.
__device__ __forceinline__ int reflect_clamp(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

}  // namespace v2v
