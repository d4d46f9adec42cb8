// Shared helpers for the port's CUDA kernels: float <-> storage-type
// conversion, the dtype codes the C entry points take, and the reflect
// index and column-halo columns of the conv bodies.
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

// The columns of a conv launch in the column-halo mode of a width shard
// (vid2vid_tpu_torch/parallel/halo.py): output column x reads input column
// x + xoff (plus the tap's offset), the input rows hold w_in columns, the
// output rows ldo; a reflect pad reflects only on the sides that `edges`
// marks as the image's edges (kLeftEdge, kRightEdge), and reads the
// neighbour's columns that the input carries elsewhere.
struct Cols {
  int xoff, w_in, ldo, edges;
};
constexpr int kLeftEdge = 1, kRightEdge = 2;

// The unsharded call's columns: input rows of w_in, output rows of W.
inline Cols whole(int W, int w_in) { return {0, w_in, W, kLeftEdge | kRightEdge}; }

// The input column of the reflect pad's local column i of an output row of
// W columns: reflect_clamp(i, W) on the image's edges, the halo elsewhere,
// clamped into the input row (only lanes of masked outputs land outside).
__device__ __forceinline__ int reflect_col(int i, int W, const Cols& c) {
  i = (c.edges & kLeftEdge) && i < 0 ? -i : i;
  i = (c.edges & kRightEdge) && i >= W ? 2 * W - 2 - i : i;
  return min(max(i + c.xoff, 0), c.w_in - 1);
}

}  // namespace v2v
