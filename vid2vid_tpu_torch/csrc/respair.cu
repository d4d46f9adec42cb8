// The eval-mode residual block ("respair") for Hopper (sm_90a).
//
// Replaces vid2vid_tpu/ops/respair_pallas.py::_respair_kernel (reached via
// respair_pallas): one residual block
//     h   = relu(conv3x3(reflect_pad(x, 1)) * a0 + c0)
//     out = x + conv3x3(reflect_pad(h, 1)) * a1 + c1
// with the conv bias and the eval-mode norm folded into (a, c) per channel.
//
// respair = two launches of conv_kxk.cuh's conv3x3_kernel<T, TCO, true> (the
// 3x3 conv with the reflect pad folded into the load addressing, so no
// padded copy of x or h is made, and the scale/offset/residual/ReLU
// epilogue on the f32 accumulator): x -> h (ReLU, no residual; h stored in
// T, as the TPU kernel stores h_ref in the data type), then h -> out
// (residual x, no ReLU). Reflecting h in the second launch's addressing
// reproduces the TPU kernel's in-VMEM edge fix (respair_pallas.py:113-130)
// exactly.
//
// What bounds it on the H100: at the main path's shapes (C = 32..1024,
// 2048..524288 pixels) the block is compute-bound: 18 FLOP per multiply-add
// tap against one load of each input and weight element, ~2.6 TFLOP per
// 2048x1024 frame. This first version runs the products on the CUDA cores
// (67 TFLOP/s f32 peak), not the tensor cores, so it sits far below the
// card's bf16 peak; wgmma with TMA-fed tiles is later work (ROADMAP).
// What the design does about it: the template's shared-memory halo and
// weight slabs with an 8-channel x 4-pixel f32 register accumulator per
// thread, and the grid split over output-channel blocks of 32.
//
// The TPU kernel keeps h on chip. Here h makes one round trip through
// device memory: at C = 1024 a halo tile of h over all channels does not
// fit in 227 KB of shared memory. A single-pass kernel that keeps h on
// chip (split over channels with a cluster, or recomputed halos) is later
// perf work (ROADMAP).
//
// Unlike the TPU kernel, any C, H >= 2 and W >= 2 are taken: ragged tiles
// are masked, so no C % 128 or block-divisibility rule carries over.

#include "conv_kxk.cuh"

// The residual block: x -> h -> out. h is caller-allocated scratch of x's
// shape and dtype.
extern "C" int v2v_respair(const void* x, const void* k0, const float* a0,
                           const float* c0, const void* k1, const float* a1,
                           const float* c1, void* h, void* out, int B, int C,
                           int H, int W, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = v2v::conv<3, true>(x, k0, a0, c0, nullptr, h, B, C, C, H, W, 1,
                               dtype, s);
  if (err != 0) return err;
  return v2v::conv<3, true>(h, k1, a1, c1, x, out, B, C, C, H, W, 0, dtype, s);
}
