// The eval-mode residual block ("respair") for Hopper (sm_90a).
//
// Replaces vid2vid_tpu/ops/respair_pallas.py::_respair_kernel (reached via
// respair_pallas): one residual block
//     h   = relu(conv3x3(reflect_pad(x, 1)) * a0 + c0)
//     out = x + conv3x3(reflect_pad(h, 1)) * a1 + c1
// with the conv bias and the eval-mode norm folded into (a, c) per channel.
//
// respair = two launches of a 3x3 conv with the reflect pad folded into the
// load addressing (so no padded copy of x or h is made) and the
// scale/offset/residual/ReLU epilogue on the f32 accumulator: x -> h (ReLU,
// no residual; h stored in the data type, as the TPU kernel stores h_ref),
// then h -> out (residual x, no ReLU). Reflecting h in the second launch's
// addressing reproduces the TPU kernel's in-VMEM edge fix
// (respair_pallas.py:113-130) exactly. Both launches run conv_wgmma.cuh on
// the tensor cores, with k0 and k1 packed by the caller: in bf16
// (ops/conv3.py::pack_conv3_weight), and in f32 as 3xTF32
// (ops/conv7.py::pack_taps_3xtf32: each weight split into two tf32 parts,
// big and small, the input split the same way in the kernel, three tf32
// products per tap; f32-class products, where one TF32 pass would keep 10
// mantissa bits). The f32 CUDA-core body (conv_kxk.cuh), which respair ran
// until then, lost to the tensor cores by 2.9-4x at every respair shape of
// the single-image paths in a same-run A/B (PERF.md), so its 3x3 went.
//
// What bounds it on the H100: the work is 36 * C^2 FLOP per pixel (~2.6
// TFLOP per 2048x1024 frame in bf16, 2.64 ms at the tensor cores' 989
// TFLOP/s; in f32 the three tf32 passes run at a third of 495 TFLOP/s, the
// FFMA rate of the CUDA cores being 67). The bytes (x, h twice, out) come
// within a factor of two of that only at C = 32 and 64. In practice the L2
// bounds the 2048-pixel scales (every block re-reads the weights of its
// output channels and the input rows of its pixels), the fixed cost of
// each block the large images with few channels, and, in f32, the shared
// memory that every k8 product reads (A and B) at N <= 64. What the design
// does about it: an implicit GEMM on wgmma (conv_wgmma.cuh) fed by a
// producer warpgroup: the input staged chunks ahead by tensor-map loads,
// transposed (and in f32 split) into a channel-interleaved tile so the
// nine taps are nine descriptors into one stage, the packed weights one
// tensor-map load per stage (multicast to pairs of blocks from C = 128),
// and tiles chosen for the L2 traffic they cause.
//
// The TPU kernel keeps h on chip. Here h makes one round trip through
// device memory: at C = 1024 a halo tile of h over all channels does not
// fit in 227 KB of shared memory. A single-pass kernel that keeps h on
// chip (split over channels with a cluster, or recomputed halos) is later
// perf work (ROADMAP).
//
// Unlike the TPU kernel, any C, H >= 2 and W >= 2 are taken: ragged tiles
// are masked, so no C % 128 or block-divisibility rule carries over.

#include "conv_wgmma.cuh"

// The residual block: x -> h -> out. h is caller-allocated scratch of x's
// shape and dtype. k0, k1: the packed layout of ops/conv3.py::
// pack_conv3_weight (bf16) or ops/conv7.py::pack_taps_3xtf32 (f32).
extern "C" int v2v_respair(const void* x, const void* k0, const float* a0,
                           const float* c0, const void* k1, const float* a1,
                           const float* c1, void* h, void* out, int B, int C,
                           int H, int W, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == v2v::kBFloat16) {
    const int err = v2v::cw::conv3<false, true>(x, k0, a0, c0, nullptr, h, B,
                                                C, C, H, W, 1, s);
    if (err != 0) return err;
    return v2v::cw::conv3<false, true>(h, k1, a1, c1, x, out, B, C, C, H, W,
                                       0, s);
  }
  if (dtype != v2v::kFloat32) return (int)cudaErrorInvalidValue;
  const int err = v2v::cw::conv3_tf32x3(true, x, k0, a0, c0, nullptr, h, B, C,
                                        C, H, W, 1, s);
  if (err != 0) return err;
  return v2v::cw::conv3_tf32x3(true, h, k1, a1, c1, x, out, B, C, C, H, W, 0,
                               s);
}
