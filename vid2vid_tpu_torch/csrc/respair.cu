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
//
// A width shard's block (the model axis, parallel/halo.py) runs the same
// two launches in the body's column-halo mode: x with two neighbour
// columns on each inner side, h computed wider there (9 columns more on an
// inner left side, 1 on an inner right: within the 64-column tile at the
// flagship's 32-column trunk on two ranks, a ninth tile at 512 columns),
// so one exchange of x serves both convs.

#include "conv_wgmma.cuh"

// The residual block: x -> h -> out. x (B, C, H, W) is the residual; the
// first conv reads x_in, whose rows are w_in long with x's column j at
// x_in column j + xoff (the unsharded call: x_in = x, xoff 0, w_in W).
// `edges` marks the sides that are the image's (common.cuh::Cols): there
// both convs reflect; on a width shard's inner side x_in carries 2 columns
// of the neighbour, h is computed beyond x there, and the second conv
// reads h's column next to x, so both launches read columns of the
// neighbour and no second exchange is needed. On the right h takes one
// more column; on the left kLeftH = 8 (only the last is read): the tensor
// maps stage from 16-byte aligned columns (conv_wgmma.cuh::staging_bytes),
// so each launch's input column of its output column 0 is a multiple of 8
// (x_in from xoff = 8, h from column 8). h is caller-allocated scratch of
// (B, C, H, ldh), ldh >= W + its extra columns (the unsharded call: x's
// shape, ldh W). k0, k1: the packed layout of ops/conv3.py::
// pack_conv3_weight (bf16) or ops/conv7.py::pack_taps_3xtf32 (f32).
extern "C" int v2v_respair(const void* x, const void* x_in, int xoff, int w_in,
                           int edges, const void* k0, const float* a0,
                           const float* c0, const void* k1, const float* a1,
                           const float* c1, void* h, int ldh, void* out, int B,
                           int C, int H, int W, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // h's extra columns on the inner sides
  constexpr int kLeftH = 8;
  const int hl = edges & v2v::kLeftEdge ? 0 : kLeftH;
  const int hr = edges & v2v::kRightEdge ? 0 : 1;
  const v2v::Cols first{xoff - hl, w_in, ldh, edges};
  const v2v::Cols second{hl, ldh, W, edges};
  const int wh = W + hl + hr;
  if (dtype == v2v::kBFloat16) {
    const int err = v2v::cw::conv3<false, true>(x_in, k0, a0, c0, nullptr, h, B,
                                                C, C, H, wh, first, 1, s);
    if (err != 0) return err;
    return v2v::cw::conv3<false, true>(h, k1, a1, c1, x, out, B, C, C, H, W,
                                       second, 0, s);
  }
  if (dtype != v2v::kFloat32) return (int)cudaErrorInvalidValue;
  const int err = v2v::cw::conv3_tf32x3(true, x_in, k0, a0, c0, nullptr, h, B,
                                        C, C, H, wh, first, 1, s);
  if (err != 0) return err;
  return v2v::cw::conv3_tf32x3(true, h, k1, a1, c1, x, out, B, C, C, H, W,
                               second, 0, s);
}
