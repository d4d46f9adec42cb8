// Stride-1 7x7 and 3x3 convolutions with a fused epilogue, for Hopper
// (sm_90a): the entries of the port's two conv bodies that the Pallas conv
// kernels map to: conv_wgmma.cuh (tensor cores; every entry in bf16, in
// f32 as 3xTF32) and conv_kxk.cuh (CUDA cores; the f32 7x7 convs where
// ops/conv7.py::conv7_body picks them).
//
// Replaces three TPU kernels:
//   - vid2vid_tpu/ops/conv7_pallas.py::_conv_kernel (reached via
//     conv7_pallas_padded / conv7_reflect): a VALID 7x7 conv of a pre-padded
//     input, f32 accumulation; here also with the reflect pad folded in and
//     a bias epilogue (v2v_conv7);
//   - vid2vid_tpu/ops/conv3_pallas.py::_conv3_kernel (conv3_pallas_padded /
//     conv3_padded): a VALID 3x3 conv of a pre-padded input (v2v_conv3, the
//     no-epilogue entry of the 3x3 bodies);
//   - vid2vid_tpu/ops/conv3_pallas.py::_conv3_fused_kernel
//     (conv3_fused_padded): the same conv, then
//     `* scale + offset [+ residual] [ReLU]` on the f32 accumulator
//     (v2v_conv3_fused).
//
// What bounds it on the H100: the 7x7 stems and heads are compute-bound:
// 98*Ci*Co FLOP per output pixel against one read of each input and output
// element (the composite's 108 -> 32 label stem at 2048x1024 is 710 GFLOP
// for 470 MB), and so are the 3x3 convs of the residual blocks at
// 18*Ci*Co FLOP per pixel. What the design does about it: in bf16 every
// conv is an implicit GEMM on wgmma, fed through a ring of shared-memory
// stages by a producer warpgroup (conv_wgmma.cuh: K*K taps as K*K
// descriptors into one channel-interleaved halo tile, weights packed by
// the caller and fetched by tensor-map loads). In f32 the same body runs
// 3xTF32: the producer splits each staged input value into two tf32 parts
// (big = tf32(x), small = tf32(x - big)), the weights come split by the
// caller (ops/conv7.py::pack_taps_3xtf32), and each tap runs three tf32
// products (small terms first, small x small dropped): f32-class products
// at up to 494 / 3 TFLOP/s, against 67 for FFMA on the CUDA cores. At N <=
// 32 (the 7x7 stems and heads) each k8 product reads its 2 KB A operand
// from shared memory for 4 to 16 tensor-core cycles, so there the shared
// memory bounds it, and the CUDA-core tiles of conv_kxk.cuh (an
// output-channel tile sized to Co, so the Co = 3 heads do not idle most
// lanes) remain for the f32 7x7 convs where ops/conv7.py::conv7_body picks
// them (Co <= 8 or Ci <= 4). The 3x3 convs run on the tensor cores only.
//
// Unlike the Pallas kernels, any Ci, Co, H and W are taken, so no Ci % 128,
// Co % 128 or block-divisibility rule carries over.

#include "conv_kxk.cuh"
#include "conv_wgmma.cuh"

// 7x7 conv with an optional bias (f32, nullable) -> (B, Co, H, W). reflect:
// x is reflect-padded by 3 in the addressing, its rows w_in long, output
// column x at input column x + xoff, the columns reflected only on the
// sides `edges` marks as the image's (common.cuh::Cols; the unsharded call
// is x (B, Ci, H, W): xoff 0, w_in W, edges 3; a width shard's input
// carries 3 or more neighbour columns on an inner side); else x is
// pre-padded, (B, Ci, H+6, W+6), and xoff, w_in, edges are not read. On the tensor cores (every bf16 call; f32
// with body = kTensorCores) it takes wpk, the packed layout of ops/conv7.py::
// pack_conv7_weight (bf16) or pack_taps_3xtf32 (f32), and does not read w;
// on the CUDA cores (f32, body = kCudaCores) w (OIHW).
extern "C" int v2v_conv7(const void* x, const void* w, const void* wpk,
                         const float* bias, void* out, int B, int Ci, int Co,
                         int H, int W, int reflect, int xoff, int w_in,
                         int edges, int dtype, int body, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const v2v::Cols cols =
      reflect ? v2v::Cols{xoff, w_in, W, edges} : v2v::whole(W, W + 6);
  if (body == v2v::kTensorCores) {
    if (wpk == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == v2v::kFloat32)
      return v2v::cw::conv7_tf32x3(reflect, x, wpk, bias, out, B, Ci, Co, H, W,
                                   cols, s);
    return reflect ? v2v::cw::conv7<false, true>(x, wpk, bias, out, B, Ci, Co,
                                                 H, W, cols, s)
                   : v2v::cw::conv7<false, false>(x, wpk, bias, out, B, Ci, Co,
                                                  H, W, cols, s);
  }
  if (body != v2v::kCudaCores || dtype != v2v::kFloat32)
    return (int)cudaErrorInvalidValue;
  if (reflect)
    return v2v::conv<7, true>(x, w, nullptr, bias, nullptr, out, B, Ci, Co, H,
                              W, cols, 0, dtype, s);
  return v2v::conv<7, false>(x, w, nullptr, bias, nullptr, out, B, Ci, Co, H,
                             W, cols, 0, dtype, s);
}

// VALID 3x3 conv of a pre-padded (B, Ci, H+2, W+2) input -> (B, Co, H, W),
// then * scale + offset (f32, (Co,), nullable) [+ residual (B, Co, H, W),
// nullable] [ReLU]. w: the packed layout of ops/conv3.py::pack_conv3_weight
// (bf16) or ops/conv7.py::pack_taps_3xtf32 (f32).
extern "C" int v2v_conv3_fused(const void* xp, const void* w,
                               const float* scale, const float* offset,
                               const void* residual, void* out, int B, int Ci,
                               int Co, int H, int W, int relu, int dtype,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const v2v::Cols cols = v2v::whole(W, W + 2);
  if (dtype == v2v::kFloat32)
    return v2v::cw::conv3_tf32x3(false, xp, w, scale, offset, residual, out, B,
                                 Ci, Co, H, W, cols, relu, s);
  if (dtype != v2v::kBFloat16) return (int)cudaErrorInvalidValue;
  return v2v::cw::conv3<false, false>(xp, w, scale, offset, residual, out, B,
                                      Ci, Co, H, W, cols, relu, s);
}

// The no-epilogue entry.
extern "C" int v2v_conv3(const void* xp, const void* w, void* out, int B,
                         int Ci, int Co, int H, int W, int dtype,
                         void* stream) {
  return v2v_conv3_fused(xp, w, nullptr, nullptr, nullptr, out, B, Ci, Co, H,
                         W, 0, dtype, stream);
}
