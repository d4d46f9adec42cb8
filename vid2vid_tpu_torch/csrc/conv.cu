// Stride-1 7x7 and 3x3 convolutions with a fused epilogue, for Hopper
// (sm_90a): the entries of conv_kxk.cuh's conv body, conv_kxk<T, K, TCO,
// REFLECT>, that the Pallas conv kernels map to.
//
// Replaces three TPU kernels:
//   - vid2vid_tpu/ops/conv7_pallas.py::_conv_kernel (reached via
//     conv7_pallas_padded / conv7_reflect): a VALID 7x7 conv of a pre-padded
//     input, f32 accumulation; here also with the reflect pad folded in and
//     a bias epilogue (v2v_conv7);
//   - vid2vid_tpu/ops/conv3_pallas.py::_conv3_kernel (conv3_pallas_padded /
//     conv3_padded): a VALID 3x3 conv of a pre-padded input (v2v_conv3, the
//     no-epilogue entry of the K = 3 template);
//   - vid2vid_tpu/ops/conv3_pallas.py::_conv3_fused_kernel
//     (conv3_fused_padded): the same conv, then
//     `* scale + offset [+ residual] [ReLU]` on the f32 accumulator
//     (v2v_conv3_fused).
//
// What bounds it on the H100: the 7x7 stems and heads of the single-image
// nets are compute-bound: 98*Ci*Co FLOP per output pixel against one read
// of each input and output element (a 31->64 stem at 512x512 is 51 GFLOP
// for 40 MB), and so are the 3x3 convs of the residual blocks at
// 18*Ci*Co FLOP per pixel. This first version runs the products on the
// CUDA cores (67 TFLOP/s f32 peak), not the tensor cores, so it sits far
// below the bf16 peak; wgmma with TMA-fed tiles is later work (ROADMAP).
// What the design does about it: the register-blocked shared-memory tiles
// of conv_kxk.cuh, with an output-channel tile sized to Co so the Co = 3
// and 16 heads do not idle most lanes.
//
// Unlike the Pallas kernels, any Ci, Co, H and W are taken, so no Ci % 128,
// Co % 128 or block-divisibility rule carries over.

#include "conv_kxk.cuh"

// 7x7 conv with an optional bias (f32, nullable) -> (B, Co, H, W). reflect:
// x is (B, Ci, H, W) and reflect-padded by 3 in the addressing; else x is
// pre-padded, (B, Ci, H+6, W+6).
extern "C" int v2v_conv7(const void* x, const void* w, const float* bias,
                         void* out, int B, int Ci, int Co, int H, int W,
                         int reflect, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reflect)
    return v2v::conv<7, true>(x, w, nullptr, bias, nullptr, out, B, Ci, Co, H,
                              W, 0, dtype, s);
  return v2v::conv<7, false>(x, w, nullptr, bias, nullptr, out, B, Ci, Co, H,
                             W, 0, dtype, s);
}

// VALID 3x3 conv of a pre-padded (B, Ci, H+2, W+2) input -> (B, Co, H, W).
extern "C" int v2v_conv3(const void* xp, const void* w, void* out, int B,
                         int Ci, int Co, int H, int W, int dtype,
                         void* stream) {
  return v2v::conv<3, false>(xp, w, nullptr, nullptr, nullptr, out, B, Ci, Co,
                             H, W, 0, dtype, static_cast<cudaStream_t>(stream));
}

// The same conv, then * scale + offset (f32, (Co,)) [+ residual (B, Co, H,
// W), nullable] [ReLU].
extern "C" int v2v_conv3_fused(const void* xp, const void* w,
                               const float* scale, const float* offset,
                               const void* residual, void* out, int B, int Ci,
                               int Co, int H, int W, int relu, int dtype,
                               void* stream) {
  return v2v::conv<3, false>(xp, w, scale, offset, residual, out, B, Ci, Co, H,
                             W, relu, dtype, static_cast<cudaStream_t>(stream));
}
