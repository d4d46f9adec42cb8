// The f32 3x3 launches of the tensor-core body (conv_wgmma.cuh, 3xTF32):
// respair.cu's two f32 launches (reflect) and conv.cu's f32 conv3 /
// conv3_fused entries (pre-padded): every f32 3x3 conv. Their own
// translation unit, so nvcc builds them beside the bf16 instantiations.

#include "conv_wgmma.cuh"

namespace v2v {
namespace cw {

int conv3_tf32x3(bool reflect, const void* in, const void* wpk,
                 const float* scale, const float* offset, const void* residual,
                 void* out, int B, int Ci, int Co, int H, int W, Cols cols,
                 int relu, cudaStream_t stream) {
  return reflect ? conv3<true, true>(in, wpk, scale, offset, residual, out, B,
                                     Ci, Co, H, W, cols, relu, stream)
                 : conv3<true, false>(in, wpk, scale, offset, residual, out, B,
                                      Ci, Co, H, W, cols, relu, stream);
}

}  // namespace cw
}  // namespace v2v
