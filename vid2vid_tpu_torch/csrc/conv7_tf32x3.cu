// The f32 7x7 launches of the tensor-core body (conv_wgmma.cuh, 3xTF32):
// conv.cu's f32 conv7 entry, reflect or pre-padded, where ops/conv7.py::
// conv7_body picks the tensor cores. Its own translation unit, so nvcc builds
// it beside the bf16 instantiations.

#include "conv_wgmma.cuh"

namespace v2v {
namespace cw {

int conv7_tf32x3(bool reflect, const void* in, const void* wpk,
                 const float* bias, void* out, int B, int Ci, int Co, int H,
                 int W, Cols cols, cudaStream_t stream) {
  return reflect
             ? conv7<true, true>(in, wpk, bias, out, B, Ci, Co, H, W, cols, stream)
             : conv7<true, false>(in, wpk, bias, out, B, Ci, Co, H, W, cols, stream);
}

}  // namespace cw
}  // namespace v2v
