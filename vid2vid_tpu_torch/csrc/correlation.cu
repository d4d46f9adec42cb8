// FlowNetC correlation cost volume, for Hopper (sm_90a).
//
// Replaces vid2vid_tpu/ops/correlation_pallas.py::_corr_kernel (and its XLA
// twin correlation.py::correlation_ref, which FlowNetC calls). It computes,
// in FlowNetC's configuration (max displacement 20, stride2 2):
//     out[b, j*21 + i, y, x] = 1/C * sum_c f1[b, c, y, x]
//                                          * f2[b, c, y + 2(j-10), x + 2(i-10)]
// for j, i in [0, 21) (dy-major), with f2 read as zero outside the image.
// f1, f2: (B, C, H, W) f32, contiguous; out: (B, 441, H, W) f32. Any B, C,
// H, W: out-of-image taps read zero in both axes, so no padded copy of f2
// exists and H needs no multiple of 8 (the TPU kernel padded rows and
// masked columns with an iota diagonal; the semantics are the same).
//
// What bounds it on the H100: FMA throughput on the CUDA cores and the
// shared-memory loads that feed them. 441 * C multiply-adds per output
// pixel (7.4 GFLOP at B=2, C=256, 128x256) against ~125 MB of compulsory
// traffic, ~59 FLOP per byte, far above the ridge point.
//
// What the design does about it: a block owns one output row y, a 64-pixel
// x tile and 7 of the 21 vertical displacements (one per warp), and walks
// the channels in chunks of 8. Per chunk it stages f1[chunk, y, tile] and,
// for each of its 7 dy, the f2 row window [x0-20, x0+84) in shared memory,
// split into even and odd columns: a pixel x only ever meets f2 columns of
// its own parity (x + 2*dx), so with the split a thread that owns the two
// same-parity pixels x and x+2 reads 22 consecutive values of one half and
// feeds 42 FMAs (21 dx for each pixel) from them. Lanes of one parity read
// even banks and the other parity sits at an odd offset (53), so the
// shared loads are conflict-free. Global loads and stores run along x.
//
// Later work: the tensor-core form. The Pallas kernel's row-pair product
// m[x, x'] = <f1[:, y, x], f2[:, y+dy, x']> is a banded GEMM (M = x tile,
// N = the x' window, K = C) that fits wgmma; the 21 stride-2 diagonals are
// then pulled from the accumulator.

#include "common.cuh"

namespace v2v {
namespace {

constexpr int RAD = 10;              // displacement radius in stride-2 steps
constexpr int ND = 2 * RAD + 1;      // 21 displacements per axis
constexpr int MD = 20;               // max displacement in pixels
constexpr int TX = 64;               // output pixels per x tile
constexpr int WIN = TX + 2 * MD;     // f2 window per row: 104 columns
constexpr int ODD = WIN / 2 + 1;     // offset of the odd half (53: odd)
constexpr int ROW = 2 * ODD;         // floats per staged (dy, c) f2 row
constexpr int F1ODD = TX / 2 + 1;    // offset of f1's odd half (33)
constexpr int F1ROW = 2 * F1ODD;
constexpr int DYB = 7;               // displacements (warps) per block
constexpr int NTHREADS = DYB * 32;
constexpr int CC = 8;                // channels per staged chunk

__global__ void __launch_bounds__(NTHREADS)
correlation_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   float* __restrict__ out, int C, int H, int W) {
  __shared__ float s2[DYB][CC][ROW];
  __shared__ float s1[CC][F1ROW];

  const int x0 = blockIdx.x * TX;
  const int y = blockIdx.y;
  const int b = blockIdx.z / (ND / DYB);
  const int jb = (blockIdx.z % (ND / DYB)) * DYB;  // first dy index
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = lane & 1;          // parity of this thread's pixels
  const int hb = (lane >> 1) * 2;  // half-index of its first pixel
  const size_t hw = (size_t)H * W;
  const float* f1b = f1 + (size_t)b * C * hw;
  const float* f2b = f2 + (size_t)b * C * hw;

  float acc0[ND], acc1[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc0[i] = acc1[i] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    for (int t = threadIdx.x; t < DYB * CC * WIN; t += NTHREADS) {
      const int p = t % WIN;
      const int cc = (t / WIN) % CC;
      const int dl = t / (WIN * CC);
      const int c = c0 + cc;
      const int yy = y + 2 * (jb + dl - RAD);
      const int xx = x0 - MD + p;
      float v = 0.f;
      if (c < C && yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = f2b[(size_t)c * hw + (size_t)yy * W + xx];
      s2[dl][cc][(p & 1) * ODD + (p >> 1)] = v;
    }
    for (int t = threadIdx.x; t < CC * TX; t += NTHREADS) {
      const int p = t % TX;
      const int c = c0 + t / TX;
      const int xx = x0 + p;
      float v = 0.f;
      if (c < C && xx < W) v = f1b[(size_t)c * hw + (size_t)y * W + xx];
      s1[t / TX][(p & 1) * F1ODD + (p >> 1)] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int cc = 0; cc < CC; ++cc) {
      // pixels x0 + 2*hb + q and x0 + 2*(hb+1) + q; at displacement i they
      // meet window half-columns hb + i and hb + 1 + i
      const float* r2 = &s2[warp][cc][q * ODD + hb];
      const float a0 = s1[cc][q * F1ODD + hb];
      const float a1 = s1[cc][q * F1ODD + hb + 1];
      float w[ND + 1];
#pragma unroll
      for (int k = 0; k <= ND; ++k) w[k] = r2[k];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        acc0[i] = fmaf(a0, w[i], acc0[i]);
        acc1[i] = fmaf(a1, w[i + 1], acc1[i]);
      }
    }
    __syncthreads();
  }

  const float inv_c = 1.f / (float)C;
  const int xa = x0 + 2 * hb + q;
  const int xb = xa + 2;
  float* o = out + ((size_t)b * ND * ND + (size_t)(jb + warp) * ND) * hw +
             (size_t)y * W;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    if (xa < W) o[(size_t)i * hw + xa] = acc0[i] * inv_c;
    if (xb < W) o[(size_t)i * hw + xb] = acc1[i] * inv_c;
  }
}

}  // namespace
}  // namespace v2v

// dtype must be f32 (code 0): the cost volume is taken in f32, as the
// Pallas kernel's preferred_element_type.
extern "C" int v2v_correlation(const void* f1, const void* f2, void* out,
                               int B, int C, int H, int W, int dtype,
                               void* stream) {
  if (dtype != v2v::kFloat32 || C <= 0) return (int)cudaErrorInvalidValue;
  if (B * H * W == 0) return (int)cudaSuccess;  // nothing to launch
  const dim3 grid((W + v2v::TX - 1) / v2v::TX, H, B * (v2v::ND / v2v::DYB));
  v2v::correlation_kernel<<<grid, v2v::NTHREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2),
      static_cast<float*>(out), C, H, W);
  return (int)cudaGetLastError();
}
