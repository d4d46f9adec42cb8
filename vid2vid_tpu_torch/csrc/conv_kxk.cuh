// The stride-1 KxK convolution with a fused epilogue that the port's conv
// kernels share: respair.cu makes its two launches through it (K = 3,
// reflect), conv.cu its conv7 / conv3 / conv3_fused entries.
//
// One body, conv_kxk<T, K, TCO, REFLECT>, for T = float and bf16, launched
// through conv3x3_kernel<T, TCO, REFLECT, MIN_BLOCKS> or
// conv7x7_kernel<T, TCO, REFLECT>:
//     out[b,co,y,x] = epi( sum_{ci,ky,kx} in[b,ci,y',x'] * w[co,ci,ky,kx] )
//     epi(v) = v * scale[co] + offset[co]  [+ residual[b,co,y,x]]  [ReLU]
// accumulated in f32 (scale, offset optional: 1 and 0). REFLECT reads
// in[refl(y+ky-K/2), refl(x+kx-K/2)] from an unpadded (H, W) input, the
// reflect pad folded into the load addressing (i < 0 -> -i, i >= N ->
// 2N-2-i) so no padded copy is made; otherwise in is pre-padded,
// (H+K-1, W+K-1), and read at (y+ky, x+kx) (VALID).
//
// Each block stages a CI_CHUNK-deep slab of the input halo tile and the
// matching weights in shared memory (as f32), and every thread keeps a
// (TCO / 4)-channel x 4-pixel f32 accumulator in registers, so each shared
// load of an input row feeds K * TCO / 4 FMAs per pixel. The weights are
// staged as [ci * K*K + tap][co] and read as float4 (two per tap at TCO =
// 32): the inner loop issues few shared loads per FMA, which decides the
// speed where few blocks per SM hide latency (the 2048-pixel coarsest
// scale of the residual blocks). The output-channel tile TCO (4, 8, 16 or
// 32) is the smallest that covers Co (up to 32), so a Co = 3 head leaves 1
// of 4 lanes idle instead of 29 of 32; wider convs split over
// output-channel blocks of 32 in the grid (the coarsest scale has only
// 2048 pixels per image: without the split most of the 132 SMs would sit
// idle). K = 7 stages 4 input channels per step (the 49-tap weight slab of
// 32 channels is 25 KB), K = 3 stages 16 and unrolls them by 2.
//
// At K = 3 a grid of more blocks than two per SM launches the instantiation
// built for three resident blocks per SM (MIN_BLOCKS = 3: 80 registers,
// against 125 at MIN_BLOCKS = 1, which fits two): the third block hides
// more latency at the residual blocks' 256x512 and 512x1024 shapes. A
// smaller grid (the 2048-pixel coarsest scale: 128-256 blocks on 132 SMs)
// cannot fill a third and runs faster without the cap. The 7x7 entry
// states no block count: with MIN_BLOCKS = 1 the Co <= 4 heads compile to
// twice the registers and run a third slower.
//
// Any Ci, Co, H and W are taken: ragged tiles are masked. Reflect padding
// needs H, W > K / 2 (the wrappers check).
#pragma once

#include "common.cuh"

namespace v2v {
namespace {

constexpr int TW = 32;        // output tile width
constexpr int TH = 8;         // output tile height
constexpr int NTHREADS = 256;
constexpr int R_PX = 4;       // consecutive pixels per thread
constexpr int PX_GROUPS = TH * TW / R_PX;  // 64 pixel groups per tile
constexpr int CO_GROUPS = NTHREADS / PX_GROUPS;  // 4 channel groups

static_assert(CO_GROUPS * PX_GROUPS == NTHREADS, "thread layout");

template <int K>
struct Tile {
  static constexpr int CI_CHUNK = K == 3 ? 16 : 4;  // input channels per step
  static constexpr int KK = K * K;
  static constexpr int IN_H = TH + K - 1;           // halo tile rows
  static constexpr int IN_W = TW + K - 1;           // halo tile cols
  // an odd row stride makes the 4-row x 8-group warp reads conflict-free
  static constexpr int IN_STRIDE = IN_W | 1;
};

__device__ __forceinline__ int reflect_clamp(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  // only ragged-tile lanes (whose outputs are masked) land outside
  return min(max(i, 0), n - 1);
}

template <typename T, int K, int TCO, bool REFLECT>
__device__ __forceinline__ void conv_kxk(
    const T* __restrict__ in, const T* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ offset,
    const T* __restrict__ residual, T* __restrict__ out, int Ci, int Co,
    int H, int W, int tiles_x, int relu) {
  using TL = Tile<K>;
  constexpr int R_CO = TCO / CO_GROUPS;  // output channels per thread
  constexpr int P = K / 2;
  static_assert(R_CO * CO_GROUPS == TCO, "TCO must be a multiple of 4");
  __shared__ float s_in[TL::CI_CHUNK][TL::IN_H][TL::IN_STRIDE];
  // [ci * K*K + tap][co]; 16-byte rows, read as float4
  __shared__ __align__(16) float s_w[TL::CI_CHUNK * TL::KK][TCO];

  const int tid = threadIdx.x;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int co0 = blockIdx.y * TCO;
  const int b = blockIdx.z;

  const int co_base = (tid / PX_GROUPS) * R_CO;
  const int pg = tid % PX_GROUPS;
  const int row = pg / (TW / R_PX);
  const int col0 = (pg % (TW / R_PX)) * R_PX;

  const int h_in = REFLECT ? H : H + K - 1;
  const int w_in = REFLECT ? W : W + K - 1;
  const size_t hw_in = (size_t)h_in * w_in;
  const T* in_b = in + (size_t)b * Ci * hw_in;

  float acc[R_CO][R_PX];
#pragma unroll
  for (int o = 0; o < R_CO; ++o)
#pragma unroll
    for (int p = 0; p < R_PX; ++p) acc[o][p] = 0.f;

  for (int ci0 = 0; ci0 < Ci; ci0 += TL::CI_CHUNK) {
    // ---- stage the input halo slab
    for (int idx = tid; idx < TL::CI_CHUNK * TL::IN_H * TL::IN_W;
         idx += NTHREADS) {
      const int cl = idx / (TL::IN_H * TL::IN_W);
      const int rem = idx % (TL::IN_H * TL::IN_W);
      const int r = rem / TL::IN_W;
      const int cc = rem % TL::IN_W;
      const int ci = ci0 + cl;
      float v = 0.f;
      if (ci < Ci) {
        int gy, gx;
        if (REFLECT) {
          gy = reflect_clamp(ty0 + r - P, H);
          gx = reflect_clamp(tx0 + cc - P, W);
        } else {
          gy = min(ty0 + r, h_in - 1);
          gx = min(tx0 + cc, w_in - 1);
        }
        v = to_f(in_b[(size_t)ci * hw_in + (size_t)gy * w_in + gx]);
      }
      s_in[cl][r][cc] = v;
    }
    // ---- stage the weights: consecutive threads take consecutive co, so
    // the shared stores are conflict-free
    for (int idx = tid; idx < TCO * TL::CI_CHUNK * TL::KK; idx += NTHREADS) {
      const int col = idx % TCO;
      const int j = idx / TCO;
      const int co = co0 + col;
      const int ci = ci0 + j / TL::KK;
      float v = 0.f;
      if (co < Co && ci < Ci)
        v = to_f(w[((size_t)co * Ci + ci0) * TL::KK + j]);
      s_w[j][col] = v;
    }
    __syncthreads();

    // one staged input channel's taps into the accumulator
    auto accumulate = [&](int cl) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        float v[R_PX + K - 1];
#pragma unroll
        for (int j = 0; j < R_PX + K - 1; ++j)
          v[j] = s_in[cl][row + ky][col0 + j];
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float* wrow = s_w[cl * TL::KK + ky * K + kx] + co_base;
          float wv[R_CO];
          if constexpr (R_CO % 4 == 0) {
#pragma unroll
            for (int q = 0; q < R_CO / 4; ++q) {
              const float4 w4 = reinterpret_cast<const float4*>(wrow)[q];
              wv[4 * q] = w4.x;
              wv[4 * q + 1] = w4.y;
              wv[4 * q + 2] = w4.z;
              wv[4 * q + 3] = w4.w;
            }
          } else {
#pragma unroll
            for (int o = 0; o < R_CO; ++o) wv[o] = wrow[o];
          }
#pragma unroll
          for (int o = 0; o < R_CO; ++o)
#pragma unroll
            for (int p = 0; p < R_PX; ++p)
              acc[o][p] = fmaf(wv[o], v[p + kx], acc[o][p]);
        }
      }
    };
    if constexpr (K == 3) {
#pragma unroll 2
      for (int cl = 0; cl < TL::CI_CHUNK; ++cl) accumulate(cl);
    } else {  // the compiler's own unrolling of the 4 channels
      for (int cl = 0; cl < TL::CI_CHUNK; ++cl) accumulate(cl);
    }
    __syncthreads();
  }

  // ---- epilogue: affine, optional residual, optional ReLU, store in T
  const int y = ty0 + row;
  if (y >= H) return;
#pragma unroll
  for (int o = 0; o < R_CO; ++o) {
    const int co = co0 + co_base + o;
    if (co >= Co) continue;
    const float so = scale != nullptr ? scale[co] : 1.f;
    const float oo = offset != nullptr ? offset[co] : 0.f;
    const size_t base = (((size_t)b * Co + co) * H + y) * W;
#pragma unroll
    for (int p = 0; p < R_PX; ++p) {
      const int x = tx0 + col0 + p;
      if (x >= W) continue;
      float val = fmaf(acc[o][p], so, oo);
      if (residual != nullptr) val += to_f(residual[base + x]);
      if (relu) val = fmaxf(val, 0.f);
      out[base + x] = from_f<T>(val);
    }
  }
}

template <typename T, int TCO, bool REFLECT, int MIN_BLOCKS>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
conv3x3_kernel(const T* in, const T* w, const float* scale,
               const float* offset, const T* residual, T* out, int Ci, int Co,
               int H, int W, int tiles_x, int relu) {
  conv_kxk<T, 3, TCO, REFLECT>(in, w, scale, offset, residual, out, Ci, Co, H,
                               W, tiles_x, relu);
}

template <typename T, int TCO, bool REFLECT>
__global__ void __launch_bounds__(NTHREADS)
conv7x7_kernel(const T* in, const T* w, const float* scale,
               const float* offset, const T* residual, T* out, int Ci, int Co,
               int H, int W, int tiles_x, int relu) {
  conv_kxk<T, 7, TCO, REFLECT>(in, w, scale, offset, residual, out, Ci, Co, H,
                               W, tiles_x, relu);
}

// more blocks than two per SM of the current device
inline bool over_two_per_sm(const dim3& grid) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (long long)grid.x * grid.y * grid.z > 2LL * sms;
}

// the entry that launches a grid (only the K asked for is instantiated)
template <typename T, int K, int TCO, bool REFLECT>
auto pick_kernel(const dim3& grid) {
  static_assert(K == 3 || K == 7, "the entries are 3x3 and 7x7");
  if constexpr (K == 3) {
    return over_two_per_sm(grid) ? conv3x3_kernel<T, TCO, REFLECT, 3>
                                 : conv3x3_kernel<T, TCO, REFLECT, 1>;
  } else {
    return conv7x7_kernel<T, TCO, REFLECT>;
  }
}

template <typename T, int K, int TCO, bool REFLECT>
void launch_tile(const void* in, const void* w, const float* scale,
                 const float* offset, const void* residual, void* out, int B,
                 int Ci, int Co, int H, int W, int relu, cudaStream_t stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, (Co + TCO - 1) / TCO, B);
  const auto kernel = pick_kernel<T, K, TCO, REFLECT>(grid);
  kernel<<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(in), static_cast<const T*>(w), scale, offset,
      static_cast<const T*>(residual), static_cast<T*>(out), Ci, Co, H, W,
      tiles_x, relu);
}

// the smallest output-channel tile that covers Co, up to 32
template <typename T, int K, bool REFLECT>
void launch(const void* in, const void* w, const float* scale,
            const float* offset, const void* residual, void* out, int B,
            int Ci, int Co, int H, int W, int relu, cudaStream_t stream) {
  if (Co <= 4) {
    launch_tile<T, K, 4, REFLECT>(in, w, scale, offset, residual, out, B, Ci,
                                  Co, H, W, relu, stream);
  } else if (Co <= 8) {
    launch_tile<T, K, 8, REFLECT>(in, w, scale, offset, residual, out, B, Ci,
                                  Co, H, W, relu, stream);
  } else if (Co <= 16) {
    launch_tile<T, K, 16, REFLECT>(in, w, scale, offset, residual, out, B, Ci,
                                   Co, H, W, relu, stream);
  } else {
    launch_tile<T, K, 32, REFLECT>(in, w, scale, offset, residual, out, B, Ci,
                                   Co, H, W, relu, stream);
  }
}

// One launch in the storage type named by dtype; returns cudaGetLastError().
template <int K, bool REFLECT>
int conv(const void* in, const void* w, const float* scale,
         const float* offset, const void* residual, void* out, int B, int Ci,
         int Co, int H, int W, int relu, int dtype, cudaStream_t stream) {
  if (dtype == kFloat32) {
    launch<float, K, REFLECT>(in, w, scale, offset, residual, out, B, Ci, Co,
                              H, W, relu, stream);
  } else if (dtype == kBFloat16) {
    launch<__nv_bfloat16, K, REFLECT>(in, w, scale, offset, residual, out, B,
                                      Ci, Co, H, W, relu, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace v2v
