// Bilinear border warp, fused with the temporal blend or alone, for Hopper
// (sm_90a).
//
// Replaces the forward of vid2vid_tpu/ops/warp.py::flow_warp (a custom_vjp
// in the JAX package, not a Pallas kernel) together with the blend of
// vid2vid_tpu/nn/composite.py::_blend; the reference ran the warp as a CUDA
// op (resample2d). Two entries share one kernel template:
//   v2v_warp_blend:  out = raw * w + bilinear_border(prev, flow) * (1 - w)
//   v2v_flow_warp:   out = bilinear_border(image, flow)
// the second for the unfused callers (FlowNet2's four warps and the
// FlowEstimator confidence, models/flownet2/{flownet2,wrapper}.py).
// prev, raw: (B, C, H, W); flow: (B, 2, H, W), channel 0 = dx in pixels;
// w: (B, 1, H, W). Every output pixel samples prev at (x + dx, y + dy) with
// the floor / clamp semantics of flow_warp_ref (warp.py:57-82): corner
// indices clamped to the image, fractional weights from the unclamped
// coordinate, all coordinate and weight math in f32. A width shard's blend
// (the model axis, parallel/halo.py) takes the whole previous frame,
// (B, C, H, Wp), with raw, flow, w and out at its W columns from column x0
// of the frame: it samples prev at (x0 + x + dx, y + dy), clamped to the
// whole frame's border. x0 = 0 with Wp = W is the unsharded call.
//
// What bounds it on the H100: memory. Per pixel it reads flow, w, C values
// of raw and four gathered taps of prev per channel (mostly L1/L2 hits for
// small flows) and writes C values, for ~10 flops per channel. At
// 2048x1024 with C = 3 in bf16 that is 12 values a pixel, ~50 MB of
// compulsory traffic, ~15 us at 3.35 TB/s; in practice the gathers of
// prev through L1 / L2, which for flows of several pixels touch two
// sectors per pixel and channel. What the design does about it: a thread
// takes two adjacent pixels of one row (`PIX`), so the flow, w, raw and
// out streams move as one 4- (bf16) or 8-byte (f32) load or store per
// thread and channel where W and the pointers allow (a scalar loop
// otherwise) while the registers leave room for the warps that hide the
// gathers; the flow and weight are read once and reused across channels,
// and the unfused warped frame never reaches device memory. The grid is
// columns x rows x batch, so a thread's pixel offsets need no division,
// and they are 32-bit within a channel plane. The gather from prev stays
// four scalar loads per pixel and channel.
//
// The backward (v2v_flow_warp_bwd, v2v_warp_blend_bwd; one template
// warp_bwd_kernel<T, BLEND>) replaces the JAX package's hand-written VJP,
// vid2vid_tpu/ops/warp.py::_flow_warp_bwd with _warp_x_cotangent (a
// sort + cumsum segment sum there, because XLA's scatter-add serialises on
// the TPU). It mirrors that VJP's patch formulation exactly: the floor
// clipped to [0, size-2], the fractional weights clipped to [0, 1], and
// JAX's gradient of the clip: 1 inside, 1/2 where a weight sits exactly on
// a bound (every integer sample point, so every zero flow), 0 beyond.
//   d/dimage: the bilinear splat into an f32 buffer that the entry zeroes
//             (cudaMemsetAsync) and, in bf16, rounds into d/dimage with a
//             second launch (a scatter: taps of many pixels may meet); the
//             sum order of the reductions varies from run to run.
//   d/dflow:  per pixel, summed over C in registers, no atomics.
//   blend:    d_raw = g * w, d_w = sum_c g * (raw - warped), and the warp's
//             backward of g * (1 - w).
// What bounds it on the H100: the f32 reductions of the splat in L2 (4 a
// pixel and channel; the bytes it must move, g, the taps, flow [raw, w] in
// and the splat, dflow [d_raw, d_w] out, take ~4 us at (2, 3, 256, 512)).
// A warp's reductions to neighbouring addresses (smooth flows) coalesce;
// scattered ones (independent flows) each take their own L2 operation.
// One thread per pixel, looping over C, keeps the flow, weight and the
// per-pixel sums in registers; the grid is columns x rows x batch, as the
// forward's, so the indices need no division. A width shard's blend
// backward (v2v_warp_blend_bwd with Wp, x0: the model axis in training)
// takes the whole previous frame (B, C, H, Wp) as the forward does: the
// shard's W columns of raw, flow, w, g, d_raw, d_flow, d_w from the frame's
// column x0, samples at (x0 + x + dx, y + dy) with the floor clipped to
// [0, Wp - 2], and splats d_prev over the whole frame, so the shards'
// d_prev sum to the whole frame's. x0 = 0 with Wp = W is the unsharded
// call, the same instructions. One call of the entry is the
// whole backward (zeroing, kernel, cast): the wrapper makes one ctypes call
// and no other device operation. A splat through a shared-memory tile with
// a halo was tried and was slower on smooth flows; it is not kept. H and W
// must be at least 2.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace v2v {
namespace {

constexpr int NTHREADS = 256;

// Sample one channel plane at the bilinear taps of (sx, sy), the
// flow_warp_ref arithmetic: corner indices clamped to the image, fractional
// weights from the unclamped coordinate, all in f32. The indices are
// offsets in one channel plane (H * W < 2**31).
struct Taps {
  int i00, i01, i10, i11;
  float wx, wy;
};

__device__ __forceinline__ Taps bilinear_taps(float sx, float sy, int H, int W) {
  const float fx = floorf(sx);
  const float fy = floorf(sy);
  // clamp before the int conversion; indices clamp to the same texels
  const int x0 = (int)fminf(fmaxf(fx, -1.f), (float)W);
  const int y0 = (int)fminf(fmaxf(fy, -1.f), (float)H);
  const int x0c = min(max(x0, 0), W - 1);
  const int x1c = min(max(x0 + 1, 0), W - 1);
  const int y0c = min(max(y0, 0), H - 1);
  const int y1c = min(max(y0 + 1, 0), H - 1);
  return {y0c * W + x0c, y0c * W + x1c, y1c * W + x0c, y1c * W + x1c, sx - fx,
          sy - fy};
}

template <typename T>
__device__ __forceinline__ float sample(const T* p, const Taps& t) {
  const float top = to_f(p[t.i00]) * (1.f - t.wx) + to_f(p[t.i01]) * t.wx;
  const float bot = to_f(p[t.i10]) * (1.f - t.wx) + to_f(p[t.i11]) * t.wx;
  return top * (1.f - t.wy) + bot * t.wy;
}

// The adjacent pixels a forward thread takes. Two, not more: the gathers
// from prev bound the kernel, and more pixels per thread hold more taps in
// registers (a bf16 thread of 8 pixels used 128 of them), so fewer warps
// are resident to hide the gathers' latency. chip_smoke.py phase 6 times
// the kernel against grid_sample.
constexpr int PIX = 2;

// n <= PIX values of a row from p as floats: one load of PIX values where
// VEC (p aligned to PIX * sizeof(T), n == PIX), else element by element
// (the values past n are 0).
template <typename T, bool VEC>
__device__ __forceinline__ void load_row(const T* p, int n, float* v) {
  if constexpr (VEC && sizeof(T) == 4) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else if constexpr (VEC) {  // a bf16 is the high half of its float
    const uint32_t q = __ldg(reinterpret_cast<const unsigned int*>(p));
    v[0] = __uint_as_float(q << 16);
    v[1] = __uint_as_float(q & 0xFFFF0000u);
  } else {
#pragma unroll
    for (int e = 0; e < PIX; ++e) v[e] = e < n ? to_f(p[e]) : 0.f;
  }
}

// n <= PIX floats into a row at p in T: one store where VEC, else element
// by element. Rounds as from_f (to nearest even).
template <typename T, bool VEC>
__device__ __forceinline__ void store_row(T* p, int n, const float* v) {
  if constexpr (VEC && sizeof(T) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else if constexpr (VEC) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
#pragma unroll
    for (int e = 0; e < PIX; ++e)
      if (e < n) p[e] = from_f<T>(v[e]);
  }
}

// BLEND: out = raw * w + warp(prev) * (1 - w); otherwise out = warp(prev)
// and raw / weight are not read. Thread (blockIdx.x, threadIdx.x) of block
// row (y = blockIdx.y, b = blockIdx.z) takes the PIX pixels from
// x0 = PIX * (blockIdx.x * blockDim.x + threadIdx.x) of row y.
template <typename T, bool BLEND, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
warp_kernel(const T* __restrict__ raw, const T* __restrict__ prev,
            const T* __restrict__ flow, const T* __restrict__ weight,
            T* __restrict__ out, int C, int H, int W, int Wp, int xs) {
  constexpr int N = PIX;
  const int y = blockIdx.y, b = blockIdx.z;
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * N;
  if (x0 >= W) return;
  const int n = min(N, W - x0);
  const int plane = H * W;
  const int pplane = H * Wp;  // prev's
  const int pix = y * W + x0;  // in a channel plane
  const T* fl = flow + (size_t)b * 2 * plane + pix;
  float fx[N], fy[N], wb[N];
  load_row<T, VEC>(fl, n, fx);
  load_row<T, VEC>(fl + plane, n, fy);
  if constexpr (BLEND) load_row<T, VEC>(weight + (size_t)b * plane + pix, n, wb);
  Taps taps[N];
#pragma unroll
  for (int e = 0; e < N; ++e)
    taps[e] = bilinear_taps((float)(xs + x0 + e) + fx[e], (float)y + fy[e], H, Wp);

  for (int ch = 0; ch < C; ++ch) {
    const size_t base = ((size_t)b * C + ch) * plane;
    const T* p = prev + ((size_t)b * C + ch) * pplane;
    float v[N];
    if constexpr (BLEND) load_row<T, VEC>(raw + base + pix, n, v);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float warped = sample(p, taps[e]);
      if constexpr (BLEND)
        v[e] = v[e] * wb[e] + warped * (1.f - wb[e]);
      else
        v[e] = warped;
    }
    store_row<T, VEC>(out + base + pix, n, v);
  }
}

// The backward's taps: the patch formulation of the JAX VJP. The floor is
// clipped to [0, size-2], so the four taps are always i00 + {0, 1, W, W+1};
// ux, uy are the fractional weights before their clip to [0, 1].
__device__ __forceinline__ Taps patch_taps(float sx, float sy, int H, int W,
                                           float* ux, float* uy) {
  const float fx = fminf(fmaxf(floorf(sx), 0.f), (float)(W - 2));
  const float fy = fminf(fmaxf(floorf(sy), 0.f), (float)(H - 2));
  *ux = sx - fx;
  *uy = sy - fy;
  const int i00 = (int)fy * W + (int)fx;
  return {i00, i00 + 1, i00 + W, i00 + W + 1, fminf(fmaxf(*ux, 0.f), 1.f),
          fminf(fmaxf(*uy, 0.f), 1.f)};
}

// d clip(u, 0, 1) / du as JAX's jnp.clip gives it.
__device__ __forceinline__ float clip_grad(float u) {
  if (u > 0.f && u < 1.f) return 1.f;
  return (u == 0.f || u == 1.f) ? 0.5f : 0.f;
}

// BLEND: the backward of out = raw * w + warp(prev) * (1 - w), writing
// draw, dprev (f32 splat), dflow, dweight; otherwise the backward of
// out = warp(prev) (raw, weight, draw, dweight are not touched). Thread
// (blockIdx.x, threadIdx.x) of block row (y = blockIdx.y, b = blockIdx.z)
// takes pixel x = blockIdx.x * blockDim.x + threadIdx.x of row y.
template <typename T, bool BLEND>
__global__ void __launch_bounds__(NTHREADS)
warp_bwd_kernel(const T* __restrict__ raw, const T* __restrict__ prev,
                const T* __restrict__ flow, const T* __restrict__ weight,
                const T* __restrict__ g, T* __restrict__ draw,
                float* __restrict__ dprev, T* __restrict__ dflow,
                T* __restrict__ dweight, int C, int H, int W, int Wp, int xs) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const int y = blockIdx.y, b = blockIdx.z;
  const int plane = H * W;
  const int pplane = H * Wp;  // prev's and dprev's
  const int pix = y * W + x;  // in a channel plane
  const T* fl = flow + (size_t)b * 2 * plane + pix;
  const float sx = (float)(xs + x) + to_f(fl[0]);
  const float sy = (float)y + to_f(fl[plane]);
  float ux, uy;
  const Taps t = patch_taps(sx, sy, H, Wp, &ux, &uy);
  const float wx = t.wx, wy = t.wy;
  const float w00 = (1.f - wx) * (1.f - wy), w01 = wx * (1.f - wy);
  const float w10 = (1.f - wx) * wy, w11 = wx * wy;
  const float wb = BLEND ? to_f(weight[(size_t)b * plane + pix]) : 0.f;

  float dwx = 0.f, dwy = 0.f, dw = 0.f;
  for (int ch = 0; ch < C; ++ch) {
    const size_t base = ((size_t)b * C + ch) * plane;
    const size_t pbase = ((size_t)b * C + ch) * pplane;
    const T* p = prev + pbase;
    const float v00 = to_f(p[t.i00]), v01 = to_f(p[t.i01]);
    const float v10 = to_f(p[t.i10]), v11 = to_f(p[t.i11]);
    const float top = v00 * (1.f - wx) + v01 * wx;
    const float bot = v10 * (1.f - wx) + v11 * wx;
    float gc = to_f(g[base + pix]);
    if (BLEND) {
      const float warped = top * (1.f - wy) + bot * wy;
      draw[base + pix] = from_f<T>(gc * wb);
      dw += gc * (to_f(raw[base + pix]) - warped);
      gc *= 1.f - wb;  // the cotangent of the warp
    }
    dwx += gc * ((v01 - v00) * (1.f - wy) + (v11 - v10) * wy);
    dwy += gc * (bot - top);
    float* d = dprev + pbase;
    atomicAdd(d + t.i00, gc * w00);
    atomicAdd(d + t.i01, gc * w01);
    atomicAdd(d + t.i10, gc * w10);
    atomicAdd(d + t.i11, gc * w11);
  }
  T* df = dflow + (size_t)b * 2 * plane + pix;
  df[0] = from_f<T>(dwx * clip_grad(ux));
  df[plane] = from_f<T>(dwy * clip_grad(uy));
  if (BLEND) dweight[(size_t)b * plane + pix] = from_f<T>(dw);
}

// out = the f32 splat rounded to bf16 (to nearest even), n elements; two a
// thread where n is even (the tensors are aligned to 4 bytes at least).
__global__ void __launch_bounds__(NTHREADS)
splat_to_bf16_kernel(const float* __restrict__ splat, __nv_bfloat16* __restrict__ out,
                     size_t n) {
  const size_t i = (size_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (n % 2 == 0) {
    if (2 * i < n) {
      const float2 v = reinterpret_cast<const float2*>(splat)[i];
      reinterpret_cast<__nv_bfloat162*>(out)[i] = __floats2bfloat162_rn(v.x, v.y);
    }
  } else if (i < n) {
    out[i] = __float2bfloat16(splat[i]);
  }
}

// One backward call: zero the f32 splat (the whole (B, C, H, Wp) frame) on
// the stream, run the kernel on a grid of the shard's columns x rows x
// batch (as the forward's), and, in bf16, round the splat into dprev_out;
// in f32 the splat is dprev_out itself.
template <typename T, bool BLEND>
int launch_bwd(const void* raw, const void* prev, const void* flow,
               const void* weight, const void* g, void* draw, void* dprev_out,
               void* splat, void* dflow, void* dweight, int B, int C, int H, int W,
               int Wp, int xs, cudaStream_t stream) {
  const size_t n = (size_t)B * C * H * Wp;
  cudaError_t err = cudaMemsetAsync(splat, 0, n * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  const int threads = std::min(NTHREADS, (W + 31) / 32 * 32);
  const dim3 grid((W + threads - 1) / threads, H, B);
  warp_bwd_kernel<T, BLEND><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(raw), static_cast<const T*>(prev),
      static_cast<const T*>(flow), static_cast<const T*>(weight),
      static_cast<const T*>(g), static_cast<T*>(draw),
      static_cast<float*>(splat), static_cast<T*>(dflow),
      static_cast<T*>(dweight), C, H, W, Wp, xs);
  if (sizeof(T) == 2 && n > 0) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t work = n % 2 == 0 ? n / 2 : n;
    splat_to_bf16_kernel<<<(unsigned)((work + NTHREADS - 1) / NTHREADS), NTHREADS, 0,
                           stream>>>(static_cast<const float*>(splat),
                                     static_cast<__nv_bfloat16*>(dprev_out), n);
  }
  return (int)cudaGetLastError();
}

template <bool BLEND>
int dispatch_bwd(const void* raw, const void* prev, const void* flow,
                 const void* weight, const void* g, void* draw, void* dprev_out,
                 void* splat, void* dflow, void* dweight, int B, int C, int H,
                 int W, int Wp, int xs, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H < 2 || Wp < 2 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  if (W < 1 || xs < 0 || xs + W > Wp) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;  // nothing to launch
  if (dtype == kFloat32) {
    if (splat != dprev_out) return (int)cudaErrorInvalidValue;
    return launch_bwd<float, BLEND>(raw, prev, flow, weight, g, draw, dprev_out,
                                    splat, dflow, dweight, B, C, H, W, Wp, xs, s);
  }
  if (dtype == kBFloat16)
    return launch_bwd<__nv_bfloat16, BLEND>(raw, prev, flow, weight, g, draw,
                                            dprev_out, splat, dflow, dweight, B, C,
                                            H, W, Wp, xs, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks of up to NTHREADS threads along a row (a warp at least), one grid
// row per image row and batch entry. The vector path where every thread's
// pixels are aligned: W a multiple of PIX and aligned pointers.
template <typename T, bool BLEND>
void launch(const void* raw, const void* prev, const void* flow,
            const void* weight, void* out, int B, int C, int H, int W, int Wp,
            int xs, cudaStream_t stream) {
  constexpr int N = PIX;
  const int per_row = (W + N - 1) / N;
  const int threads = std::min(NTHREADS, (per_row + 31) / 32 * 32);
  const dim3 grid((per_row + threads - 1) / threads, H, B);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % (N * sizeof(T)) == 0;
  };
  const bool vec = W % N == 0 && aligned(prev) && aligned(flow) && aligned(out) &&
                   (!BLEND || (aligned(raw) && aligned(weight)));
  const auto kernel = vec ? warp_kernel<T, BLEND, true> : warp_kernel<T, BLEND, false>;
  kernel<<<grid, threads, 0, stream>>>(
      static_cast<const T*>(raw), static_cast<const T*>(prev),
      static_cast<const T*>(flow), static_cast<const T*>(weight),
      static_cast<T*>(out), C, H, W, Wp, xs);
}

template <bool BLEND>
int dispatch(const void* raw, const void* prev, const void* flow,
             const void* weight, void* out, int B, int C, int H, int W, int Wp,
             int xs, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H * W == 0) return (int)cudaSuccess;  // nothing to launch
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;  // grid y, z
  if (xs < 0 || xs + W > Wp) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    launch<float, BLEND>(raw, prev, flow, weight, out, B, C, H, W, Wp, xs, s);
  } else if (dtype == kBFloat16) {
    launch<__nv_bfloat16, BLEND>(raw, prev, flow, weight, out, B, C, H, W, Wp,
                                 xs, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace v2v

// prev: (B, C, H, Wp), the whole frame; raw, flow, weight, out: W columns
// from the frame's column x0 (the unsharded call: Wp = W, x0 = 0).
extern "C" int v2v_warp_blend(const void* raw, const void* prev,
                              const void* flow, const void* weight, void* out,
                              int B, int C, int H, int W, int Wp, int x0,
                              int dtype, void* stream) {
  return v2v::dispatch<true>(raw, prev, flow, weight, out, B, C, H, W, Wp, x0,
                             dtype, stream);
}

extern "C" int v2v_flow_warp(const void* image, const void* flow, void* out,
                             int B, int C, int H, int W, int dtype,
                             void* stream) {
  return v2v::dispatch<false>(nullptr, image, flow, nullptr, out, B, C, H, W,
                              W, 0, dtype, stream);
}

// dimage in the dtype; splat: f32 scratch of the same shape, which the
// entry zeroes and accumulates into (in f32 it must be dimage itself).
extern "C" int v2v_flow_warp_bwd(const void* image, const void* flow,
                                 const void* g, void* dimage, void* splat,
                                 void* dflow, int B, int C, int H, int W,
                                 int dtype, void* stream) {
  return v2v::dispatch_bwd<false>(nullptr, image, flow, nullptr, g, nullptr,
                                  dimage, splat, dflow, nullptr, B, C, H, W, W,
                                  0, dtype, stream);
}

// prev, dprev, splat: (B, C, H, Wp), the whole frame; raw, flow, weight, g,
// draw, dflow, dweight: W columns from the frame's column x0 (the unsharded
// call: Wp = W, x0 = 0). draw, dprev, dflow, dweight in the dtype; splat
// as v2v_flow_warp_bwd's.
extern "C" int v2v_warp_blend_bwd(const void* raw, const void* prev,
                                  const void* flow, const void* weight,
                                  const void* g, void* draw, void* dprev,
                                  void* splat, void* dflow, void* dweight,
                                  int B, int C, int H, int W, int Wp, int x0,
                                  int dtype, void* stream) {
  return v2v::dispatch_bwd<true>(raw, prev, flow, weight, g, draw, dprev, splat,
                                 dflow, dweight, B, C, H, W, Wp, x0, dtype,
                                 stream);
}
