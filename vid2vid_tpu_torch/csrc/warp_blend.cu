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
// coordinate, all coordinate and weight math in f32.
//
// What bounds it on the H100: memory. Per pixel it reads flow, w, C values
// of raw and four gathered taps of prev per channel (mostly L1/L2 hits for
// small flows) and writes C values, for ~10 flops per channel. At
// 2048x1024 with C = 3 in bf16 that is 12 values a pixel, ~50 MB of
// compulsory traffic, ~15 us at 3.35 TB/s. What the design does about it: one thread per pixel, so the
// flow and weight are read once and reused across channels, the unfused
// warped frame never reaches device memory, and neighbouring threads read
// neighbouring addresses on every stream except the gather.
//
// The backward (v2v_flow_warp_bwd, v2v_warp_blend_bwd; one template
// warp_bwd_kernel<T, BLEND>) replaces the JAX package's hand-written VJP,
// vid2vid_tpu/ops/warp.py::_flow_warp_bwd with _warp_x_cotangent (a
// sort + cumsum segment sum there, because XLA's scatter-add serialises on
// the TPU). It mirrors that VJP's patch formulation exactly: the floor
// clipped to [0, size-2], the fractional weights clipped to [0, 1], and
// JAX's gradient of the clip: 1 inside, 1/2 where a weight sits exactly on
// a bound (every integer sample point, so every zero flow), 0 beyond.
//   d/dimage: the bilinear splat, four f32 atomicAdds per channel into
//             scratch the wrapper zeroes (a scatter: taps of many pixels may
//             meet); the sum order of the atomics varies from run to run.
//   d/dflow:  per pixel, summed over C in registers, no atomics.
//   blend:    d_raw = g * w, d_w = sum_c g * (raw - warped), and the warp's
//             backward of g * (1 - w).
// What bounds it on the H100: memory, as the forward (it reads g, the four
// taps of the image, flow [raw, w] and writes the f32 splat, dflow [d_raw,
// d_w]); the atomics hit L2, mostly without conflict for smooth flows. One
// thread per pixel, looping over C, keeps the flow, weight and the per-pixel
// sums in registers. H and W must be at least 2.

#include "common.cuh"

namespace v2v {
namespace {

constexpr int NTHREADS = 256;

// Sample one channel plane at the bilinear taps of (sx, sy), the
// flow_warp_ref arithmetic: corner indices clamped to the image, fractional
// weights from the unclamped coordinate, all in f32.
struct Taps {
  size_t i00, i01, i10, i11;
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
  return {(size_t)y0c * W + x0c, (size_t)y0c * W + x1c,
          (size_t)y1c * W + x0c, (size_t)y1c * W + x1c, sx - fx, sy - fy};
}

template <typename T>
__device__ __forceinline__ float sample(const T* p, const Taps& t) {
  const float top = to_f(p[t.i00]) * (1.f - t.wx) + to_f(p[t.i01]) * t.wx;
  const float bot = to_f(p[t.i10]) * (1.f - t.wx) + to_f(p[t.i11]) * t.wx;
  return top * (1.f - t.wy) + bot * t.wy;
}

// BLEND: out = raw * w + warp(prev) * (1 - w); otherwise out = warp(prev)
// and raw / weight are not read.
template <typename T, bool BLEND>
__global__ void __launch_bounds__(NTHREADS)
warp_kernel(const T* __restrict__ raw, const T* __restrict__ prev,
            const T* __restrict__ flow, const T* __restrict__ weight,
            T* __restrict__ out, int B, int C, int H, int W) {
  const size_t hw = (size_t)H * W;
  const size_t i = (size_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= (size_t)B * hw) return;
  const int b = (int)(i / hw);
  const size_t pix = i % hw;
  const int y = (int)(pix / W);
  const int x = (int)(pix % W);

  const float sx = (float)x + to_f(flow[((size_t)b * 2 + 0) * hw + pix]);
  const float sy = (float)y + to_f(flow[((size_t)b * 2 + 1) * hw + pix]);
  const Taps taps = bilinear_taps(sx, sy, H, W);
  const float wb = BLEND ? to_f(weight[(size_t)b * hw + pix]) : 0.f;

  for (int ch = 0; ch < C; ++ch) {
    const size_t base = ((size_t)b * C + ch) * hw;
    const float warped = sample(prev + base, taps);
    out[base + pix] = from_f<T>(
        BLEND ? to_f(raw[base + pix]) * wb + warped * (1.f - wb) : warped);
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
  const size_t i00 = (size_t)(int)fy * W + (size_t)(int)fx;
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
// out = warp(prev) (raw, weight, draw, dweight are not touched).
template <typename T, bool BLEND>
__global__ void __launch_bounds__(NTHREADS)
warp_bwd_kernel(const T* __restrict__ raw, const T* __restrict__ prev,
                const T* __restrict__ flow, const T* __restrict__ weight,
                const T* __restrict__ g, T* __restrict__ draw,
                float* __restrict__ dprev, T* __restrict__ dflow,
                T* __restrict__ dweight, int B, int C, int H, int W) {
  const size_t hw = (size_t)H * W;
  const size_t i = (size_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= (size_t)B * hw) return;
  const int b = (int)(i / hw);
  const size_t pix = i % hw;
  const int y = (int)(pix / W);
  const int x = (int)(pix % W);

  const float sx = (float)x + to_f(flow[((size_t)b * 2 + 0) * hw + pix]);
  const float sy = (float)y + to_f(flow[((size_t)b * 2 + 1) * hw + pix]);
  float ux, uy;
  const Taps t = patch_taps(sx, sy, H, W, &ux, &uy);
  const float wx = t.wx, wy = t.wy;
  const float w00 = (1.f - wx) * (1.f - wy), w01 = wx * (1.f - wy);
  const float w10 = (1.f - wx) * wy, w11 = wx * wy;
  const float wb = BLEND ? to_f(weight[(size_t)b * hw + pix]) : 0.f;

  float dwx = 0.f, dwy = 0.f, dw = 0.f;
  for (int ch = 0; ch < C; ++ch) {
    const size_t base = ((size_t)b * C + ch) * hw;
    const T* p = prev + base;
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
    float* d = dprev + base;
    atomicAdd(d + t.i00, gc * w00);
    atomicAdd(d + t.i01, gc * w01);
    atomicAdd(d + t.i10, gc * w10);
    atomicAdd(d + t.i11, gc * w11);
  }
  dflow[((size_t)b * 2 + 0) * hw + pix] = from_f<T>(dwx * clip_grad(ux));
  dflow[((size_t)b * 2 + 1) * hw + pix] = from_f<T>(dwy * clip_grad(uy));
  if (BLEND) dweight[(size_t)b * hw + pix] = from_f<T>(dw);
}

template <typename T, bool BLEND>
void launch_bwd(const void* raw, const void* prev, const void* flow,
                const void* weight, const void* g, void* draw, void* dprev,
                void* dflow, void* dweight, int B, int C, int H, int W,
                cudaStream_t stream) {
  const size_t n = (size_t)B * H * W;
  const unsigned blocks = (unsigned)((n + NTHREADS - 1) / NTHREADS);
  warp_bwd_kernel<T, BLEND><<<blocks, NTHREADS, 0, stream>>>(
      static_cast<const T*>(raw), static_cast<const T*>(prev),
      static_cast<const T*>(flow), static_cast<const T*>(weight),
      static_cast<const T*>(g), static_cast<T*>(draw),
      static_cast<float*>(dprev), static_cast<T*>(dflow),
      static_cast<T*>(dweight), B, C, H, W);
}

template <bool BLEND>
int dispatch_bwd(const void* raw, const void* prev, const void* flow,
                 const void* weight, const void* g, void* draw, void* dprev,
                 void* dflow, void* dweight, int B, int C, int H, int W,
                 int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;  // nothing to launch
  if (dtype == kFloat32) {
    launch_bwd<float, BLEND>(raw, prev, flow, weight, g, draw, dprev, dflow,
                             dweight, B, C, H, W, s);
  } else if (dtype == kBFloat16) {
    launch_bwd<__nv_bfloat16, BLEND>(raw, prev, flow, weight, g, draw, dprev,
                                     dflow, dweight, B, C, H, W, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool BLEND>
void launch(const void* raw, const void* prev, const void* flow,
            const void* weight, void* out, int B, int C, int H, int W,
            cudaStream_t stream) {
  const size_t n = (size_t)B * H * W;
  const unsigned blocks = (unsigned)((n + NTHREADS - 1) / NTHREADS);
  warp_kernel<T, BLEND><<<blocks, NTHREADS, 0, stream>>>(
      static_cast<const T*>(raw), static_cast<const T*>(prev),
      static_cast<const T*>(flow), static_cast<const T*>(weight),
      static_cast<T*>(out), B, C, H, W);
}

template <bool BLEND>
int dispatch(const void* raw, const void* prev, const void* flow,
             const void* weight, void* out, int B, int C, int H, int W,
             int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H * W == 0) return (int)cudaSuccess;  // nothing to launch
  if (dtype == kFloat32) {
    launch<float, BLEND>(raw, prev, flow, weight, out, B, C, H, W, s);
  } else if (dtype == kBFloat16) {
    launch<__nv_bfloat16, BLEND>(raw, prev, flow, weight, out, B, C, H, W, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace v2v

extern "C" int v2v_warp_blend(const void* raw, const void* prev,
                              const void* flow, const void* weight, void* out,
                              int B, int C, int H, int W, int dtype,
                              void* stream) {
  return v2v::dispatch<true>(raw, prev, flow, weight, out, B, C, H, W, dtype,
                             stream);
}

extern "C" int v2v_flow_warp(const void* image, const void* flow, void* out,
                             int B, int C, int H, int W, int dtype,
                             void* stream) {
  return v2v::dispatch<false>(nullptr, image, flow, nullptr, out, B, C, H, W,
                              dtype, stream);
}

// dimage: f32, zeroed by the caller (the splat accumulates into it).
extern "C" int v2v_flow_warp_bwd(const void* image, const void* flow,
                                 const void* g, void* dimage, void* dflow,
                                 int B, int C, int H, int W, int dtype,
                                 void* stream) {
  return v2v::dispatch_bwd<false>(nullptr, image, flow, nullptr, g, nullptr,
                                  dimage, dflow, nullptr, B, C, H, W, dtype,
                                  stream);
}

// dprev: f32, zeroed by the caller; draw, dflow, dweight in the dtype.
extern "C" int v2v_warp_blend_bwd(const void* raw, const void* prev,
                                  const void* flow, const void* weight,
                                  const void* g, void* draw, void* dprev,
                                  void* dflow, void* dweight, int B, int C,
                                  int H, int W, int dtype, void* stream) {
  return v2v::dispatch_bwd<true>(raw, prev, flow, weight, g, draw, dprev,
                                 dflow, dweight, B, C, H, W, dtype, stream);
}
