// Bilinear border warp, fused with the temporal blend or alone, for Hopper
// (sm_90a).
//
// Replaces the forward of vid2vid_tpu/ops/warp.py::flow_warp (a custom_vjp
// in the JAX package, not a Pallas kernel) together with the blend of
// vid2vid_tpu/nn/composite.py::_blend; the reference ran the warp as a CUDA
// op (resample2d). Two entries share one kernel template:
//   v2v_warp_blend:   out = raw * w + bilinear_border(prev, flow) * (1 - w)
//   v2v_flow_warp_at: out = bilinear_border(image, flow)
// the second for the unfused callers (FlowNet2's four warps and the
// FlowEstimator confidence, models/flownet2/{flownet2,wrapper}.py, and the
// loss engine's warps). Both take a width shard's column offset (training's
// and serving's model axis); the unsharded call is Wp = W, x0 = 0.
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
// What bounds the forward on the H100: the gathers from prev. Per pixel it
// must read flow, [w, C values of raw,] C values of prev and write C
// values, ~10 flops a channel: at (2, 3, 1024, 2048) f32 that is ~134 MB,
// ~40 us at 3.35 TB/s. A gather per corner and channel from an NCHW plane
// (12 a pixel at C = 3, on C lines a plane apart) goes through L1 / L2 a
// sector at a time, and where neighbouring pixels sample unrelated points
// one warp's gather splits into up to 32 wavefronts. A block that took a
// strip of one row (the layout before this one) found none of the next
// row's corners in its own work. What the design does about it:
//  - A block takes a 2-D tile of the output (the plan's rows x cols, all C
//    channels), a thread PIX adjacent pixels of one row, so flow, w, raw
//    and out move as one 4- to 16-byte load or store a thread and stream
//    where W and the pointers allow (element by element at a ragged edge);
//    the flow and w are read once and reused across channels, and a
//    tile's corners at y0 + 1 are mostly its own.
//  - A direct tile (no budget: 2 pixels a thread) gathers every corner
//    from prev through the read-only path, with no shared memory, no
//    decision and no barrier.
//  - A staged tile (a budget: 4 pixels a thread) reduces its corners to
//    their bounding box in prev (clamped to the frame as the sample
//    clamps), its left edge aligned down and its width rounded up to 16
//    bytes. Where the box's C planes fit the budget, the block copies them
//    in with 16-byte cp.async (element by element where prev's rows are
//    not 16-byte aligned) and gathers every corner from shared memory:
//    each value of prev crosses L2 once a tile. Where the box is over
//    budget (a large or incoherent flow), the block gathers from prev as
//    a direct tile does. The branch is uniform across the block and
//    decided from its own flow. cp.async, not a TMA tensor map: the box's
//    size depends on the data, and a tensor map fixes its box when it is
//    encoded (TMA and a channels-last box were not measured: ROADMAP).
//  - Every path runs the same sample (the same corners, products and sums
//    rounded one by one, in the same order) on the same values, so a
//    pixel's output is the same bit for bit whichever path or tile it
//    takes; x0 = 0 with Wp = W is the unsharded call, the same
//    instructions.
// The plan (tile, budget) is ops/warp.py::warp_forward_plan(C, dtype, H,
// W, Wp), which the wrapper passes to the entry; ops/warp.py::staged_tiles
// mirrors the block's decision over a flow. Measured on an H100
// (vid2vid_tpu_torch/tools/warp_plans.py, chip_ab.py --warp; PERF.md):
// 2-D tiles with rows of 128 bytes beat row strips at every shape but
// the smallest smooth blend (256 x 512 bf16, 2-6% behind); staging pays
// only where prev outgrows L2 (FlowNet2's f32 frames: 2% on FlowNet2's own
// flows, 1-4% on a drawn smooth flow, while it loses 7% on an i.i.d. one)
// and costs elsewhere, since a budget held by every block shrinks L1 and
// the blocks an SM holds, so the plan stages only from STAGE_FROM_BYTES of
// prev an image. The direct and the staged tiles are separate
// instantiations: the staging code in the direct launches cost them up to
// 10% (more registers, fewer blocks an SM). Contracting the rounded
// products into FMAs changed no time by more than 2%. One 4-byte column of
// 4 rows a thread (no bank conflicts in the box) measured slower than rows
// of pixels, and so did 8 bf16 pixels a thread against 2 or 4 (more
// registers, fewer warps).
//
// The backward (v2v_flow_warp_at_bwd, v2v_warp_blend_bwd; one template
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
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace v2v {
namespace {

constexpr int NTHREADS = 256;
// the forward's largest box budget: the 227 KB a block may hold, less 1 KB
// for the kernel's own shared words (ops/warp.py::MAX_BOX_BYTES)
constexpr int MAX_BOX_BYTES = 226 * 1024;

// The backward's taps: offsets in one channel plane (H * W < 2**31) and the
// fractional weights.
struct Taps {
  int i00, i01, i10, i11;
  float wx, wy;
};

// The forward's corners of a bilinear sample at (sx, sy) in an image of H
// rows and W columns, the flow_warp_ref arithmetic: corner indices clamped
// to the image, fractional weights from the unclamped coordinate, all in
// f32.
struct Corners {
  int x0, x1, y0, y1;
  float wx, wy;
};

__device__ __forceinline__ Corners bilinear_corners(float sx, float sy, int H, int W) {
  const float fx = floorf(sx);
  const float fy = floorf(sy);
  // clamp before the int conversion; indices clamp to the same texels
  const int x0 = (int)fminf(fmaxf(fx, -1.f), (float)W);
  const int y0 = (int)fminf(fmaxf(fy, -1.f), (float)H);
  return {min(max(x0, 0), W - 1), min(max(x0 + 1, 0), W - 1),
          min(max(y0, 0), H - 1), min(max(y0 + 1, 0), H - 1), sx - fx, sy - fy};
}

// One value of prev: through the read-only path from device memory (LDG),
// or from the staged box in shared memory.
template <typename T, bool LDG>
__device__ __forceinline__ float fetch(const T* p) {
  if constexpr (LDG)
    return to_f(__ldg(p));
  else
    return to_f(*p);
}

// One channel sampled at the corners, p a plane of rows ld values apart.
template <typename T, bool LDG>
__device__ __forceinline__ float sample(const T* p, int ld, const Corners& t) {
  const T* r0 = p + t.y0 * ld;
  const T* r1 = p + t.y1 * ld;
  // rounded products and sums (no contraction into FMAs), so both paths,
  // and the plain version's order, give the same bits
  const float top = __fadd_rn(__fmul_rn(fetch<T, LDG>(r0 + t.x0), 1.f - t.wx),
                              __fmul_rn(fetch<T, LDG>(r0 + t.x1), t.wx));
  const float bot = __fadd_rn(__fmul_rn(fetch<T, LDG>(r1 + t.x0), 1.f - t.wx),
                              __fmul_rn(fetch<T, LDG>(r1 + t.x1), t.wx));
  return __fadd_rn(__fmul_rn(top, 1.f - t.wy), __fmul_rn(bot, t.wy));
}

// Words of a thread's PIX adjacent values of T: 1, 2 or 4 (4, 8 or 16
// bytes).
template <typename T, int PIX>
constexpr int kWords = PIX * (int)sizeof(T) / 4;

// n <= PIX values of a row from p as floats: one 4-, 8- or 16-byte load
// where VEC (p aligned to PIX values, n == PIX), else element by element
// (the values past n are 0).
template <typename T, int PIX, bool VEC>
__device__ __forceinline__ void load_row(const T* p, int n, float* v) {
  constexpr int NW = kWords<T, PIX>;
  if constexpr (VEC) {
    uint32_t w[NW];
    if constexpr (NW == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
    } else if constexpr (NW == 2) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = q.x, w[1] = q.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if constexpr (sizeof(T) == 4) {
        v[i] = __uint_as_float(w[i]);
      } else {  // a bf16 is the high half of its float
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < PIX; ++e) v[e] = e < n ? to_f(__ldg(p + e)) : 0.f;
  }
}

// n <= PIX floats into a row at p in T: one 4-, 8- or 16-byte store where
// VEC, else element by element. Rounds as from_f (to nearest even).
template <typename T, int PIX, bool VEC>
__device__ __forceinline__ void store_row(T* p, int n, const float* v) {
  constexpr int NW = kWords<T, PIX>;
  if constexpr (VEC) {
    uint32_t w[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(v[i]);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    if constexpr (NW == 4)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else if constexpr (NW == 2)
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<unsigned int*>(p) = w[0];
  } else {
#pragma unroll
    for (int e = 0; e < PIX; ++e)
      if (e < n) p[e] = from_f<T>(v[e]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// The channel loop of one thread's n pixels: every channel sampled at the
// corners from p + ch * pstride (rows ld apart), blended or not, stored.
// LDG: p is prev in device memory, else the box in shared memory.
template <typename T, int PIX, bool BLEND, bool VEC, bool LDG>
__device__ __forceinline__ void blend_channels(const T* raw, const T* p, size_t pstride,
                                               int ld, const Corners* cn, const float* wb,
                                               T* out, size_t plane, int C, int n) {
  for (int ch = 0; ch < C; ++ch) {
    float v[PIX];
    if constexpr (BLEND) load_row<T, PIX, VEC>(raw + ch * plane, n, v);
#pragma unroll
    for (int e = 0; e < PIX; ++e) {
      if (e >= n) break;
      const float warped = sample<T, LDG>(p + ch * pstride, ld, cn[e]);
      if constexpr (BLEND)
        v[e] = __fadd_rn(__fmul_rn(v[e], wb[e]), __fmul_rn(warped, 1.f - wb[e]));
      else
        v[e] = warped;
    }
    store_row<T, PIX, VEC>(out + ch * plane, n, v);
  }
}

// BLEND: out = raw * w + warp(prev) * (1 - w); otherwise out = warp(prev)
// and raw / weight are not read. Block (blockIdx.x, blockIdx.y) of image
// b = blockIdx.z takes the tile of blockDim.y rows and blockDim.x * PIX
// columns at (blockIdx.y * blockDim.y, blockIdx.x * blockDim.x * PIX);
// thread (threadIdx.x, threadIdx.y) the PIX pixels from column
// threadIdx.x * PIX of its row threadIdx.y. STAGED (a staged tile takes 4
// pixels a thread, a direct one 2): the box is staged when its C planes
// take at most `budget` bytes (the dynamic shared memory of the launch),
// and `staged`, if not null, counts the blocks that staged it; otherwise
// every tile gathers, with no decision and no barrier.
template <typename T, bool BLEND, bool VEC, bool STAGED>
__global__ void __launch_bounds__(NTHREADS)
warp_kernel(const T* __restrict__ raw, const T* __restrict__ prev,
            const T* __restrict__ flow, const T* __restrict__ weight,
            T* __restrict__ out, int C, int H, int W, int Wp, int xs, int budget,
            int* __restrict__ staged) {
  constexpr int PIX = STAGED ? 4 : 2;
  const int b = blockIdx.z;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = (blockIdx.x * blockDim.x + threadIdx.x) * PIX;
  const int n = y < H && x < W ? min(PIX, W - x) : 0;
  const size_t plane = (size_t)H * W;
  const size_t pix_off = (size_t)y * W + x;  // in a channel plane

  Corners cn[PIX];
  float wb[PIX];
  if (n > 0) {
    const T* fl = flow + (size_t)b * 2 * plane + pix_off;
    float fx[PIX], fy[PIX];
    load_row<T, PIX, VEC>(fl, n, fx);
    load_row<T, PIX, VEC>(fl + plane, n, fy);
    if constexpr (BLEND)
      load_row<T, PIX, VEC>(weight + (size_t)b * plane + pix_off, n, wb);
#pragma unroll
    for (int e = 0; e < PIX; ++e)
      if (e < n)
        cn[e] = bilinear_corners((float)(xs + x + e) + fx[e], (float)y + fy[e], H, Wp);
  }
  const T* plane0 = prev + (size_t)b * C * H * Wp;  // image b's first channel
  T* const o = out + (size_t)b * C * plane + pix_off;
  const T* const r = BLEND ? raw + (size_t)b * C * plane + pix_off : nullptr;
  if constexpr (!STAGED) {
    if (n > 0)
      blend_channels<T, PIX, BLEND, VEC, true>(r, plane0, (size_t)H * Wp, Wp, cn, wb, o,
                                               plane, C, n);
  } else {
    constexpr int A = 16 / (int)sizeof(T);  // the box's alignment, in columns
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int lim[4];  // the box: min x, -max x, min y, -max y
    const int t = threadIdx.y * blockDim.x + threadIdx.x;
    int xmin = INT_MAX, xmax = -1, ymin = INT_MAX, ymax = -1;  // corners are >= 0
#pragma unroll
    for (int e = 0; e < PIX; ++e)
      if (e < n) {
        xmin = min(xmin, cn[e].x0);
        xmax = max(xmax, cn[e].x1);
        ymin = min(ymin, cn[e].y0);
        ymax = max(ymax, cn[e].y1);
      }
    if constexpr (BLEND) {  // raw's rows on their way to L2 across the decision
      if (n > 0)
        for (int ch = 0; ch < C; ++ch)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(r + ch * plane));
    }
    if (t == 0) lim[0] = lim[1] = lim[2] = lim[3] = INT_MAX;
    __syncthreads();
    xmin = __reduce_min_sync(0xffffffffu, xmin);
    xmax = __reduce_min_sync(0xffffffffu, -xmax);
    ymin = __reduce_min_sync(0xffffffffu, ymin);
    ymax = __reduce_min_sync(0xffffffffu, -ymax);
    if (t % 32 == 0) {
      atomicMin(&lim[0], xmin);
      atomicMin(&lim[1], xmax);
      atomicMin(&lim[2], ymin);
      atomicMin(&lim[3], ymax);
    }
    __syncthreads();
    // thread 0's first pixel lies in the image, so the box is never empty
    const int bx0 = lim[0] / A * A;
    const int sw = (-lim[1] + 1 - bx0 + A - 1) / A * A;
    const int by0 = lim[2];
    const int sh = -lim[3] + 1 - by0;
    if ((long long)C * sh * sw * (long long)sizeof(T) > budget) {  // the direct path
      if (n > 0)
        blend_channels<T, PIX, BLEND, VEC, true>(r, plane0, (size_t)H * Wp, Wp, cn, wb, o,
                                                 plane, C, n);
      return;
    }
    T* box = reinterpret_cast<T*>(smem);
    const int box_rows = C * sh;
    const int nthreads = blockDim.x * blockDim.y;
    if (Wp % A == 0 && reinterpret_cast<uintptr_t>(prev) % 16 == 0) {
      // prev's rows are 16-byte aligned: the box moves in 16-byte cp.asyncs
      const int chunks = sw / A;
      for (int i = t; i < box_rows * chunks; i += nthreads) {
        const int rr = i / chunks, k = i - rr * chunks;
        const int ch = rr / sh, yy = by0 + rr - ch * sh;
        cp_async16(box + rr * sw + k * A,
                   plane0 + ((size_t)ch * H + yy) * Wp + bx0 + k * A);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    } else {
      for (int i = t; i < box_rows * sw; i += nthreads) {
        const int rr = i / sw, k = i - rr * sw;
        const int ch = rr / sh, yy = by0 + rr - ch * sh;
        if (bx0 + k < Wp) box[i] = plane0[((size_t)ch * H + yy) * Wp + bx0 + k];
      }
    }
    __syncthreads();
    if (staged != nullptr && t == 0) atomicAdd(staged, 1);
    if (n == 0) return;
#pragma unroll
    for (int e = 0; e < PIX; ++e) {  // the corners in the box
      cn[e].x0 -= bx0;
      cn[e].x1 -= bx0;
      cn[e].y0 -= by0;
      cn[e].y1 -= by0;
    }
    blend_channels<T, PIX, BLEND, VEC, false>(r, box, (size_t)sh * sw, sw, cn, wb, o, plane,
                                              C, n);
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

// One forward launch on a grid of tiles x batch, with the plan's tile
// (rows x cols) and shared-memory budget: a budget makes the tile staged (4
// pixels a thread), none direct (2). The vector path (VEC) where every
// thread's pixels are aligned: W a multiple of PIX and streams aligned to
// PIX values.
template <typename T, bool BLEND, bool STAGED>
int launch(const void* raw, const void* prev, const void* flow, const void* weight,
           void* out, int B, int C, int H, int W, int Wp, int xs, int rows, int cols,
           int budget, int* staged, cudaStream_t stream) {
  constexpr int PIX = STAGED ? 4 : 2;
  const int per_row = cols % PIX == 0 ? cols / PIX : 0;
  const int threads = rows * per_row;
  if (rows < 1 || threads < 32 || threads > NTHREADS || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + cols - 1) / cols, (H + rows - 1) / rows, B);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  constexpr int V = PIX * (int)sizeof(T);
  const bool vec = W % PIX == 0 && aligned(flow, V) && aligned(out, V) &&
                   (!BLEND || (aligned(raw, V) && aligned(weight, V)));
  const auto kernel = vec ? warp_kernel<T, BLEND, true, STAGED>
                          : warp_kernel<T, BLEND, false, STAGED>;
  // the box and the kernel's own words past the default 48 KB: asked for
  // before every such launch (the attribute is the current device's)
  if (budget + (int)(4 * sizeof(int)) > 48 * 1024) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, budget);
    if (attr != cudaSuccess) return (int)attr;
  }
  kernel<<<grid, dim3(per_row, rows), budget, stream>>>(
      static_cast<const T*>(raw), static_cast<const T*>(prev),
      static_cast<const T*>(flow), static_cast<const T*>(weight), static_cast<T*>(out),
      C, H, W, Wp, xs, budget, staged);
  return (int)cudaGetLastError();
}

template <typename T, bool BLEND>
int launch_plan(const void* raw, const void* prev, const void* flow, const void* weight,
                void* out, int B, int C, int H, int W, int Wp, int xs, int rows,
                int cols, int budget, int* staged, cudaStream_t stream) {
  if (budget < 0 || budget > MAX_BOX_BYTES) return (int)cudaErrorInvalidValue;
  if (budget > 0)
    return launch<T, BLEND, true>(raw, prev, flow, weight, out, B, C, H, W, Wp, xs, rows,
                                  cols, budget, staged, stream);
  return launch<T, BLEND, false>(raw, prev, flow, weight, out, B, C, H, W, Wp, xs, rows,
                                 cols, 0, nullptr, stream);
}

template <bool BLEND>
int dispatch(const void* raw, const void* prev, const void* flow,
             const void* weight, void* out, int B, int C, int H, int W, int Wp,
             int xs, int rows, int cols, int budget, int* staged, int dtype,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H * W == 0) return (int)cudaSuccess;  // nothing to launch
  if (B > 65535) return (int)cudaErrorInvalidValue;  // grid z
  if (xs < 0 || xs + W > Wp) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch_plan<float, BLEND>(raw, prev, flow, weight, out, B, C, H, W, Wp, xs,
                                     rows, cols, budget, staged, s);
  if (dtype == kBFloat16)
    return launch_plan<__nv_bfloat16, BLEND>(raw, prev, flow, weight, out, B, C, H, W, Wp,
                                             xs, rows, cols, budget, staged, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace v2v

// prev: (B, C, H, Wp), the whole frame; raw, flow, weight, out: W columns
// from the frame's column x0 (the unsharded call: Wp = W, x0 = 0). rows,
// cols, smem_bytes: the plan (ops/warp.py::warp_forward_plan); staged:
// null, or an int the launch adds its staged tiles to.
extern "C" int v2v_warp_blend(const void* raw, const void* prev,
                              const void* flow, const void* weight, void* out,
                              int B, int C, int H, int W, int Wp, int x0, int rows,
                              int cols, int smem_bytes, void* staged, int dtype,
                              void* stream) {
  return v2v::dispatch<true>(raw, prev, flow, weight, out, B, C, H, W, Wp, x0, rows,
                             cols, smem_bytes, static_cast<int*>(staged), dtype, stream);
}

// The unfused warp: image (B, C, H, Wp), the whole frame; flow and out: W
// columns from the frame's column x0 (a width shard's: the loss engine's
// F_Warp and G_Warp on the model axis; the unsharded call: Wp = W, x0 = 0).
extern "C" int v2v_flow_warp_at(const void* image, const void* flow, void* out,
                                int B, int C, int H, int W, int Wp, int x0, int rows,
                                int cols, int smem_bytes, void* staged, int dtype,
                                void* stream) {
  return v2v::dispatch<false>(nullptr, image, flow, nullptr, out, B, C, H, W, Wp, x0,
                              rows, cols, smem_bytes, static_cast<int*>(staged), dtype,
                              stream);
}

// The backward of v2v_flow_warp_at: image, dimage, splat (B, C, H, Wp), the
// whole frame (on a shard, its splat: the shards' dimage sum to the whole
// frame's); flow, g, dflow: W columns from the frame's column x0. dimage in
// the dtype; splat: f32 scratch of the same shape, which the entry zeroes
// and accumulates into (in f32 it must be dimage itself).
extern "C" int v2v_flow_warp_at_bwd(const void* image, const void* flow,
                                    const void* g, void* dimage, void* splat,
                                    void* dflow, int B, int C, int H, int W, int Wp,
                                    int x0, int dtype, void* stream) {
  return v2v::dispatch_bwd<false>(nullptr, image, flow, nullptr, g, nullptr,
                                  dimage, splat, dflow, nullptr, B, C, H, W, Wp,
                                  x0, dtype, stream);
}

// prev, dprev, splat: (B, C, H, Wp), the whole frame; raw, flow, weight, g,
// draw, dflow, dweight: W columns from the frame's column x0 (the unsharded
// call: Wp = W, x0 = 0). draw, dprev, dflow, dweight in the dtype; splat
// as v2v_flow_warp_at_bwd's.
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
