// FlowNetC correlation cost volume, for Hopper (sm_90a).
//
// Replaces vid2vid_tpu/ops/correlation_pallas.py::_corr_kernel (:35; and its
// XLA twin correlation.py::correlation_ref, which FlowNetC calls). It
// computes, in FlowNetC's configuration (max displacement 20, stride2 2):
//     out[b, j*21 + i, y, x] = 1/C * sum_c f1[b, c, y, x]
//                                          * f2[b, c, y + 2(j-10), x + 2(i-10)]
// for j, i in [0, 21) (dy-major), with f2 read as zero outside the image.
// f1, f2: (B, C, H, W) f32, contiguous; out: (B, 441, H, W) f32. Any B, C,
// H, W: out-of-image taps read zero in both axes, so no padded copy of f2
// exists (the TPU kernel padded rows and masked columns with an iota
// diagonal; the semantics are the same). The column-halo mode of a width
// shard (v2v_correlation_cols, training's model axis) runs the same kernel
// on the shard's columns, f2 carrying 20 more on each side that the caller
// fetched from the neighbouring ranks (zeros past the image's edges).
//
// What bounds it on the H100. FMAs on the CUDA cores: 441 * C per output
// pixel, 7.4 G at (2, 256, 128, 256), 0.221 ms at 67 TFLOP/s. The
// compulsory traffic (f1, f2 once, the 441 planes of out) is 182 MB, 0.054
// ms at 3.35 TB/s. Between the two stand the shared-memory words each FMA
// needs (an SM serves 32 words a clock against 128 FMA lanes, so a kernel
// needs >= 4 FMAs per word to stay FMA-bound) and the L2 traffic of staging
// f2 again for every output row that meets it (~34 times per value with
// one output row per block, ~2.3 GB a call).
//
// The tiling. Output row y meets f2 row y + 2(j-10), so rows of one parity
// two apart share f2 rows along diagonals: in a row group of Q rows
// u0..u0+Q-1 (y = 2u + parity), pair (q, j) reads f2 row 2(u0 + n - 10) +
// parity with n = q + j, and diagonal n in [0, Q + 20) holds every pair
// that meets one f2 row.
//  - A block owns Q = 4 rows of one parity, M = 4 diagonals (one warp
//    each) and a 64-column x tile, and walks C in chunks of CC = 16
//    channels. A thread owns two same-parity pixels (x, x+2) and the Q
//    pairs of its warp's diagonal: 4 * 2 * 21 = 168 accumulators (~250
//    registers, no spills; two blocks an SM). Per channel it reads 22 f2
//    words (11 LDS.64; pixel x only meets f2 columns of its own parity, so
//    the staged rows are split into even and odd halves) and 8 f1 words
//    (4 LDS.64) for 168 FMAs: 5.6 FMAs per word, 30 wavefronts a warp
//    against 42 FMA clocks.
//  - f2 stagings: a row group stages Q + 20 = 24 f2 rows for its 84 pairs,
//    so each f2 row is staged (Q + 20) / Q = 6 times, times the window's
//    overhead (64 + 40) / 64: 9.75 per value, 7.99 counting only in-image
//    taps at (2, 256, 128, 256) (ops/correlation.py::f2_stagings), against
//    ~34; f1 is staged once per diagonal group, 6 times. The row group's
//    first and last three diagonals hold fewer than Q pairs; their other
//    rows are computed and not stored ((Q - 1) / (Q + 20) = 12.5% of the
//    FMAs). Skipping them with one code path per row range made the kernel
//    slower (its registers and code grew).
//  - Staging is asynchronous and double-buffered: `cp.async` of 4 bytes a
//    column, chunk k+1 in flight while chunk k is computed, one
//    __syncthreads a chunk. Taps outside the image and channels past C copy
//    with src-size 0, which zero-fills, so the inner loop has no border
//    branch. Each thread's column and first row slot are fixed at the
//    start: no division per element. Wider copies cannot split the
//    parities, and neither can a TMA tile (cuTensorMapEncodeTiled ignores
//    the element stride of its innermost dimension). Each staged row's odd
//    half starts 16 (mod 32) words past its even half, so a warp's copy of
//    32 columns writes 32 distinct banks.
//  - Stores: a shuffle between the lanes of the two parities gives each
//    lane two adjacent columns, so a warp writes 64 consecutive floats
//    of each output plane with 8-byte stores (scalar where W is odd).
//  - Small grids: where the blocks would not fill the card once (two per
//    SM), the channel sum is split into parts, written to scratch, and a
//    second kernel adds the parts in a fixed order and scales by 1/C: the
//    result is the same bit for bit from run to run (no atomics).
//    ops/correlation.py::correlation_plan picks the split and mirrors
//    these constants; tests/test_torch_correlation_tiles.py walks the map.
//  - What holds it below the FFMA bound (~0.47 of it at (2, 256, 128, 256)
//    on an H100, chip_smoke.py phase 6), by count: 12.5% of its FMAs are
//    the edge diagonals' unstored rows, the staging and the shared loads
//    are ~20% of the issued instructions, and the accumulators fill the
//    registers, so eight warps an SM hide the staging behind the FMAs only
//    in part.
//
// Not taken: the tensor cores. For a row pair the product m[x, x'] =
// <f1[:, y, x], f2[:, y', x']> is a banded GEMM; split by x parity into 16-
// pixel M sub-tiles it is an m64n40k8 wgmma (four f1 rows sharing one f2
// row) of which 52% of the products are used. In f32-class precision
// (3xTF32, 165 TFLOP/s) that bounds at 14.8 GFLOP / 0.52 / 165 = 0.171 ms,
// only 1.3x below this kernel's 0.221 ms FFMA bound for far more code; a
// single TF32 pass (~3e-5 on these O(0.06) outputs) misses the smoke's atol
// 1e-5. It becomes worth it if the cost volume may be taken in TF32 or
// bf16, or at C well above 256.

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace v2v {
namespace {

constexpr int RAD = 10;           // displacement radius in stride-2 steps
constexpr int ND = 2 * RAD + 1;   // 21 displacements per axis
constexpr int MD = 2 * RAD;       // max displacement in pixels
// the tile (ops/correlation.py mirrors these)
constexpr int Q = 4;              // output rows per block and per thread
constexpr int M = 4;              // diagonals per block, one warp each
constexpr int TX = 64;            // output columns per block
constexpr int CC = 16;            // channels per staged chunk
constexpr int STAGES = 2;         // chunks in shared memory (in flight + computed)
constexpr int NT = 32 * M;
constexpr int NDIAG = Q + 2 * RAD;        // diagonals of a row group: 24
constexpr int NDG = (NDIAG + M - 1) / M;  // diagonal groups: 6
constexpr int WIN = TX + 2 * MD;          // staged f2 columns a row: 104
// A staged row holds its even columns, then from ODD its odd ones. ODD is
// the first offset >= the half's length that is 16 (mod 32): a warp's copy
// of 32 consecutive columns then writes 16 banks of each half, disjoint,
// and the halves stay 8-byte aligned for the LDS.64 reads.
constexpr int odd_offset(int half) { return (half - 16 + 31) / 32 * 32 + 16; }
constexpr int ODD2 = odd_offset(WIN / 2);   // f2: 80
constexpr int ROW2 = ODD2 + WIN / 2;        // floats a staged f2 row: 132
constexpr int ODD1 = odd_offset(TX / 2);    // f1: 48
constexpr int ROW1 = ODD1 + TX / 2;         // floats a staged f1 row: 80
constexpr int F2_STAGE = M * CC * ROW2;     // floats of f2 a stage
constexpr int STAGE = F2_STAGE + Q * CC * ROW1;
constexpr int SMEM_BYTES = STAGES * STAGE * (int)sizeof(float);
constexpr int F2_ROWS_PER_PASS = NT / WIN;  // f2 row slots a thread steps by
constexpr int F1_ROWS_PER_PASS = NT / TX;
static_assert(NT >= WIN && NT % TX == 0 && ODD2 % 2 == 0 && ODD1 % 2 == 0 &&
                  (CC & (CC - 1)) == 0,
              "tile");
static_assert(CC % F2_ROWS_PER_PASS == 0 && CC % F1_ROWS_PER_PASS == 0, "tile");

template <bool B>
struct Full {  // a chunk with every channel < C (the staging's fast path)
  static constexpr bool value = B;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One staged chunk's FMAs for the Q rows of the warp's diagonal: CC
// channels, each 11 LDS.64 of the f2 window and Q of f1, 42 FMAs a row.
// Rows whose j = n - q falls outside [0, 21) (on the row group's first and
// last Q - 1 diagonals) are computed too and never stored.
__device__ __forceinline__ void chunk_fmas(const float* cur, int f1_read, int f2_read,
                                           float (&acc)[Q][2][ND]) {
#pragma unroll 4
  for (int cc = 0; cc < CC; ++cc) {
    float2 a[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q)
      a[q] = *reinterpret_cast<const float2*>(cur + f1_read + (q * CC + cc) * ROW1);
    const float* w = cur + f2_read + cc * ROW2;
    // window word m serves pixel e = 0 at i = m and pixel e = 1 at i = m - 1
#pragma unroll
    for (int m = 0; m < ND + 1; m += 2) {
      const float2 v = *reinterpret_cast<const float2*>(w + m);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (m < ND) acc[q][0][m] = fmaf(a[q].x, v.x, acc[q][0][m]);
        if (m >= 1) acc[q][1][m - 1] = fmaf(a[q].y, v.x, acc[q][1][m - 1]);
        if (m + 1 < ND) acc[q][0][m + 1] = fmaf(a[q].x, v.y, acc[q][0][m + 1]);
        acc[q][1][m] = fmaf(a[q].y, v.y, acc[q][1][m]);
      }
    }
  }
}

// Grid: x tiles, row groups * NDG, (part * B + b) * 2 + parity. `out`
// holds part `part` at out + part * part_stride (split > 1: scratch, raw
// sums, scale 1) or is the result (split 1, scale 1/C). f2's rows are W2
// columns long and output column x reads f2 column x + xoff2 + 2(i - 10):
// W2 = W, xoff2 = 0 for the whole image; the column-halo mode (a width
// shard's W columns, f2 carrying MD more on each side: its neighbours'
// columns, zeros past the image's edges) has W2 = W + 2 MD, xoff2 = MD,
// and its f2 taps all lie inside that row. Taps past f2's row read zero.
__global__ void __launch_bounds__(NT)
correlation_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   float* __restrict__ out, int B, int C, int H, int W, int W2,
                   int xoff2, int chunks_per_part, size_t part_stride, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int x0 = blockIdx.x * TX;
  const int g = blockIdx.y / NDG;
  const int n0 = (blockIdx.y - g * NDG) * M;  // first diagonal of the block
  const int par = blockIdx.z & 1;
  const int b = (blockIdx.z >> 1) % B;
  const int part = (blockIdx.z >> 1) / B;
  const int u0 = g * Q;                  // first row of the group (this parity)
  const int hp = (H - par + 1) >> 1;     // rows of this parity
  if (u0 >= hp) return;                  // the block has no output row
  const int k0 = part * chunks_per_part;
  const int k1 = min((C + CC - 1) / CC, k0 + chunks_per_part);
  const size_t hw = (size_t)H * W, hw2 = (size_t)H * W2;
  const float* f1b = f1 + (size_t)b * C * hw;
  const float* f2b = f2 + (size_t)b * C * hw2;

  // the staging map, fixed for the whole kernel: thread t copies column
  // p2 of the f2 row slots n * CC + cc with cc = r2 (mod F2_ROWS_PER_PASS)
  // and column p1 of the f1 row slots q * CC + cc with cc = r1 (mod
  // F1_ROWS_PER_PASS); columns land split by parity
  const int t = threadIdx.x;
  const int p2 = t % WIN, r2 = t / WIN;
  const bool stages_f2 = r2 < F2_ROWS_PER_PASS;
  const int x2 = x0 - MD + p2 + xoff2;  // the column of f2's row
  const bool x2_in = x2 >= 0 && x2 < W2;
  const int d2 = r2 * ROW2 + (p2 & 1) * ODD2 + (p2 >> 1);
  const int p1 = t % TX, r1 = t / TX;
  const int x1 = x0 + p1;
  const bool x1_in = x1 < W;
  const int d1 = F2_STAGE + r1 * ROW1 + (p1 & 1) * ODD1 + (p1 >> 1);

  // Chunk k into buf. `full` (every channel of the chunk < C, the common
  // case) drops the per-element channel test; taps outside the image
  // and channels past C copy 0 bytes, which zero-fills.
  auto stage = [&](auto full, int k, float* buf) {
    const int c0 = k * CC;
    const int c_left = C - c0;  // channels of the chunk inside C (if < CC)
    if (stages_f2) {
#pragma unroll
      for (int n = 0; n < M; ++n) {
        const int yy = 2 * (u0 + n0 + n - RAD) + par;
        const bool row_in = x2_in && yy >= 0 && yy < H;
        const float* src = f2b + (size_t)(c0 + r2) * hw2 + (row_in ? (size_t)yy * W2 + x2 : 0);
#pragma unroll
        for (int cc = 0; cc < CC; cc += F2_ROWS_PER_PASS) {
          float* dst = buf + d2 + (n * CC + cc) * ROW2;
          if constexpr (decltype(full)::value) {
            cp_async4(dst, src, row_in ? 4 : 0);
          } else {
            const bool in = row_in && r2 + cc < c_left;
            cp_async4(dst, in ? src : f2b, in ? 4 : 0);
          }
          src += F2_ROWS_PER_PASS * hw2;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int yy = 2 * (u0 + q) + par;
      const bool row_in = x1_in && yy < H;
      const float* src = f1b + (size_t)(c0 + r1) * hw + (row_in ? (size_t)yy * W + x1 : 0);
#pragma unroll
      for (int cc = 0; cc < CC; cc += F1_ROWS_PER_PASS) {
        float* dst = buf + d1 + (q * CC + cc) * ROW1;
        if constexpr (decltype(full)::value) {
          cp_async4(dst, src, row_in ? 4 : 0);
        } else {
          const bool in = row_in && r1 + cc < c_left;
          cp_async4(dst, in ? src : f1b, in ? 4 : 0);
        }
        src += F1_ROWS_PER_PASS * hw;
      }
    }
  };
  auto stage_chunk = [&](int k, float* buf) {
    if ((k + 1) * CC <= C)
      stage(Full<true>(), k, buf);
    else
      stage(Full<false>(), k, buf);
  };

  // the compute map: warp = diagonal n0 + nl; lane = (parity px of its
  // pixels, t16); pixels x0 + 4 * t16 + 2e + px, e = 0, 1
  const int warp = t >> 5, lane = t & 31;
  const int nl = warp;
  const int px = lane >> 4, t16 = lane & 15;
  const int f2_read = nl * CC * ROW2 + px * ODD2 + 2 * t16;
  const int f1_read = F2_STAGE + px * ODD1 + 2 * t16;

  float acc[Q][2][ND];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[q][0][i] = acc[q][1][i] = 0.f;

  // chunk k lives in buffer (k - k0) % STAGES; STAGES - 1 chunks are in
  // flight while one is computed (one commit group per chunk, empty past k1)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (k0 + s < k1) stage_chunk(k0 + s, smem + s * STAGE);
    cp_async_commit();
  }
  int slot = 0;  // (k - k0) % STAGES
  for (int k = k0; k < k1; ++k) {
    float* cur = smem + slot * STAGE;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk k landed everywhere; chunk k-1's reads are done
    const int next = slot == 0 ? STAGES - 1 : slot - 1;  // chunk k-1's buffer
    if (k + STAGES - 1 < k1) stage_chunk(k + STAGES - 1, smem + next * STAGE);
    cp_async_commit();
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    chunk_fmas(cur, f1_read, f2_read, acc);
  }

  // lane (px, t16) holds columns 4 t16 + px (e = 0) and 4 t16 + 2 + px
  // (e = 1); after one shuffle across the parities it holds the adjacent
  // pair xs, xs + 1 with xs = 4 t16 + 2 px
  const int xs = x0 + 4 * t16 + 2 * px;
  const bool pairs = (W & 1) == 0 && xs + 1 < W;
  float* outp = out + part * part_stride + (size_t)b * ND * ND * hw;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int u = u0 + q, j = n0 + nl - q;
    const bool rows = u < hp && j >= 0 && j < ND;  // uniform over the warp
    const int y = 2 * u + par;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const float e0 = acc[q][0][i] * scale, e1 = acc[q][1][i] * scale;
      const float got = __shfl_xor_sync(0xffffffffu, px ? e0 : e1, 16);
      if (!rows) continue;
      const float v0 = px ? got : e0, v1 = px ? e1 : got;
      float* o = outp + (size_t)(j * ND + i) * hw + (size_t)y * W + xs;
      if (pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        if (xs < W) o[0] = v0;
        if (xs + 1 < W) o[1] = v1;
      }
    }
  }
}

// out[e] = scale * (parts[0][e] + parts[1][e] + ...), in that order.
__global__ void sum_parts_kernel(const float* __restrict__ parts,
                                 float* __restrict__ out, size_t n, int nparts,
                                 float scale) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  if (n % 4 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(parts);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n / 4;
         e += stride) {
      float4 s = p4[e];
      for (int p = 1; p < nparts; ++p) {
        const float4 v = p4[p * (n / 4) + e];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      o4[e] = make_float4(s.x * scale, s.y * scale, s.z * scale, s.w * scale);
    }
  } else {
    for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += stride) {
      float s = parts[e];
      for (int p = 1; p < nparts; ++p) s += parts[p * n + e];
      out[e] = s * scale;
    }
  }
}

// ---------------------------------------------------------------- backward
//
// The VJP of the cost volume above, in the same configuration (max
// displacement 20, stride2 2, f32): with dy = 2(j-10), dx = 2(i-10),
//     df1[b,c,y,x] = 1/C sum_{j,i} g[b, j*21+i, y, x]       f2[b,c, y+dy, x+dx]
//     df2[b,c,y,x] = 1/C sum_{j,i} g[b, j*21+i, y-dy, x-dx] f1[b,c, y-dy, x-dx]
// with every tap outside the image zero. It replaces the autograd of the
// plain version (ops/correlation.py::correlation_plain), the port's
// counterpart of the JAX package's jax.vjp of correlation_ref
// (vid2vid_tpu/ops/correlation.py:25-65; the TPU kernel has no backward).
//
// What bounds it on the H100: FMAs on the CUDA cores, one per in-image tap
// of each gradient (ops/correlation.py::correlation_taps: 788 of the 48 x
// 21 row taps and 1124 of the 64 x 21 column taps are inside the image at
// FlowNetC's training shape (8, 256, 48, 64)): 2 x 8 x 256 x 788 x 1124 =
// 3.63 G FMAs there, 0.108 ms at 67 TFLOP/s; the compulsory bytes (f1, f2,
// g read once, df1, df2 written once) are 144 MB there, 0.043 ms at
// 3.35 TB/s.
//
// One form for both gradients. Output row y = 2u + parity meets the f row
// 2(u + n - 10) + parity on diagonal n of its row group (as in the forward):
// for df1 the f2 row, paired with g at the output pixel (j = n - q); for
// df2 the f1 row, paired with g at that same row, the pixel that read this
// one (j = q + 20 - n, i = 20 - k). In both, with the staged g row G and
// the staged f window F (columns x0 - 20 .. x0 + 83, each parity a half),
//     acc[c][q][h] += G[q][k][h] * F[c][h + k],   k in [0, 21)
// for pixel h of a parity half: df1 stages G[q][k] = g[(n-q)*21 + k] at row
// q, columns x0..x0+63; df2 stages G[q][k] = g[(q+20-n)*21 + 20-k] at the
// f row, columns shifted by -20 + 2k. Only the staging differs.
//
// The tiling.
//  - A block owns Q = 4 output rows of one parity, a 64-column x tile and
//    64 channels of one gradient (a channel block; the grid covers C with
//    them), and walks the Q + 20 = 24 f rows its rows meet, or those inside
//    the image (at (8, 256, 48, 64) 108 of a channel block's 144). Each f
//    row is staged once for the block and serves every (row, j) pair on
//    its diagonal; the pairs of the first and last three diagonals that
//    fall outside [0, 21) read a zero-filled G row, and the columns of a
//    window outside the image a zero-filled F word: 4.76 G FMAs executed
//    there, 1.31 times the 3.63 G the bound counts.
//  - Four warps: two column halves x two channel halves. A lane owns 4
//    same-parity pixels (h = 16 wx + 4 pg + e) x 8 channels (32 wc + cg +
//    4 cc) x the Q rows: 128 accumulators. Per f row and k it reads the Q
//    G words of its pixels (4 LDS.128, broadcast over the 4 channel groups
//    of a warp) and one new word of each channel's window (8 LDS.32): the
//    window F[c][h0 + k .. h0 + k + 3] slides along k in registers (word m
//    in slot m mod 4), so one f word serves the next pixel at the next k.
//    The 21 steps are unrolled in groups of 4 (the window's period) and a
//    last step, which keeps the f-row loop ~12 KB of code.
//  - Per f row a thread does 21 * 128 = 2688 FMAs on 336 G + 192 F words:
//    5.1 FMAs per shared-memory word (>= 4, see the forward's note). Per
//    warp, a G LDS.128 is 128 distinct bytes (one wavefront, or four if the
//    hardware splits 128-bit loads by quarter warp) and an F LDS.32 32
//    distinct words: 276 (at most 528) wavefronts against 672 FMA clocks.
//  - Banks: the F halves of 64 channels lie in two arrays of rows of 53
//    floats (odd, so 4 consecutive channels start in 4 banks mod 4), the
//    odd array 3408 floats on (16 mod 32): a warp's F read hits 32 banks.
//    A G row holds chunks of 4 pixels, each parity's side by side (slot
//    8 (h / 4) + 4 parity + h mod 4): a warp's LDS.128 reads 128 contiguous
//    bytes and a warp's copy of 32 columns writes 32 banks.
//  - Staging is asynchronous and double-buffered: `cp.async` of 4 bytes a
//    column (so each lands in its parity's half), f row n + 1 in flight
//    while row n is computed, one __syncthreads a row. Taps outside the
//    image, channels past C and pairs outside [0, 21) copy with src-size 0,
//    which zero-fills, so the inner loop has no border branch. A block
//    stages <= 6656 + 5376 words an f row for 344,064 FMAs (28.6 a word);
//    each g value once per channel block (C / 64 = 4 times at C = 256,
//    against 16 L1 passes in the gather this replaces).
//  - Stores: one shuffle between the lanes of the two parities gives each
//    lane 4 adjacent columns; a warp writes 128 contiguous bytes of 4
//    channel rows with 16-byte stores (scalar where W % 4 != 0).
//  - Registers: 128 accumulators, 32 window and 16 G words (~200 in all,
//    at most 255); 97,408 bytes of shared memory; two blocks an SM. At
//    (8, 256, 48, 64): 4 x 6 x 1 x 8 x 2 x 2 = 768 blocks over 264 slots,
//    2.91 waves, in one launch (ops/correlation.py::correlation_bwd_plan).
//  - Each output element is summed by one thread in a fixed order (f rows,
//    then k, ascending), scaled by 1/C and written once: no atomics, the
//    same bit for bit from launch to launch. tests/test_torch_flow_train.py
//    walks the map in numpy from the constants ops/correlation.py mirrors.

constexpr int BQ = 4;                  // output rows per block and per thread
constexpr int BTX = 64;                // output columns per block
constexpr int BCB = 64;                // channels per block
constexpr int BK = 8;                  // channels per thread
constexpr int BNT = 128;               // 2 column halves x 2 channel halves, a warp each
constexpr int BSTAGES = 2;             // f rows in shared memory (in flight + computed)
constexpr int BNDIAG = BQ + 2 * RAD;   // f rows a row group meets: 24
constexpr int BWIN = BTX + 2 * MD;     // staged f columns a row: 104
constexpr int BROWF = BWIN / 2 + 1;    // floats of a staged half row: 53 (odd)
constexpr int BODDF = odd_offset(BCB * BROWF);  // the odd halves' array: 3408
constexpr int BF_STAGE = BODDF + BCB * BROWF;   // 6800
constexpr int BG_ROW = BTX;                     // floats of a staged g row: 64
constexpr int BG_STAGE = BQ * ND * BG_ROW;      // 5376
constexpr int BSTAGE = BF_STAGE + BG_STAGE;     // 12176
constexpr int BSMEM_BYTES = BSTAGES * BSTAGE * (int)sizeof(float);  // 97408
static_assert(BROWF % 2 == 1 && BF_STAGE % 4 == 0 && BSTAGE % 4 == 0, "banks, alignment");
static_assert(BNT >= BWIN && BNT == 2 * BTX && BQ == 4, "staging map");
static_assert(BCB == 2 * 4 * BK && BTX == 2 * 32 && BNT == 128, "compute map");

// Step k of an f row: the Q G words of the lane's pixels, the new word k + 3
// of each channel's window into slot S = (k + 3) mod 4, then 128 FMAs;
// pixel e reads window word k + e, in slot (S + 1 + e) mod 4.
template <int S>
__device__ __forceinline__ void bwd_step(const float* g_k, const float* f_new,
                                         float (&win)[BK][4], float (&acc)[BQ][BK][4]) {
  float4 gv[BQ];
#pragma unroll
  for (int q = 0; q < BQ; ++q)
    gv[q] = *reinterpret_cast<const float4*>(g_k + q * ND * BG_ROW);
#pragma unroll
  for (int cc = 0; cc < BK; ++cc) win[cc][S] = f_new[cc * 4 * BROWF];
#pragma unroll
  for (int q = 0; q < BQ; ++q) {
#pragma unroll
    for (int cc = 0; cc < BK; ++cc) {
      acc[q][cc][0] = fmaf(gv[q].x, win[cc][(S + 1) & 3], acc[q][cc][0]);
      acc[q][cc][1] = fmaf(gv[q].y, win[cc][(S + 2) & 3], acc[q][cc][1]);
      acc[q][cc][2] = fmaf(gv[q].z, win[cc][(S + 3) & 3], acc[q][cc][2]);
      acc[q][cc][3] = fmaf(gv[q].w, win[cc][S], acc[q][cc][3]);
    }
  }
}

// Grid: channel blocks, row groups * x tiles, (b * 2 + grad) * 2 + parity
// (grad 0: df1 to out1, 1: df2 to out2), each scaled by `scale` (1/C).
// `vec`: W % 4 == 0 and the outputs 16-byte aligned.
__global__ void __launch_bounds__(BNT, 2)
correlation_bwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                       const float* __restrict__ g, float* __restrict__ out1,
                       float* __restrict__ out2, int B, int C, int H, int W, int x_tiles,
                       float scale, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int cb0 = blockIdx.x * BCB;
  const int grp = blockIdx.y / x_tiles;
  const int x0 = (blockIdx.y - grp * x_tiles) * BTX;
  const int par = blockIdx.z & 1;
  const bool df2 = (blockIdx.z >> 1) & 1;
  const int b = blockIdx.z >> 2;
  const int u0 = grp * BQ;               // first row of the group (this parity)
  const int hp = (H - par + 1) >> 1;     // rows of this parity
  if (u0 >= hp) return;                  // the block has no output row
  // the f rows inside the image: 2(u0 + n - RAD) + par in [0, H)
  const int n0 = max(0, RAD - u0), n1 = min(BNDIAG, hp + RAD - u0);
  const size_t hw = (size_t)H * W;
  const float* fb = (df2 ? f1 : f2) + (size_t)b * C * hw;  // the staged f rows
  const float* gb = g + (size_t)b * ND * ND * hw;
  const bool full_c = cb0 + BCB <= C;

  // the staging map, fixed for the whole kernel: thread t < BWIN copies
  // window column t of the 64 channels' f rows; thread t copies tile column
  // t mod 64 of the G rows q = t / 64 and q + 2 (all k)
  const int t = threadIdx.x;
  const bool stages_f = t < BWIN;
  const int xf = x0 - MD + t;
  const bool xf_in = stages_f && xf >= 0 && xf < W;
  const int f_slot = (t & 1) * BODDF + (t >> 1);
  const int gcol = t & (BTX - 1), gq = t >> 6;
  const int gx = x0 + gcol;
  const int g_slot = BF_STAGE + 8 * (gcol >> 3) + 4 * (gcol & 1) + ((gcol >> 1) & 3);

  auto stage = [&](int n, float* buf) {
    const int yf = 2 * (u0 + n - RAD) + par;  // the f row (inside the image)
    if (stages_f) {
      const float* src = fb + (size_t)cb0 * hw + (size_t)yf * W + (xf_in ? xf : 0);
      float* dst = buf + f_slot;
      if (full_c) {
#pragma unroll 16
        for (int cl = 0; cl < BCB; ++cl) {
          cp_async4(dst + cl * BROWF, src, xf_in ? 4 : 0);
          src += hw;
        }
      } else {
        for (int cl = 0; cl < BCB; ++cl) {
          const bool in = xf_in && cb0 + cl < C;
          cp_async4(dst + cl * BROWF, in ? src : fb, in ? 4 : 0);
          src += hw;
        }
      }
    }
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) {
      const int q = gq + 2 * qq;
      float* dst = buf + g_slot + q * ND * BG_ROW;
      if (!df2) {  // g[(n - q) * 21 + k] at output row q, tile column gcol
        const int j = n - q, y = 2 * (u0 + q) + par;
        const bool ok = gx < W && j >= 0 && j < ND && y < H;
        const float* src = ok ? gb + (size_t)j * ND * hw + (size_t)y * W + gx : gb;
        const size_t step = ok ? hw : 0;
#pragma unroll
        for (int k = 0; k < ND; ++k) {
          cp_async4(dst + k * BG_ROW, src, ok ? 4 : 0);
          src += step;
        }
      } else {  // g[(q + 20 - n) * 21 + 20 - k] at the f row, column gx - 20 + 2k
        const int j = q + 2 * RAD - n;
        const bool ok = j >= 0 && j < ND;
        const long long off0 =
            ((long long)(j * ND + 2 * RAD) * H + yf) * W + (gx - MD);
        const long long step = 2 - (long long)hw;
#pragma unroll
        for (int k = 0; k < ND; ++k) {
          const int xk = gx - MD + 2 * k;
          const bool in = ok && xk >= 0 && xk < W;
          cp_async4(dst + k * BG_ROW, in ? gb + (off0 + k * step) : gb, in ? 4 : 0);
        }
      }
    }
  };

  // the compute map: warp (wx, wc), lane (cg, pg, px); pixels h = 16 wx +
  // 4 pg + e of parity px (column x0 + 2h + px), channels 32 wc + cg + 4 cc
  const int warp = t >> 5, lane = t & 31;
  const int wx = warp & 1, wc = warp >> 1;
  const int px = lane & 1, pg = (lane >> 1) & 3, cg = lane >> 3;
  const int f_read = px * BODDF + (32 * wc + cg) * BROWF + 16 * wx + 4 * pg;
  const int g_read = BF_STAGE + 8 * (4 * wx + pg) + 4 * px;

  float acc[BQ][BK][4];
#pragma unroll
  for (int q = 0; q < BQ; ++q)
#pragma unroll
    for (int cc = 0; cc < BK; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][cc][e] = 0.f;

  if (n0 < n1) stage(n0, smem);
  cp_async_commit();
  int slot = 0;
  for (int n = n0; n < n1; ++n) {
    const float* cur = smem + slot * BSTAGE;
    cp_async_wait<0>();
    __syncthreads();  // row n landed everywhere; row n-1's reads are done
    if (n + 1 < n1) stage(n + 1, smem + (slot ^ 1) * BSTAGE);
    cp_async_commit();
    slot ^= 1;
    const float* fr = cur + f_read;
    const float* gr = cur + g_read;
    float win[BK][4];
#pragma unroll
    for (int cc = 0; cc < BK; ++cc)
#pragma unroll
      for (int e = 0; e < 3; ++e) win[cc][e] = fr[cc * 4 * BROWF + e];
#pragma unroll 1
    for (int k = 0; k < 20; k += 4) {
      bwd_step<3>(gr + k * BG_ROW, fr + k + 3, win, acc);
      bwd_step<0>(gr + (k + 1) * BG_ROW, fr + k + 4, win, acc);
      bwd_step<1>(gr + (k + 2) * BG_ROW, fr + k + 5, win, acc);
      bwd_step<2>(gr + (k + 3) * BG_ROW, fr + k + 6, win, acc);
    }
    bwd_step<3>(gr + 20 * BG_ROW, fr + 23, win, acc);
  }

  // lane (px, pg) holds columns 8 pg + 2e + px of its warp's 32; after one
  // shuffle across the parities it holds xs .. xs + 3, xs = 8 pg + 4 px
  const int xs = x0 + 32 * wx + 8 * pg + 4 * px;
  float* outp = (df2 ? out2 : out1) + (size_t)b * C * hw;
#pragma unroll
  for (int q = 0; q < BQ; ++q) {
    const int u = u0 + q;
    if (u >= hp) break;  // uniform over the block
    const int y = 2 * u + par;
#pragma unroll
    for (int cc = 0; cc < BK; ++cc) {
      const float v0 = acc[q][cc][0] * scale, v1 = acc[q][cc][1] * scale;
      const float v2 = acc[q][cc][2] * scale, v3 = acc[q][cc][3] * scale;
      const float r0 = __shfl_xor_sync(0xffffffffu, px ? v0 : v2, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, px ? v1 : v3, 1);
      const float4 o = px ? make_float4(r0, v2, r1, v3) : make_float4(v0, r0, v1, r1);
      const int c = cb0 + 32 * wc + cg + 4 * cc;
      if (c >= C || xs >= W) continue;
      float* p = outp + (size_t)c * hw + (size_t)y * W + xs;
      if (vec) {
        *reinterpret_cast<float4*>(p) = o;
      } else {
        p[0] = o.x;
        if (xs + 1 < W) p[1] = o.y;
        if (xs + 2 < W) p[2] = o.z;
        if (xs + 3 < W) p[3] = o.w;
      }
    }
  }
}

}  // namespace
}  // namespace v2v

namespace v2v {
namespace {

// One forward launch (and the second pass of a split channel sum): f2's
// rows W2 columns long, output column 0 at its column xoff2.
int launch_correlation(const void* f1, const void* f2, void* out, void* scratch, int B,
                       int C, int H, int W, int W2, int xoff2, int split,
                       int chunks_per_part, int dtype, void* stream) {
  if (dtype != kFloat32 || C <= 0 || split < 1 || chunks_per_part < 1 ||
      (split > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B * H * W == 0) return (int)cudaSuccess;  // nothing to launch
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (SMEM_BYTES > 48 * 1024) {  // above the default limit: ask for it
    const cudaError_t attr = cudaFuncSetAttribute(
        correlation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (attr != cudaSuccess) return (int)attr;
  }
  const int groups = ((H + 1) / 2 + Q - 1) / Q;
  const dim3 grid((W + TX - 1) / TX, groups * NDG, B * 2 * split);
  const size_t n = (size_t)B * ND * ND * H * W;
  const float inv_c = 1.f / (float)C;
  float* dst = static_cast<float*>(split > 1 ? scratch : out);
  correlation_kernel<<<grid, NT, SMEM_BYTES, s>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2), dst, B, C, H,
      W, W2, xoff2, chunks_per_part, n, split > 1 ? 1.f : inv_c);
  if (split > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int threads = 256;
    const size_t work = n % 4 == 0 ? n / 4 : n;
    const int blocks = (int)std::min<size_t>((work + threads - 1) / threads, 4096);
    sum_parts_kernel<<<blocks, threads, 0, s>>>(dst, static_cast<float*>(out), n,
                                                split, inv_c);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace v2v

// dtype must be f32 (code 0): the cost volume is taken in f32, as the
// Pallas kernel's preferred_element_type. `split` parts of
// `chunks_per_part` channel chunks each (ops/correlation.py::
// correlation_plan); split > 1 needs `scratch` of split * B * 441 * H * W
// floats, split == 1 none (it may be null).
extern "C" int v2v_correlation(const void* f1, const void* f2, void* out,
                               void* scratch, int B, int C, int H, int W,
                               int split, int chunks_per_part, int dtype,
                               void* stream) {
  return v2v::launch_correlation(f1, f2, out, scratch, B, C, H, W, W, 0, split,
                                 chunks_per_part, dtype, stream);
}

// The column-halo mode of a width shard (training's model axis): f1 the
// shard's (B, C, H, W) columns, f2 (B, C, H, W + 40) its columns with 20
// more on each side (the neighbours' columns, zeros past the image's
// edges: parallel/halo.py::padded), out the shard's (B, 441, H, W)
// columns of the whole image's cost volume. The rows are padded here, as
// v2v_correlation pads them; the grid and its plan are v2v_correlation's
// at width W.
extern "C" int v2v_correlation_cols(const void* f1, const void* f2, void* out,
                                    void* scratch, int B, int C, int H, int W,
                                    int split, int chunks_per_part, int dtype,
                                    void* stream) {
  using namespace v2v;
  return launch_correlation(f1, f2, out, scratch, B, C, H, W, W + 2 * MD, MD, split,
                            chunks_per_part, dtype, stream);
}

// The backward: f1, f2 (B, C, H, W), g (B, 441, H, W), all f32 and
// contiguous; writes df1 and df2 (B, C, H, W) in one launch
// (ops/correlation.py::correlation_bwd_plan mirrors its grid).
extern "C" int v2v_correlation_bwd(const void* f1, const void* f2, const void* g,
                                   void* df1, void* df2, int B, int C, int H, int W,
                                   int dtype, void* stream) {
  using namespace v2v;
  if (dtype != kFloat32 || C <= 0) return (int)cudaErrorInvalidValue;
  if (B * H * W == 0) return (int)cudaSuccess;  // nothing to launch
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int x_tiles = (W + BTX - 1) / BTX;
  const int groups = ((H + 1) / 2 + BQ - 1) / BQ;
  if ((long long)groups * x_tiles > 65535 || (long long)B * 4 > 65535)
    return (int)cudaErrorInvalidValue;
  if (BSMEM_BYTES > 48 * 1024) {  // above the default limit: ask for it
    const cudaError_t attr = cudaFuncSetAttribute(
        correlation_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BSMEM_BYTES);
    if (attr != cudaSuccess) return (int)attr;
  }
  float* o1 = static_cast<float*>(df1);
  float* o2 = static_cast<float*>(df2);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = W % 4 == 0 && aligned(o1) && aligned(o2);
  const dim3 grid((C + BCB - 1) / BCB, groups * x_tiles, B * 4);
  correlation_bwd_kernel<<<grid, BNT, BSMEM_BYTES, s>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2),
      static_cast<const float*>(g), o1, o2, B, C, H, W, x_tiles, 1.f / (float)C, vec);
  return (int)cudaGetLastError();
}
