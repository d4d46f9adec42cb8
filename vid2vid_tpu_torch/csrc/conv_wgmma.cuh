// The bf16 stride-1 KxK convolution (K = 3, 7) with a fused epilogue on
// Hopper's tensor cores: respair.cu makes its two bf16 launches through it
// (K = 3, reflect), conv.cu its bf16 conv3 / conv3_fused entries (K = 3,
// pre-padded input) and its bf16 conv7 entries (K = 7, both).
//
//     out[b,co,y,x] = epi( sum_{ci,ky,kx} in[b,ci,y',x'] * w[co,ci,ky,kx] )
//     epi(v) = v * scale[co] + offset[co]  [+ residual[b,co,y,x]]  [ReLU]
//
// on the f32 accumulator (scale, offset optional: 1 and 0; conv7's bias is
// the offset), stored in bf16. With P = K / 2, REFLECT reads
// in[refl(y+ky-P), refl(x+kx-P)] from an unpadded (H, W) input (i < 0 ->
// -i, i >= N -> 2N-2-i); otherwise in is pre-padded, (H+K-1, W+K-1), and
// read at (y+ky, x+kx).
//
// An implicit GEMM, M = output pixels, N = Co, K*K * Ci deep, on `wgmma`
// (bf16 operands from shared memory, f32 accumulators in registers). A
// block owns TH = 2 * RW output rows x 64 columns x BN output channels and
// runs three warpgroups:
//   - two consumers, each owning RW rows of 64 pixels (one m64nBNk16
//     accumulator per row), which run K*K * RW wgmmas per 16 input
//     channels;
//   - one producer, which fills a ring of operand stages, one per 16 input
//     channels: the input halo tile (TH + K - 1 rows) and the weights of
//     those channels for all K*K taps.
// Stages are handed over with mbarriers, `full` (the producer's 128 threads
// after their stores, plus the weights' bytes) and `empty` (one arrival
// per consumer warpgroup, once the wgmmas reading the stage completed).
//
// The layout that lets the taps read one staged tile: the halo is K-major
// and channel-interleaved, [ci / 8][halo row][column][8 channels], so 8
// consecutive pixels of a row are one 128-byte core matrix of the
// no-swizzle wgmma layout, a one-pixel shift is +16 bytes and a row
// +AW * 16: tap (ky, kx) of tile row r is a descriptor at (r + ky, first
// column + kx), with SBO = 128 bytes between 8-pixel blocks and LBO = one
// channel group's plane between the two 8-channel halves of K. The halo's
// columns x0 - P .. x0 + 63 + P fit the AW = 80 columns of the tile for
// both K. NCHW cannot be copied into it, so the producer stages the input
// first, as in memory: [halo row][16 channels][SW columns from x0 - 8].
// Where the rows are 16-byte aligned (W % 8 == 0 with the reflect pad: the
// main path), one tensor-map load per halo row fetches them (the reflect of
// the row in its coordinate, zeros outside the image), else cp.asyncs of 8
// or 4 bytes, else 2-byte loads; a second ring holds MAX_STG staged chunks
// in flight, so their latency overlaps the products. Each 8-channel x
// 8-pixel block then goes from the staging slot into the tile through one
// transposed ldmatrix read (the staging rows of 176 bytes keep its 8 rows
// on distinct banks) and 4-byte stores, with offsets computed once per
// block; the reflect of columns -P .. -1 and W .. W + P - 1 is then copied
// in at the image's left and right tiles. The weights are packed once by
// the caller (ops/conv7.py::pack_taps) into [Ci_pad / 8][tap][Co_pad][8]
// (Ci_pad a multiple of 16, Co_pad of 8, zero-filled); a stage takes one
// tensor-map box [K*K taps][BN][8] per 8-channel group, zero past Co_pad:
// the same no-swizzle K-major layout (SBO 128, LBO K*K * BN * 16).
// Every core matrix is 128 contiguous bytes, so the wgmma reads are free of
// bank conflicts; so are the 4-byte transposed stores and the epilogue's
// tile writes (row stride BM + 4 words).
//
// K = 3. From Ci = 128 up, the blocks of a cluster of two (adjacent pixel
// tiles, the same output channels) each load one of the two groups and
// multicast it to both, halving the weights' L2 reads; each block's stages
// are then released by the consumers of both (`empty` counts both blocks).
// What bounds it: at the 2048-pixel scale and C = 1024 at 64x64 the blocks
// re-read the weights of their BN channels and the input rows of their
// pixels through the L2, so the tile is chosen for the L2 traffic it
// causes (`conv3`); at the large images with few input channels, the fixed
// cost of a block (the first loads, the epilogue) at one block per SM.
//
// K = 7. The 49 taps of 16 channels are 49 * BN * 32 bytes of weights per
// stage: at BN = 128 that is 200 KB of the 227 KB a block has. The weights
// stay whole in each stage (one tensor-map box, as at K = 3) and BN stays
// at 32 or below (50 KB, two stages beside a 14-row halo), more blocks
// along N covering a wider Co; the alternative, a second ring staging the
// weights by kernel row against a halo that stays for seven rows, would
// allow BN = 128 but hands a stage over seven times per chunk. Each stage
// then carries 49 * RW wgmmas per consumer against one halo transpose, 5x
// the 3x3's work per stage. What bounds it: at the composite's shapes
// (Ci = 108 or 6 label and frame stems, Co = 1..128) the MMAs at N <= 32,
// whose A operand (64 x 16 per instruction) is read from shared memory
// for every 8 to 32 columns of N; the Co = 1, 2, 3 heads fill 1/8 to 3/8
// of an n8 wgmma, and Ci = 6 is 6/16 of a K step.
//
// The epilogue: both consumers stop reading the stages (a named barrier),
// write the f32 accumulators into the freed ring as a [co][pixel] tile,
// and all 256 threads apply the epilogue along pixels, reading the
// residual and storing the output 16 bytes (8 pixels) at a time where W %
// 8 == 0, element by element otherwise.
//
// Any B, Ci, Co and H, W (> P with reflect, >= 1 pre-padded) are taken:
// channels past Ci are zero in the tile and the packed weights, columns
// past Co and pixels past H, W are computed on clamped inputs and never
// stored.
#pragma once

#include <cuda.h>  // CUtensorMap; its encoder is looked up at run time
#include <dlfcn.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace v2v {
namespace cw {

constexpr int TW = 64;                // output columns per tile: one wgmma M
constexpr int N_CONSUMERS = 2;        // consumer warpgroups
constexpr int NTHREADS = 128 * (N_CONSUMERS + 1);
constexpr int MAX_STAGES = 4;         // the ring of wgmma operand stages
constexpr int MAX_STG = 4;            // the ring of input staging slots
constexpr int SW = 88;  // staged input columns, x0 - 8 .. x0 + 79: 176-byte
                        // rows keep the transpose's 8-row reads conflict-free
constexpr int AW = 80;  // columns of the wgmma halo tile: staged 0 .. 79
constexpr int BARRIER_BYTES = 128;    // the mbarriers, before the stages
constexpr int SMEM_MAX = 232448;      // dynamic shared memory of one block

template <int K, int BN, int RW>
struct Cfg {
  static constexpr int P = K / 2;                     // the pad
  static constexpr int TAPS = K * K;
  static constexpr int TH = N_CONSUMERS * RW;         // output rows per tile
  static constexpr int HR = TH + K - 1;               // halo rows
  static constexpr int BM = TH * TW;                  // output pixels
  static constexpr int HALO_PIX = HR * AW;            // per 8-channel group
  static constexpr int A_BYTES = 2 * HALO_PIX * 16;   // 16 channels
  static constexpr int B_BYTES = 2 * TAPS * BN * 16;  // 2 groups x K*K taps
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int OUT_STRIDE = BM + 4;           // f32 words per co
  static constexpr int OUT_BYTES = BN * OUT_STRIDE * 4;
  static constexpr int STG_ELEMS = HR * 16 * SW;      // one staging slot
  static_assert(A_BYTES % 128 == 0 && B_BYTES % 128 == 0, "stage alignment");
  static_assert(TW + K - 1 + 8 - P <= AW, "the halo's columns fit the tile");
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// one arrival on the barrier at the same offset in cluster block `rank`
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}

// every thread of both blocks of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one box of a 4-D tensor map from global memory into the shared memory of
// every block of the cluster in `mask`, at the same offset, completing on
// the barrier at bar's offset in each
__device__ __forceinline__ void tma_load_4d_multicast(
    void* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
    uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "h"(mask)
      : "memory");
}

// one box of a 4-D tensor map from global to shared memory, completing on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// V bytes (4 or 8, aligned) from global to shared memory, asynchronously
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(V)
               : "memory");
}

// one arrival on bar once this thread's cp.asyncs so far have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// four 8x8 b16 matrices, transposed: lane l gets, of matrix i, column l / 4
// of rows 2 (l % 4) and 2 (l % 4) + 1; lanes 8i .. 8i + 7 address its rows
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* v,
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
      : "r"(smem_u32(row)));
}

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// make this thread's shared-memory stores visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * N_CONSUMERS) : "memory");
}

// a no-swizzle K-major wgmma operand: 8-row core matrices of 16 bytes a
// row; lbo: bytes between the two 8-element halves of K; sbo: bytes between
// 8-row blocks of M (or N)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across the async MMAs
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] += A[64 x 16] * B[16 x N]: bf16 operands from shared memory
// (descriptors a, b), f32 accumulators; d[4k + 2i + j] holds row
// 16 * warp + lane / 4 + 8i, column 8k + 2 * (lane % 4) + j
template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma<8>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<16>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// ------------------------------------------------------------- kernel

// Stage chunk c's input rows into a staging slot, [halo row][16 channels]
// [SW columns from x0 - 8], with V-byte cp.asyncs (V = 4, 8), or
// element by element (V = 2, synchronous) where the rows are not aligned
// (the tensor map's path, when the rows are 16-byte aligned, is in
// `produce`). Channels past Ci and columns outside the input are left as
// they are: the transpose writes zeros for the first and never reads the
// second for a stored output.
template <int K, int HR, int V, bool REFLECT>
__device__ __forceinline__ void fill(const uint16_t* __restrict__ in_b,
                                     uint16_t* stg, int c, int Ci, int H,
                                     int h_in, int w_in, size_t plane, int y0,
                                     int x0, int pt) {
  constexpr int E = V / 2;                     // elements per copy
  constexpr int NC = SW / E;                   // copies per staged row
  constexpr int LPR = NC <= 16 ? 16 : 32;      // lanes per staged row
  constexpr int RPW = 32 / LPR;                // rows per warp at a time
  constexpr int PASSES = (NC + LPR - 1) / LPR;
  const int lane = pt % 32;
  // staged row rr = (halo row) * 16 + channel: the warps take them in turn
  for (int rr = pt / 32 * RPW + lane / LPR; rr < HR * 16; rr += 4 * RPW) {
    const int r = rr / 16, ci = c * 16 + rr % 16;
    if (ci >= Ci) continue;
    const int gy =
        REFLECT ? reflect_clamp(y0 - K / 2 + r, H) : min(y0 + r, h_in - 1);
    const uint16_t* src = in_b + (size_t)ci * plane + (size_t)gy * w_in;
#pragma unroll
    for (int k = 0; k < PASSES; ++k) {
      const int q = lane % LPR + k * LPR;
      const int x = x0 - 8 + q * E;
      if (q >= NC || x < 0 || x + E > w_in) continue;
      if constexpr (V == 2)
        stg[rr * SW + q * E] = __ldg(src + x);
      else
        cp_async<V>(stg + rr * SW + q * E, src + x);
    }
  }
}

// The halo tile of a staged chunk in the wgmma layout, [8-channel group j]
// [halo row][AW columns][8 channels], column for column as staged. The
// 8x8 blocks (8 channels x 8 pixels) go in groups of four, (j, q) = (0, 2g),
// (0, 2g + 1), (1, 2g), (1, 2g + 1) of halo row r: one transposed ldmatrix
// read each, after which lane l holds pixel l / 4 of channels 2 (l % 4) and
// 2 (l % 4) + 1 of every block and stores them as 4 bytes (zero past Ci).
// A warp takes the groups warp, warp + 4, ...: their offsets are the
// same for every chunk and are computed once (`Transpose`). HR: halo rows.
template <int HR>
struct Transpose {
  static constexpr int GROUPS = HR * AW / 16;
  static constexpr int ITER = (GROUPS + 3) / 4;  // groups per warp, at most
  static constexpr int PLANE = HR * AW * 16;     // bytes per channel group
  uint32_t src[ITER], dst[ITER];  // staged element offset, tile byte offset
  int n;                          // this warp's groups

  __device__ __forceinline__ Transpose(int pt) {
    const int warp = pt / 32, lane = pt % 32;
    const int i = lane / 8;  // the block whose row this lane addresses
    n = (GROUPS - warp + 3) / 4;
#pragma unroll
    for (int k = 0; k < ITER; ++k) {
      const int gg = warp + 4 * k, r = gg / (AW / 16), g = gg % (AW / 16);
      src[k] = (r * 16 + (i / 2) * 8 + lane % 8) * SW + (2 * g + i % 2) * 8;
      dst[k] = (r * AW + 16 * g) * 16 + lane * 4;
    }
  }

  __device__ __forceinline__ void operator()(const uint16_t* stg, uint8_t* sa,
                                             int c, int Ci, int lane) const {
    const int ch = c * 16 + 2 * (lane % 4);  // channel group j = 0; j = 1: + 8
    const uint32_t m0 = ch + 1 < Ci ? ~0u : ch < Ci ? 0xFFFFu : 0u;
    const uint32_t m1 = ch + 9 < Ci ? ~0u : ch + 8 < Ci ? 0xFFFFu : 0u;
#pragma unroll
    for (int k = 0; k < ITER; ++k) {
      if (k >= n) break;
      uint32_t v[4];
      ldmatrix_x4_trans(v, stg + src[k]);
      uint8_t* d = sa + dst[k];
      *reinterpret_cast<uint32_t*>(d) = v[0] & m0;
      *reinterpret_cast<uint32_t*>(d + 128) = v[1] & m0;
      *reinterpret_cast<uint32_t*>(d + PLANE) = v[2] & m1;
      *reinterpret_cast<uint32_t*>(d + PLANE + 128) = v[3] & m1;
    }
  }
};

// With the reflect pad, the halo's x = -k and x = W - 1 + k, k = 1 .. P
// (zeros or stale where they were staged; staged column 8 is x0) take
// x = k and x = W - 1 - k: P 16-byte entries per (channel group, halo row,
// side), after every transposed store. A tile reads columns up to
// x0 + TW - 1 + P, so the right side is reflected where W - x0 <= TW - 1 + P.
template <int K, int HR>
__device__ __forceinline__ void reflect_columns(uint8_t* sa, int W, int x0,
                                                int pt) {
  constexpr int P = K / 2;
  const bool left = x0 == 0, right = W - x0 <= TW - 1 + P;
  if (!left && !right) return;  // an interior tile
  producers_sync();
  if (pt < 2 * HR * 2) {
    uint4* a = reinterpret_cast<uint4*>(sa) + (pt / 2) * AW;
#pragma unroll
    for (int k = 1; k <= P; ++k) {
      if (pt % 2 == 0 && left) a[8 - k] = a[8 + k];
      if (pt % 2 == 1 && right) a[W - x0 + 7 + k] = a[W - x0 + 7 - k];
    }
  }
}

// The producer warpgroup. The input is staged n_stg chunks ahead, each
// halo row by one tensor-map load (vbytes = 0: rows 16-byte aligned) or by
// cp.asyncs, landing on `landed`, so its latency overlaps the products; per
// chunk it waits for a free operand stage, starts the weights' tensor-map
// load into it, transposes the staged halo into it and arrives on `full`.
template <int K, int BN, int RW, bool REFLECT, int CL>
__device__ __forceinline__ void produce(
    const uint16_t* __restrict__ in, const CUtensorMap* imap,
    const CUtensorMap* wmap,
    uint8_t* stages, uint16_t* staging, uint64_t* full, uint64_t* empty,
    uint64_t* landed, int n_stages, int n_stg, int vbytes, int Ci, int H,
    int W, int y0, int x0, int co0, int b, uint32_t rank) {
  using C = Cfg<K, BN, RW>;
  constexpr int HR = C::HR;
  const int pt = threadIdx.x - 128 * N_CONSUMERS;
  const int n_chunks = (Ci + 15) / 16;
  const int h_in = REFLECT ? H : H + K - 1;
  const int w_in = REFLECT ? W : W + K - 1;
  const size_t plane = (size_t)h_in * w_in;
  const uint16_t* in_b = in + (size_t)b * Ci * plane;

  auto stage_input = [&](int c, int d) {
    uint16_t* stg = staging + d * C::STG_ELEMS;
    if (vbytes == 0) {
      if (pt == 0) {
        mbar_arrive_expect_tx(&landed[d], C::STG_ELEMS * 2);
        for (int r = 0; r < HR; ++r) {
          const int gy = REFLECT ? reflect_clamp(y0 - C::P + r, H)
                                 : min(y0 + r, h_in - 1);
          tma_load_4d(stg + r * 16 * SW, imap, x0 - 8, gy, c * 16, b,
                      &landed[d]);
        }
      }
      return;
    }
    switch (vbytes) {
      case 8:
        fill<K, HR, 8, REFLECT>(in_b, stg, c, Ci, H, h_in, w_in, plane, y0, x0,
                                pt);
        break;
      case 4:
        fill<K, HR, 4, REFLECT>(in_b, stg, c, Ci, H, h_in, w_in, plane, y0, x0,
                                pt);
        break;
      default:
        fill<K, HR, 2, REFLECT>(in_b, stg, c, Ci, H, h_in, w_in, plane, y0, x0,
                                pt);
    }
    if (vbytes >= 4)
      mbar_arrive_cp_async(&landed[d]);
    else
      mbar_arrive(&landed[d]);
  };

  const Transpose<HR> transpose(pt);
  for (int c = 0; c < min(n_stg, n_chunks); ++c) stage_input(c, c);
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % n_stages;
    const int n = c / n_stages;
    if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
    uint8_t* sa = stages + (size_t)s * C::STAGE_BYTES;
    uint8_t* sb = sa + C::A_BYTES;
    if (pt == 0) {  // the weights of channel groups 2c, 2c + 1, all taps
      mbar_arrive_expect_tx(&full[s], C::B_BYTES);
      if constexpr (CL == 2) {  // group 2c + rank, into both blocks
        tma_load_4d_multicast(sb + rank * C::TAPS * BN * 16, wmap, 0, co0, 0,
                              2 * c + rank, &full[s], 0b11);
      } else {  // both groups: the map's box is two groups deep
        tma_load_4d(sb, wmap, 0, co0, 0, 2 * c, &full[s]);
      }
    }
    const int d = c % n_stg;
    mbar_wait(&landed[d], (c / n_stg) & 1);
    transpose(staging + d * C::STG_ELEMS, sa, c, Ci, pt % 32);
    if (REFLECT) reflect_columns<K, HR>(sa, W, x0, pt);
    fence_proxy_async();
    mbar_arrive(&full[s]);
    producers_sync();  // every producer thread is done with slot d
    if (c + n_stg < n_chunks) stage_input(c + n_stg, d);
  }
}

// The consumer warpgroups: RW rows of 64 pixels x BN channels each, chunk
// by chunk, then the epilogue. Each warpgroup releases a stage to the
// producer of every block of the cluster (the weights of a stage arrive
// in all of them).
template <int K, int BN, int RW, bool REFLECT, int CL>
__device__ __forceinline__ void consume(
    uint8_t* stages, uint64_t* full, uint64_t* empty, int n_stages,
    const float* __restrict__ scale, const float* __restrict__ offset,
    const __nv_bfloat16* __restrict__ residual,
    __nv_bfloat16* __restrict__ out, int Ci, int Co, int H, int W, int y0,
    int x0, int co0, int b, int relu, int vec, uint32_t rank) {
  using C = Cfg<K, BN, RW>;
  const int wg = threadIdx.x / 128;
  const int n_chunks = (Ci + 15) / 16;
  float acc[RW][BN / 2];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0.f;

  const uint32_t ring = smem_u32(stages);
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % n_stages;
    mbar_wait(&full[s], (c / n_stages) & 1);
    const uint32_t a_base = ring + s * C::STAGE_BYTES;
    const uint32_t b_base = a_base + C::A_BYTES;
#pragma unroll
    for (int r = 0; r < RW; ++r) fence_regs<BN / 2>(acc[r]);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < C::TAPS; ++t) {
      const uint64_t db =
          desc(b_base + t * BN * 16, C::TAPS * BN * 16, 128);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        // halo row and column of tap t: staged column 8 is x0 (reflect: of
        // the input; pre-padded: of the padded input, x0 - P of the image)
        const int row = wg * RW + r + t / K;
        const int col = (REFLECT ? 8 - C::P : 8) + t % K;
        const uint64_t da =
            desc(a_base + (row * AW + col) * 16, C::HALO_PIX * 16, 128);
        wgmma<BN>(acc[r], da, db);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int r = 0; r < RW; ++r) fence_regs<BN / 2>(acc[r]);
    wgmma_wait<1>();  // the previous chunk's products are done
    if (c > 0 && threadIdx.x % 128 == 0) {  // for the whole warpgroup
      mbar_arrive(&empty[(c - 1) % n_stages]);
      if constexpr (CL == 2) mbar_arrive_cluster(&empty[(c - 1) % n_stages], rank ^ 1);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < RW; ++r) fence_regs<BN / 2>(acc[r]);

  // ---- epilogue: the accumulators as a [co][pixel] f32 tile in the ring
  consumers_sync();  // neither consumer reads the stages any more
  float* tile = reinterpret_cast<float*>(stages);
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int m0 = (wg * RW + r) * TW + warp * 16 + lane / 4;
#pragma unroll
    for (int k = 0; k < BN / 8; ++k)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          tile[(8 * k + 2 * (lane % 4) + j) * C::OUT_STRIDE + m0 + 8 * i] =
              acc[r][4 * k + 2 * i + j];
  }
  consumers_sync();

  // 8 pixels of one output row and channel per item, NI items per thread,
  // in groups of NG: the group's residual loads are issued before its
  // first store
  constexpr int NI = BN * C::TH * 8 / (128 * N_CONSUMERS);
  constexpr int NG = NI < 4 ? NI : 4;
  static_assert(NI * 128 * N_CONSUMERS == BN * C::TH * 8, "epilogue items");
#pragma unroll 1
  for (int i0 = 0; i0 < NI; i0 += NG) {
    uint4 res[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int item = threadIdx.x + (i0 + i) * 128 * N_CONSUMERS;
      const int co = co0 + item / (C::TH * 8);
      const int y = y0 + (item / 8) % C::TH;
      const int x = x0 + (item % 8) * 8;
      res[i] = make_uint4(0, 0, 0, 0);
      if (vec && residual != nullptr && co < Co && y < H && x + 8 <= W)
        res[i] = __ldg(reinterpret_cast<const uint4*>(
            residual + (((size_t)b * Co + co) * H + y) * W + x));
    }
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int item = threadIdx.x + (i0 + i) * 128 * N_CONSUMERS;
      const int n = item / (C::TH * 8);
      const int tr = (item / 8) % C::TH;
      const int x = x0 + (item % 8) * 8;
      const int co = co0 + n;
      const int y = y0 + tr;
      if (co >= Co || y >= H || x >= W) continue;
      const float so = scale != nullptr ? scale[co] : 1.f;
      const float oo = offset != nullptr ? offset[co] : 0.f;
      const float* src = tile + n * C::OUT_STRIDE + tr * TW + (x - x0);
      const size_t base = (((size_t)b * Co + co) * H + y) * W + x;
      if (vec && x + 8 <= W) {
        const float4 lo = reinterpret_cast<const float4*>(src)[0];
        const float4 hi = reinterpret_cast<const float4*>(src)[1];
        float val[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const uint32_t rw[4] = {res[i].x, res[i].y, res[i].z, res[i].w};
        uint32_t ow[4];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          val[e] = fmaf(val[e], so, oo);
          if (residual != nullptr)  // a bf16 is the high half of its float
            val[e] += __uint_as_float(e % 2 ? rw[e / 2] & 0xFFFF0000u
                                            : rw[e / 2] << 16);
          if (relu) val[e] = fmaxf(val[e], 0.f);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 pair =
              __floats2bfloat162_rn(val[2 * e], val[2 * e + 1]);
          memcpy(&ow[e], &pair, 4);
        }
        *reinterpret_cast<uint4*>(out + base) =
            make_uint4(ow[0], ow[1], ow[2], ow[3]);
      } else {
        for (int e = 0; e < 8 && x + e < W; ++e) {
          float val = fmaf(src[e], so, oo);
          if (residual != nullptr) val += __bfloat162float(residual[base + e]);
          if (relu) val = fmaxf(val, 0.f);
          out[base + e] = __float2bfloat16(val);
        }
      }
    }
  }
}

// CL blocks per cluster (1 or 2): with 2, the blocks of a pair (adjacent
// pixel tiles, the same output channels) load half of each stage's weights
// each and multicast it to both.
template <int K, int BN, int RW, bool REFLECT, int CL>
__global__ void __launch_bounds__(NTHREADS, 1)
conv_wgmma_kernel(const __nv_bfloat16* __restrict__ in,
                   const __grid_constant__ CUtensorMap imap,
                   const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ scale,
                   const float* __restrict__ offset,
                   const __nv_bfloat16* __restrict__ residual,
                   __nv_bfloat16* __restrict__ out, int Ci, int Co, int H,
                   int W, int tiles_x, int n_stages, int n_stg, int vbytes,
                   int relu, int vec) {
  using C = Cfg<K, BN, RW>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* landed = empty + MAX_STAGES;
  uint8_t* stages = smem + BARRIER_BYTES;
  uint16_t* staging = reinterpret_cast<uint16_t*>(
      stages + max(n_stages * C::STAGE_BYTES, C::OUT_BYTES));

  const int wg = threadIdx.x / 128;
  const uint32_t rank = CL == 2 ? cluster_rank() : 0;
  const int y0 = (blockIdx.x / tiles_x) * C::TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z;

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(&full[s], 128 + 1);  // the producer's threads + the copies
      mbar_init(&empty[s], CL * N_CONSUMERS);  // each consumer warpgroup
    }
    for (int d = 0; d < n_stg; ++d)  // the tensor map's bytes, or 128 threads
      mbar_init(&landed[d], vbytes == 0 ? 1 : 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (CL == 2)
    cluster_sync();  // both blocks' barriers are set up
  else
    __syncthreads();

  if (wg == N_CONSUMERS)
    produce<K, BN, RW, REFLECT, CL>(reinterpret_cast<const uint16_t*>(in),
                                    &imap, &wmap, stages, staging, full, empty,
                                    landed, n_stages, n_stg, vbytes, Ci, H, W,
                                    y0, x0, co0, b, rank);
  else
    consume<K, BN, RW, REFLECT, CL>(stages, full, empty, n_stages, scale,
                                    offset, residual, out, Ci, Co, H, W, y0,
                                    x0, co0, b, relu, vec, rank);
  if constexpr (CL == 2)
    cluster_sync();  // the other block arrives on our barriers until here
}

// ---------------------------------------------------------------- host

// cuTensorMapEncodeTiled, looked up in libcuda (which the CUDA runtime has
// loaded; the library does not link it); null if it is not there
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return reinterpret_cast<EncodeTiled>(
        lib != nullptr ? dlsym(lib, "cuTensorMapEncodeTiled") : nullptr);
  }();
  return fn;
}

inline bool encode_map(CUtensorMap* map, const void* base,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The input, (B, Ci, h_in, w_in) bf16, as a 4-D tensor map whose box is one
// staged halo row: 16 channels x SW columns (zero-filled outside).
inline bool input_map(CUtensorMap* map, const void* in, int B, int Ci,
                      int h_in, int w_in) {
  const cuuint64_t w = w_in, plane = (cuuint64_t)h_in * w_in;
  const cuuint64_t dims[4] = {w, (cuuint64_t)h_in, (cuuint64_t)Ci,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {w * 2, plane * 2, plane * Ci * 2};
  const cuuint32_t box[4] = {SW, 1, 16, 1};
  return encode_map(map, in, dims, strides, box);
}

// The packed weights, [Ci_pad / 8][taps][Co_pad][8] bf16, as a 4-D tensor
// map whose box, [groups][taps][BN][8], is the weights of 8 * groups input
// channels of all taps for BN output channels (zero-filled past Co_pad):
// a stage's with groups = 2, its half with 1.
inline bool weight_map(CUtensorMap* map, const void* wpk, int Ci, int Co,
                       int taps, int bn, int groups) {
  const cuuint64_t n_g = (Ci + 15) / 16 * 2, co_pad = (Co + 7) / 8 * 8;
  const cuuint64_t dims[4] = {8, co_pad, (cuuint64_t)taps, n_g};
  const cuuint64_t strides[3] = {16, co_pad * 16, taps * co_pad * 16};
  const cuuint32_t box[4] = {8, (cuuint32_t)bn, (cuuint32_t)taps,
                             (cuuint32_t)groups};
  return encode_map(map, wpk, dims, strides, box);
}

// The ring sizes of a launch: the operand and staging rings shrink, the
// staging ring first down to two, to fit SMEM_MAX, keeping two operand
// stages where it can (one staging slot then), and one at the least.
template <int K, int BN, int RW>
void rings(int n_chunks, int* n_stages, int* n_stg, int* smem) {
  using C = Cfg<K, BN, RW>;
  *n_stg = std::min(MAX_STG, n_chunks);
  *n_stages = std::min(MAX_STAGES, n_chunks);
  auto bytes = [&] {
    return BARRIER_BYTES + std::max(*n_stages * C::STAGE_BYTES, C::OUT_BYTES) +
           *n_stg * C::STG_ELEMS * 2;
  };
  while (bytes() > SMEM_MAX && *n_stages > 1) {
    if (*n_stg > 2)
      --*n_stg;
    else if (*n_stages > 2)
      --*n_stages;
    else if (*n_stg > 1)
      --*n_stg;
    else
      --*n_stages;
  }
  *smem = bytes();
}

template <int K, int BN, int RW, bool REFLECT, int CL>
int launch_tile(const void* in, const void* wpk, const float* scale,
                 const float* offset, const void* residual, void* out, int B,
                 int Ci, int Co, int H, int W, int relu, int vbytes, int vec,
                 cudaStream_t stream) {
  using C = Cfg<K, BN, RW>;
  int n_stages, n_stg, smem;
  rings<K, BN, RW>((Ci + 15) / 16, &n_stages, &n_stg, &smem);
  CUtensorMap imap{}, wmap;
  if (!weight_map(&wmap, wpk, Ci, Co, C::TAPS, BN, CL == 2 ? 1 : 2) ||
      (vbytes == 0 && !input_map(&imap, in, B, Ci, REFLECT ? H : H + K - 1,
                                 REFLECT ? W : W + K - 1)))
    return (int)cudaErrorNotSupported;
  const auto kernel = conv_wgmma_kernel<K, BN, RW, REFLECT, CL>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + C::TH - 1) / C::TH;
  // clusters of CL along x: a tile count that is not a multiple gets a
  // block past the image (it loads its partner's weights, stores nothing)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles_x * tiles_y + CL - 1) / CL * CL,
                     (Co + BN - 1) / BN, B);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = CL;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = CL > 1;
  return (int)cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(in), imap, wmap, scale,
      offset, static_cast<const __nv_bfloat16*>(residual),
      static_cast<__nv_bfloat16*>(out), Ci, Co, H, W, tiles_x, n_stages, n_stg,
      vbytes, relu, vec);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// How the input of a launch is staged: by the tensor map (0) where every
// row (w_in elements) is 16-byte aligned, else by cp.asyncs of 8 or 4
// bytes, else element by element (2).
inline int staging_bytes(const void* in, int w_in) {
  int vbytes = 16;
  while (vbytes > 2 && ((2 * w_in) % vbytes != 0 || !aligned(in, vbytes)))
    vbytes /= 2;
  return vbytes == 16 ? 0 : vbytes;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The blocks of a grid of tiles (BN channels x 2 * rw rows x TW columns).
inline long long grid_blocks(int B, int Co, int H, int W, int bn, int rw) {
  const long long th = N_CONSUMERS * rw;
  return (long long)((W + TW - 1) / TW) * ((H + th - 1) / th) *
         ((Co + bn - 1) / bn) * B;
}

// One bf16 3x3 launch; wpk is the packed weight (ops/conv3.py::
// pack_conv3_weight). The tile: what the L2 must deliver decides it, since
// every block re-reads the weights of its BN channels and the input rows
// of its pixels. BN is the smallest of 16..128 that covers Co; two rows per
// consumer (RW = 2, 256 pixels: half the weight reads) wherever the grid
// still fills nine tenths of the SMs, also at BN / 2 (the 2048-pixel scale
// at C = 1024 runs 128 blocks of 256 pixels x 64 channels, not 128 of
// 128 x 128); else RW = 1 with BN halved while the grid has fewer blocks
// than half the SMs (C = 512 there: 128 blocks of BN = 64). From Ci = 128
// up at BN >= 64, pairs of blocks share each stage's weights (clusters of
// two): that halves the weight reads again where they dominate; with fewer
// input channels a block is too short to pay for the pairing. Returns the
// launch's error.
template <bool REFLECT>
int conv3(const void* in, const void* wpk, const float* scale,
          const float* offset, const void* residual, void* out, int B, int Ci,
          int Co, int H, int W, int relu, cudaStream_t stream) {
  if (!aligned(wpk, 16)) return (int)cudaErrorMisalignedAddress;
  const int vec = W % 8 == 0 && aligned(out, 16) &&
                  (residual == nullptr || aligned(residual, 16));
  const int vbytes = staging_bytes(in, REFLECT ? W : W + 2);
  const int sms = sm_count();
  auto blocks = [&](int bn, int rw) { return grid_blocks(B, Co, H, W, bn, rw); };
  const long long fill = sms * 9LL / 10;
  int bn = Co <= 16 ? 16 : Co <= 32 ? 32 : Co <= 64 ? 64 : 128;
  bool rw2 = blocks(bn, 2) >= fill;
  if (!rw2 && bn > 16 && blocks(bn / 2, 2) >= fill) {
    bn /= 2;
    rw2 = true;
  }
  while (!rw2 && bn > 16 && blocks(bn, 1) < sms / 2) bn /= 2;
#define V2V_C3_LAUNCH(BN_, RW_, CL_)                                     \
  launch_tile<3, BN_, RW_, REFLECT, CL_>(in, wpk, scale, offset, residual, \
                                         out, B, Ci, Co, H, W, relu, vbytes, \
                                         vec, stream)
  const bool pairs = Ci >= 128;
  switch (bn) {
    case 16: return rw2 ? V2V_C3_LAUNCH(16, 2, 1) : V2V_C3_LAUNCH(16, 1, 1);
    case 32: return rw2 ? V2V_C3_LAUNCH(32, 2, 1) : V2V_C3_LAUNCH(32, 1, 1);
    case 64:
      if (pairs)
        return rw2 ? V2V_C3_LAUNCH(64, 2, 2) : V2V_C3_LAUNCH(64, 1, 2);
      return rw2 ? V2V_C3_LAUNCH(64, 2, 1) : V2V_C3_LAUNCH(64, 1, 1);
    default:
      if (pairs)
        return rw2 ? V2V_C3_LAUNCH(128, 2, 2) : V2V_C3_LAUNCH(128, 1, 2);
      return rw2 ? V2V_C3_LAUNCH(128, 2, 1) : V2V_C3_LAUNCH(128, 1, 1);
  }
#undef V2V_C3_LAUNCH
}

// One bf16 7x7 launch with an optional f32 bias (the epilogue's offset);
// wpk is the packed weight (ops/conv7.py::pack_conv7_weight). A stage
// holds all 49 taps of 16 input channels for BN output channels (49 * BN *
// 32 bytes), so BN is at most 32 (50 KB; BN = 64 would leave room for one
// stage): the smallest of 8, 16, 32 that covers Co, more blocks along N
// beyond. Four rows per consumer (RW = 4: 8 output rows, whose 14-row halo
// is re-read 1.75x through the L2 against 2.5x at 4 rows, and 4 * 49
// wgmmas per stage) wherever that grid fills nine tenths of the SMs, else
// two. Returns the launch's error.
template <bool REFLECT>
int conv7(const void* in, const void* wpk, const float* bias, void* out,
          int B, int Ci, int Co, int H, int W, cudaStream_t stream) {
  if (!aligned(wpk, 16)) return (int)cudaErrorMisalignedAddress;
  const int vec = W % 8 == 0 && aligned(out, 16);
  const int vbytes = staging_bytes(in, REFLECT ? W : W + 6);
  const int bn = Co <= 8 ? 8 : Co <= 16 ? 16 : 32;
  const bool rw4 = grid_blocks(B, Co, H, W, bn, 4) >= sm_count() * 9LL / 10;
#define V2V_C7_LAUNCH(BN_, RW_)                                                \
  launch_tile<7, BN_, RW_, REFLECT, 1>(in, wpk, nullptr, bias, nullptr, out, B, \
                                       Ci, Co, H, W, 0, vbytes, vec, stream)
  switch (bn) {
    case 8: return rw4 ? V2V_C7_LAUNCH(8, 4) : V2V_C7_LAUNCH(8, 2);
    case 16: return rw4 ? V2V_C7_LAUNCH(16, 4) : V2V_C7_LAUNCH(16, 2);
    default: return rw4 ? V2V_C7_LAUNCH(32, 4) : V2V_C7_LAUNCH(32, 2);
  }
#undef V2V_C7_LAUNCH
}

}  // namespace cw
}  // namespace v2v
