// The stride-1 KxK convolution (K = 3, 7) with a fused epilogue on
// Hopper's tensor cores, in bf16 and in f32 (3xTF32): respair.cu makes its
// two launches through it (K = 3, reflect), conv.cu its conv3 /
// conv3_fused entries (K = 3, pre-padded input) and its conv7 entries
// (K = 7, both); the f32 instantiations are built in conv3_tf32x3.cu and
// conv7_tf32x3.cu. Every 3x3 conv runs on it, and every 7x7 but the f32
// ones where ops/conv7.py::conv7_body picks the CUDA cores (conv_kxk.cuh).
//
//     out[b,co,y,x] = epi( sum_{ci,ky,kx} in[b,ci,y',x'] * w[co,ci,ky,kx] )
//     epi(v) = v * scale[co] + offset[co]  [+ residual[b,co,y,x]]  [ReLU]
//
// on the f32 accumulator (scale, offset optional: 1 and 0; conv7's bias is
// the offset), stored in the input's type. With P = K / 2, REFLECT reads
// in[refl(y+ky-P), refl(x+kx-P)] from an unpadded (H, W) input (i < 0 ->
// -i, i >= N -> 2N-2-i); otherwise in is pre-padded, (H+K-1, W+K-1), and
// read at (y+ky, x+kx).
//
// The column-halo mode of a width shard (parallel/halo.py; `Cols`): the
// input rows hold w_in columns, output column x reads input column x +
// xoff (+ kx - P), and the output rows are ldo long (the residual's too).
// With REFLECT a column is reflected only on a side that `edges` marks as
// the image's edge (bit 0 left, bit 1 right: about the output's first or
// last column); elsewhere the input carries that side's neighbour columns
// (a halo of P or more). The unsharded call is xoff 0, w_in W (pre-padded:
// W + K - 1), ldo W, both edges: the same instructions on the same values.
//
// An implicit GEMM, M = output pixels, N = Co, K*K * Ci deep, on `wgmma`
// (operands from shared memory, f32 accumulators in registers). A block
// owns TH = 2 * RW output rows x 64 columns x BN output channels and runs
// three warpgroups:
//   - two consumers, each owning RW rows of 64 pixels (one m64nBN
//     accumulator per row), which run K*K * RW wgmmas per chunk (bf16: 16
//     input channels, k16; f32: 8, k8, three wgmmas each, below);
//   - one producer, which fills a ring of operand stages, one per chunk:
//     the input halo tile (TH + K - 1 rows) and the weights of those
//     channels for all K*K taps.
// Stages are handed over with mbarriers, `full` (the producer's 128 threads
// after their stores, plus the weights' bytes) and `empty` (one arrival
// per consumer warpgroup, once the wgmmas reading the stage completed).
//
// The layout that lets the taps read one staged tile: the halo is K-major
// and channel-interleaved, [channel group][halo row][column][GC channels]
// with 16 bytes a pixel (GC = 8 bf16 or 4 f32 channels), so 8 consecutive
// pixels of a row are one 128-byte core matrix of the no-swizzle wgmma
// layout, a one-pixel shift is +16 bytes and a row +AW * 16: tap (ky, kx)
// of tile row r is a descriptor at (r + ky, first column + kx), with SBO =
// 128 bytes between 8-pixel blocks and LBO = one channel group's plane
// between the two groups of a K step. The halo's columns x0 - P .. x0 + 63
// + P fit the AW = 80 columns of the tile for both K. NCHW cannot be
// copied into it, so the producer stages the input first, as in memory:
// [halo row][chunk's channels][SW columns from x0 - 8]. Where the rows are
// 16-byte aligned (the main path), one tensor-map load per halo row fetches
// them (the reflect of the row in its coordinate, zeros outside the image),
// else cp.asyncs of 8 or 4 bytes, else (bf16) 2-byte loads; a second ring
// holds MAX_STG staged chunks in flight, so their latency overlaps the
// products. bf16: each 8-channel x 8-pixel block then goes from the staging
// slot into the tile through one transposed ldmatrix read (the staging
// rows of 176 bytes keep its 8 rows on distinct banks) and 4-byte stores,
// with offsets computed once per block. The reflect of columns -P .. -1
// and W .. W + P - 1 is then copied in at the image's left and right
// tiles. The weights are packed once by the caller (ops/conv7.py::
// pack_taps) into [Ci_pad / 8][tap][Co_pad][8] (Ci_pad a multiple of 16,
// Co_pad of 8, zero-filled); a stage takes one tensor-map box [K*K taps]
// [BN][8] per 8-channel group, zero past Co_pad: the same no-swizzle
// K-major layout (SBO 128, LBO K*K * BN * 16). Every core matrix is 128
// contiguous bytes, so the wgmma reads are free of bank conflicts; so are
// the 4-byte transposed stores and the epilogue's tile writes (row stride
// BM + 4 words).
//
// f32 as 3xTF32. A single TF32 pass keeps 10 mantissa bits of each
// operand; the f32 paths keep f32-class products, so every operand is
// split into two tf32 parts, big = tf32(x) and small = tf32(x - big)
// (cvt.rna: to nearest, ties away from zero; x - big is exact), and each
// tap runs A_small B_big + A_big B_small + A_big B_big into the same
// accumulator, small terms first (A_small B_small, below f32's rounding,
// is dropped): products within ~2**-21 of their value, at a third of the
// 495 TFLOP/s TF32 rate, against 67 for FFMA on the CUDA cores. tf32
// operands from shared memory must both be K-major (there is no transpose
// flag); the layout above is, with 4 channels to a 16-byte core-matrix row
// and a k8 step of two 4-channel groups, so a chunk is 8 channels. The
// staged input is f32 (the same bytes per chunk as bf16's 16 channels).
// ldmatrix moves 16-bit elements only, so the producer's transpose is its
// own (SplitTranspose): a thread reads the 4 channels of one pixel with
// 4-byte loads (consecutive threads, consecutive columns: distinct banks),
// splits them, and stores one 16-byte entry per part into the tile,
// [part][group][halo row][AW][4]. The weights come split by the caller
// (ops/conv7.py::pack_taps_3xtf32: [Ci_pad / 4][part][tap][Co_pad][4],
// twice the f32 weight's bytes, cached by the eval ResnetBlock and
// ReflectConv7 as the bf16 packing is), one tensor-map box [2 groups x 2
// parts][K*K][BN][4] per stage. A stage of 8 f32 channels holds twice the
// bytes of 16 bf16 ones, so the tiles are smaller (below).
//
// K = 3. From Ci = 128 up, the blocks of a cluster of two (adjacent pixel
// tiles, the same output channels) each load one of the two groups and
// multicast it to both, halving the weights' L2 reads; each block's stages
// are then released by the consumers of both (`empty` counts both blocks).
// What bounds it: at the 2048-pixel scale and C = 1024 at 64x64 the blocks
// re-read the weights of their BN channels and the input rows of their
// pixels through the L2, so the tile is chosen for the L2 traffic it
// causes (`conv3`); at the large images with few input channels, the fixed
// cost of a block (the first loads, the epilogue) at one block per SM. In
// f32 each k8 product also reads its A (2 KB) and B operands from shared
// memory: at N = 128 6 KB for 64 tensor-core cycles, at N = 64 4 KB for 32.
//
// K = 7. The 49 taps of a chunk are 49 * BN * 32 bytes of weights per
// stage (bf16; f32 the same per 8 channels, times two parts): at BN = 128
// that is 200 KB of the 227 KB a block has. The weights stay whole in each
// stage (one tensor-map box, as at K = 3) and BN stays at 32 or below
// (bf16: 50 KB, two stages beside a 14-row halo; f32: 100 KB, one stage
// beside a 10-row halo of two parts, released by its consumers only once
// its products are done), more blocks along N covering a wider Co; the
// alternative, a second ring staging the weights by kernel row against a
// halo that stays for seven rows, would allow BN = 128 but hands a stage
// over seven times per chunk. Each stage then carries 49 * RW wgmmas (f32:
// three times that) per consumer against one halo transpose. What bounds
// it: at the composite's shapes (Ci = 108 or 6 label and frame stems, Co =
// 1..128) the MMAs at N <= 32, whose A operand (64 x 16 bf16 or 64 x 8 f32
// per instruction) is read from shared memory for every 8 to 32 columns of
// N; the Co = 1, 2, 3 heads fill 1/8 to 3/8 of an n8 wgmma, and Ci = 6 is
// 6/16 of a K step (Ci = 3 in f32, 3/8).
//
// The epilogue: both consumers stop reading the stages (a named barrier),
// write the f32 accumulators into the freed ring as a [co][pixel] tile,
// and all 256 threads apply the epilogue along pixels, reading the
// residual and storing the output 16 bytes at a time where W % 8 == 0
// (bf16: 8 pixels; f32: two stores of 4), element by element otherwise.
//
// Any B, Ci, Co and H, W (> P with reflect, >= 1 pre-padded) are taken:
// channels past Ci are zero in the tile and the packed weights, columns
// past Co and pixels past H, W are computed on clamped inputs and never
// stored. A launch the body cannot make (packed weights that are not
// 16-byte aligned, a tensor map that cuTensorMapEncodeTiled refuses)
// returns an error, which the wrappers raise; no other body runs in its
// place.
#pragma once

#include <cuda.h>  // CUtensorMap; its encoder is looked up at run time
#include <dlfcn.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

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

// The element type of a body: bf16, or f32 run as 3xTF32 (F32). A 16-byte
// core-matrix row holds GC channels of one pixel; a chunk (one wgmma K
// step) is CH = 2 * GC channels; F32 keeps each operand as two tf32 parts,
// big and small (PARTS = 2).
template <bool F32>
struct Elem {
  using T = __nv_bfloat16;
  using S = uint16_t;  // its bits, as staged
  static constexpr int BYTES = 2, GC = 8, CH = 16, PARTS = 1;
};
template <>
struct Elem<true> {
  using T = float;
  using S = uint32_t;
  static constexpr int BYTES = 4, GC = 4, CH = 8, PARTS = 2;
};

template <bool F32, int K, int BN, int RW>
struct Cfg {
  using E = Elem<F32>;
  static constexpr int P = K / 2;                     // the pad
  static constexpr int TAPS = K * K;
  static constexpr int TH = N_CONSUMERS * RW;         // output rows per tile
  static constexpr int HR = TH + K - 1;               // halo rows
  static constexpr int BM = TH * TW;                  // output pixels
  static constexpr int HALO_PIX = HR * AW;            // per channel group
  static constexpr int A_PART = 2 * HALO_PIX * 16;    // one chunk, one part
  static constexpr int A_BYTES = E::PARTS * A_PART;   // [part][group]...
  static constexpr int B_GROUP = E::PARTS * TAPS * BN * 16;  // [part][tap]...
  static constexpr int B_BYTES = 2 * B_GROUP;         // [group][part][tap]...
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int OUT_STRIDE = BM + 4;           // f32 words per co
  static constexpr int OUT_BYTES = BN * OUT_STRIDE * 4;
  static constexpr int STG_ELEMS = HR * E::CH * SW;   // one staging slot
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

// The output registers of an m64nN accumulator, d[o] .. d[o + n - 1]
#define V2V_OUT4(o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3])
#define V2V_OUT8(o) V2V_OUT4(o), V2V_OUT4(o + 4)
#define V2V_OUT16(o) V2V_OUT8(o), V2V_OUT8(o + 8)
#define V2V_OUT32(o) V2V_OUT16(o), V2V_OUT16(o + 16)
#define V2V_OUT64(o) V2V_OUT32(o), V2V_OUT32(o + 32)
#define V2V_R4(a, b, c, e) "%" #a ", %" #b ", %" #c ", %" #e
#define V2V_R8 V2V_R4(0, 1, 2, 3) ", " V2V_R4(4, 5, 6, 7)
#define V2V_R16 V2V_R8 ", " V2V_R4(8, 9, 10, 11) ", " V2V_R4(12, 13, 14, 15)
#define V2V_R32                                                     \
  V2V_R16 ", " V2V_R4(16, 17, 18, 19) ", " V2V_R4(20, 21, 22, 23) ", " \
      V2V_R4(24, 25, 26, 27) ", " V2V_R4(28, 29, 30, 31)
#define V2V_R64                                                     \
  V2V_R32 ", " V2V_R4(32, 33, 34, 35) ", " V2V_R4(36, 37, 38, 39) ", " \
      V2V_R4(40, 41, 42, 43) ", " V2V_R4(44, 45, 46, 47) ", "          \
      V2V_R4(48, 49, 50, 51) ", " V2V_R4(52, 53, 54, 55) ", "          \
      V2V_R4(56, 57, 58, 59) ", " V2V_R4(60, 61, 62, 63)

// d[64 x N] += A * B, both operands from shared memory (descriptors a, b),
// f32 accumulators; d[4k + 2i + j] holds row 16 * warp + lane / 4 + 8i,
// column 8k + 2 * (lane % 4) + j. bf16: A is 64 x 16, B 16 x N (k16);
// F32 (tf32 operands, whose low 13 mantissa bits the tensor cores do not
// read): A is 64 x 8, B 8 x N (k8), both K-major, with no transpose flag.
template <bool F32, int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t a, uint64_t b);

#define V2V_WGMMA_ASM(SHAPE, TAIL, REGS, A, B, P, ...)                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"              \
               "wgmma.mma_async.sync.aligned." SHAPE " {" REGS "}, %" #A     \
               ", %" #B ", p, 1, 1" TAIL ";\n}\n"                           \
               : __VA_ARGS__                                                \
               : "l"(a), "l"(b), "r"(1))
#define V2V_WGMMA_DEF(N, REGS, A, B, P, ...)                                  \
  template <>                                                                 \
  __device__ __forceinline__ void wgmma<false, N>(float* d, uint64_t a,       \
                                                  uint64_t b) {               \
    V2V_WGMMA_ASM("m64n" #N "k16.f32.bf16.bf16", ", 0, 0", REGS, A, B, P,     \
                  __VA_ARGS__);                                               \
  }                                                                           \
  template <>                                                                 \
  __device__ __forceinline__ void wgmma<true, N>(float* d, uint64_t a,        \
                                                 uint64_t b) {                \
    V2V_WGMMA_ASM("m64n" #N "k8.f32.tf32.tf32", "", REGS, A, B, P,           \
                  __VA_ARGS__);                                               \
  }
V2V_WGMMA_DEF(8, V2V_R4(0, 1, 2, 3), 4, 5, 6, V2V_OUT4(0))
V2V_WGMMA_DEF(16, V2V_R8, 8, 9, 10, V2V_OUT8(0))
V2V_WGMMA_DEF(32, V2V_R16, 16, 17, 18, V2V_OUT16(0))
V2V_WGMMA_DEF(64, V2V_R32, 32, 33, 34, V2V_OUT32(0))
V2V_WGMMA_DEF(128, V2V_R64, 64, 65, 66, V2V_OUT64(0))
V2V_WGMMA_DEF(136, V2V_R64 ", " V2V_R4(64, 65, 66, 67), 68, 69, 70, V2V_OUT64(0),
              V2V_OUT4(64))
#undef V2V_WGMMA_DEF
#undef V2V_WGMMA_ASM

// x rounded to tf32 (10 explicit mantissa bits, the low 13 bits zero),
// to nearest with ties away from zero: the bits of the f32 result
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// ------------------------------------------------------------- kernel

// Stage chunk c's input rows into a staging slot, [halo row][CH channels]
// [SW columns from xs - 8] (xs: the input column of the tile's first
// output column), with V-byte cp.asyncs (V = 4, 8), or
// element by element (V = 2, bf16, synchronous) where the rows are not
// aligned (the tensor map's path, when the rows are 16-byte aligned, is in
// `produce`). Channels past Ci and columns outside the input are left as
// they are: the transpose writes zeros for the first and never reads the
// second for a stored output.
template <bool F32, int K, int HR, int V, bool REFLECT>
__device__ __forceinline__ void fill(const typename Elem<F32>::S* __restrict__ in_b,
                                     typename Elem<F32>::S* stg, int c, int Ci,
                                     int H, int h_in, int w_in, size_t plane,
                                     int y0, int xs, int pt) {
  constexpr int CH = Elem<F32>::CH;
  constexpr int E = V / Elem<F32>::BYTES;      // elements per copy
  constexpr int NC = SW / E;                   // copies per staged row
  constexpr int LPR = NC <= 16 ? 16 : 32;      // lanes per staged row
  constexpr int RPW = 32 / LPR;                // rows per warp at a time
  constexpr int PASSES = (NC + LPR - 1) / LPR;
  const int lane = pt % 32;
  // staged row rr = (halo row) * CH + channel: the warps take them in turn
  for (int rr = pt / 32 * RPW + lane / LPR; rr < HR * CH; rr += 4 * RPW) {
    const int r = rr / CH, ci = c * CH + rr % CH;
    if (ci >= Ci) continue;
    const int gy =
        REFLECT ? reflect_clamp(y0 - K / 2 + r, H) : min(y0 + r, h_in - 1);
    const auto* src = in_b + (size_t)ci * plane + (size_t)gy * w_in;
#pragma unroll
    for (int k = 0; k < PASSES; ++k) {
      const int q = lane % LPR + k * LPR;
      const int x = xs - 8 + q * E;
      if (q >= NC || x < 0 || x + E > w_in) continue;
      if constexpr (V == 2)
        stg[rr * SW + q * E] = __ldg(src + x);
      else
        cp_async<V>(stg + rr * SW + q * E, src + x);
    }
  }
}

// bf16: the halo tile of a staged chunk in the wgmma layout, [8-channel
// group j][halo row][AW columns][8 channels], column for column as staged.
// The 8x8 blocks (8 channels x 8 pixels) go in groups of four, (j, q) =
// (0, 2g), (0, 2g + 1), (1, 2g), (1, 2g + 1) of halo row r: one transposed
// ldmatrix read each, after which lane l holds pixel l / 4 of channels
// 2 (l % 4) and 2 (l % 4) + 1 of every block and stores them as 4 bytes
// (zero past Ci). A warp takes the groups warp, warp + 4, ...: their
// offsets are the same for every chunk and are computed once. HR: halo rows.
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
                                             int c, int Ci, int pt) const {
    const int lane = pt % 32;
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

// F32: the halo tile of a staged chunk as two tf32 parts, [part][4-channel
// group j][halo row][AW columns][4 channels], column for column as staged:
// big = tf32(x), small = tf32(x - big) (x - big is exact in f32). ldmatrix
// moves 16-bit elements only, so each item (j, halo row, column) is one
// thread's: four 4-byte reads of its channels (consecutive threads read
// consecutive columns of a staged row: distinct banks), the split, and one
// 16-byte store per part (consecutive threads, consecutive 16 bytes). Zero
// past Ci.
template <int HR>
struct SplitTranspose {
  static constexpr int ITEMS = 2 * HR * AW;
  static constexpr int PLANE = HR * AW * 16;     // bytes per channel group

  __device__ __forceinline__ SplitTranspose(int) {}

  __device__ __forceinline__ void operator()(const uint32_t* stg, uint8_t* sa,
                                             int c, int Ci, int pt) const {
#pragma unroll 4
    for (int i = pt; i < ITEMS; i += 128) {
      const int col = i % AW, r = (i / AW) % HR, j = i / (AW * HR);
      const int ch = c * 8 + 4 * j;
      const uint32_t* s = stg + (r * 8 + 4 * j) * SW + col;
      uint32_t big[4], small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = ch + e < Ci ? __uint_as_float(s[e * SW]) : 0.f;
        big[e] = to_tf32(x);
        small[e] = to_tf32(x - __uint_as_float(big[e]));
      }
      uint8_t* d = sa + j * PLANE + (r * AW + col) * 16;
      *reinterpret_cast<uint4*>(d) = make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(d + 2 * PLANE) =
          make_uint4(small[0], small[1], small[2], small[3]);
    }
  }
};

// With the reflect pad, the halo's x = -k and x = W - 1 + k, k = 1 .. P
// (zeros or stale where they were staged; staged column 8 is output
// column x0) take x = k and x = W - 1 - k: P 16-byte entries per (part,
// channel group, halo row, side), after every transposed store, on the
// sides that `edges` marks as the image's (a shard's inner side reads its
// halo as staged). A tile reads columns up to x0 + TW - 1 + P, so the
// right side is reflected where W - x0 <= TW - 1 + P.
template <int K, int HR, int PARTS>
__device__ __forceinline__ void reflect_columns(uint8_t* sa, int W, int x0,
                                                int edges, int pt) {
  constexpr int P = K / 2;
  constexpr int ROWS = PARTS * 2 * HR;  // (part, group, halo row)
  static_assert(2 * ROWS <= 128, "one producer thread per row and side");
  const bool left = (edges & kLeftEdge) && x0 == 0;
  const bool right = (edges & kRightEdge) && W - x0 <= TW - 1 + P;
  if (!left && !right) return;  // an interior tile
  producers_sync();
  if (pt < 2 * ROWS) {
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
template <bool F32, int K, int BN, int RW, bool REFLECT, int CL>
__device__ __forceinline__ void produce(
    const typename Elem<F32>::S* __restrict__ in, const CUtensorMap* imap,
    const CUtensorMap* wmap, uint8_t* stages, typename Elem<F32>::S* staging,
    uint64_t* full, uint64_t* empty, uint64_t* landed, int n_stages,
    int n_stg, int vbytes, int Ci, int H, int W, Cols cols, int y0, int x0,
    int co0, int b, uint32_t rank) {
  using C = Cfg<F32, K, BN, RW>;
  constexpr int HR = C::HR, CH = C::E::CH, PARTS = C::E::PARTS;
  const int pt = threadIdx.x - 128 * N_CONSUMERS;
  const int n_chunks = (Ci + CH - 1) / CH;
  const int h_in = REFLECT ? H : H + K - 1;
  const int w_in = cols.w_in;
  const int xs = x0 + cols.xoff;  // the input column of output column x0
  const size_t plane = (size_t)h_in * w_in;
  const auto* in_b = in + (size_t)b * Ci * plane;

  auto stage_input = [&](int c, int d) {
    auto* stg = staging + d * C::STG_ELEMS;
    if (vbytes == 0) {
      if (pt == 0) {
        mbar_arrive_expect_tx(&landed[d], C::STG_ELEMS * C::E::BYTES);
        for (int r = 0; r < HR; ++r) {
          const int gy = REFLECT ? reflect_clamp(y0 - C::P + r, H)
                                 : min(y0 + r, h_in - 1);
          tma_load_4d(stg + r * CH * SW, imap, xs - 8, gy, c * CH, b,
                      &landed[d]);
        }
      }
      return;
    }
    switch (vbytes) {
      case 8:
        fill<F32, K, HR, 8, REFLECT>(in_b, stg, c, Ci, H, h_in, w_in, plane,
                                     y0, xs, pt);
        break;
      case 4:
        fill<F32, K, HR, 4, REFLECT>(in_b, stg, c, Ci, H, h_in, w_in, plane,
                                     y0, xs, pt);
        break;
      default:
        if constexpr (!F32)
          fill<F32, K, HR, 2, REFLECT>(in_b, stg, c, Ci, H, h_in, w_in, plane,
                                       y0, xs, pt);
    }
    if (vbytes >= 4)
      mbar_arrive_cp_async(&landed[d]);
    else
      mbar_arrive(&landed[d]);
  };

  using Tr = std::conditional_t<F32, SplitTranspose<HR>, Transpose<HR>>;
  const Tr transpose(pt);
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
        tma_load_4d_multicast(sb + rank * C::B_GROUP, wmap, 0, co0, 0,
                              PARTS * (2 * c + rank), &full[s], 0b11);
      } else {  // both groups: the map's box is two groups deep
        tma_load_4d(sb, wmap, 0, co0, 0, PARTS * 2 * c, &full[s]);
      }
    }
    const int d = c % n_stg;
    mbar_wait(&landed[d], (c / n_stg) & 1);
    transpose(staging + d * C::STG_ELEMS, sa, c, Ci, pt);
    if (REFLECT) reflect_columns<K, HR, PARTS>(sa, W, x0, cols.edges, pt);
    fence_proxy_async();
    mbar_arrive(&full[s]);
    producers_sync();  // every producer thread is done with slot d
    if (c + n_stg < n_chunks) stage_input(c + n_stg, d);
  }
}

// The consumer warpgroups: RW rows of 64 pixels x BN channels each, chunk
// by chunk, then the epilogue. Each warpgroup releases a stage to the
// producer of every block of the cluster (the weights of a stage arrive
// in all of them): bf16 the previous chunk's once this chunk's products
// are under way (its tiles have two stages or more wherever there are two
// chunks or more), F32 this chunk's once they are done (so F32 also
// takes a ring of one stage). F32 runs three tf32 products per tap and row, small terms first: A_small
// B_big + A_big B_small + A_big B_big (3xTF32; A_small B_small, below
// f32's rounding, is dropped), into `part`, zeroed per chunk; once the
// chunk's products are done the consumer adds part to acc (rounded to
// nearest) and releases the stage. The tensor cores align every product
// of an instruction to the accumulator's exponent and drop the bits below
// it: into one accumulator over the whole sum that cost ~1e-4 at Ci = 528
// (the card tests), against ~1e-6 for FFMA, so each chunk's sum starts
// from zero and only 8 channels x K*K taps meet the truncation at a time.
template <bool F32, int K, int BN, int RW, bool REFLECT, int CL>
__device__ __forceinline__ void consume(
    uint8_t* stages, uint64_t* full, uint64_t* empty, int n_stages,
    const float* __restrict__ scale, const float* __restrict__ offset,
    const typename Elem<F32>::T* __restrict__ residual,
    typename Elem<F32>::T* __restrict__ out, int Ci, int Co, int H, int W,
    int ldo, int y0, int x0, int co0, int b, int relu, int vec, uint32_t rank) {
  using C = Cfg<F32, K, BN, RW>;
  using T = typename Elem<F32>::T;
  const int wg = threadIdx.x / 128;
  const int n_chunks = (Ci + C::E::CH - 1) / C::E::CH;
  // F32: each chunk's products go into `part`, which the consumer then
  // adds to `acc` itself; bf16: into `acc` (part is unused)
  float acc[RW][BN / 2], part[RW][BN / 2];
  float(&d)[RW][BN / 2] = F32 ? part : acc;
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0.f;

  auto release = [&](int chunk) {
    if (threadIdx.x % 128 == 0) {  // for the whole warpgroup
      mbar_arrive(&empty[chunk % n_stages]);
      if constexpr (CL == 2) mbar_arrive_cluster(&empty[chunk % n_stages], rank ^ 1);
    }
  };
  const uint32_t ring = smem_u32(stages);
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % n_stages;
    mbar_wait(&full[s], (c / n_stages) & 1);
    const uint32_t a_base = ring + s * C::STAGE_BYTES;
    const uint32_t b_base = a_base + C::A_BYTES;
    if constexpr (F32) {
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) part[r][i] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) fence_regs<BN / 2>(d[r]);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < C::TAPS; ++t) {
      const uint64_t db = desc(b_base + t * BN * 16, C::B_GROUP, 128);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        // halo row and column of tap t: staged column 8 is x0 (reflect: of
        // the input; pre-padded: of the padded input, x0 - P of the image)
        const int row = wg * RW + r + t / K;
        const int col = (REFLECT ? 8 - C::P : 8) + t % K;
        const uint32_t a = a_base + (row * AW + col) * 16;
        const uint64_t da = desc(a, C::HALO_PIX * 16, 128);
        if constexpr (F32) {
          const uint64_t da_small = desc(a + C::A_PART, C::HALO_PIX * 16, 128);
          const uint64_t db_small =
              desc(b_base + (C::TAPS + t) * BN * 16, C::B_GROUP, 128);
          wgmma<true, BN>(d[r], da_small, db);
          wgmma<true, BN>(d[r], da, db_small);
        }
        wgmma<F32, BN>(d[r], da, db);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int r = 0; r < RW; ++r) fence_regs<BN / 2>(d[r]);
    if constexpr (F32) {  // the chunk's sum, rounded to nearest into acc
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        fence_regs<BN / 2>(part[r]);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[r][i] += part[r][i];
      }
      release(c);
    } else {
      wgmma_wait<1>();  // the previous chunk's products are done
      if (c > 0) release(c - 1);
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
  // in groups of NG: the group's residual loads (RV 16-byte words each) are
  // all started before its first store
  constexpr int ITEMS = BN * C::TH * 8;
  constexpr int NI = (ITEMS + 128 * N_CONSUMERS - 1) / (128 * N_CONSUMERS);
  constexpr int NG = NI < 4 ? NI : 4;
  constexpr int RV = C::E::BYTES / 2;
#pragma unroll 1
  for (int i0 = 0; i0 < NI; i0 += NG) {
    uint4 res[NG][RV];
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int item = threadIdx.x + (i0 + i) * 128 * N_CONSUMERS;
      const int co = item < ITEMS ? co0 + item / (C::TH * 8) : Co;
      const int y = y0 + (item / 8) % C::TH;
      const int x = x0 + (item % 8) * 8;
#pragma unroll
      for (int v = 0; v < RV; ++v) {
        res[i][v] = make_uint4(0, 0, 0, 0);
        if (vec && residual != nullptr && co < Co && y < H && x + 8 <= W)
          res[i][v] = __ldg(reinterpret_cast<const uint4*>(
                                residual + (((size_t)b * Co + co) * H + y) * ldo + x) +
                            v);
      }
    }
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int item = threadIdx.x + (i0 + i) * 128 * N_CONSUMERS;
      const int n = item / (C::TH * 8);
      const int tr = (item / 8) % C::TH;
      const int x = x0 + (item % 8) * 8;
      const int co = co0 + n;
      const int y = y0 + tr;
      if (item >= ITEMS || co >= Co || y >= H || x >= W) continue;
      const float so = scale != nullptr ? scale[co] : 1.f;
      const float oo = offset != nullptr ? offset[co] : 0.f;
      const float* src = tile + n * C::OUT_STRIDE + tr * TW + (x - x0);
      const size_t base = (((size_t)b * Co + co) * H + y) * ldo + x;
      if (vec && x + 8 <= W) {
        const float4 lo = reinterpret_cast<const float4*>(src)[0];
        const float4 hi = reinterpret_cast<const float4*>(src)[1];
        float val[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        uint32_t rw[4 * RV];
#pragma unroll
        for (int v = 0; v < RV; ++v) {
          rw[4 * v] = res[i][v].x;
          rw[4 * v + 1] = res[i][v].y;
          rw[4 * v + 2] = res[i][v].z;
          rw[4 * v + 3] = res[i][v].w;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          val[e] = fmaf(val[e], so, oo);
          if (residual != nullptr) {
            if constexpr (F32)
              val[e] += __uint_as_float(rw[e]);
            else  // a bf16 is the high half of its float
              val[e] += __uint_as_float(e % 2 ? rw[e / 2] & 0xFFFF0000u
                                              : rw[e / 2] << 16);
          }
          if (relu) val[e] = fmaxf(val[e], 0.f);
        }
        if constexpr (F32) {
          float4* o = reinterpret_cast<float4*>(out + base);
          o[0] = make_float4(val[0], val[1], val[2], val[3]);
          o[1] = make_float4(val[4], val[5], val[6], val[7]);
        } else {
          uint32_t ow[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat162 pair =
                __floats2bfloat162_rn(val[2 * e], val[2 * e + 1]);
            memcpy(&ow[e], &pair, 4);
          }
          *reinterpret_cast<uint4*>(out + base) =
              make_uint4(ow[0], ow[1], ow[2], ow[3]);
        }
      } else {
        for (int e = 0; e < 8 && x + e < W; ++e) {
          float val = fmaf(src[e], so, oo);
          if (residual != nullptr) val += to_f(residual[base + e]);
          if (relu) val = fmaxf(val, 0.f);
          out[base + e] = from_f<T>(val);
        }
      }
    }
  }
}

// CL blocks per cluster (1 or 2): with 2, the blocks of a pair (adjacent
// pixel tiles, the same output channels) load half of each stage's weights
// each and multicast it to both.
template <bool F32, int K, int BN, int RW, bool REFLECT, int CL>
__global__ void __launch_bounds__(NTHREADS, 1)
conv_wgmma_kernel(const typename Elem<F32>::T* __restrict__ in,
                  const __grid_constant__ CUtensorMap imap,
                  const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ scale,
                  const float* __restrict__ offset,
                  const typename Elem<F32>::T* __restrict__ residual,
                  typename Elem<F32>::T* __restrict__ out, int Ci, int Co,
                  int H, int W, Cols cols, int tiles_x, int n_stages,
                  int n_stg, int vbytes, int relu, int vec) {
  using C = Cfg<F32, K, BN, RW>;
  using S = typename Elem<F32>::S;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* landed = empty + MAX_STAGES;
  uint8_t* stages = smem + BARRIER_BYTES;
  S* staging = reinterpret_cast<S*>(
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
    produce<F32, K, BN, RW, REFLECT, CL>(reinterpret_cast<const S*>(in), &imap,
                                         &wmap, stages, staging, full, empty,
                                         landed, n_stages, n_stg, vbytes, Ci, H,
                                         W, cols, y0, x0, co0, b, rank);
  else
    consume<F32, K, BN, RW, REFLECT, CL>(stages, full, empty, n_stages, scale,
                                         offset, residual, out, Ci, Co, H, W,
                                         cols.ldo, y0, x0, co0, b, relu, vec, rank);
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

template <bool F32>
bool encode_map(CUtensorMap* map, const void* base, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode != nullptr &&
         encode(map,
                F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The input, (B, Ci, h_in, w_in), as a 4-D tensor map whose box is one
// staged halo row: CH channels x SW columns (zero-filled outside).
template <bool F32>
bool input_map(CUtensorMap* map, const void* in, int B, int Ci, int h_in,
               int w_in) {
  using E = Elem<F32>;
  const cuuint64_t w = w_in, plane = (cuuint64_t)h_in * w_in;
  const cuuint64_t dims[4] = {w, (cuuint64_t)h_in, (cuuint64_t)Ci,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {w * E::BYTES, plane * E::BYTES,
                                 plane * Ci * E::BYTES};
  const cuuint32_t box[4] = {SW, 1, E::CH, 1};
  return encode_map<F32>(map, in, dims, strides, box);
}

// The packed weights, [Ci_pad / GC][PARTS][taps][Co_pad][GC] (bf16:
// ops/conv7.py::pack_taps; F32: pack_taps_3xtf32, big and small parts), as
// a 4-D tensor map over [group * PARTS + part][taps][Co_pad][GC] whose box,
// [groups * PARTS][taps][BN][GC], is the weights of groups * GC input
// channels of all taps for BN output channels (zero-filled past Co_pad): a
// stage's with groups = 2, its half with 1.
template <bool F32>
bool weight_map(CUtensorMap* map, const void* wpk, int Ci, int Co, int taps,
                int bn, int groups) {
  using E = Elem<F32>;
  const cuuint64_t n_g = (Ci + E::CH - 1) / E::CH * 2 * E::PARTS,
                   co_pad = (Co + 7) / 8 * 8;
  const cuuint64_t dims[4] = {(cuuint64_t)E::GC, co_pad, (cuuint64_t)taps, n_g};
  const cuuint64_t strides[3] = {16, co_pad * 16, taps * co_pad * 16};
  const cuuint32_t box[4] = {(cuuint32_t)E::GC, (cuuint32_t)bn,
                             (cuuint32_t)taps, (cuuint32_t)(groups * E::PARTS)};
  return encode_map<F32>(map, wpk, dims, strides, box);
}

// The ring sizes of a launch: the operand and staging rings shrink, the
// staging ring first down to two, to fit SMEM_MAX, keeping two operand
// stages where it can (one staging slot then), and one at the least (two
// staging slots then, where they fit: a stage of the f32 7x7 at BN = 32;
// only F32 consumers take a ring of one stage, see `consume`).
template <bool F32, int K, int BN, int RW>
void rings(int n_chunks, int* n_stages, int* n_stg, int* smem) {
  using C = Cfg<F32, K, BN, RW>;
  *n_stg = std::min(MAX_STG, n_chunks);
  *n_stages = std::min(MAX_STAGES, n_chunks);
  auto bytes = [&] {
    return BARRIER_BYTES + std::max(*n_stages * C::STAGE_BYTES, C::OUT_BYTES) +
           *n_stg * C::STG_ELEMS * C::E::BYTES;
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
  if (*n_stages == 1 && *n_stg == 1 && n_chunks > 1) {
    *n_stg = 2;
    if (bytes() > SMEM_MAX) *n_stg = 1;
  }
  *smem = bytes();
}

template <bool F32, int K, int BN, int RW, bool REFLECT, int CL>
int launch_tile(const void* in, const void* wpk, const float* scale,
                const float* offset, const void* residual, void* out, int B,
                int Ci, int Co, int H, int W, Cols cols, int relu, int vbytes,
                int vec, cudaStream_t stream) {
  using C = Cfg<F32, K, BN, RW>;
  using T = typename Elem<F32>::T;
  int n_stages, n_stg, smem;
  rings<F32, K, BN, RW>((Ci + C::E::CH - 1) / C::E::CH, &n_stages, &n_stg,
                        &smem);
  CUtensorMap imap{}, wmap;
  if (!weight_map<F32>(&wmap, wpk, Ci, Co, C::TAPS, BN, CL == 2 ? 1 : 2) ||
      (vbytes == 0 &&
       !input_map<F32>(&imap, in, B, Ci, REFLECT ? H : H + K - 1, cols.w_in)))
    return (int)cudaErrorNotSupported;
  const auto kernel = conv_wgmma_kernel<F32, K, BN, RW, REFLECT, CL>;
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
      &cfg, kernel, static_cast<const T*>(in), imap, wmap, scale, offset,
      static_cast<const T*>(residual), static_cast<T*>(out), Ci, Co, H, W,
      cols, tiles_x, n_stages, n_stg, vbytes, relu, vec);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// How the input of a launch is staged: by the tensor map (0) where every
// row (w_in elements of `size` bytes) and the column of output column 0
// (xoff) are 16-byte aligned (a tensor-map load from a column that is not
// faults on the H100: an illegal instruction), else by cp.asyncs of 8 or 4
// bytes (which the rows and xoff must be aligned to), else (bf16) element
// by element (2).
inline int staging_bytes(const void* in, int w_in, int xoff, int size) {
  if ((size * w_in) % 16 == 0 && (size * xoff) % 16 == 0 && aligned(in, 16))
    return 0;
  int vbytes = 8;
  while (vbytes > size && ((size * w_in) % vbytes != 0 ||
                           (size * xoff) % vbytes != 0 || !aligned(in, vbytes)))
    vbytes /= 2;
  return vbytes;
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

// One 3x3 launch; wpk is the packed weight (bf16: ops/conv3.py::
// pack_conv3_weight; F32: its 3xTF32 form). The tile: what the L2 must
// deliver decides it, since every block re-reads the weights of its BN
// channels and the input rows of its pixels. BN is the smallest of 16..128
// that covers Co; two rows per consumer (RW = 2, 256 pixels: half the
// weight reads) wherever the grid still fills nine tenths of the SMs. bf16
// tries BN / 2 at RW = 2 next (the 2048-pixel scale at C = 1024 runs 128
// blocks of 256 pixels x 64 channels, not 128 of 128 x 128); F32 keeps BN
// = 128 at RW = 1 there, since at k8 an m64n64 product reads as many
// shared-memory bytes (A and B) as the tensor cores take cycles, and
// m64n128 two thirds of that. Then RW = 1 with BN halved while the grid
// has fewer blocks than half the SMs. From Ci = 128 up at BN >= 64, pairs
// of blocks share each stage's weights (clusters of two): that halves the
// weight reads again where they dominate; with fewer input channels a
// block is too short to pay for the pairing. Returns the launch's error.
template <bool F32, bool REFLECT>
int conv3(const void* in, const void* wpk, const float* scale,
          const float* offset, const void* residual, void* out, int B, int Ci,
          int Co, int H, int W, Cols cols, int relu, cudaStream_t stream) {
  constexpr int SIZE = Elem<F32>::BYTES;
  if (!aligned(wpk, 16)) return (int)cudaErrorMisalignedAddress;
  const int vec = cols.ldo % 8 == 0 && aligned(out, 16) &&
                  (residual == nullptr || aligned(residual, 16));
  const int vbytes = staging_bytes(in, cols.w_in, cols.xoff, SIZE);
  const int sms = sm_count();
  auto blocks = [&](int bn, int rw) { return grid_blocks(B, Co, H, W, bn, rw); };
  const long long fill = sms * 9LL / 10;
  int bn = Co <= 16 ? 16 : Co <= 32 ? 32 : Co <= 64 ? 64 : 128;
  bool rw2 = blocks(bn, 2) >= fill;
  if (!F32 && !rw2 && bn > 16 && blocks(bn / 2, 2) >= fill) {
    bn /= 2;
    rw2 = true;
  }
  while (!rw2 && bn > 16 && blocks(bn, 1) < sms / 2) bn /= 2;
  if (F32 && bn == 128) {  // RW = 1: BN = 136 where it saves a wave
    rw2 = false;
    auto waves = [&](int n) { return (blocks(n, 1) + sms - 1) / sms * n; };
    if (waves(136) < waves(128)) bn = 136;
  }
#define V2V_C3_LAUNCH(BN_, RW_, CL_)                                          \
  launch_tile<F32, 3, BN_, RW_, REFLECT, CL_>(in, wpk, scale, offset,         \
                                              residual, out, B, Ci, Co, H, W, \
                                              cols, relu, vbytes, vec, stream)
  const bool pairs = Ci >= 128;
  switch (bn) {
    case 16: return rw2 ? V2V_C3_LAUNCH(16, 2, 1) : V2V_C3_LAUNCH(16, 1, 1);
    case 32: return rw2 ? V2V_C3_LAUNCH(32, 2, 1) : V2V_C3_LAUNCH(32, 1, 1);
    case 64:
      if (pairs)
        return rw2 ? V2V_C3_LAUNCH(64, 2, 2) : V2V_C3_LAUNCH(64, 1, 2);
      return rw2 ? V2V_C3_LAUNCH(64, 2, 1) : V2V_C3_LAUNCH(64, 1, 1);
    default:
      if constexpr (F32) {
        if (bn == 136)
          return pairs ? V2V_C3_LAUNCH(136, 1, 2) : V2V_C3_LAUNCH(136, 1, 1);
        return pairs ? V2V_C3_LAUNCH(128, 1, 2) : V2V_C3_LAUNCH(128, 1, 1);
      } else {
        if (pairs)
          return rw2 ? V2V_C3_LAUNCH(128, 2, 2) : V2V_C3_LAUNCH(128, 1, 2);
        return rw2 ? V2V_C3_LAUNCH(128, 2, 1) : V2V_C3_LAUNCH(128, 1, 1);
      }
  }
#undef V2V_C3_LAUNCH
}

// One 7x7 launch with an optional f32 bias (the epilogue's offset); wpk is
// the packed weight (bf16: ops/conv7.py::pack_conv7_weight; F32: its
// 3xTF32 form). A stage holds all 49 taps of one chunk for BN output
// channels (bf16: 49 * BN * 32 bytes per 16 channels; F32: 49 * BN * 64,
// big and small parts of 8 channels), so BN is the smallest of 8, 16, 32
// that covers Co, more blocks along N beyond. bf16: four rows per consumer
// (RW = 4: 8 output rows, whose 14-row halo is re-read 1.75x through the
// L2 against 2.5x at 4 rows, and 4 * 49 wgmmas per stage) wherever that
// grid fills nine tenths of the SMs, else two. F32: two rows per consumer,
// whose 10-row halo of two parts (51 KB) leaves room for two stages up to
// BN = 16 and one at 32 (a stage of 100 KB of weights beside two staging
// slots; its consumers release it only once its products are done).
// Returns the launch's error.
template <bool F32, bool REFLECT>
int conv7(const void* in, const void* wpk, const float* bias, void* out,
          int B, int Ci, int Co, int H, int W, Cols cols, cudaStream_t stream) {
  if (!aligned(wpk, 16)) return (int)cudaErrorMisalignedAddress;
  const int vec = cols.ldo % 8 == 0 && aligned(out, 16);
  const int vbytes =
      staging_bytes(in, cols.w_in, cols.xoff, Elem<F32>::BYTES);
  const int bn = Co <= 8 ? 8 : Co <= 16 ? 16 : 32;
  const bool rw4 =
      !F32 && grid_blocks(B, Co, H, W, bn, 4) >= sm_count() * 9LL / 10;
#define V2V_C7_LAUNCH(BN_, RW_)                                               \
  launch_tile<F32, 7, BN_, RW_, REFLECT, 1>(in, wpk, nullptr, bias, nullptr, \
                                            out, B, Ci, Co, H, W, cols, 0,   \
                                            vbytes, vec, stream)
  if constexpr (F32) {
    switch (bn) {
      case 8: return V2V_C7_LAUNCH(8, 2);
      case 16: return V2V_C7_LAUNCH(16, 2);
      default: return V2V_C7_LAUNCH(32, 2);
    }
  } else {
    switch (bn) {
      case 8: return rw4 ? V2V_C7_LAUNCH(8, 4) : V2V_C7_LAUNCH(8, 2);
      case 16: return rw4 ? V2V_C7_LAUNCH(16, 4) : V2V_C7_LAUNCH(16, 2);
      default: return rw4 ? V2V_C7_LAUNCH(32, 4) : V2V_C7_LAUNCH(32, 2);
    }
  }
#undef V2V_C7_LAUNCH
}

// The f32 (3xTF32) launches, built in their own translation units
// (conv3_tf32x3.cu, conv7_tf32x3.cu) so that nvcc compiles them beside the
// bf16 ones: conv3<true, reflect> and conv7<true, reflect>.
int conv3_tf32x3(bool reflect, const void* in, const void* wpk,
                 const float* scale, const float* offset, const void* residual,
                 void* out, int B, int Ci, int Co, int H, int W, Cols cols,
                 int relu, cudaStream_t stream);
int conv7_tf32x3(bool reflect, const void* in, const void* wpk,
                 const float* bias, void* out, int B, int Ci, int Co, int H,
                 int W, Cols cols, cudaStream_t stream);

}  // namespace cw
}  // namespace v2v
