// Pipelined 3x3 implicit-GEMM convolution on wgmma, the main loop of the
// bf16 RDB (rdb.cu), K1 (conv_body.cu), the int8 RDBs (rdb_int8.cu,
// rdb_dyn.cu), the upsampling tail (tail.cu), the band conv (band_conv.cu)
// and the bf16 SRVGG chain (srvgg.cu); the int8 SRVGG chain's loop
// (srvgg.cu) is built from its pieces.
//
// Element kinds (Kind<T>): bf16 activations and weights with f32
// accumulators (m64nNk16), or int8 codes with s32 accumulators
// (m64nNk32). A chunk is 32 bytes a pixel either way, 16 bf16 or 32 int8
// channels, so the halo boxes, the swizzle, the ldmatrix addressing and
// the weight chunks below are the same bytes for both: the 8-bit k32
// register fragment of A is the 16-bit k16 fragment in bytes (thread t of
// row group g holds bytes 4t..4t+3 and 16+4t..16+4t+3 of rows g and g+8,
// as for mma.sync m16n8k32.s8 and m16n8k16.bf16), and 8-bit B must be
// K-major, which is the layout the bf16 loop already used.
//
// Layout: activations NHWC with an explicit channel stride, biases f32,
// weights in a chunk-major copy of their OHWI form made once on the host
// (fused_rrdb.wgmma_weights, wgmma_weights_s8; see launch_conv3x3).
//
// Work: a persistent grid, one CTA per SM of two consumer warpgroups and
// one producer. The output is cut into 16x16-pixel tiles in row-major
// (image, row, column) order; a CTA walks over pairs of consecutive
// tiles, one tile per consumer, and the consumers share each weight chunk
// it stages. Warp q of a consumer owns tile rows 4q..4q+3: M tile j (the
// 64 rows of a wgmma) is rows {j, 4 + j, 8 + j, 12 + j}, so a warp's A
// fragments for its six halo rows at one column shift serve all three row
// taps of all four M tiles (6 ldmatrix.x4 for 12 wgmma).
//
// Pipeline: the input channels go through in chunks of KC (one k step,
// 32 bytes a pixel). Stage s of a ring of NST holds one chunk: each tile's
// 18x18 halo pixels x KC channels, one TMA box (cp.async.bulk.tensor), and
// the taps x N x KC weights, one contiguous bulk copy. TMA fills zeros
// outside the image (SAME padding) and swizzles the 32-byte rows
// (SWIZZLE_32B), which puts the eight row addresses of an ldmatrix phase
// on distinct banks. One thread of the producer keeps the ring full,
// across tile boundaries, so the next tile's loads overlap this tile's
// last products and its epilogue: full[s] completes when a stage's bytes
// have landed, empty[s] when every consumer warp is done with it. A
// consumer releases a stage one step into the next chunk, when the last
// wgmma group that read it has retired (each step waits for all but its
// own group), so no step drains the tensor pipe except before an
// epilogue. The producer gives its registers to the consumers
// (setmaxnreg): N = 64 holds 128 accumulators a thread.
//
// Products: wgmma.mma_async m64nNk16 (bf16 in, f32 accumulators) or
// m64nNk32 (s8 in, s32 accumulators) in registers, A from registers
// (ldmatrix from the halo tile: a tap's shifted window is not a canonical
// wgmma shared-memory tile, while ldmatrix takes one row address per
// lane), B from shared memory through a matrix descriptor.
//
// Epilogue: each consumer has a staging buffer, so that the stores (and
// the residual's reads) move whole 16-byte runs, neighbouring threads on
// neighbouring runs, instead of the fragments' scattered 4-byte pieces;
// an epilogue may write a tile out in slices while the next tile's
// products run (Epi::DEFER).
//
// Taps (a Taps class, see Taps3x3): a conv makes NPASS passes over each
// tile group's input chunks, pass p reading the NU x NV taps of the 3x3
// window whose top left tap is origin(p), with its own weights, and ending
// in an epilogue. The 3x3 conv is one pass of all nine taps. A 3x3 conv
// after a nearest 2x upsample is four passes of 2x2 taps (TapsUp2, the
// phase convs of tail.cu): all four phases read the 3x3 window around an
// input pixel, so one halo box serves them all, and when a pass's chunks
// fill the ring exactly (nchunk == NST) each box stays in its stage from
// the first pass to the last and only the weights are loaded again.
//
// Order of the f32 sums: every output value accumulates (chunk, column
// tap v, row tap u) in that order, whatever the tile, the image size or
// block mode, so the merge, round-trip and resident bodies agree bit for
// bit, and K2 and tail1 give the same intermediates. s32 sums are exact
// in any order.
//
// Flushes (Epi::FLUSH, the int8 schemes f32acc and dynamic): after each
// chunk that ends a source (Epi::flushes), the consumer waits for the
// chunk's products, the epilogue folds the s32 partial into its f32 sums
// (Epi::Part) and the accumulators restart from zero. That drains the
// warpgroup's tensor pipe once a chunk; the other consumer's products
// can run meanwhile.
//
// Split tiles (SPLIT, the f32acc and dynamic stage 5): both consumers
// take the same tile, each N of the chunk's 2N output channels (its half
// of each weight row block, through the B descriptor's start address),
// so that the f32 sums of N = 64 (64 s32 + 64 f32 registers a thread
// for each half, not 128 + 128) fit beside the accumulators; a stage
// then holds one halo box and 2N weight rows.
//
// Why TMA and bulk copies (PERF.md): 16-byte cp.async copies between CTA
// barriers, one 32-byte sector per pixel and chunk, could not keep the
// products fed; and a TMA box of 32-byte rows moves only a few bytes a
// clock, so the weights, which would be such a box, come by one bulk copy.
// scripts/torch_wgmma_rate.cu measures the rates of these wgmma shapes,
// scripts/torch_rdb_stages.py times the RDB's stages.
#pragma once

#include <cuda.h>

#include <type_traits>

#include "conv_common.cuh"

namespace fw {
namespace wg {

constexpr int TS = 16;                 // output tile side (one warpgroup)
constexpr int HS = TS + 2;             // halo tile side
constexpr int KB = 32;                 // bytes a pixel of one chunk (one k step)
// one tile's halo box, padded to the 256-byte period of the 32B swizzle
constexpr int HALO_BYTES = (HS * HS * KB + 255) / 256 * 256;

// The element kinds: input channels per chunk, accumulator type, the
// tensor map's element type.
template <typename T>
struct Kind;
template <>
struct Kind<bf16> {
  using Acc = float;
  static constexpr int KC = 16;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Kind<int8_t> {
  using Acc = int;
  static constexpr int KC = 32;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// Consumer warpgroups per CTA (one CTA per SM, plus the producer
// warpgroup) and the registers a thread gets: a consumer 232 (N = 64 has
// 128 accumulators a thread), the producer 40, so that 128 (2 x 232 + 40)
// fit the SM's 65,536. (Three consumers of 160 registers at N = 32
// measured no faster.)
constexpr int NWG = 2;
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
static_assert(128 * (NWG * CONSUMER_REGS + PRODUCER_REGS) <= 65536, "registers");
__host__ __device__ constexpr int wchunk_bytes(int n, int ntap = 9) { return ntap * n * KB; }
// A stage: the halo boxes of a tile group (one box a consumer, or one
// for both when SPLIT) and the weight chunk of its NW = N (x 2 when SPLIT)
// output channels for the pass's ntap taps.
__host__ __device__ constexpr int nboxes(bool split) { return split ? 1 : NWG; }
__host__ __device__ constexpr int nweights(int n, bool split) { return split ? NWG * n : n; }
__host__ __device__ constexpr int stage_bytes(int n, bool split = false, int ntap = 9) {
  return nboxes(split) * HALO_BYTES + wchunk_bytes(nweights(n, split), ntap);
}
__host__ __device__ constexpr int nstage(int n) { return n <= 32 ? 5 : 4; }
// A warpgroup's epilogue staging: its 256 pixels x N bf16,
// rows padded by 16 bytes so that the fragment-layout writes of eight
// neighbouring pixels fall on distinct banks. An epilogue names its
// staging bytes as BUF.
constexpr int TPX = TS * TS;
__host__ __device__ constexpr int epi_row(int n) { return 2 * n + 16; }
__host__ __device__ constexpr int epi_bytes(int n) { return TPX * epi_row(n); }
// + 256 to align the ring, + two mbarriers a stage
__host__ __device__ constexpr int smem_bytes(int n, bool split, int buf, int ntap = 9) {
  return nstage(n) * stage_bytes(n, split, ntap) + NWG * buf + 256 + 16 * nstage(n);
}
// with the bf16 epilogues' staging of N channels
__host__ __device__ constexpr int smem_bytes(int n) { return smem_bytes(n, false, epi_bytes(n)); }

static_assert(stage_bytes(32) % 256 == 0 && stage_bytes(64) % 256 == 0 &&
                  stage_bytes(32, true) % 256 == 0 && stage_bytes(8) % 256 == 0 &&
                  stage_bytes(64, false, 4) % 256 == 0,
              "stage alignment");

// The taps of a conv (see the header): NPASS passes, pass p reading taps
// (u, v) = origin + (0..NU-1, 0..NV-1) of the 3x3 window (u the row, v
// the column shift inside the halo tile), origin(p) = u0 HS + v0; VG
// columns of taps a wgmma group (NV / VG groups a chunk).
struct Taps3x3 {
  static constexpr int NPASS = 1, NU = 3, NV = 3, VG = 1;
  static __device__ __forceinline__ int origin(int) { return 0; }
};
// A 3x3 conv after a nearest 2x upsample: phase p = 2 a + c gives output
// pixel (2 y + a, 2 x + c) from input rows y + a - 1 + {0, 1} and columns
// x + c - 1 + {0, 1}, taps (a + {0, 1}, c + {0, 1}) of the window. Both
// columns in one group: 16 products a group, as many as a 3x3 column's
// (two groups of 8 measured 5% slower, PERF.md).
struct TapsUp2 {
  static constexpr int NPASS = 4, NU = 2, NV = 2, VG = 2;
  static __device__ __forceinline__ int origin(int p) { return (p >> 1) * HS + (p & 1); }
};
static_assert(smem_bytes(32) <= 232448 && smem_bytes(64) <= 232448, "shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Contiguous bytes (a multiple of 16) into shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

// Barrier of the 128 threads of consumer warpgroup wgi (barrier 0 is
// __syncthreads).
__device__ __forceinline__ void wg_sync(int wgi) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wgi + 1) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int K>
__device__ __forceinline__ void fence_acc(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int K>
__device__ __forceinline__ void fence_acc(int (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Matrix descriptor of a K-major B tile without swizzle: core matrices of
// 8 rows x 16 bytes, lbo bytes apart along K, 128 bytes apart along N.
__device__ __forceinline__ uint64_t desc_b(uint32_t saddr, uint32_t lbo) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// D (64 x N f32) += A (64 x 16 bf16, registers) * B (16 x N bf16, smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// D (64 x N s32) += A (64 x 32 s8, registers) * B (32 x N s8, smem). The
// 8-bit forms take no scale or transpose immediates.
__device__ __forceinline__ void wgmma_rs(int (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// An epilogue's flushes and state (see conv3x3): Epi::FLUSH and
// Epi::Part where it names a Part, else no flush and no state.
struct NoPart {};
template <class E, class = void>
struct EpiTraits {
  static constexpr bool FLUSH = false;
  using Part = NoPart;
};
template <class E>
struct EpiTraits<E, std::void_t<typename E::Part>> {
  static constexpr bool FLUSH = E::FLUSH;
  using Part = typename E::Part;
};

// Tile t of B images of H x W: image, top row, left column.
struct Tiles {
  int tx, ty, count;
  __device__ __forceinline__ Tiles(int B, int H, int W)
      : tx((W + TS - 1) / TS), ty((H + TS - 1) / TS), count(B * tx * ty) {}
  __device__ __forceinline__ void at(int t, int& b, int& y0, int& x0) const {
    x0 = (t % tx) * TS;
    const int r = t / tx;
    y0 = (r % ty) * TS;
    b = r / ty;
  }
};

// The accumulators of one thread: acc[j][4 i + 2 h + e] is the output at
// tile row 4 q + j (q = warp in the warpgroup), tile column g + 8 h
// (g = lane / 4), channel 8 i + 2 (lane % 4) + e (+ N for consumer 1 of a
// SPLIT tile).
//
// in: the activations' tensor map (channels, W, H, B), box (KC, 18, 18,
// 1), T the element type; w: the weights in launch_conv3x3's chunked
// layout; Taps: the passes and their taps (Taps3x3: one pass). Epi (the
// caller's epilogue) provides
//   BUF                               its staging bytes a consumer
//   bool live(int b, int y0, int x0)  false: the tile needs no product
//                                     (block mode: wholly outside the
//                                     block's valid rectangle)
//   FLUSH, Part, flushes(c), flush(acc, part, c, b), drain(part)
//                                     optional (EpiTraits); with FLUSH,
//                                     after each chunk c with flushes(c)
//                                     (and after the last), the retired
//                                     accumulators go to flush, which
//                                     folds them into part, this thread's
//                                     state across the tile (and across
//                                     tiles: drain(part) after the last)
//   void stage(acc, part, b, y0, x0, live, buf)
//                                     after a pass's last product (b: the
//                                     image, b NPASS + p for pass p of
//                                     several, here and in load, finish): put
//                                     this thread's outputs in buf, the
//                                     warpgroup's BUF bytes of shared
//                                     memory (see Frag), or store them
//   SLICES, Slice, load(sl, k, b, y0, x0, buf), finish(sl, k, ...)
//                                     then slice k = 0..SLICES-1: issue
//                                     its loads into sl, write it out.
//                                     With DEFER, one slice a chunk of the
//                                     next tile, its loads behind the
//                                     chunk's first wgmma group and its
//                                     stores behind the last, so that the
//                                     output's device-memory traffic
//                                     overlaps the next tile's products;
//                                     else all at once
template <typename T, int N, bool SPLIT, class Taps, class Epi>
__device__ __forceinline__ void conv3x3(const CUtensorMap* in, const T* __restrict__ w, int cin,
                                        int B, int H, int W, const Epi& epi) {
  using Acc = typename Kind<T>::Acc;
  constexpr bool FLUSH = EpiTraits<Epi>::FLUSH;
  constexpr int NST = nstage(N), NW = nweights(N, SPLIT), NBOX = nboxes(SPLIT);
  constexpr int NP = Taps::NPASS, NU = Taps::NU, NV = Taps::NV, VG = Taps::VG, NTAP = NU * NV;
  static_assert(NV % VG == 0, "whole groups of columns");
  constexpr int SB = stage_bytes(N, SPLIT, NTAP), WB = wchunk_bytes(NW, NTAP);
  static_assert(SB % 256 == 0 && smem_bytes(N, SPLIT, Epi::BUF, NTAP) <= 232448,
                "shared memory");
  extern __shared__ uint8_t wg_smem[];
  const int tid = threadIdx.x, lane = tid & 31, q = (tid >> 5) & 3;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);   // warp-uniform
  const int wgi = warp >> 2;
  const Tiles tiles(B, H, W);
  const int ngroups = SPLIT ? tiles.count : (tiles.count + NWG - 1) / NWG;
  const int nchunk = cin / Kind<T>::KC;
  // iterations a tile group: (pass, chunk), the weight chunk's index
  const int per_group = NP * nchunk;
  const int my_groups =
      (int)blockIdx.x < ngroups ? (ngroups - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int total = my_groups * per_group;
  const uint32_t ring = (smem_u32(wg_smem) + 255u) & ~255u;
  // full[s]: stage s loaded (the producer's arrival + the TMA bytes);
  // empty[s]: every consumer warp is done with stage s
  const uint32_t stage_end = ring + NST * SB;
  const uint32_t full = stage_end + NWG * Epi::BUF, empty = full + 8 * NST;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == NWG) {
    // the producer warpgroup gives its registers to the consumers; one
    // thread keeps the ring full, iteration k (group k / per_group, chunk
    // k % nchunk) into stage k % NST once the consumers have released
    // the iteration k - NST that the stage last held; with several passes
    // and nchunk == NST that was the same chunk of the same group's last
    // pass, whose boxes the stage keeps
    const bool reuse = NP > 1 && nchunk == NST;
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    for (int k = 0; tid == 128 * NWG && k < total; ++k) {
      const int s = k % NST;
      if (k >= NST) mbar_wait(empty + 8 * s, ((k / NST) & 1) ^ 1);
      const int group = (int)blockIdx.x + (k / per_group) * (int)gridDim.x;
      const int kc = k % per_group, c0 = (k % nchunk) * Kind<T>::KC;
      const bool boxes = !reuse || kc < nchunk;
      const uint32_t st = ring + s * SB, bar = full + 8 * s;
      int b[NBOX], y0[NBOX], x0[NBOX];
      bool box[NBOX];
      int bytes = WB;
#pragma unroll
      for (int t = 0; t < NBOX; ++t) {
        tiles.at(group * NBOX + t, b[t], y0[t], x0[t]);
        box[t] = boxes && group * NBOX + t < tiles.count && epi.live(b[t], y0[t], x0[t]);
        if (box[t]) bytes += HS * HS * KB;
      }
      mbar_expect_tx(bar, bytes);
#pragma unroll
      for (int t = 0; t < NBOX; ++t)
        if (box[t]) tma_load_4d(st + t * HALO_BYTES, in, bar, c0, x0[t] - 1, y0[t] - 1, b[t]);
      bulk_load(st + NBOX * HALO_BYTES, reinterpret_cast<const uint8_t*>(w) + (size_t)kc * WB, WB,
                bar);
    }
  } else {
    // the consumers: warpgroup wgi takes tile wgi of each group (SPLIT:
    // both take the group's tile, wgi its output channels wgi N .. + N).
    // Accumulators are written by other code only here, after a flush and
    // after an epilogue, each time behind a wait for every product in
    // flight.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    Acc acc[4][N / 2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < N / 2; ++r) acc[j][r] = 0;
    }
    typename EpiTraits<Epi>::Part part{};
    // this lane's ldmatrix rows: pixel column lane % 16 (+ v) of halo row
    // 4 q (+ r), bytes 16 (lane / 16) .. +16; in the 32B swizzle the two
    // 16-byte halves of a pixel swap in every other group of four pixels
    const int p0 = 4 * q * HS + (lane & 15), half = lane >> 4;
    // stage of iteration it - 1 released: its last products have retired
    auto release = [&](int it) {
      if (it > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % NST));
    };
    uint8_t* buf = wg_smem + (stage_end + wgi * Epi::BUF - smem_u32(wg_smem));
    // the staged tile still being written out: slices left, its place
    int pend = 0, pb = 0, py0 = 0, px0 = 0;
    typename Epi::Slice sl;

    for (int it = 0; it < total; ++it) {
      mbar_wait(full + 8 * (it % NST), (it / NST) & 1);
      const int c = it % nchunk;
      const int pass = NP == 1 ? 0 : it % per_group / nchunk;
      const int group = (int)blockIdx.x + (it / per_group) * (int)gridDim.x;
      const int t = SPLIT ? group : group * NWG + wgi;
      int b, y0, x0;
      tiles.at(t, b, y0, x0);
      const bool has = t < tiles.count;
      // warp-uniform by construction; the broadcast lets ptxas see it, so
      // the products below sit on a convergent path and are not serialized
      const bool live = __shfl_sync(0xffffffffu, has && epi.live(b, y0, x0), 0);
      if (live) {
        const uint32_t st = ring + (it % NST) * SB;
        const uint32_t sh = st + (SPLIT ? 0 : wgi) * HALO_BYTES;
        const uint32_t sw = st + NBOX * HALO_BYTES + (SPLIT ? wgi * N * 16 : 0);
        const int org = Taps::origin(pass);
#pragma unroll
        for (int v = 0; v < NV; v += VG) {
          // columns v .. v + VG - 1: their A fragments, then their products
          uint32_t a[VG][NU + 3][4];
#pragma unroll
          for (int e = 0; e < VG; ++e) {
#pragma unroll
            for (int r = 0; r < NU + 3; ++r) {
              const int p = p0 + org + r * HS + v + e;
              ldmatrix_x4(a[e][r], sh + p * 32 + ((half ^ ((p >> 2) & 1)) << 4));
            }
          }
          wgmma_fence();
#pragma unroll
          for (int e = 0; e < VG; ++e) {
#pragma unroll
            for (int u = 0; u < NU; ++u) {
              const uint64_t desc = desc_b(sw + (NV * u + v + e) * NW * 32, NW * 16);
#pragma unroll
              for (int j = 0; j < 4; ++j) wgmma_rs(acc[j], a[e][j + u], desc);
            }
          }
          wgmma_commit();
          // one slice of the previous tile's output a chunk, its loads
          // issued behind the first group and used behind the last
          if (v == 0 && pend > 0) epi.load(sl, Epi::SLICES - pend, pb, py0, px0, buf);
          wgmma_wait<1>();
          if (v == 0) release(it);
          if (v == NV - VG && pend > 0) epi.finish(sl, Epi::SLICES - pend--, pb, py0, px0, buf);
        }
      } else {
        release(it);
        if (pend > 0) {
          epi.load(sl, Epi::SLICES - pend, pb, py0, px0, buf);
          epi.finish(sl, Epi::SLICES - pend--, pb, py0, px0, buf);
        }
      }
      if (c == nchunk - 1) {
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < 4; ++j) fence_acc(acc[j]);
        if constexpr (FLUSH) {
          if (live) epi.flush(acc, part, c, b);   // the last source
        }
        for (; pend > 0; --pend) {
          epi.load(sl, Epi::SLICES - pend, pb, py0, px0, buf);
          epi.finish(sl, Epi::SLICES - pend, pb, py0, px0, buf);
        }
        if constexpr (NP > 1) b = b * NP + pass;   // the epilogue's image
        wg_sync(wgi);   // the warpgroup is done reading the buffer
        if (has) epi.stage(acc, part, b, y0, x0, live, buf);
        wg_sync(wgi);   // the staged tile is visible to the whole warpgroup
        if (has) pend = Epi::SLICES, pb = b, py0 = y0, px0 = x0;
        for (; !Epi::DEFER && pend > 0; --pend) {
          epi.load(sl, Epi::SLICES - pend, pb, py0, px0, buf);
          epi.finish(sl, Epi::SLICES - pend, pb, py0, px0, buf);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int r = 0; r < N / 2; ++r) acc[j][r] = 0;
          fence_acc(acc[j]);
        }
      } else if constexpr (FLUSH) {
        if (live && epi.flushes(c)) {
          wgmma_wait<0>();
#pragma unroll
          for (int j = 0; j < 4; ++j) fence_acc(acc[j]);
          epi.flush(acc, part, c, b);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int r = 0; r < N / 2; ++r) acc[j][r] = 0;
            fence_acc(acc[j]);
          }
        }
      }
    }
    for (; pend > 0; --pend) {
      epi.load(sl, Epi::SLICES - pend, pb, py0, px0, buf);
      epi.finish(sl, Epi::SLICES - pend, pb, py0, px0, buf);
    }
    if constexpr (FLUSH) epi.drain(part);
  }
}

template <typename T, int N, bool SPLIT, class Taps, class Epi>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    conv3x3_kernel(const __grid_constant__ CUtensorMap in, const T* __restrict__ w, int cin,
                   int B, int H, int W, Epi epi) {
  conv3x3<T, N, SPLIT, Taps>(&in, w, cin, B, H, W, epi);
}

// --- host side ---------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry
// point query, so that the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
        cudaSuccess)
      return nullptr;
#endif
    if (found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a conv's input: the activations (B, H, W, cs) of T read
// in boxes of one chunk's channels (32 bytes) x 18 x 18 pixels in the
// 32-byte swizzle; reads outside the activations give zeros (the int8
// code 0 is the value 0 at any scale).
template <typename T>
inline cudaError_t input_map(CUtensorMap* map, const T* in, int cs, int B, int H, int W) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dim[4] = {(cuuint64_t)cs, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)cs * e, (cuuint64_t)W * cs * e,
                                (cuuint64_t)H * W * cs * e};
  const cuuint32_t box[4] = {Kind<T>::KC, HS, HS, 1}, ones[4] = {1, 1, 1, 1};
  if (encode(map, Kind<T>::MAP, 4, (void*)in, dim, stride, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// CTAs of the persistent grid: one per SM, at most one per tile group.
inline cudaError_t grid_size(int B, int H, int W, int per_cta, int* grid) {
  const long tiles = (long)B * ((H + TS - 1) / TS) * ((W + TS - 1) / TS);
  const long groups = (tiles + per_cta - 1) / per_cta;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = (int)(groups < sms ? groups : sms);
  return err;
}

// Launch one 3x3 conv of in (B, H, W, cs) of T (bf16 or int8), input
// channels [0, cin) (cin a multiple of the chunk's channels, KC), with
// epilogue epi: N output channels a consumer, 2N a tile when SPLIT. The
// weights w are in the chunked layout [cin / KC][9 taps][2][NW][KC / 2]
// (NW = N, or 2N when SPLIT; fused_rrdb.wgmma_weights for bf16,
// wgmma_weights_s8 for int8): one chunk is one contiguous copy and lands
// as wgmma's canonical K-major B without swizzle. With Taps of several
// passes, [NPASS][cin / KC][NU NV taps][2][NW][KC / 2]
// (fused_tail.tail_weights).
template <int N, bool SPLIT = false, class Taps = Taps3x3, typename T, class Epi>
inline cudaError_t launch_conv3x3(const T* in, int cs, int cin, int B, int H, int W, const T* w,
                                  const Epi& epi, cudaStream_t stream) {
  if (cin <= 0 || cin % Kind<T>::KC != 0 || cin > cs || (cs * sizeof(T)) % 16 != 0)
    return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = grid_size(B, H, W, nboxes(SPLIT), &grid);
  if (err != cudaSuccess || grid == 0) return err;
  CUtensorMap in_map;
  err = input_map(&in_map, in, cs, B, H, W);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_kernel<T, N, SPLIT, Taps, Epi>;
  constexpr int smem = smem_bytes(N, SPLIT, Epi::BUF, Taps::NU * Taps::NV);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 128 * (NWG + 1), smem, stream>>>(in_map, w, cin, B, H, W, epi);
  return cudaGetLastError();
}

// This thread's place in the accumulators: warp q of its warpgroup,
// g = lane / 4, t = lane % 4 (see conv3x3); wt its index in the
// warpgroup. An epilogue stages a tile through its buffer in two steps:
// each thread writes its fragments at pixel px(j, h) (tile row 4 q + j,
// column g + 8 h); then (in slices, see conv3x3) each moves whole 16-byte
// runs between the buffer and device memory, neighbouring threads on
// neighbouring runs, so that the device-memory accesses are coalesced.
struct Frag {
  int q, g, t, wt;
  __device__ __forceinline__ Frag()
      : q((threadIdx.x >> 5) & 3), g((threadIdx.x & 31) >> 2), t(threadIdx.x & 3),
        wt(threadIdx.x & 127) {}
  __device__ __forceinline__ int px(int j, int h) const { return (4 * q + j) * TS + g + 8 * h; }
};

// Whether a 16x16 tile at (y0, x0) meets the rectangle r.
__device__ __forceinline__ bool tile_meets(const Rect& r, int y0, int x0) {
  return y0 < r.r1 && y0 + TS > r.r0 && x0 < r.c1 && x0 + TS > r.c0;
}

}  // namespace wg
}  // namespace fw
