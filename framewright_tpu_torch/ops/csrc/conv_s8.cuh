// s8 x s8 -> s32 3x3 implicit-GEMM main loop for the int8 RDB kernels
// (rdb_int8.cu). The tiling is conv_tile's (conv_common.cuh): one CTA of
// 8 warps computes a 16x16 tile of output pixels for all of its output
// channels, warp w owning tile rows 2w and 2w+1, one m16 fragment per row.
//
// Layout: activations NHWC int8 with an explicit channel stride, weights
// [cout][9 taps][cin] int8 (tap-major, input channels contiguous). Each
// step stages one 32-channel chunk (32 bytes a pixel) of the 18x18 halo
// tile and of the weights through shared memory and runs
// mma.sync.m16n8k32 s8 x s8 -> s32 on the tensor cores: K = 32 channels
// of one tap per instruction, twice the channels of the bf16 m16n8k16
// at the same 32 bytes per fragment row. The A and B fragments of
// m16n8k32.s8 hold the same bytes as those of m16n8k16.bf16 (thread t of
// group g reads bytes 4t..4t+3 and 16+4t..16+4t+3 of rows g and g+8), so
// the addressing is conv_tile's in bytes.
//
// Zero-filled halo loads give SAME zero padding at every frame border
// (the code 0 is the value 0 at any scale).
//
// Shared-memory rows are padded from 32 to 48 bytes: the 32-bit fragment
// loads of 8 rows x 4 lanes then fall on 32 distinct banks (row r starts
// at word 12 r, and 12 r mod 32 for r < 8 is 0, 12, 24, 4, 16, 28, 8, 20).
#pragma once

#include "conv_common.cuh"

namespace fw {

constexpr int KC8 = 32;            // int8 channels staged per chunk (one k32 step)
constexpr int KP8 = 48;            // shared-memory row stride in bytes

// Dynamic shared memory of one CTA: input halo tile + one chunk of weights.
__host__ __device__ constexpr int conv_s8_smem_bytes(int cout) {
  return (HT * HW + 9 * cout) * KP8;
}

__device__ __forceinline__ uint32_t ld_u32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Add one 32-channel chunk [c0, c0 + 32) of a 3x3 SAME convolution to the
// int32 accumulators of this CTA's 16x16 tile at (ty0, tx0).
//   in   : (B, H, W, in_cs) int8
//   w    : [NFRAG*8][9][cin] int8
//   acc  : acc[mf][nf][r] = output pixel (row 2*warp + mf, column g or
//          g + 8), channels nf*8 + 2*t + {0, 1} (mma C fragment layout)
template <int NFRAG>
__device__ __forceinline__ void conv_chunk_s8(int (&acc)[2][NFRAG][4],
                                              const int8_t* __restrict__ in, int in_cs, int c0,
                                              int H, int W, int b, int ty0, int tx0,
                                              const int8_t* __restrict__ w, int cin,
                                              int8_t* s_in, int8_t* s_w) {
  constexpr int COUT = NFRAG * 8;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // input halo tile: HT*HW pixels x 32 bytes, 16 bytes per load
  for (int i = tid; i < HT * HW * 2; i += NTHREADS) {
    const int p = i >> 1, q = i & 1;
    const int gy = ty0 - 1 + p / HW, gx = tx0 - 1 + p % HW;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = *reinterpret_cast<const uint4*>(in + (((size_t)b * H + gy) * W + gx) * in_cs + c0 +
                                          q * 16);
    *reinterpret_cast<uint4*>(s_in + p * KP8 + q * 16) = v;
  }
  // weights of this chunk: row (tap, n) holds 32 input channels
  for (int i = tid; i < 9 * COUT * 2; i += NTHREADS) {
    const int r = i >> 1, q = i & 1;
    const int tap = r / COUT, n = r % COUT;
    *reinterpret_cast<uint4*>(s_w + r * KP8 + q * 16) =
        *reinterpret_cast<const uint4*>(w + ((size_t)n * 9 + tap) * cin + c0 + q * 16);
  }
  __syncthreads();

#pragma unroll
  for (int u = 0; u < 3; ++u) {
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const int tap = u * 3 + v;
      uint32_t a[2][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        // output (row 2 warp + mf, column j) reads halo pixel (row + u, j + v)
        const int8_t* base = s_in + ((2 * warp + mf + u) * HW + v) * KP8 + 4 * t;
        a[mf][0] = ld_u32(base + g * KP8);
        a[mf][1] = ld_u32(base + (g + 8) * KP8);
        a[mf][2] = ld_u32(base + g * KP8 + 16);
        a[mf][3] = ld_u32(base + (g + 8) * KP8 + 16);
      }
#pragma unroll
      for (int nf = 0; nf < NFRAG; ++nf) {
        const int8_t* wb = s_w + (tap * COUT + nf * 8 + g) * KP8 + 4 * t;
        const uint32_t b0 = ld_u32(wb), b1 = ld_u32(wb + 16);
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) mma_s8_16832(acc[mf][nf], a[mf], b0, b1);
      }
    }
  }
  __syncthreads();
}

}  // namespace fw
