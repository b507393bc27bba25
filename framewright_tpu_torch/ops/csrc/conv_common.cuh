// The port's shared device helpers (bf16 conversions and stores, int8
// codes, the valid rectangles of halo blocks, the shared-memory limit),
// which every kernel includes, directly or through conv_wgmma.cuh; and
// conv_tile, a 3x3 implicit-GEMM convolution on mma.sync that only the
// band conv (band_conv.cu) still runs. The RDBs (bf16 and int8), K1, the
// upsampling tail and the SRVGG chains run on conv_wgmma.cuh instead.
//
// conv_tile's layout: activations NHWC bf16 with an explicit channel
// stride, weights [cout][taps][cin] bf16 (tap-major, input channels
// contiguous), biases f32. One CTA of 8 warps computes a 16x16 tile of output pixels for all
// of its output channels; warp w owns tile rows 2w and 2w+1, one m16
// fragment per row (16 pixels). The input halo tile (18x18 pixels) and
// the weights are staged through shared memory 32 input channels at a
// time, and the products run on the tensor cores as
// mma.sync.m16n8k16 bf16 x bf16 -> f32.
//
// Zero padding: halo pixels outside the frame are stored as zeros in
// shared memory, which is SAME zero-pad semantics at every border. The
// TPU kernels get the same result from per-block valid masks
// (framewright_tpu/ops/fused_rrdb.py, module docstring).
//
// Shared-memory rows are padded from 32 to 40 bf16 (80 bytes): the
// 32-bit fragment loads of 8 pixels x 4 lanes then fall on 32 distinct
// banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fw {

typedef __nv_bfloat16 bf16;

constexpr int TH = 16;             // output tile rows
constexpr int TW = 16;             // output tile columns (one m16 fragment)
constexpr int HT = TH + 2;         // staged input rows (1-pixel halo)
constexpr int HW = TW + 2;         // staged input columns
constexpr int KC = 32;             // input channels staged per chunk
constexpr int KP = 40;             // shared-memory row stride in bf16
constexpr int NTHREADS = 256;      // 8 warps

// Dynamic shared memory of one CTA: input halo tile + one chunk of the
// nine taps' weights.
__host__ __device__ constexpr int conv_smem_bytes(int cout_pad) {
  return (HT * HW + 9 * cout_pad) * KP * 2;
}

__device__ __forceinline__ uint32_t ld_b32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.2f * v; }

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ bf16 rb(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ void st_bf16x2(bf16* p, float v0, float v1) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16(v0);
  v.y = __float2bfloat16(v1);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// The int8 code of v (the int8 RDBs, the int8 SRVGG chain):
// clip(rint(v), -127, 127) with rint half to even, as jnp.round: clipped
// first (the bounds are integers, so the order does not matter), then
// rounded by adding 1.5 * 2^23, whose float has an ulp of 1, so that the
// integer lands in the low mantissa bits. No conversion instruction: the
// epilogues' conversions (a quarter of the FMA rate) otherwise bound them.
__device__ __forceinline__ int8_t code(float v) {
  const float m = __fadd_rn(fminf(fmaxf(v, -127.f), 127.f), 12582912.f);
  return (int8_t)(__float_as_int(m) - 0x4B400000);
}

// The valid rectangle [r0, r1) x [c0, c1) of image (or block) b. The RDB
// kernels run on whole images (ext == NULL: every pixel is valid) or on
// the resident body's halo blocks, where ext (nb, 4) int32 holds each
// block's rectangle of frame pixels, as the TPU kernels' ext_ref does
// (fused_rrdb.py:412-444); outside it the stage outputs are zero. Each
// kernel takes block mode as a template parameter BLOCKS (its launcher
// picks the instance), so that the image path compiles to the code it had
// before blocks existed: a run-time test of ext cost the int8 i32 RDB 5%
// (PERF.md).
struct Rect {
  int r0, r1, c0, c1;
  __device__ __forceinline__ bool has(int y, int x) const {
    return y >= r0 && y < r1 && x >= c0 && x < c1;
  }
};

__device__ __forceinline__ Rect valid_rect(const int* ext, int b, int H, int W) {
  if (ext == nullptr) return Rect{0, H, 0, W};
  const int4 e = reinterpret_cast<const int4*>(ext)[b];
  return Rect{e.x, e.y, e.z, e.w};
}

// Accumulate one CTA tile of a 3x3 convolution (SAME padding).
//   in   : (B, H, W, in_cs) bf16; channels [0, cin) are read, cin % 32 == 0
//   w    : [NFRAG*8][9 taps][cin] bf16
//   acc  : acc[mf][nf][r] = output pixel (row 2*warp + mf, column g or
//          g + 8), channels nf*8 + 2*t + {0, 1} (mma C fragment layout)
// The output grid equals the input grid (H, W).
template <int NFRAG>
__device__ __forceinline__ void conv_tile(float (&acc)[2][NFRAG][4],
                                          const bf16* __restrict__ in, int in_cs, int cin,
                                          int H, int W, int b, int ty0, int tx0,
                                          const bf16* __restrict__ w, bf16* s_in, bf16* s_w) {
  constexpr int NTAP = 9;
  constexpr int COUT = NFRAG * 8;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < NFRAG; ++nf)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mf][nf][r] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += KC) {
    // input halo tile: HT*HW pixels x 32 channels, 16 bytes per load
    for (int i = tid; i < HT * HW * 4; i += NTHREADS) {
      const int p = i >> 2, q = i & 3;
      const int gy = ty0 - 1 + p / HW, gx = tx0 - 1 + p % HW;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = *reinterpret_cast<const uint4*>(in + (((size_t)b * H + gy) * W + gx) * in_cs + c0 + q * 8);
      *reinterpret_cast<uint4*>(s_in + p * KP + q * 8) = v;
    }
    // weights of this chunk: row (tap, n) holds 32 input channels
    for (int i = tid; i < NTAP * COUT * 4; i += NTHREADS) {
      const int r = i >> 2, q = i & 3;
      const int tap = r / COUT, n = r % COUT;
      const uint4 v =
          *reinterpret_cast<const uint4*>(w + ((size_t)n * NTAP + tap) * cin + c0 + q * 8);
      *reinterpret_cast<uint4*>(s_w + r * KP + q * 8) = v;
    }
    __syncthreads();

#pragma unroll
    for (int u = 0; u < 3; ++u) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const int tap = u * 3 + v;   // (u, v): the shift inside the halo tile
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
          uint32_t a[2][4];
#pragma unroll
          for (int mf = 0; mf < 2; ++mf) {
            const bf16* base = s_in + ((2 * warp + mf + u) * HW + v) * KP + ks * 16 + 2 * t;
            a[mf][0] = ld_b32(base + g * KP);
            a[mf][1] = ld_b32(base + (g + 8) * KP);
            a[mf][2] = ld_b32(base + g * KP + 8);
            a[mf][3] = ld_b32(base + (g + 8) * KP + 8);
          }
#pragma unroll
          for (int nf = 0; nf < NFRAG; ++nf) {
            const bf16* wb = s_w + (tap * COUT + nf * 8 + g) * KP + ks * 16 + 2 * t;
            const uint32_t b0 = ld_b32(wb), b1 = ld_b32(wb + 8);
#pragma unroll
            for (int mf = 0; mf < 2; ++mf) mma_bf16_16816(acc[mf][nf], a[mf], b0, b1);
          }
        }
      }
    }
    __syncthreads();
  }
}

// Set the dynamic shared-memory limit once per kernel instantiation.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace fw
