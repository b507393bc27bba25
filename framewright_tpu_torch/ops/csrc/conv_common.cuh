// The port's shared device helpers (bf16 conversions and stores, int8
// codes, the valid rectangles of halo blocks, the shared-memory limit),
// which every kernel includes, directly or through conv_wgmma.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fw {

typedef __nv_bfloat16 bf16;

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

// Set the dynamic shared-memory limit once per kernel instantiation.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace fw
