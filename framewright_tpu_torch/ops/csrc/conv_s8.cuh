// mma.sync m16n8k32 s8 x s8 -> s32 and its 32-bit fragment loads, for the
// int8 SRVGG chain (srvgg.cu), which tiles as conv_common.cuh's conv_tile
// does: the A and B fragments of m16n8k32.s8 hold the same bytes as those
// of m16n8k16.bf16 (thread t of group g reads bytes 4t..4t+3 and
// 16+4t..16+4t+3 of rows g and g+8), so its addressing is conv_tile's in
// bytes. The int8 RDBs run on conv_wgmma.cuh instead.
#pragma once

#include "conv_common.cuh"

namespace fw {

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

}  // namespace fw
