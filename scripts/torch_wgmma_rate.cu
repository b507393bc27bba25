// Rate of Hopper's wgmma.mma_async at the shapes the port's conv main loop
// issues (framewright_tpu_torch/ops/csrc/conv_wgmma.cuh): m64nNk16 bf16 ->
// f32 and m64nNk32 s8 -> s32, N = 32 and 64, A from registers (RS) or
// shared memory (SS), one or two warpgroups per SM. Each step issues 12
// products (4 accumulators x 3), commits them and waits for all but the
// newest group, as the main loop does; the operands' values do not matter.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o /tmp/wgmma_rate scripts/torch_wgmma_rate.cu && /tmp/wgmma_rate
//
// One line per case: TFLOP/s (bf16) or TOP/s (s8) over the whole card
// (132 CTAs, one per SM).
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <type_traits>

#define WGMMA_ACC16 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}"
#define WGMMA_ACC32                                                                     \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22," \
  "%23,%24,%25,%26,%27,%28,%29,%30,%31}"
#define OUT16(d, c)                                                                      \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]),       \
      c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15])
#define OUT32(d, c)                                                                      \
  OUT16(d, c), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]),     \
      c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]),    \
      c(d[31])
#define F(x) "+f"(x)
#define R(x) "+r"(x)

// scale-d is a predicate: always accumulate
#define PRED(i) "{\n.reg .pred p;\nsetp.ne.b32 p, %" #i ", 0;\n"
__device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t, uint64_t b) {
  asm volatile(PRED(21) "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WGMMA_ACC16
               ", {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
               : OUT16(d, F) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t, uint64_t b) {
  asm volatile(PRED(37) "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_ACC32
               ", {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
               : OUT32(d, F) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(PRED(18) "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WGMMA_ACC16
               ", %16, %17, p, 1, 1, 0, 0;\n}\n" : OUT16(d, F) : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(PRED(34) "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_ACC32
               ", %32, %33, p, 1, 1, 0, 0;\n}\n" : OUT32(d, F) : "l"(a), "l"(b), "r"(1));
}
// s8: no scale or transpose immediates (8-bit operands are K-major only)
__device__ __forceinline__ void mma(int (&d)[16], const uint32_t (&a)[4], uint64_t, uint64_t b) {
  asm volatile(PRED(21) "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 " WGMMA_ACC16
               ", {%16,%17,%18,%19}, %20, p;\n}\n"
               : OUT16(d, R) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4], uint64_t, uint64_t b) {
  asm volatile(PRED(37) "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " WGMMA_ACC32
               ", {%32,%33,%34,%35}, %36, p;\n}\n"
               : OUT32(d, R) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(PRED(18) "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 " WGMMA_ACC16
               ", %16, %17, p;\n}\n" : OUT16(d, R) : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(PRED(34) "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " WGMMA_ACC32
               ", %32, %33, p;\n}\n" : OUT32(d, R) : "l"(a), "l"(b), "r"(1));
}

template <typename Acc, int N, bool SS>
__global__ void __launch_bounds__(256, 1) rate(int steps, float* out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  const uint64_t desc = (uint64_t)((s >> 4) & 0x3FFF) | ((uint64_t)N << 16) | ((uint64_t)8 << 32);
  Acc acc[4][N / 2] = {};
  uint32_t a[6][4];
  for (int r = 0; r < 6; ++r)
    for (int i = 0; i < 4; ++i) a[r][i] = 0x3f803f80u * (threadIdx.x & 1);
  for (int it = 0; it < steps; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (SS) mma(acc[j], desc + 8 * j, desc + 64 * u);
        else mma(acc[j], a[j + u], 0, desc + 64 * u);
      }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float t = 0.f;
  for (int j = 0; j < 4; ++j)
    for (int r = 0; r < N / 2; ++r) t += (float)acc[j][r];
  if (t == 12345.f) out[threadIdx.x] = t;   // keeps the products live
}

template <typename Acc, int N, bool SS>
void run(int warpgroups) {
  const int steps = 4000, smem = 100000;
  const bool s8 = std::is_same<Acc, int>::value;
  const int k = s8 ? 32 : 16;
  float* out = nullptr;
  cudaMalloc(&out, 4096);
  auto kern = rate<Acc, N, SS>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kern<<<132, 128 * warpgroups, smem>>>(10, out);
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  cudaEventRecord(t0);
  kern<<<132, 128 * warpgroups, smem>>>(steps, out);
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, t0, t1);
  const double ops = 2.0 * 132 * warpgroups * (double)steps * 12 * 64 * N * k;
  printf("%s %s m64n%dk%d, %d warpgroup(s) per SM: %.1f %s (%s)\n", SS ? "SS" : "RS",
         s8 ? "s8" : "bf16", N, k, warpgroups, ops / ms / 1e9, s8 ? "TOP/s" : "TFLOP/s",
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  run<float, 32, false>(1);
  run<float, 32, false>(2);
  run<float, 64, false>(1);
  run<float, 64, false>(2);
  run<float, 32, true>(2);
  run<float, 64, true>(2);
  run<int, 32, false>(1);
  run<int, 32, false>(2);
  run<int, 64, false>(1);
  run<int, 64, false>(2);
  run<int, 32, true>(1);
  run<int, 32, true>(2);
  run<int, 64, true>(1);
  run<int, 64, true>(2);
  return 0;
}
