// Rate of Hopper's wgmma.mma_async m64nNk16 bf16 -> f32 at the shapes the
// port's conv main loop issues (framewright_tpu_torch/ops/csrc/conv_wgmma.cuh):
// N = 32 and 64, A from registers (RS) or shared memory (SS), one or two
// warpgroups per SM. Each step issues 12 products (4 accumulators x 3),
// commits them and waits for all but the newest group, as the main loop
// does; the operands' values do not matter.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o /tmp/wgmma_rate scripts/torch_wgmma_rate.cu && /tmp/wgmma_rate
//
// One line per case: TFLOP/s over the whole card (132 CTAs, one per SM).
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#define WGMMA_ACC16 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}"
#define WGMMA_ACC32                                                                     \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22," \
  "%23,%24,%25,%26,%27,%28,%29,%30,%31}"
#define OUT16(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define OUT32(d)                                                                         \
  OUT16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),        \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// scale-d is a predicate: always accumulate
#define PRED(i) "{\n.reg .pred p;\nsetp.ne.b32 p, %" #i ", 0;\n"
__device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t, uint64_t b) {
  asm volatile(PRED(21) "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WGMMA_ACC16
               ", {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
               : OUT16(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t, uint64_t b) {
  asm volatile(PRED(37) "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_ACC32
               ", {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
               : OUT32(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(PRED(18) "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WGMMA_ACC16
               ", %16, %17, p, 1, 1, 0, 0;\n}\n" : OUT16(d) : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(PRED(34) "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_ACC32
               ", %32, %33, p, 1, 1, 0, 0;\n}\n" : OUT32(d) : "l"(a), "l"(b), "r"(1));
}

template <int N, bool SS>
__global__ void __launch_bounds__(256, 1) rate(int steps, float* out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  const uint64_t desc = (uint64_t)((s >> 4) & 0x3FFF) | ((uint64_t)N << 16) | ((uint64_t)8 << 32);
  float acc[4][N / 2] = {};
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
    for (int r = 0; r < N / 2; ++r) t += acc[j][r];
  if (t == 12345.f) out[threadIdx.x] = t;   // keeps the products live
}

template <int N, bool SS>
void run(int warpgroups) {
  const int steps = 4000, smem = 100000;
  float* out = nullptr;
  cudaMalloc(&out, 4096);
  auto k = rate<N, SS>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  k<<<132, 128 * warpgroups, smem>>>(10, out);
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  cudaEventRecord(t0);
  k<<<132, 128 * warpgroups, smem>>>(steps, out);
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, t0, t1);
  const double flop = 2.0 * 132 * warpgroups * (double)steps * 12 * 64 * N * 16;
  printf("%s m64n%dk16, %d warpgroup(s) per SM: %.1f TFLOP/s (%s)\n", SS ? "SS" : "RS", N,
         warpgroups, flop / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  run<32, false>(1);
  run<32, false>(2);
  run<64, false>(1);
  run<64, false>(2);
  run<32, true>(2);
  run<64, true>(2);
  return 0;
}
