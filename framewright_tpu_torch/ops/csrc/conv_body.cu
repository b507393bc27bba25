// K1: conv_body 3x3 64->64 + bias + the head features' skip.
//
// Replaces framewright_tpu/ops/fused_tail3.py: _cbody_kernel (via
// conv_body_skip_blocks). out = bf16(conv(body) + b + feat), summed in f32
// and rounded once, as _cbody_kernel does.
//
// Bound: bytes, narrowly. A 1080p frame does 19 GMAC (38 GFLOP, 38 us at
// the bf16 peak) against 199 MB of reads and writes (body, feat, out:
// 59 us at 3.35 TB/s), ~190 FLOP per byte, below the card's balance
// point of ~295. The design reads each operand once: the body's 64
// channels straight from the RDB workspace (channel stride 192, no
// copy), and the skip folded into the store, so the add costs one read
// of feat and no extra pass. The product is the RDB's implicit GEMM
// (conv_common.cuh).
#include "conv_common.cuh"

namespace fw {

__global__ void __launch_bounds__(NTHREADS, 2)
    conv_body_kernel(const bf16* __restrict__ body, int body_cs, int H, int W,
                     const bf16* __restrict__ w, const float* __restrict__ bias,
                     const bf16* __restrict__ feat, bf16* __restrict__ out) {
  extern __shared__ uint4 smem_u4[];
  bf16* s_in = reinterpret_cast<bf16*>(smem_u4);
  bf16* s_w = s_in + HT * HW * KP;
  const int b = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  float acc[2][8][4];
  conv_tile<3, 8>(acc, body, body_cs, 64, H, W, b, ty0, tx0, -1, -1, w, s_in, s_w);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    const int y = ty0 + 2 * warp + mf;
    if (y >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = tx0 + g + 8 * h;
      if (x >= W) continue;
      const size_t pix = (((size_t)b * H + y) * W + x) * 64;
#pragma unroll
      for (int nf = 0; nf < 8; ++nf) {
        const int n = nf * 8 + 2 * t;
        st_bf16x2(out + pix + n, acc[mf][nf][2 * h] + bias[n] + bf(feat[pix + n]),
                  acc[mf][nf][2 * h + 1] + bias[n + 1] + bf(feat[pix + n + 1]));
      }
    }
  }
}

}  // namespace fw

using namespace fw;

extern "C" int fw_conv_body_skip(const void* body, int body_cs, int B, int H, int W, const void* w,
                                 const void* bias, const void* feat, void* out, void* stream) {
  const int smem = conv_smem_bytes(9, 64);
  cudaError_t err = allow_smem(conv_body_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  conv_body_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)body, body_cs, H, W, (const bf16*)w, (const float*)bias, (const bf16*)feat,
      (bf16*)out);
  return (int)cudaGetLastError();
}
