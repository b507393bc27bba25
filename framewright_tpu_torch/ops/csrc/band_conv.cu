// 3x3 SAME convolution + bias (+ lrelu), bf16 in and out, f32 accumulation:
// the convs of the band-conv RRDB tail (FastTail).
//
// Replaces framewright_tpu/ops/pallas_conv.py: _kernel (via band_conv3x3).
// out[b, y, x, n] = bf16(act(sum conv + bias[n])), with act lrelu or none,
// the TPU kernel's rounding points (pallas_conv.py:80-83). Cout is 64 (a
// full-width conv) or 8 (conv_last's 3 outputs padded to one n8 mma
// fragment; the caller crops).
//
// The TPU kernel cuts the image into row bands, fetches each band's halo
// rows by a double-buffered DMA from a zero-padded flat copy whose width
// is a multiple of 128, and turns taps into lane rolls: Mosaic
// workarounds, none carried over. Here each CTA reads its 18x18 input
// tile straight from the NHWC image with zeros outside it, through the
// RDB's implicit GEMM (conv_common.cuh, conv_tile), one launch per conv.
//
// Bound: bytes, narrowly. A 64->64 conv at 2160x3840 does 611.5 GFLOP
// (0.618 ms at the bf16 peak) against 2.12 GB of input and output (0.633
// ms at 3.35 TB/s): ~290 FLOP per byte, at the card's balance point. The
// design reads each input and writes each output once from device memory
// (the halo rows of a tile come again from L2), with bias and lrelu
// folded into the store.
#include "conv_common.cuh"

namespace fw {

template <int NFRAG>
__global__ void __launch_bounds__(NTHREADS, 2)
    band_conv_kernel(const bf16* __restrict__ in, int cin, int H, int W,
                     const bf16* __restrict__ w, const float* __restrict__ bias, int act,
                     bf16* __restrict__ out) {
  constexpr int COUT = NFRAG * 8;
  extern __shared__ uint4 smem_u4[];
  bf16* s_in = reinterpret_cast<bf16*>(smem_u4);
  bf16* s_w = s_in + HT * HW * KP;
  const int b = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  float acc[2][NFRAG][4];
  conv_tile<NFRAG>(acc, in, cin, cin, H, W, b, ty0, tx0, w, s_in, s_w);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    const int y = ty0 + 2 * warp + mf;
    if (y >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = tx0 + g + 8 * h;
      if (x >= W) continue;
      bf16* dst = out + (((size_t)b * H + y) * W + x) * COUT;
#pragma unroll
      for (int nf = 0; nf < NFRAG; ++nf) {
        const int n = nf * 8 + 2 * t;
        float v0 = acc[mf][nf][2 * h] + bias[n], v1 = acc[mf][nf][2 * h + 1] + bias[n + 1];
        if (act) v0 = lrelu(v0), v1 = lrelu(v1);
        st_bf16x2(dst + n, v0, v1);
      }
    }
  }
}

template <int NFRAG>
cudaError_t launch_band_conv(const bf16* in, int B, int H, int W, int cin, const bf16* w,
                             const float* bias, int act, bf16* out, cudaStream_t stream) {
  const int smem = conv_smem_bytes(NFRAG * 8);
  cudaError_t err = allow_smem(band_conv_kernel<NFRAG>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  band_conv_kernel<NFRAG><<<grid, NTHREADS, smem, stream>>>(in, cin, H, W, w, bias, act, out);
  return cudaGetLastError();
}

}  // namespace fw

using namespace fw;

// in (B, H, W, cin) bf16, cin % 32 == 0; w (cout, 3, 3, cin) bf16; bias
// (cout,) f32; out (B, H, W, cout) bf16, cout 64 or 8; act 1 = lrelu.
extern "C" int fw_band_conv(const void* in, int B, int H, int W, int cin, const void* w,
                            const void* bias, int cout, int act, void* out, void* stream) {
  if (cin % KC != 0) return (int)cudaErrorInvalidValue;
  if (cout == 64)
    return (int)launch_band_conv<8>((const bf16*)in, B, H, W, cin, (const bf16*)w,
                                    (const float*)bias, act, (bf16*)out, (cudaStream_t)stream);
  if (cout == 8)
    return (int)launch_band_conv<1>((const bf16*)in, B, H, W, cin, (const bf16*)w,
                                    (const float*)bias, act, (bf16*)out, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
