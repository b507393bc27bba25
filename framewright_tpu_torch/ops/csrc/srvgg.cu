// SRVGGNetCompact conv chain: one 3x3 64->64 conv + bias + PReLU per
// launch, in bf16 and in int8 (static activation scales).
//
// Replaces framewright_tpu/ops/fused_srvgg.py:
//   _make_chain_kernel (via fused_conv_chain): bf16 operands, f32 sums,
//     v = acc + b, PReLU v >= 0 ? v : v alpha in f32, one rounding to
//     bf16 per conv;
//   _make_chain_kernel_int8 (via fused_conv_chain_int8): the group input
//     quantized at inv_0, s8 x s8 products whose int32 partials are
//     flushed to f32 per chunk of 4 taps (taps 0-3, 4-7, 8, each over all
//     64 input channels) as f32(p) (ws sa), summed in that order, + b,
//     PReLU, requantized at inv_{i+1} within the group and rounded to
//     bf16 at the group's last conv.
// Both run for every chain conv of the SRVGG restore (16 convs, two
// groups of 8, for realesr-animevideov3).
//
// Bound: tensor-core operations. A 540x960 frame does 9 x 64 x 64 MAC
// per pixel per conv, 38.2 G operations per conv, 0.039 ms at the bf16
// peak (989 TFLOP/s) and 0.019 ms at the int8 peak (1,979 TOP/s), against
// 132.7 MB of bf16 input and output (0.040 ms at 3.35 TB/s) for a group
// of 8 that keeps its intermediates on the card, so a whole group is
// bound by operations. This first version writes every conv's output
// through device memory (one launch per conv, one bf16 or s8 buffer to
// the other); fusing a group's convs with halo recompute is later work.
//
// Design: the bf16 conv is conv_common.cuh's implicit GEMM (16x16 pixel
// tile per CTA, 18x18 zero-filled halo = SAME padding at every border,
// mma.sync.m16n8k16) with a PReLU epilogue, as K1 (conv_body.cu). The
// int8 conv stages the whole 64-channel halo tile and all 9 taps' weights
// at once (80-byte shared rows: the 32-bit fragment loads of 8 rows x 4
// lanes fall on 32 distinct banks), so each 4-tap chunk's int32 sum over
// all 64 channels is complete before it is flushed, as the TPU kernel's
// chunked dot is; mma.sync.m16n8k32.s8 as in conv_s8.cuh. Every f32
// multiply and add is __fmul_rn/__fadd_rn (no FMA contraction) and codes
// round with rintf (half to even, like jnp.round). The TPU kernels'
// 112x112 windows, halo 8, packed words and cyclic rolls are Mosaic
// workarounds and have no counterpart here.
#include "conv_s8.cuh"

namespace fw {
namespace {

constexpr int VC = 64;            // channels of every chain activation
constexpr int KPV = 80;           // int8 shared-memory row: 64 codes + 16 pad bytes
constexpr int TPC_I8 = 4;         // taps per int32 flush
constexpr int I8_SMEM = (HT * HW + 9 * VC) * KPV;

__device__ __forceinline__ float prelu_rn(float v, float a) { return v >= 0.f ? v : __fmul_rn(v, a); }

__device__ __forceinline__ int8_t vgg_code(float v) {
  return (int8_t)(int)fminf(fmaxf(rintf(v), -127.f), 127.f);
}

__global__ void __launch_bounds__(NTHREADS, 2)
    vgg_conv_kernel(const bf16* __restrict__ in, int H, int W, const bf16* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ alpha,
                    bf16* __restrict__ out) {
  extern __shared__ uint4 smem_u4[];
  bf16* s_in = reinterpret_cast<bf16*>(smem_u4);
  bf16* s_w = s_in + HT * HW * KP;
  const int b = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  float acc[2][8][4];
  conv_tile<3, 8>(acc, in, VC, VC, H, W, b, ty0, tx0, -1, -1, w, s_in, s_w);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    const int y = ty0 + 2 * warp + mf;
    if (y >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = tx0 + g + 8 * h;
      if (x >= W) continue;
      const size_t pix = (((size_t)b * H + y) * W + x) * VC;
#pragma unroll
      for (int nf = 0; nf < 8; ++nf) {
        const int n = nf * 8 + 2 * t;
        st_bf16x2(out + pix + n,
                  prelu_rn(__fadd_rn(acc[mf][nf][2 * h], bias[n]), alpha[n]),
                  prelu_rn(__fadd_rn(acc[mf][nf][2 * h + 1], bias[n + 1]), alpha[n + 1]));
      }
    }
  }
}

// q[p, c] = clip(rint(f32(x[p, c]) inv0)), 8 channels a thread.
__global__ void vgg_i8_quant_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q,
                                    long long n8, float inv0) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const uint4 raw = *reinterpret_cast<const uint4*>(x + i * 8);
  const bf16* v = reinterpret_cast<const bf16*>(&raw);
  union {
    int8_t s[8];
    uint2 u;
  } out;
#pragma unroll
  for (int j = 0; j < 8; ++j) out.s[j] = vgg_code(__fmul_rn(bf(v[j]), inv0));
  *reinterpret_cast<uint2*>(q + i * 8) = out.u;
}

// One int8 chain conv from the codes q. LAST: out = bf16(prelu(acc + b));
// otherwise qout = codes of prelu(acc + b) at inv_next.
template <bool LAST>
__global__ void __launch_bounds__(NTHREADS, 1)
    vgg_i8_conv_kernel(const int8_t* __restrict__ q, int H, int W, const int8_t* __restrict__ w,
                       const float* __restrict__ dq, const float* __restrict__ bias,
                       const float* __restrict__ alpha, float inv_next,
                       int8_t* __restrict__ qout, bf16* __restrict__ out) {
  extern __shared__ uint4 smem_u4[];
  int8_t* s_in = reinterpret_cast<int8_t*>(smem_u4);
  int8_t* s_w = s_in + HT * HW * KPV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;

  // halo tile: HT*HW pixels x 64 codes, 16 bytes per load
  for (int i = tid; i < HT * HW * 4; i += NTHREADS) {
    const int p = i >> 2, c = i & 3;
    const int gy = ty0 - 1 + p / HW, gx = tx0 - 1 + p % HW;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = *reinterpret_cast<const uint4*>(q + (((size_t)b * H + gy) * W + gx) * VC + c * 16);
    *reinterpret_cast<uint4*>(s_in + p * KPV + c * 16) = v;
  }
  // weights: row (tap, n) holds the 64 input channels of tap for target n
  for (int i = tid; i < 9 * VC * 4; i += NTHREADS) {
    const int r = i >> 2, c = i & 3;
    const int tap = r / VC, n = r % VC;
    *reinterpret_cast<uint4*>(s_w + r * KPV + c * 16) =
        *reinterpret_cast<const uint4*>(w + ((size_t)n * 9 + tap) * VC + c * 16);
  }
  __syncthreads();

  float facc[2][8][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 8; ++nf)
#pragma unroll
      for (int r = 0; r < 4; ++r) facc[mf][nf][r] = 0.f;

#pragma unroll
  for (int t0 = 0; t0 < 9; t0 += TPC_I8) {
    int acc[2][8][4];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nf = 0; nf < 8; ++nf)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mf][nf][r] = 0;
#pragma unroll
    for (int tap = t0; tap < (t0 + TPC_I8 < 9 ? t0 + TPC_I8 : 9); ++tap) {
      const int u = tap / 3, v = tap % 3;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          // output (row 2 warp + mf, column j) reads halo pixel (row + u, j + v)
          const int8_t* base = s_in + ((2 * warp + mf + u) * HW + v) * KPV + ks * 32 + 4 * t;
          a[mf][0] = ld_u32(base + g * KPV);
          a[mf][1] = ld_u32(base + (g + 8) * KPV);
          a[mf][2] = ld_u32(base + g * KPV + 16);
          a[mf][3] = ld_u32(base + (g + 8) * KPV + 16);
        }
#pragma unroll
        for (int nf = 0; nf < 8; ++nf) {
          const int8_t* wb = s_w + (tap * VC + nf * 8 + g) * KPV + ks * 32 + 4 * t;
          const uint32_t b0 = ld_u32(wb), b1 = ld_u32(wb + 16);
#pragma unroll
          for (int mf = 0; mf < 2; ++mf) mma_s8_16832(acc[mf][nf], a[mf], b0, b1);
        }
      }
    }
    // flush this chunk: facc += f32(p) * (ws sa)
#pragma unroll
    for (int nf = 0; nf < 8; ++nf) {
      const int n = nf * 8 + 2 * t;
      const float s0 = dq[n], s1 = dq[n + 1];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          facc[mf][nf][r] =
              __fadd_rn(facc[mf][nf][r], __fmul_rn(__int2float_rn(acc[mf][nf][r]), r & 1 ? s1 : s0));
    }
  }

#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    const int y = ty0 + 2 * warp + mf;
    if (y >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = tx0 + g + 8 * h;
      if (x >= W) continue;
      const size_t pix = (((size_t)b * H + y) * W + x) * VC;
#pragma unroll
      for (int nf = 0; nf < 8; ++nf) {
        const int n = nf * 8 + 2 * t;
        const float v0 = prelu_rn(__fadd_rn(facc[mf][nf][2 * h], bias[n]), alpha[n]);
        const float v1 = prelu_rn(__fadd_rn(facc[mf][nf][2 * h + 1], bias[n + 1]), alpha[n + 1]);
        if (LAST) {
          st_bf16x2(out + pix + n, v0, v1);
        } else {
          char2 c;
          c.x = vgg_code(__fmul_rn(v0, inv_next));
          c.y = vgg_code(__fmul_rn(v1, inv_next));
          *reinterpret_cast<char2*>(qout + pix + n) = c;
        }
      }
    }
  }
}

}  // namespace
}  // namespace fw

using namespace fw;

extern "C" {

// One bf16 chain conv: out = bf16(prelu(conv(in) + bias)), (B, H, W, 64).
int fw_vgg_conv(const void* in, int B, int H, int W, const void* w, const void* bias,
                const void* alpha, void* out, void* stream) {
  const int smem = conv_smem_bytes(9, VC);
  cudaError_t err = allow_smem(vgg_conv_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  vgg_conv_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)in, H, W, (const bf16*)w, (const float*)bias, (const float*)alpha,
      (bf16*)out);
  return (int)cudaGetLastError();
}

// The codes of a group's bf16 input x at inv0, npix pixels x 64 channels.
int fw_vgg_i8_quant(const void* x, void* q, long long npix, float inv0, void* stream) {
  const long long n8 = npix * (VC / 8);
  const int threads = 256;
  const long long blocks = (n8 + threads - 1) / threads;
  vgg_i8_quant_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (int8_t*)q, n8, inv0);
  return (int)cudaGetLastError();
}

// One int8 chain conv from the codes q: the next codes into qout at
// inv_next, or, when qout is NULL (the group's last conv), bf16 into out.
int fw_vgg_i8_conv(const void* q, int B, int H, int W, const void* w, const void* dq,
                   const void* bias, const void* alpha, float inv_next, void* qout, void* out,
                   void* stream) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaError_t err;
  if (qout == nullptr) {
    err = allow_smem(vgg_i8_conv_kernel<true>, I8_SMEM);
    if (err != cudaSuccess) return (int)err;
    vgg_i8_conv_kernel<true><<<grid, NTHREADS, I8_SMEM, (cudaStream_t)stream>>>(
        (const int8_t*)q, H, W, (const int8_t*)w, (const float*)dq, (const float*)bias,
        (const float*)alpha, inv_next, nullptr, (bf16*)out);
  } else {
    err = allow_smem(vgg_i8_conv_kernel<false>, I8_SMEM);
    if (err != cudaSuccess) return (int)err;
    vgg_i8_conv_kernel<false><<<grid, NTHREADS, I8_SMEM, (cudaStream_t)stream>>>(
        (const int8_t*)q, H, W, (const int8_t*)w, (const float*)dq, (const float*)bias,
        (const float*)alpha, inv_next, (int8_t*)qout, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
