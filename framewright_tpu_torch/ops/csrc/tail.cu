// K2: the Real-ESRGAN upsampling tail with the output epilogue.
//
// Replaces framewright_tpu/ops/fused_tail.py: _make_tail2_kernel (via
// fused_tail2_blocks), with the weights of tail2_phase_weights and the
// colour matrix of yuv420_matrix. From the conv_body+skip output x at
// body resolution (B, h, w, 64) it computes
//   a0 = bf16(lrelu(conv_up1(nearest2(x))))      (B, 2h, 2w, 64)
//   a  = bf16(lrelu(conv_up2(nearest2(a0))))     (B, 4h, 4w, 64)
//   c  = bf16(lrelu(conv_hr(a)))                 (B, 4h, 4w, 64)
//   y  = conv_last(c)  (f32)  -> epilogue
// A conv after a nearest 2x upsample is four 2x2-tap phase convs at the
// lower resolution (fused_tail.py:_up2_phase_weights): output pixel
// (2i+p, 2j+q) reads input rows i+p-1+{0,1} and columns j+q-1+{0,1},
// 4/9 of the MACs of the 3x3 over the upsampled image.
//
// The epilogue is in the store of the last launch, so no crop or
// depth-to-space pass follows it: bf16 RGB, rgb_u8
// floor(clip(y,0,1)*255+0.5), or yuv420_u8 where each 2x2 output quad
// gives four Y samples and one U and one V (BT.601, limited or full
// range; coefficients and the +0.5 rounding offsets come from the host
// as yuv420_matrix builds them).
//
// Bound: tensor-core operations. A 1080p frame does 490 GMAC (0.98 TFLOP,
// ~1 ms at the bf16 peak); the intermediates a and c are kept in device
// memory in this version (1.06 GB each at 4K), about 4.5 GB of traffic,
// ~1.3 ms at 3.35 TB/s, so at the roofline the bytes would bound it.
// Fusing the four launches into one kernel that keeps them on chip, as
// the TPU kernel does, removes that traffic; this first version keeps
// the launches separate and simple.
#include "conv_common.cuh"

namespace fw {

struct YuvCoef {
  float wy[3];   // Y per RGB channel (BT.601 x range scale)
  float wu[3];   // U per RGB channel, already x 0.25 for the 2x2 mean
  float wv[3];
  float by;      // Y offset + 0.5 (16.5 limited, 0.5 full range)
  float bc;      // chroma offset + 0.5 (128.5)
};

enum OutMode { OUT_BF16 = 0, OUT_RGB_U8 = 1, OUT_YUV420_U8 = 2 };

// Phase conv after a nearest 2x upsample, 64 -> 64, lrelu, bf16 out.
// in (B, H, W, 64) -> out (B, 2H, 2W, 64); w: [4 phases][64][4 taps][64].
__global__ void __launch_bounds__(NTHREADS, 2)
    up2_phase_kernel(const bf16* __restrict__ in, int H, int W, const bf16* __restrict__ w,
                     const float* __restrict__ bias, bf16* __restrict__ out) {
  extern __shared__ uint4 smem_u4[];
  bf16* s_in = reinterpret_cast<bf16*>(smem_u4);
  bf16* s_w = s_in + HT * HW * KP;
  const int b = blockIdx.z >> 2, ph = blockIdx.z & 3, pa = ph >> 1, pb = ph & 1;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  float acc[2][8][4];
  conv_tile<2, 8>(acc, in, 64, 64, H, W, b, ty0, tx0, pa - 1, pb - 1,
                  w + (size_t)ph * 64 * 4 * 64, s_in, s_w);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int H2 = 2 * H, W2 = 2 * W;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    const int y = ty0 + 2 * warp + mf;
    if (y >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = tx0 + g + 8 * h;
      if (x >= W) continue;
      bf16* dst = out + (((size_t)b * H2 + 2 * y + pa) * W2 + 2 * x + pb) * 64;
#pragma unroll
      for (int nf = 0; nf < 8; ++nf) {
        const int n = nf * 8 + 2 * t;
        st_bf16x2(dst + n, lrelu(acc[mf][nf][2 * h] + bias[n]),
                  lrelu(acc[mf][nf][2 * h + 1] + bias[n + 1]));
      }
    }
  }
}

// 3x3 64 -> 64 conv + bias + lrelu, bf16 out (conv_hr at 4K).
__global__ void __launch_bounds__(NTHREADS, 2)
    conv3x3_lrelu_kernel(const bf16* __restrict__ in, int H, int W, const bf16* __restrict__ w,
                         const float* __restrict__ bias, bf16* __restrict__ out) {
  extern __shared__ uint4 smem_u4[];
  bf16* s_in = reinterpret_cast<bf16*>(smem_u4);
  bf16* s_w = s_in + HT * HW * KP;
  const int b = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  float acc[2][8][4];
  conv_tile<3, 8>(acc, in, 64, 64, H, W, b, ty0, tx0, -1, -1, w, s_in, s_w);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    const int y = ty0 + 2 * warp + mf;
    if (y >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = tx0 + g + 8 * h;
      if (x >= W) continue;
      bf16* dst = out + (((size_t)b * H + y) * W + x) * 64;
#pragma unroll
      for (int nf = 0; nf < 8; ++nf) {
        const int n = nf * 8 + 2 * t;
        st_bf16x2(dst + n, lrelu(acc[mf][nf][2 * h] + bias[n]),
                  lrelu(acc[mf][nf][2 * h + 1] + bias[n + 1]));
      }
    }
  }
}

// conv_last 3x3 64 -> 3 (padded to 8 output channels) + bias, then the
// output epilogue. The f32 tile is staged in shared memory so that a 2x2
// quad can be finished by one thread.
//   OUT_BF16:      out0 (B, H, W, 3) bf16
//   OUT_RGB_U8:    out0 (B, H, W, 3) uint8
//   OUT_YUV420_U8: out0 Y (B, H, W), out1 U, out2 V (B, H/2, W/2) uint8
__global__ void __launch_bounds__(NTHREADS, 2)
    conv_last_kernel(const bf16* __restrict__ in, int H, int W, const bf16* __restrict__ w,
                     const float* __restrict__ bias, int mode, YuvCoef k, void* out0, void* out1,
                     void* out2) {
  extern __shared__ uint4 smem_u4[];
  bf16* s_in = reinterpret_cast<bf16*>(smem_u4);
  bf16* s_w = s_in + HT * HW * KP;
  const int b = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  float acc[2][1][4];
  conv_tile<3, 1>(acc, in, 64, 64, H, W, b, ty0, tx0, -1, -1, w, s_in, s_w);

  // conv_tile ends with a barrier, so the input tile's memory is free
  float* s_c = reinterpret_cast<float*>(smem_u4);   // [TH*TW][3]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (t < 2) {
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = 2 * t + j;
          if (n < 3) {
            const int p = (2 * warp + mf) * TW + g + 8 * h;
            s_c[p * 3 + n] = acc[mf][0][2 * h + j] + bias[n];
          }
        }
  }
  __syncthreads();

  const int tid = threadIdx.x;
  if (mode == OUT_YUV420_U8) {
    if (tid >= (TH / 2) * (TW / 2)) return;
    const int qy = tid / (TW / 2), qx = tid % (TW / 2);
    const int y = ty0 + 2 * qy, x = tx0 + 2 * qx;   // H, W and tile origins are even
    if (y >= H || x >= W) return;
    uint8_t* yp = static_cast<uint8_t*>(out0);
    float su = 0.f, sv = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* c = s_c + ((2 * qy + i) * TW + 2 * qx + j) * 3;
        const float r = fminf(fmaxf(c[0], 0.f), 1.f);
        const float gg = fminf(fmaxf(c[1], 0.f), 1.f);
        const float bb = fminf(fmaxf(c[2], 0.f), 1.f);
        const float yy = floorf(k.wy[0] * r + k.wy[1] * gg + k.wy[2] * bb + k.by);
        yp[((size_t)b * H + y + i) * W + x + j] = (uint8_t)fminf(fmaxf(yy, 0.f), 255.f);
        su += k.wu[0] * r + k.wu[1] * gg + k.wu[2] * bb;
        sv += k.wv[0] * r + k.wv[1] * gg + k.wv[2] * bb;
      }
    const size_t ci = ((size_t)b * (H / 2) + y / 2) * (W / 2) + x / 2;
    static_cast<uint8_t*>(out1)[ci] = (uint8_t)fminf(fmaxf(floorf(su + k.bc), 0.f), 255.f);
    static_cast<uint8_t*>(out2)[ci] = (uint8_t)fminf(fmaxf(floorf(sv + k.bc), 0.f), 255.f);
    return;
  }
  const int y = ty0 + tid / TW, x = tx0 + tid % TW;
  if (y >= H || x >= W) return;
  const float* c = s_c + tid * 3;
  const size_t o = (((size_t)b * H + y) * W + x) * 3;
  if (mode == OUT_BF16) {
    bf16* op = static_cast<bf16*>(out0);
#pragma unroll
    for (int n = 0; n < 3; ++n) op[o + n] = rb(c[n]);
  } else {
    uint8_t* op = static_cast<uint8_t*>(out0);
#pragma unroll
    for (int n = 0; n < 3; ++n)
      op[o + n] = (uint8_t)floorf(fminf(fmaxf(c[n], 0.f), 1.f) * 255.f + 0.5f);
  }
}

}  // namespace fw

using namespace fw;

extern "C" {

// in (B, H, W, 64) -> out (B, 2H, 2W, 64): conv after nearest 2x, lrelu.
int fw_tail_up2(const void* in, int B, int H, int W, const void* w, const void* bias, void* out,
                void* stream) {
  const int smem = conv_smem_bytes(4, 64);
  cudaError_t err = allow_smem(up2_phase_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * 4);
  up2_phase_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)in, H, W, (const bf16*)w, (const float*)bias, (bf16*)out);
  return (int)cudaGetLastError();
}

// in (B, H, W, 64) -> out (B, H, W, 64): 3x3 conv + bias + lrelu.
int fw_tail_hr(const void* in, int B, int H, int W, const void* w, const void* bias, void* out,
               void* stream) {
  const int smem = conv_smem_bytes(9, 64);
  cudaError_t err = allow_smem(conv3x3_lrelu_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  conv3x3_lrelu_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)in, H, W, (const bf16*)w, (const float*)bias, (bf16*)out);
  return (int)cudaGetLastError();
}

// conv_last + epilogue. coef: 11 floats (wy[3], wu[3], wv[3], by, bc).
int fw_tail_last(const void* in, int B, int H, int W, const void* w, const void* bias, int mode,
                 const float* coef, void* out0, void* out1, void* out2, void* stream) {
  const int smem = conv_smem_bytes(9, 8);
  cudaError_t err = allow_smem(conv_last_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  YuvCoef k;
  for (int i = 0; i < 3; ++i) {
    k.wy[i] = coef[i];
    k.wu[i] = coef[3 + i];
    k.wv[i] = coef[6 + i];
  }
  k.by = coef[9];
  k.bc = coef[10];
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  conv_last_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)in, H, W, (const bf16*)w, (const float*)bias, mode, k, out0, out1, out2);
  return (int)cudaGetLastError();
}

}  // extern "C"
