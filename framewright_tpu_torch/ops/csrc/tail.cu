// K2: the Real-ESRGAN upsampling tail with the output epilogue.
//
// Replaces framewright_tpu/ops/fused_tail.py: _make_tail2_kernel (via
// fused_tail2_blocks), with the weights of tail2_phase_weights and the
// colour matrix of yuv420_matrix, and _tail_kernel (tail1, via
// fused_tail_blocks: the last three launches). From the conv_body+skip
// output x at body resolution (B, h, w, 64) it computes
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
// Bound: by operations, 490 GMAC a 1080p frame (0.98 TFLOP, 0.99 ms at
// the bf16 peak, 62% of it in conv_hr); by bytes, with a0, a and c in
// device memory (a and c 1.06 GB each at 4K), 4.86 GB, 1.45 ms at 3.35
// TB/s. So the launches are balanced between the two, and conv_hr alone
// (611 GFLOP against 2.1 GB) sits at the card's balance point. Design:
// all four launches run on conv_wgmma.cuh's main loop (wgmma, a TMA-fed
// ring kept full by a producer warpgroup, a persistent grid): conv_hr as
// a 3x3 conv; conv_up1 and conv_up2 as four passes of 2x2 taps over each
// tile group's halo boxes (TapsUp2: the boxes stay in the ring across
// the passes, only each phase's weights are loaded, one wgmma group of 16
// products a chunk); conv_last at N = 8 (its 3 outputs padded). Each
// 64-channel epilogue (BiasActEpi, epi_bf16.cuh, which the band conv
// shares) stages its bf16 tile in shared memory and writes it as 16-byte
// runs while the next pass's products run. What holds it
// now (PERF.md, the per-launch split on an H100): the traffic of a and c
// and the epilogues. Built without products, the launches still take 75%
// of their time (conv_hr 0.78 of 1.10 ms, reading a and writing c at
// ~2.7 TB/s); without the epilogue's staging, 12-15% less. Keeping c on
// chip, as the TPU kernel does, means conv_last inside conv_hr's tiles
// with conv_hr recomputed on a one-pixel halo (18x18 of c for 16x16
// outputs: 1.27x its MACs, and 324 rows are six 64-row wgmma tiles,
// 1.5x) to save 2.1 GB of traffic.
#include "epi_bf16.cuh"

namespace fw {

struct YuvCoef {
  float wy[3];   // Y per RGB channel (BT.601 x range scale)
  float wu[3];   // U per RGB channel, already x 0.25 for the 2x2 mean
  float wv[3];
  float by;      // Y offset + 0.5 (16.5 limited, 0.5 full range)
  float bc;      // chroma offset + 0.5 (128.5)
};

enum OutMode { OUT_BF16 = 0, OUT_RGB_U8 = 1, OUT_YUV420_U8 = 2 };

// conv_last 3x3 64 -> 3 (padded to 8 output channels) + bias in f32, then
// the output epilogue. The f32 tile is staged in shared memory so that a
// 2x2 quad can be finished by one thread.
//   OUT_BF16:      out0 (B, H, W, 3) bf16
//   OUT_RGB_U8:    out0 (B, H, W, 3) uint8
//   OUT_YUV420_U8: out0 Y (B, H, W), out1 U, out2 V (B, H/2, W/2) uint8
struct LastEpi {
  int H, W;
  const float* __restrict__ bias;
  int mode;
  YuvCoef k;
  void *out0, *out1, *out2;

  __device__ __forceinline__ bool live(int, int, int) const { return true; }

  static constexpr int BUF = wg::TPX * 16;   // 256 pixels x 4 f32 (3 used)
  static constexpr int SLICES = 1;
  static constexpr bool DEFER = false;
  struct Slice {};

  // acc[j][2 h + e]: pixel px(j, h), channel 2 t + e (N = 8, one n8 block)
  __device__ __forceinline__ void stage(const float (&acc)[4][4], wg::NoPart&, int, int, int,
                                        bool, uint8_t* buf) const {
    const wg::Frag f;
    if (f.t >= 2) return;
    float* s_c = reinterpret_cast<float*>(buf);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 2 * f.t + e;
      if (n >= 3) continue;
      const float bn = bias[n];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) s_c[f.px(j, h) * 4 + n] = acc[j][2 * h + e] + bn;
    }
  }

  __device__ __forceinline__ void load(Slice&, int, int, int, int, const uint8_t*) const {}

  __device__ __forceinline__ void finish(const Slice&, int, int b, int y0, int x0,
                                         const uint8_t* buf) const {
    const float* s_c = reinterpret_cast<const float*>(buf);
    const int tid = wg::Frag().wt;
    if (mode == OUT_YUV420_U8) {
      if (tid >= (wg::TS / 2) * (wg::TS / 2)) return;
      const int qy = tid / (wg::TS / 2), qx = tid % (wg::TS / 2);
      const int y = y0 + 2 * qy, x = x0 + 2 * qx;   // H, W and tile origins are even
      if (y >= H || x >= W) return;
      uint8_t* yp = static_cast<uint8_t*>(out0);
      float su = 0.f, sv = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* c = s_c + ((2 * qy + i) * wg::TS + 2 * qx + j) * 4;
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
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int p = s * 128 + tid;
      const int y = y0 + p / wg::TS, x = x0 + p % wg::TS;
      if (y >= H || x >= W) continue;
      const float* c = s_c + p * 4;
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
  }
};

}  // namespace fw

using namespace fw;

extern "C" {

// in (B, H, W, 64) -> out (B, 2H, 2W, 64): conv after nearest 2x, lrelu;
// w: the four phases' weights in launch_conv3x3's layout of TapsUp2
// (fused_tail.tail_weights).
int fw_tail_up2(const void* in, int B, int H, int W, const void* w, const void* bias, void* out,
                void* stream) {
  return (int)wg::launch_conv3x3<64, false, wg::TapsUp2>(
      (const bf16*)in, 64, 64, B, H, W, (const bf16*)w,
      BiasActEpi<true, true>{H, W, (const float*)bias, (bf16*)out}, (cudaStream_t)stream);
}

// in (B, H, W, 64) -> out (B, H, W, 64): 3x3 conv + bias + lrelu; w in
// launch_conv3x3's chunked layout (fused_rrdb.wgmma_weights).
int fw_tail_hr(const void* in, int B, int H, int W, const void* w, const void* bias, void* out,
               void* stream) {
  return (int)wg::launch_conv3x3<64>(
      (const bf16*)in, 64, 64, B, H, W, (const bf16*)w,
      BiasActEpi<false, true>{H, W, (const float*)bias, (bf16*)out}, (cudaStream_t)stream);
}

// conv_last + epilogue, w (8 output channels, 3 real) in launch_conv3x3's
// chunked layout. coef: 11 floats (wy[3], wu[3], wv[3], by, bc).
int fw_tail_last(const void* in, int B, int H, int W, const void* w, const void* bias, int mode,
                 const float* coef, void* out0, void* out1, void* out2, void* stream) {
  YuvCoef k;
  for (int i = 0; i < 3; ++i) {
    k.wy[i] = coef[i];
    k.wu[i] = coef[3 + i];
    k.wv[i] = coef[6 + i];
  }
  k.by = coef[9];
  k.bc = coef[10];
  return (int)wg::launch_conv3x3<8>(
      (const bf16*)in, 64, 64, B, H, W, (const bf16*)w,
      LastEpi{H, W, (const float*)bias, mode, k, out0, out1, out2}, (cudaStream_t)stream);
}

}  // extern "C"
