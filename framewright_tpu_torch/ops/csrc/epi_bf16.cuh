// The 64-channel bf16 epilogue of conv_wgmma.cuh's main loop that the
// upsampling tail (tail.cu: conv_up1, conv_up2, conv_hr) and the band conv
// (band_conv.cu) share: out = bf16(act(acc + bias)), act lrelu(0.2) when
// ACT, else none. ACT is a template parameter, not a run-time test (a
// run-time test of block mode cost the int8 RDB 5%, PERF.md), so that each
// instance compiles to the code of its own case.
#pragma once

#include "conv_wgmma.cuh"

namespace fw {

template <bool ACT>
__device__ __forceinline__ float activate(float v) {
  return ACT ? lrelu(v) : v;
}

// 64 channels from an input of H x W: a 3x3 conv (UP2 false, out H x W) or
// a phase conv (UP2, TapsUp2: pass p of image b arrives as image 4 b + p
// and lands at (2 y + p / 2, 2 x + p % 2) of the 2H x 2W output).
template <bool UP2, bool ACT>
struct BiasActEpi {
  int H, W;
  const float* __restrict__ bias;
  bf16* __restrict__ out;

  __device__ __forceinline__ bool live(int, int, int) const { return true; }

  static constexpr int ROW = wg::epi_row(64), BUF = wg::epi_bytes(64);
  // 256 pixels x 8 runs of 8 channels: 16 runs a thread, 4 a slice,
  // written while the next pass's products run
  static constexpr int SLICES = 4;
  static constexpr bool DEFER = true;
  struct Slice {};

  __device__ __forceinline__ void stage(const float (&acc)[4][32], wg::NoPart&, int, int, int,
                                        bool, uint8_t* buf) const {
    const wg::Frag f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float b0 = bias[8 * i + 2 * f.t], b1 = bias[8 * i + 2 * f.t + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          st_bf16x2(reinterpret_cast<bf16*>(buf + f.px(j, h) * ROW) + 8 * i + 2 * f.t,
                    activate<ACT>(acc[j][4 * i + 2 * h] + b0),
                    activate<ACT>(acc[j][4 * i + 2 * h + 1] + b1));
      }
    }
  }

  __device__ __forceinline__ void load(Slice&, int, int, int, int, const uint8_t*) const {}

  __device__ __forceinline__ void finish(const Slice&, int k, int b, int y0, int x0,
                                         const uint8_t* buf) const {
    const wg::Frag f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (4 * k + e) * 128 + f.wt, p = r >> 3, c8 = r & 7;
      const int y = y0 + p / wg::TS, x = x0 + p % wg::TS;
      if (y >= H || x >= W) continue;
      const size_t o = UP2 ? ((size_t)(b >> 2) * 2 * H + 2 * y + ((b >> 1) & 1)) * 2 * W + 2 * x +
                                 (b & 1)
                           : ((size_t)b * H + y) * W + x;
      *reinterpret_cast<uint4*>(out + o * 64 + 8 * c8) =
          *reinterpret_cast<const uint4*>(buf + p * ROW + 16 * c8);
    }
  }
};

}  // namespace fw
