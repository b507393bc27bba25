// 3x3 SAME convolution + bias (+ lrelu), bf16 in and out, f32 accumulation:
// the convs of the band-conv RRDB tail (FastTail).
//
// Replaces framewright_tpu/ops/pallas_conv.py: _kernel (via band_conv3x3).
// out[b, y, x, n] = bf16(act(sum conv + bias[n])), with act lrelu or none,
// the TPU kernel's rounding points (pallas_conv.py:80-83). Cout is 64 (a
// full-width conv) or 8 (conv_last's 3 outputs padded with zero weights
// and zero biases; the caller crops).
//
// The TPU kernel cuts the image into row bands, fetches each band's halo
// rows by a double-buffered DMA from a zero-padded flat copy whose width
// is a multiple of 128, and turns taps into lane rolls: Mosaic
// workarounds, none carried over.
//
// Bound: bytes, narrowly. A 64->64 conv at 2160x3840 does 611.5 GFLOP
// (0.618 ms at the bf16 peak) against 2.12 GB of input and output (0.633
// ms at 3.35 TB/s): ~290 FLOP per byte, at the card's balance point. So
// loads, products and stores have to overlap.
//
// Design: conv_wgmma.cuh's main loop, as K2 runs its conv_hr and conv_last
// (launch_conv3x3, Taps3x3): TMA halo boxes with zeros outside the image
// (SAME padding), the chunk-major weights by one bulk copy a chunk, a
// producer warpgroup that keeps a ring full across tiles, two consumer
// warpgroups on wgmma m64nNk16, a persistent grid. Cout 64 with lrelu is
// fw_tail_hr's own instance (BiasActEpi<false, true>, epi_bf16.cuh), so
// the two give the same bits; without act it is BiasActEpi<false, false>.
// Cout 8 runs N = 8 with Bf16x8Epi, which stages a tile's 256 pixels x 8
// bf16 and writes one 16-byte run a pixel. The weights are the
// chunk-major copy BandConvWeights.wk (fused_rrdb.wgmma_weights of the
// OHWI w). The f32 sums run in conv_wgmma.cuh's order (chunk, column tap,
// row tap), which is neither the TPU kernel's nor cuDNN's: an output may
// sit one bf16 step from the plain version.
#include "epi_bf16.cuh"

namespace fw {

// out = bf16(act(acc + bias)), 8 channels (N = 8: acc[j][2 h + e] is pixel
// px(j, h), channel 2 t + e). The tile is staged as bf16, 16 bytes a
// pixel (the eight pixels of a fragment row on 128 contiguous bytes, so
// the writes fall on distinct banks), then each thread writes whole
// pixels, neighbouring threads on neighbouring pixels.
template <bool ACT>
struct Bf16x8Epi {
  int H, W;
  const float* __restrict__ bias;
  bf16* __restrict__ out;

  __device__ __forceinline__ bool live(int, int, int) const { return true; }

  static constexpr int BUF = wg::TPX * 16;
  static constexpr int SLICES = 1;
  static constexpr bool DEFER = false;
  struct Slice {};

  __device__ __forceinline__ void stage(const float (&acc)[4][4], wg::NoPart&, int, int, int,
                                        bool, uint8_t* buf) const {
    const wg::Frag f;
    const float b0 = bias[2 * f.t], b1 = bias[2 * f.t + 1];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        st_bf16x2(reinterpret_cast<bf16*>(buf + f.px(j, h) * 16) + 2 * f.t,
                  activate<ACT>(acc[j][2 * h] + b0), activate<ACT>(acc[j][2 * h + 1] + b1));
  }

  __device__ __forceinline__ void load(Slice&, int, int, int, int, const uint8_t*) const {}

  __device__ __forceinline__ void finish(const Slice&, int, int b, int y0, int x0,
                                         const uint8_t* buf) const {
    const int tid = wg::Frag().wt;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int p = s * 128 + tid;
      const int y = y0 + p / wg::TS, x = x0 + p % wg::TS;
      if (y >= H || x >= W) continue;
      *reinterpret_cast<uint4*>(out + (((size_t)b * H + y) * W + x) * 8) =
          *reinterpret_cast<const uint4*>(buf + p * 16);
    }
  }
};

template <int N, class Epi>
cudaError_t launch_band_conv(const void* in, int B, int H, int W, int cin, const void* w,
                             const Epi& epi, void* stream) {
  return wg::launch_conv3x3<N>((const bf16*)in, cin, cin, B, H, W, (const bf16*)w, epi,
                               (cudaStream_t)stream);
}

}  // namespace fw

using namespace fw;

// in (B, H, W, cin) bf16, cin a multiple of 16; w: the (cout, 3, 3, cin)
// weights in launch_conv3x3's chunked layout (fused_rrdb.wgmma_weights);
// bias (cout,) f32; out (B, H, W, cout) bf16, cout 64 or 8; act 1 = lrelu.
// Any other shape returns cudaErrorInvalidValue and launches nothing.
extern "C" int fw_band_conv(const void* in, int B, int H, int W, int cin, const void* w,
                            const void* bias, int cout, int act, void* out, void* stream) {
  const float* b = (const float*)bias;
  bf16* o = (bf16*)out;
  if (cout == 64)
    return (int)(act ? launch_band_conv<64>(in, B, H, W, cin, w,
                                            BiasActEpi<false, true>{H, W, b, o}, stream)
                     : launch_band_conv<64>(in, B, H, W, cin, w,
                                            BiasActEpi<false, false>{H, W, b, o}, stream));
  if (cout == 8)
    return (int)(act ? launch_band_conv<8>(in, B, H, W, cin, w, Bf16x8Epi<true>{H, W, b, o},
                                           stream)
                     : launch_band_conv<8>(in, B, H, W, cin, w, Bf16x8Epi<false>{H, W, b, o},
                                           stream));
  return (int)cudaErrorInvalidValue;
}
