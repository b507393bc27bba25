// K1: conv_body 3x3 64->64 + bias + the head features' skip.
//
// Replaces framewright_tpu/ops/fused_tail3.py: _cbody_kernel (via
// conv_body_skip_blocks). out = bf16(conv(body) + b + feat), summed in f32
// and rounded once, as _cbody_kernel does.
//
// Bound: bytes, narrowly. A 1080p frame does 19 GMAC (38 GFLOP, 38 us at
// the bf16 peak) against 199 MB of reads and writes (body, feat, out:
// 59 us at 3.35 TB/s), ~190 FLOP per byte, below the card's balance
// point of ~295. So the product must keep pace with the copies, which
// conv_wgmma.cuh's main loop does (wgmma, a TMA-fed ring kept full by a
// producer warpgroup, a persistent grid). Each operand is read once: the
// body's 64 channels straight from the RDB workspace (channel stride 192,
// no copy), and the skip folded into the store, so the add costs one
// read of feat and no extra pass.
#include "conv_wgmma.cuh"

namespace fw {

struct BodySkipEpi {
  int H, W;
  const float* __restrict__ bias;
  const bf16* __restrict__ feat;
  bf16* __restrict__ out;

  __device__ __forceinline__ bool live(int, int, int) const { return true; }

  // Straight from the fragments: the f32 sum must meet feat before its
  // one rounding, and staging 256 pixels x 64 channels of f32 through
  // shared memory (in two halves) measured slower than this.
  static constexpr int SLICES = 0;   // stage() stores the tile itself
  static constexpr int BUF = wg::epi_bytes(64);   // unused
  static constexpr bool DEFER = false;
  struct Slice {};
  __device__ __forceinline__ void load(Slice&, int, int, int, int, const uint8_t*) const {}
  __device__ __forceinline__ void finish(const Slice&, int, int, int, int, const uint8_t*) const {}

  __device__ __forceinline__ void stage(const float (&acc)[4][32], wg::NoPart&, int b, int y0,
                                        int x0, bool, uint8_t*) const {
    const wg::Frag f;
    float bs[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      bs[i][0] = bias[8 * i + 2 * f.t];
      bs[i][1] = bias[8 * i + 2 * f.t + 1];
    }
    // pixel s = (j, h) of this thread: j = s / 2, h = s % 2; its skip is
    // loaded one pixel ahead, so the loads' latency overlaps the stores
    __nv_bfloat162 sv[2][8];
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      if (s < 8) {
        const int y = min(y0 + 4 * f.q + (s >> 1), H - 1), x = min(x0 + f.g + 8 * (s & 1), W - 1);
        const size_t pix = (((size_t)b * H + y) * W + x) * 64 + 2 * f.t;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sv[s & 1][i] = *reinterpret_cast<const __nv_bfloat162*>(feat + pix + 8 * i);
      }
      if (s == 0) continue;
      const int p = s - 1, j = p >> 1, h = p & 1;
      const int y = y0 + 4 * f.q + j, x = x0 + f.g + 8 * h;
      if (y >= H || x >= W) continue;
      const size_t pix = (((size_t)b * H + y) * W + x) * 64 + 2 * f.t;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        st_bf16x2(out + pix + 8 * i, acc[j][4 * i + 2 * h] + bs[i][0] + bf(sv[p & 1][i].x),
                  acc[j][4 * i + 2 * h + 1] + bs[i][1] + bf(sv[p & 1][i].y));
    }
  }
};

}  // namespace fw

using namespace fw;

// w: conv_body's weights in launch_conv3x3's chunked layout
// (fused_rrdb.wgmma_weights).
extern "C" int fw_conv_body_skip(const void* body, int body_cs, int B, int H, int W, const void* w,
                                 const void* bias, const void* feat, void* out, void* stream) {
  return (int)wg::launch_conv3x3<64>(
      (const bf16*)body, body_cs, 64, B, H, W, (const bf16*)w,
      BodySkipEpi{H, W, (const float*)bias, (const bf16*)feat, (bf16*)out}, (cudaStream_t)stream);
}
