// ResidualDenseBlock sweep of the RRDB body, one launch per dense stage.
//
// Replaces framewright_tpu/ops/fused_rrdb.py: _rdb_kernel_merge and
// _rdb_kernel_merge_res (via fused_rdb_blocks_merge), the bf16 RDB that
// the default RealESRGAN_x2plus body runs 69 times per frame.
//
// Data: one NHWC bf16 workspace (B, H, W, 192) per RDB. Channels 0:64
// hold the block input x and 64:192 receive x1..x4, so the dense
// concatenation [x, x1, .., x_k] is a prefix of the channel axis and
// costs no copy. Stage k < 5 reads channels 0:64+32(k-1) and writes its
// 32 channels as bf16(lrelu(acc + b)). Stage 5 (192 -> 64) writes
// bf16(bf16(0.2 (acc + b)) + x) into channels 0:64 of the destination
// workspace; for the third RDB of an RRDB it then applies the RRDB
// residual bf16(bf16(0.2) * o) + carry in place over the carry. These
// are the rounding points of _rdb_kernel_merge_res
// (fused_rrdb.py:917-946).
//
// Bound: tensor-core operations. A 540x960 body does 239,616 MAC per
// pixel per RDB, 0.248 TFLOP per RDB, against 133 MB of workspace
// traffic: about 1,900 FLOP per byte, far above the card's balance
// point. So every stage runs on conv_wgmma.cuh's main loop, which keeps
// the tensor cores fed: wgmma with A from ldmatrix and B from shared
// memory, a TMA-fed ring of stages kept full by a producer warpgroup, and
// a persistent grid whose CTAs stage each weight chunk once for two
// 16x16 tiles. Stages 1-4 (N = 32) and stage 5 (N = 64) stage their
// outputs through shared memory so that the stores, and stage 5's reads
// of x and carry, are whole 16-byte runs; stages 1-4 write theirs while
// the next tile's products run.
//
// Blocks: the same launches run the resident body (FW_RDB_BODY=resident)
// on halo blocks (nb, S, S, 192), the image of each block being the block
// itself, with ext (nb, 4) int32 the valid rectangle of each block
// (_rdb_kernel's ext_ref, fused_rrdb.py:412-444): x1..x4 are zero outside
// it and stage 5 writes bf16(bf16(0.2 where(valid, x5, 0)) + x). A tile
// wholly outside its block's rectangle stages nothing and runs no
// product; it stores zeros (stages 1-4) or x with the residual (stage 5).
// The halo rings are rebuilt between RDBs by halo.cu. Block mode is the
// template parameter BLOCKS (ext != NULL): the image path tests nothing.
#include "conv_wgmma.cuh"

namespace fw {

constexpr int WS_C = 192;   // workspace channels: x (64) + x1..x4 (4 x 32)
constexpr float BF16_0P2 = 0.2001953125f;   // bf16(0.2): JAX's weak-typed 0.2 * bf16

// Stages 1-4: ws[..., cin:cin+32] = bf16(lrelu(conv(ws[..., :cin]) + b)).
template <bool BLOCKS>
struct DenseEpi {
  bf16* ws;
  int H, W, cin;
  const float* __restrict__ bias;
  const int* __restrict__ ext;

  __device__ __forceinline__ bool live(int b, int y0, int x0) const {
    return !BLOCKS || wg::tile_meets(valid_rect(ext, b, H, W), y0, x0);
  }

  static constexpr int ROW = wg::epi_row(32), BUF = wg::epi_bytes(32);
  // 256 pixels x 4 runs of 8 channels: 8 runs a thread, 2 a slice,
  // written while the next tile's products run
  static constexpr int SLICES = 4;
  static constexpr bool DEFER = true;
  struct Slice {};

  __device__ __forceinline__ void stage(const float (&acc)[4][16], wg::NoPart&, int b, int y0,
                                        int x0, bool lv, uint8_t* buf) const {
    const wg::Frag f;
    const Rect valid = valid_rect(ext, b, H, W);
    float bs[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bs[i][0] = bias[8 * i + 2 * f.t];
      bs[i][1] = bias[8 * i + 2 * f.t + 1];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = !BLOCKS || (lv && valid.has(y0 + 4 * f.q + j, x0 + f.g + 8 * h));
        uint8_t* row = buf + f.px(j, h) * ROW;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          st_bf16x2(reinterpret_cast<bf16*>(row) + 8 * i + 2 * f.t,
                    ok ? lrelu(acc[j][4 * i + 2 * h] + bs[i][0]) : 0.f,
                    ok ? lrelu(acc[j][4 * i + 2 * h + 1] + bs[i][1]) : 0.f);
      }
    }
  }

  __device__ __forceinline__ void load(Slice&, int, int, int, int, const uint8_t*) const {}

  __device__ __forceinline__ void finish(const Slice&, int k, int b, int y0, int x0,
                                         const uint8_t* buf) const {
    const wg::Frag f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = (2 * k + e) * 128 + f.wt, p = r >> 2, c8 = r & 3;
      const int y = y0 + p / wg::TS, x = x0 + p % wg::TS;
      if (y < H && x < W)
        *reinterpret_cast<uint4*>(ws + (((size_t)b * H + y) * W + x) * WS_C + cin + 8 * c8) =
            *reinterpret_cast<const uint4*>(buf + p * ROW + 16 * c8);
    }
  }
};

// Stage 5: dst[..., :64] = bf16(bf16(0.2 (conv(ws) + b)) + ws[..., :64])
// (conv + b taken as 0 outside the valid rectangle),
// then with carry: dst[..., :64] = bf16(bf16(0.2 * dst) + carry[..., :64]).
// dst and carry may be the same workspace (each pixel reads its carry
// before it writes), but neither may be ws.
template <bool BLOCKS>
struct FinalEpi {
  const bf16* __restrict__ ws;
  int H, W;
  const float* __restrict__ bias;
  bf16* dst;
  const bf16* carry;
  const int* __restrict__ ext;

  __device__ __forceinline__ bool live(int b, int y0, int x0) const {
    return !BLOCKS || wg::tile_meets(valid_rect(ext, b, H, W), y0, x0);
  }

  static constexpr int ROW = wg::epi_row(64), BUF = wg::epi_bytes(64);
  // 256 pixels x 8 runs of 8 channels: 16 runs a thread, 4 a slice, all
  // written at once (one slice a chunk, the loads of x and carry slowed
  // the next tile's products more than they saved)
  static constexpr int SLICES = 4;
  static constexpr bool DEFER = false;
  struct Slice {
    uint4 x[4], c[4];
  };

  // the first rounding point, bf16(0.2 x5), staged in the fragment layout
  __device__ __forceinline__ void stage(const float (&acc)[4][32], wg::NoPart&, int b, int y0,
                                        int x0, bool lv, uint8_t* buf) const {
    const wg::Frag f;
    const Rect valid = valid_rect(ext, b, H, W);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float b0 = bias[8 * i + 2 * f.t], b1 = bias[8 * i + 2 * f.t + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok = !BLOCKS || (lv && valid.has(y0 + 4 * f.q + j, x0 + f.g + 8 * h));
          st_bf16x2(reinterpret_cast<bf16*>(buf + f.px(j, h) * ROW) + 8 * i + 2 * f.t,
                    0.2f * (ok ? acc[j][4 * i + 2 * h] + b0 : 0.f),
                    0.2f * (ok ? acc[j][4 * i + 2 * h + 1] + b1 : 0.f));
        }
      }
    }
  }

  // run e of slice k: pixel p of the tile, channels 8 c8 .. +8
  __device__ __forceinline__ size_t at(int k, int e, int b, int y0, int x0, int& p, int& c8,
                                       bool& in) const {
    const int r = (4 * k + e) * 128 + wg::Frag().wt;
    p = r >> 3, c8 = r & 7;
    const int y = y0 + p / wg::TS, x = x0 + p % wg::TS;
    in = y < H && x < W;
    return (((size_t)b * H + (in ? y : 0)) * W + (in ? x : 0)) * WS_C + 8 * c8;
  }

  __device__ __forceinline__ void load(Slice& sl, int k, int b, int y0, int x0,
                                       const uint8_t*) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int p, c8;
      bool in;
      const size_t o = at(k, e, b, y0, x0, p, c8, in);
      sl.x[e] = *reinterpret_cast<const uint4*>(ws + o);
      sl.c[e] = carry != nullptr ? *reinterpret_cast<const uint4*>(carry + o) : sl.x[e];
    }
  }

  __device__ __forceinline__ void finish(const Slice& sl, int k, int b, int y0, int x0,
                                         const uint8_t* buf) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int p, c8;
      bool in;
      const size_t o = at(k, e, b, y0, x0, p, c8, in);
      const uint4 tv = *reinterpret_cast<const uint4*>(buf + p * ROW + 16 * c8);
      const bf16* t5 = reinterpret_cast<const bf16*>(&tv);
      const bf16* xs = reinterpret_cast<const bf16*>(&sl.x[e]);
      const bf16* cs = reinterpret_cast<const bf16*>(&sl.c[e]);
      uint4 ov;
      bf16* out = reinterpret_cast<bf16*>(&ov);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = bf(rb(bf(t5[i]) + bf(xs[i])));
        if (carry != nullptr) v = bf(rb(bf(rb(BF16_0P2 * v)) + bf(cs[i])));
        out[i] = rb(v);
      }
      if (in) *reinterpret_cast<uint4*>(dst + o) = ov;
    }
  }
};

}  // namespace fw

using namespace fw;

extern "C" {

// One dense stage k in 1..4 (cin = 64 + 32 (k - 1)) over the workspace;
// w: the conv's weights in launch_conv3x3's chunked layout
// (fused_rrdb.wgmma_weights), here and in fw_rdb_final;
// ext: NULL (images) or (B, 4) int32 valid rectangles (halo blocks).
int fw_rdb_dense(void* ws, int B, int H, int W, int cin, const void* w, const void* bias,
                 const void* ext, void* stream) {
  const bf16* in = (const bf16*)ws;
  if (ext != nullptr)
    return (int)wg::launch_conv3x3<32>(
        in, WS_C, cin, B, H, W, (const bf16*)w,
        DenseEpi<true>{(bf16*)ws, H, W, cin, (const float*)bias, (const int*)ext},
        (cudaStream_t)stream);
  return (int)wg::launch_conv3x3<32>(
      in, WS_C, cin, B, H, W, (const bf16*)w,
      DenseEpi<false>{(bf16*)ws, H, W, cin, (const float*)bias, nullptr}, (cudaStream_t)stream);
}

// Stage 5 with the RDB residual, and the RRDB residual when carry != NULL.
int fw_rdb_final(const void* ws, int B, int H, int W, const void* w, const void* bias, void* dst,
                 const void* carry, const void* ext, void* stream) {
  const bf16* in = (const bf16*)ws;
  if (ext != nullptr)
    return (int)wg::launch_conv3x3<64>(
        in, WS_C, WS_C, B, H, W, (const bf16*)w,
        FinalEpi<true>{in, H, W, (const float*)bias, (bf16*)dst, (const bf16*)carry,
                       (const int*)ext},
        (cudaStream_t)stream);
  return (int)wg::launch_conv3x3<64>(
      in, WS_C, WS_C, B, H, W, (const bf16*)w,
      FinalEpi<false>{in, H, W, (const float*)bias, (bf16*)dst, (const bf16*)carry, nullptr},
      (cudaStream_t)stream);
}

// Dynamic shared memory of the conv3x3 main loop for N output channels
// (32: stages 1-4; 64: stage 5 and K1).
int fw_wgmma_smem_bytes(int n) { return n <= 32 ? wg::smem_bytes(32) : wg::smem_bytes(64); }

}  // extern "C"
