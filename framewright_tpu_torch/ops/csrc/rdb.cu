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
// point, so the design spends its effort on the product: implicit GEMM
// on mma.sync with bf16 operands and f32 accumulators, a 16x16-pixel
// tile per CTA so that each weight chunk staged in shared memory serves
// 256 pixels. Halo reads come straight from device memory, zero outside
// the image; packed words are not needed.
//
// Blocks: the same launches run the resident body (FW_RDB_BODY=resident)
// on halo blocks (nb, S, S, 192), the image of each block being the block
// itself, with ext (nb, 4) int32 the valid rectangle of each block
// (_rdb_kernel's ext_ref, fused_rrdb.py:412-444): x1..x4 are zero outside
// it and stage 5 writes bf16(bf16(0.2 where(valid, x5, 0)) + x). The
// halo rings are rebuilt between RDBs by halo.cu. ext == NULL is the
// image path, unchanged.
#include "conv_common.cuh"

namespace fw {

constexpr int WS_C = 192;   // workspace channels: x (64) + x1..x4 (4 x 32)
constexpr float BF16_0P2 = 0.2001953125f;   // bf16(0.2): JAX's weak-typed 0.2 * bf16

// Stages 1-4: ws[..., cin:cin+32] = bf16(lrelu(conv(ws[..., :cin]) + b)).
template <bool BLOCKS>
__global__ void __launch_bounds__(NTHREADS, 2)
    rdb_dense_kernel(bf16* ws, int H, int W, int cin, const bf16* __restrict__ w,
                     const float* __restrict__ bias, const int* __restrict__ ext) {
  extern __shared__ uint4 smem_u4[];
  bf16* s_in = reinterpret_cast<bf16*>(smem_u4);
  bf16* s_w = s_in + HT * HW * KP;
  const int b = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  float acc[2][4][4];
  conv_tile<3, 4>(acc, ws, WS_C, cin, H, W, b, ty0, tx0, -1, -1, w, s_in, s_w);
  const Rect valid = valid_rect(ext, b, H, W);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    const int y = ty0 + 2 * warp + mf;
    if (y >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = tx0 + g + 8 * h;
      if (x >= W) continue;
      bf16* dst = ws + (((size_t)b * H + y) * W + x) * WS_C + cin;
      const bool ok = !BLOCKS || valid.has(y, x);
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const int n = nf * 8 + 2 * t;
        st_bf16x2(dst + n, ok ? lrelu(acc[mf][nf][2 * h] + bias[n]) : 0.f,
                  ok ? lrelu(acc[mf][nf][2 * h + 1] + bias[n + 1]) : 0.f);
      }
    }
  }
}

// Stage 5: dst[..., :64] = bf16(bf16(0.2 (conv(ws) + b)) + ws[..., :64])
// (conv + b taken as 0 outside the valid rectangle),
// then with carry: dst[..., :64] = bf16(bf16(0.2 * dst) + carry[..., :64]).
// dst and carry may be the same workspace (each pixel reads its carry
// before it writes), but neither may be ws.
template <bool BLOCKS>
__global__ void __launch_bounds__(NTHREADS, 2)
    rdb_final_kernel(const bf16* __restrict__ ws, int H, int W, const bf16* __restrict__ w,
                     const float* __restrict__ bias, bf16* dst, const bf16* carry,
                     const int* __restrict__ ext) {
  extern __shared__ uint4 smem_u4[];
  bf16* s_in = reinterpret_cast<bf16*>(smem_u4);
  bf16* s_w = s_in + HT * HW * KP;
  const int b = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  float acc[2][8][4];
  conv_tile<3, 8>(acc, ws, WS_C, WS_C, H, W, b, ty0, tx0, -1, -1, w, s_in, s_w);
  const Rect valid = valid_rect(ext, b, H, W);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    const int y = ty0 + 2 * warp + mf;
    if (y >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = tx0 + g + 8 * h;
      if (x >= W) continue;
      const size_t pix = (((size_t)b * H + y) * W + x) * WS_C;
      const bool ok = !BLOCKS || valid.has(y, x);
#pragma unroll
      for (int nf = 0; nf < 8; ++nf) {
        const int n = nf * 8 + 2 * t;
        float o[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x5 = ok ? acc[mf][nf][2 * h + j] + bias[n + j] : 0.f;
          o[j] = bf(rb(bf(rb(0.2f * x5)) + bf(ws[pix + n + j])));
          if (carry != nullptr) o[j] = bf(rb(bf(rb(BF16_0P2 * o[j])) + bf(carry[pix + n + j])));
        }
        st_bf16x2(dst + pix + n, o[0], o[1]);
      }
    }
  }
}

}  // namespace fw

using namespace fw;

extern "C" {

// One dense stage k in 1..4 (cin = 64 + 32 (k - 1)) over the workspace;
// ext: NULL (images) or (B, 4) int32 valid rectangles (halo blocks).
int fw_rdb_dense(void* ws, int B, int H, int W, int cin, const void* w, const void* bias,
                 const void* ext, void* stream) {
  return (int)launch_tiles(ext, rdb_dense_kernel<true>, rdb_dense_kernel<false>,
                           conv_smem_bytes(9, 32), B, H, W, (cudaStream_t)stream, (bf16*)ws, H,
                           W, cin, (const bf16*)w, (const float*)bias, (const int*)ext);
}

// Stage 5 with the RDB residual, and the RRDB residual when carry != NULL.
int fw_rdb_final(const void* ws, int B, int H, int W, const void* w, const void* bias, void* dst,
                 const void* carry, const void* ext, void* stream) {
  return (int)launch_tiles(ext, rdb_final_kernel<true>, rdb_final_kernel<false>,
                           conv_smem_bytes(9, 64), B, H, W, (cudaStream_t)stream,
                           (const bf16*)ws, H, W, (const bf16*)w, (const float*)bias, (bf16*)dst,
                           (const bf16*)carry, (const int*)ext);
}

}  // extern "C"
