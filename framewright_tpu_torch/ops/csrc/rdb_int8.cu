// int8 ResidualDenseBlock sweep of the RRDB body with static activation
// scales, one launch per dense stage plus the quantization of x.
//
// Replaces framewright_tpu/ops/fused_rrdb.py:
//   _rdb_kernel_int8_i32_merge, _rdb_kernel_int8_i32_merge_res (via
//     fused_rdb_blocks_merge_int8_i32): scheme "i32", weights
//     rdb_wide_weights_int8_i32;
//   _rdb_kernel_int8_static_merge (via fused_rdb_blocks_merge_int8) and
//     _rdb_kernel_int8_static (via fused_rdb_blocks_int8, the round-trip
//     body): scheme "f32acc", weights rdb_wide_weights_int8 with act_q.
// Each runs 69 times per frame on its int8 restore. Data and arithmetic:
// rdb_int8.cuh.
//
// Bound: tensor-core operations. A 540x960 body does 239,616 MAC per
// pixel per RDB, 248 G operations, 0.126 ms at the card's 1,979 TOP/s
// int8 dense peak, against 133 MB of bf16 input and output (0.040 ms at
// 3.35 TB/s). The design is the bf16 RDB's (rdb.cu) on the s8 tensor
// cores: half the mma instructions and half the staged bytes per channel
// (conv_s8.cuh), codes one byte a channel in Q. The TPU kernel's ring
// merge and four codes per int32 word are Mosaic workarounds and have no
// counterpart here; its resident blocks are the resident body's (ext,
// rdb_int8.cuh; halo.cu).
#include "rdb_int8.cuh"

namespace fw {

// q[p, c] = clip(rint(f32(x[p, c]) * inv0)) for c < 64, 8 channels a thread.
__global__ void rdb_i8_quant_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q,
                                    long long n8, float inv0) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const long long p = i >> 3;
  const int c = (int)(i & 7) * 8;
  const uint4 raw = *reinterpret_cast<const uint4*>(x + p * X_C + c);
  const bf16* v = reinterpret_cast<const bf16*>(&raw);
  union {
    int8_t s[8];
    uint2 u;
  } out;
#pragma unroll
  for (int j = 0; j < 8; ++j) out.s[j] = code(__fmul_rn(bf(v[j]), inv0));
  *reinterpret_cast<uint2*>(q + p * Q_C + c) = out.u;
}

// Stages 1-4: Q[..., cin:cin+32] = codes of lrelu(conv(Q[..., :cin]) + b).
//   i32   : sc = oscale (32), bias = obias (32)
//   f32acc: sc = ws_row * sa_src (32 x 5), bias = b (32), inv_next = 1 / sa_k
template <int MODE, bool BLOCKS>
__global__ void __launch_bounds__(NTHREADS, 2)
    rdb_i8_dense_kernel(int8_t* q, int H, int W, int cin, const int8_t* __restrict__ w,
                        const float* __restrict__ sc, const float* __restrict__ bias,
                        float inv_next, const int* __restrict__ ext) {
  extern __shared__ uint4 smem_u4[];
  int8_t* s_in = reinterpret_cast<int8_t*>(smem_u4);
  int8_t* s_w = s_in + HT * HW * KP8;
  const int b = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  int acc[2][4][4];
  float facc[2][4][4];
  accumulate<4, MODE>(acc, facc, q, cin, H, W, b, ty0, tx0, w, sc, nullptr, s_in, s_w);
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
      int8_t* dst = q + (((size_t)b * H + y) * W + x) * Q_C + cin;
      const bool ok = !BLOCKS || valid.has(y, x);
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const int n = nf * 8 + 2 * t;
        char2 out;
        int8_t c[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 2 * h + j;
          const float v = lrelu_rn(
              preact<MODE>(acc[mf][nf][r], facc[mf][nf][r], MODE == I32 ? sc[n + j] : 0.f, bias[n + j]));
          c[j] = ok ? code(MODE == F32ACC ? __fmul_rn(v, inv_next) : v) : 0;
        }
        out.x = c[0];
        out.y = c[1];
        *reinterpret_cast<char2*>(dst + n) = out;
      }
    }
  }
}

}  // namespace fw

using namespace fw;

extern "C" {

// q0 = codes of x for npix pixels (channels 0:64 of the workspace).
int fw_rdb_i8_quant(const void* x, void* q, long long npix, float inv0, void* stream) {
  const long long n8 = npix * 8;
  const int threads = 256;
  const long long blocks = (n8 + threads - 1) / threads;
  rdb_i8_quant_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (int8_t*)q, n8, inv0);
  return (int)cudaGetLastError();
}

// One dense stage k in 1..4 (cin = 64 + 32 (k - 1)); f32acc selects the
// scheme; ext: NULL (images) or (B, 4) int32 valid rectangles (blocks).
int fw_rdb_i8_dense(void* q, int B, int H, int W, int cin, const void* w, const void* sc,
                    const void* bias, float inv_next, int f32acc, const void* ext,
                    void* stream) {
  const bool f = f32acc != 0;
  return (int)launch_tiles(
      ext, f ? rdb_i8_dense_kernel<F32ACC, true> : rdb_i8_dense_kernel<I32, true>,
      f ? rdb_i8_dense_kernel<F32ACC, false> : rdb_i8_dense_kernel<I32, false>,
      conv_s8_smem_bytes(32), B, H, W, (cudaStream_t)stream, (int8_t*)q, H, W, cin,
      (const int8_t*)w, (const float*)sc, (const float*)bias, inv_next, (const int*)ext);
}

// Stage 5 with the RDB residual, and the RRDB residual when carry != NULL.
int fw_rdb_i8_final(const void* q, int B, int H, int W, const void* w, const void* sc,
                    const void* bias, int f32acc, const void* x, void* dst, const void* carry,
                    const void* ext, void* stream) {
  const bool f = f32acc != 0;
  return (int)launch_tiles(
      ext, f ? rdb_i8_final_kernel<F32ACC, true> : rdb_i8_final_kernel<I32, true>,
      f ? rdb_i8_final_kernel<F32ACC, false> : rdb_i8_final_kernel<I32, false>,
      conv_s8_smem_bytes(64), B, H, W, (cudaStream_t)stream, (const int8_t*)q, H, W,
      (const int8_t*)w, (const float*)sc, (const float*)bias, (const float*)nullptr,
      (const bf16*)x, (bf16*)dst, (const bf16*)carry, (const int*)ext, 1);
}

}  // extern "C"
