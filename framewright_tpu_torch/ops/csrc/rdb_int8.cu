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
// 3.35 TB/s). So the five convs run on conv_wgmma.cuh's main loop in its
// int8 form, as the bf16 RDB (rdb.cu) does in bf16: wgmma m64nNk32 s8 x
// s8 -> s32 with A by ldmatrix from TMA halo boxes of Q and B from the
// chunk-major weights, a producer warpgroup keeping a ring of stages
// full, a persistent grid; half the chunks per channel of the bf16 RDB at
// twice the tensor-core rate. Stages 1-4 stage their 32 codes a pixel
// through shared memory and write them as 16-byte runs while the next
// tile's products run; stage 5 (rdb_int8.cuh, FinalEpi8) writes the bf16
// output with both residuals. The f32acc scheme flushes each source's
// partial into f32 sums (rdb_int8.cuh), so it drains a consumer's tensor
// pipe once a chunk, and runs stage 5 on split tiles. The TPU kernel's
// ring merge and four codes per int32 word are Mosaic workarounds and have
// no counterpart here; its resident blocks are the resident body's (ext,
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
struct DenseEpi8 {
  int8_t* q;
  int H, W, cin;
  const float* __restrict__ sc;
  const float* __restrict__ bias;
  float inv_next;
  const int* __restrict__ ext;

  static constexpr bool FLUSH = MODE != I32;
  using Part = Sums<32, FLUSH>;
  // 256 pixels x 32 codes, rows padded by 16 bytes (the fragments' 2-byte
  // writes of eight neighbouring pixels on distinct banks): 2 runs of 16
  // bytes a pixel, 4 a thread, 2 a slice, written while the next tile's
  // products run
  static constexpr int ROW = 48, BUF = wg::TPX * ROW;
  static constexpr int SLICES = 2;
  static constexpr bool DEFER = true;
  struct Slice {};

  __device__ __forceinline__ bool live(int b, int y0, int x0) const {
    return !BLOCKS || wg::tile_meets(valid_rect(ext, b, H, W), y0, x0);
  }

  __device__ __forceinline__ bool flushes(int c) const { return c >= 1; }
  __device__ __forceinline__ void drain(Part&) const {}

  __device__ __forceinline__ void flush(const int (&acc)[4][16], Part& part, int c, int) const {
    fold<MODE, 32>(acc, part.f, sc, nullptr, chunk_source(c), 0);
  }

  __device__ __forceinline__ void stage(const int (&acc)[4][16], Part& part, int b, int y0,
                                        int x0, bool lv, uint8_t* buf) const {
    const wg::Frag f;
    const Rect valid = valid_rect(ext, b, H, W);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 8 * i + 2 * f.t;
      const float b0 = bias[n], b1 = bias[n + 1];
      const float s0 = MODE == I32 ? sc[n] : 0.f, s1 = MODE == I32 ? sc[n + 1] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok = !BLOCKS || (lv && valid.has(y0 + 4 * f.q + j, x0 + f.g + 8 * h));
          const int r = 4 * i + 2 * h;
          float v[2];
          if constexpr (MODE == I32) {
            v[0] = __fadd_rn(__fmul_rn(__int2float_rn(acc[j][r]), s0), b0);
            v[1] = __fadd_rn(__fmul_rn(__int2float_rn(acc[j][r + 1]), s1), b1);
          } else {
            v[0] = __fadd_rn(part.f[j][r], b0);
            v[1] = __fadd_rn(part.f[j][r + 1], b1);
          }
          char2 out;
          out.x = ok ? code(MODE == F32ACC ? __fmul_rn(lrelu_rn(v[0]), inv_next) : lrelu_rn(v[0]))
                     : 0;
          out.y = ok ? code(MODE == F32ACC ? __fmul_rn(lrelu_rn(v[1]), inv_next) : lrelu_rn(v[1]))
                     : 0;
          *reinterpret_cast<char2*>(buf + f.px(j, h) * ROW + n) = out;
        }
      }
    }
    if constexpr (FLUSH) clear(part);
  }

  __device__ __forceinline__ void load(Slice&, int, int, int, int, const uint8_t*) const {}

  __device__ __forceinline__ void finish(const Slice&, int k, int b, int y0, int x0,
                                         const uint8_t* buf) const {
    const wg::Frag f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = (2 * k + e) * 128 + f.wt, p = r >> 1, c16 = r & 1;
      const int y = y0 + p / wg::TS, x = x0 + p % wg::TS;
      if (y < H && x < W)
        *reinterpret_cast<uint4*>(q + (((size_t)b * H + y) * W + x) * Q_C + cin + 16 * c16) =
            *reinterpret_cast<const uint4*>(buf + p * ROW + 16 * c16);
    }
  }
};

template <int MODE>
inline cudaError_t launch_dense8(int8_t* q, int B, int H, int W, int cin, const int8_t* w,
                                 const float* sc, const float* bias, float inv_next,
                                 const int* ext, cudaStream_t stream) {
  if (ext != nullptr)
    return wg::launch_conv3x3<32>(
        (const int8_t*)q, Q_C, cin, B, H, W, w,
        DenseEpi8<MODE, true>{q, H, W, cin, sc, bias, inv_next, ext}, stream);
  return wg::launch_conv3x3<32>((const int8_t*)q, Q_C, cin, B, H, W, w,
                                DenseEpi8<MODE, false>{q, H, W, cin, sc, bias, inv_next, nullptr},
                                stream);
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
// scheme; w: the conv's weights in the chunk-major int8 layout
// (fused_rrdb.wgmma_weights_s8), here and in fw_rdb_i8_final; ext: NULL
// (images) or (B, 4) int32 valid rectangles (blocks).
int fw_rdb_i8_dense(void* q, int B, int H, int W, int cin, const void* w, const void* sc,
                    const void* bias, float inv_next, int f32acc, const void* ext,
                    void* stream) {
  auto go = [&](auto launch) {
    return (int)launch((int8_t*)q, B, H, W, cin, (const int8_t*)w, (const float*)sc,
                       (const float*)bias, inv_next, (const int*)ext, (cudaStream_t)stream);
  };
  return f32acc ? go(launch_dense8<F32ACC>) : go(launch_dense8<I32>);
}

// Stage 5 with the RDB residual, and the RRDB residual when carry != NULL.
int fw_rdb_i8_final(const void* q, int B, int H, int W, const void* w, const void* sc,
                    const void* bias, int f32acc, const void* x, void* dst, const void* carry,
                    const void* ext, void* stream) {
  auto go = [&](auto launch) {
    return (int)launch((const int8_t*)q, B, H, W, (const int8_t*)w, (const float*)sc,
                       (const float*)bias, nullptr, 1, (const bf16*)x, (bf16*)dst,
                       (const bf16*)carry, (const int*)ext, (cudaStream_t)stream);
  };
  return f32acc ? go(launch_final8<F32ACC>) : go(launch_final8<I32>);
}

}  // extern "C"
