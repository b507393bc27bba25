// int8 ResidualDenseBlock sweep of the RRDB body (static activation
// scales), one launch per dense stage plus the quantization of x.
//
// Replaces framewright_tpu/ops/fused_rrdb.py:
//   _rdb_kernel_int8_i32_merge, _rdb_kernel_int8_i32_merge_res (via
//     fused_rdb_blocks_merge_int8_i32): scheme "i32", weights
//     rdb_wide_weights_int8_i32;
//   _rdb_kernel_int8_static_merge (via fused_rdb_blocks_merge_int8):
//     scheme "f32acc", weights rdb_wide_weights_int8 with act_q.
// Both run 69 times per frame on the --dtype int8 restore.
//
// Data: the bf16 RDB input x (B, H, W, 64) and one int8 NHWC workspace
// Q (B, H, W, 192): channels 0:64 receive q0 = clip(rint(f32(x) inv0)),
// 64:192 the codes q1..q4 of the dense stages, so the dense
// concatenation [x, x1, .., x_k] is a channel prefix of Q, as in rdb.cu.
// Stage k < 5 convolves Q[..., :64+32(k-1)] and appends 32 codes; stage 5
// convolves all 192 and writes the bf16 output.
//
// Arithmetic, at the TPU kernels' rounding points:
//   i32    one int32 accumulator per output across every source; stage
//          k < 5: q = clip(rint(lrelu(f32(acc) osc + ob))), osc and ob
//          already in stage k's code domain; stage 5: x5 = f32(acc) osc
//          + ob.
//   f32acc each source's int32 partial (x = channels 0:64, x_k one
//          32-channel chunk each) is flushed into an f32 accumulator as
//          f32(partial) (ws_row sa_src) at the source boundary; stage k
//          < 5: q = clip(rint(lrelu(acc + b) inv_k)); stage 5: x5 = acc +
//          b. (The TPU kernel flushes per chunk of taps instead, which
//          reorders the f32 sums only.)
//   both   out = bf16(bf16(0.2 x5) + x), and for the third RDB of an
//          RRDB the residual bf16(bf16(bf16(0.2) out) + carry), as in
//          rdb.cu. For f32acc the JAX package applies that residual in
//          XLA with the same rounding points.
// Every multiply and add is __fmul_rn/__fadd_rn: XLA rounds twice where
// the requant reads "acc * osc + ob", so no FMA contraction; rintf rounds
// half to even like jnp.round.
//
// Bound: tensor-core operations. A 540x960 body does 239,616 MAC per
// pixel per RDB, 248 G operations, 0.126 ms at the card's 1,979 TOP/s
// int8 dense peak, against 133 MB of bf16 input and output (0.040 ms at
// 3.35 TB/s). The design is the bf16 RDB's (rdb.cu) on the s8 tensor
// cores: half the mma instructions and half the staged bytes per channel
// (conv_s8.cuh), codes one byte a channel in Q. The TPU kernel's
// resident blocks, ring merge and four codes per int32 word are Mosaic
// workarounds and have no counterpart here.
#include "conv_s8.cuh"

namespace fw {

constexpr int Q_C = 192;                    // workspace channels: q0 (64) + q1..q4 (4 x 32)
constexpr int X_C = 64;                     // bf16 carries
constexpr int NSRC = 5;                     // sources x, x1..x4 (f32acc scale stride)
constexpr float BF16_0P2_I8 = 0.2001953125f;   // bf16(0.2): JAX's weak-typed 0.2 * bf16

__device__ __forceinline__ float lrelu_rn(float v) { return v >= 0.f ? v : __fmul_rn(0.2f, v); }

__device__ __forceinline__ int8_t code(float v) {
  return (int8_t)(int)fminf(fmaxf(rintf(v), -127.f), 127.f);
}

// Source index of the chunk that ends at channel c_end, or -1 inside x.
__device__ __forceinline__ int source_ending_at(int c_end) {
  return c_end == 64 ? 0 : (c_end > 64 ? (c_end - 64) / 32 : -1);
}

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

// Accumulate conv(Q[..., :cin]) for this CTA's tile: int32 in acc, and for
// f32acc also flushed per source into facc with the scales sc[n*5 + s].
template <int NFRAG, bool F32ACC>
__device__ __forceinline__ void accumulate(int (&acc)[2][NFRAG][4], float (&facc)[2][NFRAG][4],
                                           const int8_t* q, int cin, int H, int W, int b,
                                           int ty0, int tx0, const int8_t* w,
                                           const float* __restrict__ sc, int8_t* s_in,
                                           int8_t* s_w) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < NFRAG; ++nf)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mf][nf][r] = 0, facc[mf][nf][r] = 0.f;
  for (int c0 = 0; c0 < cin; c0 += KC8) {
    conv_chunk_s8<NFRAG>(acc, q, Q_C, c0, H, W, b, ty0, tx0, w, cin, s_in, s_w);
    if (F32ACC) {
      const int s = source_ending_at(c0 + KC8);
      if (s < 0) continue;
#pragma unroll
      for (int nf = 0; nf < NFRAG; ++nf) {
        const int n = nf * 8 + 2 * t;
        const float s0 = sc[n * NSRC + s], s1 = sc[(n + 1) * NSRC + s];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            facc[mf][nf][r] =
                __fadd_rn(facc[mf][nf][r], __fmul_rn(__int2float_rn(acc[mf][nf][r]), r & 1 ? s1 : s0));
            acc[mf][nf][r] = 0;
          }
      }
    }
  }
}

// Pre-activation value of output channel n from the accumulators.
template <bool F32ACC>
__device__ __forceinline__ float preact(int acc, float facc, float sc, float bias) {
  return F32ACC ? __fadd_rn(facc, bias) : __fadd_rn(__fmul_rn(__int2float_rn(acc), sc), bias);
}

// Stages 1-4: Q[..., cin:cin+32] = codes of lrelu(conv(Q[..., :cin]) + b).
//   i32   : sc = oscale (32), bias = obias (32)
//   f32acc: sc = ws_row * sa_src (32 x 5), bias = b (32), inv_next = 1 / sa_k
template <bool F32ACC>
__global__ void __launch_bounds__(NTHREADS, 2)
    rdb_i8_dense_kernel(int8_t* q, int H, int W, int cin, const int8_t* __restrict__ w,
                        const float* __restrict__ sc, const float* __restrict__ bias,
                        float inv_next) {
  extern __shared__ uint4 smem_u4[];
  int8_t* s_in = reinterpret_cast<int8_t*>(smem_u4);
  int8_t* s_w = s_in + HT * HW * KP8;
  const int b = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  int acc[2][4][4];
  float facc[2][4][4];
  accumulate<4, F32ACC>(acc, facc, q, cin, H, W, b, ty0, tx0, w, sc, s_in, s_w);

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
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const int n = nf * 8 + 2 * t;
        char2 out;
        int8_t c[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 2 * h + j;
          const float v = lrelu_rn(
              preact<F32ACC>(acc[mf][nf][r], facc[mf][nf][r], F32ACC ? 0.f : sc[n + j], bias[n + j]));
          c[j] = code(F32ACC ? __fmul_rn(v, inv_next) : v);
        }
        out.x = c[0];
        out.y = c[1];
        *reinterpret_cast<char2*>(dst + n) = out;
      }
    }
  }
}

// Stage 5: dst = bf16(bf16(0.2 x5) + x), x5 = conv(Q) + bias in the
// scheme's form; with carry dst = bf16(bf16(bf16(0.2) dst) + carry).
// x, dst and carry are (B, H, W, 64) bf16; each thread reads x and carry at
// the pixels and channels it writes before writing them, so dst may be x
// or carry.
template <bool F32ACC>
__global__ void __launch_bounds__(NTHREADS, F32ACC ? 1 : 2)
    rdb_i8_final_kernel(const int8_t* __restrict__ q, int H, int W, const int8_t* __restrict__ w,
                        const float* __restrict__ sc, const float* __restrict__ bias,
                        const bf16* x, bf16* dst, const bf16* carry) {
  extern __shared__ uint4 smem_u4[];
  int8_t* s_in = reinterpret_cast<int8_t*>(smem_u4);
  int8_t* s_w = s_in + HT * HW * KP8;
  const int b = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  int acc[2][8][4];
  float facc[2][8][4];
  accumulate<8, F32ACC>(acc, facc, q, Q_C, H, W, b, ty0, tx0, w, sc, s_in, s_w);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    const int y = ty0 + 2 * warp + mf;
    if (y >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int xc = tx0 + g + 8 * h;
      if (xc >= W) continue;
      const size_t pix = (((size_t)b * H + y) * W + xc) * X_C;
#pragma unroll
      for (int nf = 0; nf < 8; ++nf) {
        const int n = nf * 8 + 2 * t;
        float o[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 2 * h + j;
          const float x5 =
              preact<F32ACC>(acc[mf][nf][r], facc[mf][nf][r], F32ACC ? 0.f : sc[n + j], bias[n + j]);
          o[j] = bf(rb(__fadd_rn(bf(rb(__fmul_rn(0.2f, x5))), bf(x[pix + n + j]))));
          if (carry != nullptr)
            o[j] = bf(rb(__fadd_rn(bf(rb(__fmul_rn(BF16_0P2_I8, o[j]))), bf(carry[pix + n + j]))));
        }
        st_bf16x2(dst + pix + n, o[0], o[1]);
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

// One dense stage k in 1..4 (cin = 64 + 32 (k - 1)); f32acc selects the scheme.
int fw_rdb_i8_dense(void* q, int B, int H, int W, int cin, const void* w, const void* sc,
                    const void* bias, float inv_next, int f32acc, void* stream) {
  const int smem = conv_s8_smem_bytes(32);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaError_t err;
  if (f32acc) {
    err = allow_smem(rdb_i8_dense_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    rdb_i8_dense_kernel<true><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        (int8_t*)q, H, W, cin, (const int8_t*)w, (const float*)sc, (const float*)bias, inv_next);
  } else {
    err = allow_smem(rdb_i8_dense_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    rdb_i8_dense_kernel<false><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        (int8_t*)q, H, W, cin, (const int8_t*)w, (const float*)sc, (const float*)bias, inv_next);
  }
  return (int)cudaGetLastError();
}

// Stage 5 with the RDB residual, and the RRDB residual when carry != NULL.
int fw_rdb_i8_final(const void* q, int B, int H, int W, const void* w, const void* sc,
                    const void* bias, int f32acc, const void* x, void* dst, const void* carry,
                    void* stream) {
  const int smem = conv_s8_smem_bytes(64);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaError_t err;
  if (f32acc) {
    err = allow_smem(rdb_i8_final_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    rdb_i8_final_kernel<true><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        (const int8_t*)q, H, W, (const int8_t*)w, (const float*)sc, (const float*)bias,
        (const bf16*)x, (bf16*)dst, (const bf16*)carry);
  } else {
    err = allow_smem(rdb_i8_final_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    rdb_i8_final_kernel<false><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        (const int8_t*)q, H, W, (const int8_t*)w, (const float*)sc, (const float*)bias,
        (const bf16*)x, (bf16*)dst, (const bf16*)carry);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
