// Shared device code of the int8 ResidualDenseBlock kernels: rdb_int8.cu
// (static activation scales, schemes "i32" and "f32acc") and rdb_dyn.cu
// (dynamic scales, scheme "dynamic").
//
// Data: the bf16 RDB input x (B, H, W, 64) and one int8 NHWC workspace
// Q (B, H, W, 192): channels 0:64 receive q0, the codes of x, 64:192 the
// codes q1..q4 of the dense stages, so the dense concatenation
// [x, x1, .., x_k] is a channel prefix of Q, as in rdb.cu. Stage k < 5
// convolves Q[..., :64+32(k-1)] and appends 32 codes; stage 5 convolves
// all 192 and writes the bf16 output.
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
//   dynamic as f32acc, with sa_src taken from the frame (rdb_dyn.cu).
//   all    out = bf16(bf16(0.2 x5) + x), and for the third RDB of an
//          RRDB the residual bf16(bf16(bf16(0.2) out) + carry), as in
//          rdb.cu. For f32acc and dynamic the JAX package applies that
//          residual in XLA with the same rounding points.
// Blocks (the resident body): every launch also takes ext, NULL for whole
// images or (nb, 4) int32 valid rectangles of halo blocks (conv_common.cuh,
// Rect); outside the rectangle the codes q1..q4 are 0 and x5 counts as 0,
// as the TPU kernels mask them (fused_rrdb.py:502-597).
// Every multiply and add is __fmul_rn/__fadd_rn: XLA rounds twice where
// the requant reads "acc * osc + ob", so no FMA contraction; rintf rounds
// half to even like jnp.round.
#pragma once

#include "conv_s8.cuh"

namespace fw {

constexpr int Q_C = 192;                    // workspace channels: q0 (64) + q1..q4 (4 x 32)
constexpr int X_C = 64;                     // bf16 carries
constexpr int A_C = 32;                     // dynamic scheme's f32 stage scratch
constexpr int NSRC = 5;                     // sources x, x1..x4 (scale and amax stride)
constexpr float BF16_0P2_I8 = 0.2001953125f;   // bf16(0.2): JAX's weak-typed 0.2 * bf16
constexpr float INV127 = (float)(1.0 / 127.0);  // JAX's weak-typed 1.0 / 127.0

// Schemes (the launchers' `mode`).
constexpr int I32 = 0, F32ACC = 1, DYN = 2;

__device__ __forceinline__ float lrelu_rn(float v) { return v >= 0.f ? v : __fmul_rn(0.2f, v); }

__device__ __forceinline__ int8_t code(float v) {
  return (int8_t)(int)fminf(fmaxf(rintf(v), -127.f), 127.f);
}

// Dynamic scheme: the activation scale of source s from the ranges
// amax_f (5) of one frame.
__device__ __forceinline__ float dyn_sa(const float* amax_f, int s) {
  return __fmul_rn(fmaxf(amax_f[s], 1e-8f), INV127);
}

// The ranges (5 floats) of frame f (on halo blocks, a frame is per_frame
// consecutive blocks). NULL for the static schemes.
__device__ __forceinline__ const float* frame_amax(const float* amax, int f) {
  return amax == nullptr ? nullptr : amax + f * NSRC;
}

// Source index of the chunk that ends at channel c_end, or -1 inside x.
__device__ __forceinline__ int source_ending_at(int c_end) {
  return c_end == 64 ? 0 : (c_end > 64 ? (c_end - 64) / 32 : -1);
}

// Accumulate conv(Q[..., :cin]) for this CTA's tile: int32 in acc, and for
// f32acc and dynamic also flushed per source into facc with the scale of
// (row n, source s): sc[n*5 + s] (f32acc), or sc[n*5 + s] * sa_s of the
// frame (dynamic: sc holds the weight scales, amax_f the frame's ranges).
template <int NFRAG, int MODE>
__device__ __forceinline__ void accumulate(int (&acc)[2][NFRAG][4], float (&facc)[2][NFRAG][4],
                                           const int8_t* q, int cin, int H, int W, int b,
                                           int ty0, int tx0, const int8_t* w,
                                           const float* __restrict__ sc, const float* amax_f,
                                           int8_t* s_in,
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
    if (MODE != I32) {
      const int s = source_ending_at(c0 + KC8);
      if (s < 0) continue;
      const float sa = MODE == DYN ? dyn_sa(amax_f, s) : 1.f;
#pragma unroll
      for (int nf = 0; nf < NFRAG; ++nf) {
        const int n = nf * 8 + 2 * t;
        float s0 = sc[n * NSRC + s], s1 = sc[(n + 1) * NSRC + s];
        if (MODE == DYN) s0 = __fmul_rn(s0, sa), s1 = __fmul_rn(s1, sa);
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
template <int MODE>
__device__ __forceinline__ float preact(int acc, float facc, float sc, float bias) {
  return MODE != I32 ? __fadd_rn(facc, bias) : __fadd_rn(__fmul_rn(__int2float_rn(acc), sc), bias);
}

// Stage 5: dst = bf16(bf16(0.2 x5) + x), x5 = conv(Q) + bias in the
// scheme's form (0 outside the valid rectangle); with carry dst =
// bf16(bf16(bf16(0.2) dst) + carry).
// x, dst and carry are (B, H, W, 64) bf16; each thread reads x and carry at
// the pixels and channels it writes before writing them, so dst may be x
// or carry.
template <int MODE, bool BLOCKS>
__global__ void __launch_bounds__(NTHREADS, MODE == I32 ? 2 : 1)
    rdb_i8_final_kernel(const int8_t* __restrict__ q, int H, int W, const int8_t* __restrict__ w,
                        const float* __restrict__ sc, const float* __restrict__ bias,
                        const float* amax, const bf16* x, bf16* dst, const bf16* carry,
                        const int* __restrict__ ext, int per_frame) {
  extern __shared__ uint4 smem_u4[];
  int8_t* s_in = reinterpret_cast<int8_t*>(smem_u4);
  int8_t* s_w = s_in + HT * HW * KP8;
  const int b = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  int acc[2][8][4];
  float facc[2][8][4];
  accumulate<8, MODE>(acc, facc, q, Q_C, H, W, b, ty0, tx0, w, sc,
                      frame_amax(amax, BLOCKS ? b / per_frame : b), s_in, s_w);
  const Rect valid = valid_rect(ext, b, H, W);

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
      const bool ok = !BLOCKS || valid.has(y, xc);
#pragma unroll
      for (int nf = 0; nf < 8; ++nf) {
        const int n = nf * 8 + 2 * t;
        float o[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 2 * h + j;
          const float x5 = ok ? preact<MODE>(acc[mf][nf][r], facc[mf][nf][r],
                                             MODE == I32 ? sc[n + j] : 0.f, bias[n + j])
                              : 0.f;
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
