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
// Main loop: conv_wgmma.cuh on int8 (wgmma m64nNk32 s8 x s8 -> s32, A by
// ldmatrix from TMA halo boxes of Q, B the chunk-major copy of the
// weights, fused_rrdb.wgmma_weights_s8). A 32-channel chunk is one source
// boundary apart from x, which is chunks 0-1: x_k is chunk k + 1.
//
// Arithmetic, at the TPU kernels' rounding points:
//   i32    one int32 accumulator per output across every source; stage
//          k < 5: q = clip(rint(lrelu(f32(acc) osc + ob))), osc and ob
//          already in stage k's code domain; stage 5: x5 = f32(acc) osc
//          + ob.
//   f32acc each source's int32 partial (x = channels 0:64, x_k one
//          32-channel chunk each) is flushed into an f32 accumulator as
//          f32(partial) (ws_row sa_src) at the source boundary, in source
//          order (the main loop's FLUSH); stage k < 5: q = clip(rint(
//          lrelu(acc + b) inv_k)); stage 5: x5 = acc + b. (The TPU kernel
//          flushes per chunk of taps instead, which reorders the f32 sums
//          only.)
//   dynamic as f32acc, with sa_src taken from the frame (rdb_dyn.cu).
//   all    out = bf16(bf16(0.2 x5) + x), and for the third RDB of an
//          RRDB the residual bf16(bf16(bf16(0.2) out) + carry), as in
//          rdb.cu. For f32acc and dynamic the JAX package applies that
//          residual in XLA with the same rounding points.
// Registers: the f32 sums of a flushing scheme sit beside the s32
// accumulators, 64 + 64 a thread at N = 32. At N = 64 (stage 5) that
// would be 128 + 128, past the consumers' 232, so f32acc and dynamic run
// stage 5 as a SPLIT tile: both consumers on one 16x16 tile, 32 output
// channels each. i32 needs no f32 sums and runs stage 5 at N = 64, two
// tiles a CTA, as the bf16 RDB does.
// Blocks (the resident body): every launch also takes ext, NULL for whole
// images or (nb, 4) int32 valid rectangles of halo blocks (conv_common.cuh,
// Rect); outside the rectangle the codes q1..q4 are 0 and x5 counts as 0,
// as the TPU kernels mask them (fused_rrdb.py:502-597). A tile wholly
// outside its block's rectangle loads nothing and runs no product.
// Every multiply and add is __fmul_rn/__fadd_rn: XLA rounds twice where
// the requant reads "acc * osc + ob", so no FMA contraction; rintf rounds
// half to even like jnp.round.
#pragma once

#include "conv_wgmma.cuh"

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

// Dynamic scheme: the activation scale of source s from the ranges
// amax_f (5) of one frame.
__device__ __forceinline__ float dyn_sa(const float* amax_f, int s) {
  return __fmul_rn(fmaxf(amax_f[s], 1e-8f), INV127);
}

// The source of 32-channel chunk c: x (0) is chunks 0-1, x_k chunk k + 1.
// Every chunk from 1 on ends a source.
__device__ __forceinline__ int chunk_source(int c) { return c < 2 ? 0 : c - 1; }

// A consumer's f32 sums across a tile's sources (flushing schemes), in the
// accumulators' layout (conv_wgmma.cuh); empty for i32.
template <int N, bool ON>
struct Sums {
  float f[4][N / 2];
};
template <int N>
struct Sums<N, false> {};

// Fold source s's int32 partial into the f32 sums: f += f32(acc) scale_n,
// scale_n = sc[n * 5 + s] (f32acc: ws_row sa_src) or sc[n * 5 + s] sa_s
// of the frame (dynamic: sc holds ws_row, amax_f the frame's ranges), for
// this thread's output channels n0 + 8 i + 2 (lane % 4) + e.
template <int MODE, int N>
__device__ __forceinline__ void fold(const int (&acc)[4][N / 2], float (&f)[4][N / 2],
                                     const float* __restrict__ sc, const float* amax_f, int s,
                                     int n0) {
  const int t = threadIdx.x & 3;
  const float sa = MODE == DYN ? dyn_sa(amax_f, s) : 1.f;
  float scale[N / 8][2];
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v = sc[(n0 + 8 * i + 2 * t + e) * NSRC + s];
      scale[i][e] = MODE == DYN ? __fmul_rn(v, sa) : v;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int r = 0; r < N / 2; ++r)
      f[j][r] = __fadd_rn(f[j][r], __fmul_rn(__int2float_rn(acc[j][r]), scale[r >> 2][r & 1]));
  }
}

template <int N>
__device__ __forceinline__ void clear(Sums<N, true>& p) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int r = 0; r < N / 2; ++r) p.f[j][r] = 0.f;
  }
}

// Stage 5: dst = bf16(bf16(0.2 x5) + x), x5 = conv(Q) + bias in the
// scheme's form (0 outside the valid rectangle); with carry dst =
// bf16(bf16(bf16(0.2) dst) + carry). x, dst and carry are (B, H, W, 64)
// bf16; each run of 8 channels reads x and carry before it writes dst, so
// dst may be x or carry.
//   i32    : sc = oscale (64), bias = obias (64); N = 64, a tile a consumer
//   f32acc : sc = ws_row sa_src (64 x 5), bias = b; SPLIT, 32 channels a
//            consumer
//   dynamic: sc = ws_row (64 x 5), bias = b, amax the frames' ranges
//            (per_frame images or blocks to a frame); SPLIT
template <int MODE, bool BLOCKS>
struct FinalEpi8 {
  int H, W;
  const float* __restrict__ sc;
  const float* __restrict__ bias;
  const float* amax;
  int per_frame;
  const bf16* x;
  bf16* dst;
  const bf16* carry;
  const int* __restrict__ ext;

  static constexpr bool FLUSH = MODE != I32, SPLIT = FLUSH;
  static constexpr int NC = SPLIT ? 32 : 64;   // output channels a consumer holds
  using Part = Sums<NC, FLUSH>;
  static constexpr int ROW = wg::epi_row(NC), BUF = wg::epi_bytes(NC);
  // 256 pixels x NC / 8 runs of 8 channels, 4 runs a thread a slice, all
  // written at once (as rdb.cu's stage 5; issuing more slices' loads at
  // once spilled registers and measured slower)
  static constexpr int RUNS = NC / 8, SLICES = NC / 16;
  static constexpr bool DEFER = false;
  struct Slice {
    uint4 x[4], c[4];
  };

  // this consumer's first output channel
  __device__ __forceinline__ static int n0() { return SPLIT ? NC * (threadIdx.x >> 7) : 0; }

  __device__ __forceinline__ bool live(int b, int y0, int x0) const {
    return !BLOCKS || wg::tile_meets(valid_rect(ext, b, H, W), y0, x0);
  }

  __device__ __forceinline__ bool flushes(int c) const { return c >= 1; }
  __device__ __forceinline__ void drain(Part&) const {}

  __device__ __forceinline__ void flush(const int (&acc)[4][NC / 2], Part& part, int c,
                                        int b) const {
    fold<MODE, NC>(acc, part.f, sc, MODE == DYN ? amax + (BLOCKS ? b / per_frame : b) * NSRC
                                                : nullptr,
                   chunk_source(c), n0());
  }

  // the first rounding point, bf16(0.2 x5), staged in the fragment layout
  __device__ __forceinline__ void stage(const int (&acc)[4][NC / 2], Part& part, int b, int y0,
                                        int x0, bool lv, uint8_t* buf) const {
    const wg::Frag f;
    const Rect valid = valid_rect(ext, b, H, W);
#pragma unroll
    for (int i = 0; i < NC / 8; ++i) {
      const int n = n0() + 8 * i + 2 * f.t;
      const float b0 = bias[n], b1 = bias[n + 1];
      const float s0 = MODE == I32 ? sc[n] : 0.f, s1 = MODE == I32 ? sc[n + 1] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok = !BLOCKS || (lv && valid.has(y0 + 4 * f.q + j, x0 + f.g + 8 * h));
          const int r = 4 * i + 2 * h;
          float x5[2];
          if constexpr (MODE == I32) {
            x5[0] = __fadd_rn(__fmul_rn(__int2float_rn(acc[j][r]), s0), b0);
            x5[1] = __fadd_rn(__fmul_rn(__int2float_rn(acc[j][r + 1]), s1), b1);
          } else {
            x5[0] = __fadd_rn(part.f[j][r], b0);
            x5[1] = __fadd_rn(part.f[j][r + 1], b1);
          }
          st_bf16x2(reinterpret_cast<bf16*>(buf + f.px(j, h) * ROW) + 8 * i + 2 * f.t,
                    ok ? __fmul_rn(0.2f, x5[0]) : 0.f, ok ? __fmul_rn(0.2f, x5[1]) : 0.f);
        }
      }
    }
    if constexpr (FLUSH) clear(part);
  }

  // run e of slice k: pixel p of the tile, channels n0 + 8 c8 .. +8
  __device__ __forceinline__ size_t at(int k, int e, int b, int y0, int x0, int& p, int& c8,
                                       bool& in) const {
    const int r = (4 * k + e) * 128 + wg::Frag().wt;
    p = r / RUNS, c8 = r % RUNS;
    const int y = y0 + p / wg::TS, xc = x0 + p % wg::TS;
    in = y < H && xc < W;
    return (((size_t)b * H + (in ? y : 0)) * W + (in ? xc : 0)) * X_C + n0() + 8 * c8;
  }

  __device__ __forceinline__ void load(Slice& sl, int k, int b, int y0, int x0,
                                       const uint8_t*) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int p, c8;
      bool in;
      const size_t o = at(k, e, b, y0, x0, p, c8, in);
      sl.x[e] = *reinterpret_cast<const uint4*>(x + o);
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
        float v = bf(rb(__fadd_rn(bf(t5[i]), bf(xs[i]))));
        if (carry != nullptr) v = bf(rb(__fadd_rn(bf(rb(__fmul_rn(BF16_0P2_I8, v))), bf(cs[i]))));
        out[i] = rb(v);
      }
      if (in) *reinterpret_cast<uint4*>(dst + o) = ov;
    }
  }
};

// Launch stage 5 of scheme MODE on Q (B, H, W, 192); w: the conv's
// weights (wgmma_weights_s8); the rest as FinalEpi8's fields.
template <int MODE>
inline cudaError_t launch_final8(const int8_t* q, int B, int H, int W, const int8_t* w,
                                 const float* sc, const float* bias, const float* amax,
                                 int per_frame, const bf16* x, bf16* dst, const bf16* carry,
                                 const int* ext, cudaStream_t stream) {
  constexpr int N = MODE == I32 ? 64 : 32;
  constexpr bool SPLIT = MODE != I32;
  if (ext != nullptr)
    return wg::launch_conv3x3<N, SPLIT>(
        q, Q_C, Q_C, B, H, W, w,
        FinalEpi8<MODE, true>{H, W, sc, bias, amax, per_frame, x, dst, carry, ext}, stream);
  return wg::launch_conv3x3<N, SPLIT>(
      q, Q_C, Q_C, B, H, W, w,
      FinalEpi8<MODE, false>{H, W, sc, bias, amax, per_frame, x, dst, carry, nullptr}, stream);
}

}  // namespace fw
