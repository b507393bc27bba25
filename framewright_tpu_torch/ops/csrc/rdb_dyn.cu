// int8 ResidualDenseBlock sweep of the RRDB body with dynamic activation
// scales: a reduction of each frame's max|x|, the codes of x, four dense
// stages each followed by the quantization of its output, and stage 5.
//
// Replaces framewright_tpu/ops/fused_rrdb.py: _rdb_kernel_int8 (via
// fused_rdb_blocks_int8), weights rdb_wide_weights_int8 without act_q,
// which the int8_scales="dynamic" restore runs 69 times per frame on the
// round-trip body. Data and the shared arithmetic: rdb_int8.cuh.
//
// Arithmetic: the f32acc scheme's, with the activation scales taken from
// the frame: amax_s = max|a_s| over the frame b for each source s (a_0 =
// f32(x), a_k = lrelu(acc + b) of stage k), sa_s = max(amax_s, 1e-8)
// f32(1/127), codes clip(rint(a f32(127 / max(amax_s, 1e-8)))), and the
// flush scale f32(ws_row sa_s) formed on the device (fused_rrdb.py:
// 518-523, :457). The TPU kernel takes amax per 112x112 Mosaic window,
// including a ring of values its cyclic tap rolls wrap around; the port
// takes it per frame, so each pixel has one code whatever the tiling or
// the batch (PERF.md). A dense stage writes lrelu(acc + b) in f32 to a
// (B, H, W, 32) scratch and folds max|.| into amax[b][k] with atomicMax
// on the float's bits (an order-free maximum, valid for values >= 0): each
// consumer warp keeps a running maximum for the frame of its tiles across
// the persistent grid's walk and issues one atomicMax when the frame
// changes and one at the end, not one per tile. A quantization launch
// then turns the scratch into codes, since a frame's range is known only
// when all of its tiles are done. The scales never leave the device.
//
// Blocks (the resident body, ext != NULL): a frame is per_frame
// consecutive halo blocks, and a dense stage folds into amax only the
// pixels of the block interior [halo, S - halo)^2 inside the valid
// rectangle. The interiors tile the frame once, so the ranges equal the
// image path's; ring pixels, which hold values computed against the
// block's zero edge, never reach them. The absmax pass over x takes
// whole blocks: their rings hold copies of interior pixels (extraction,
// halo.cu) or zeros, so its maximum is the frame's too.
//
// Bound: the static kernels' (rdb_int8.cu): 248 G int8 operations per
// 540x960 RDB, 0.126 ms. The convs run on conv_wgmma.cuh's int8 main
// loop with the f32acc scheme's flushes (rdb_int8.cuh), the frame's
// scale folded in at each flush. The f32 scratch adds device-memory
// traffic that the bound does not count: per dense stage 128 B a pixel
// written and read and 32 B of codes written, ~0.6 GB a call, ~0.18 ms
// at 3.35 TB/s, this kernel's floor beside its operations bound. Stages
// 1-4 write the scratch as 16-byte runs staged through shared memory,
// while the next tile's products run.
#include "rdb_int8.cuh"

namespace fw {

// Dynamic scheme: fold max|x| of each frame into amax[b * 5] (zeroed by
// the caller). Grid (blocks, B); each thread takes 8 bf16 at a time.
__global__ void rdb_dyn_absmax_kernel(const bf16* __restrict__ x, long long n8_frame,
                                      float* amax) {
  const int b = blockIdx.y;
  const bf16* xb = x + (size_t)b * n8_frame * 8;
  float m = 0.f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n8_frame;
       i += (long long)gridDim.x * blockDim.x) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xb + i * 8);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(bf(v[j])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float s_red[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_red[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, s_red[w]);
    atomicMax(reinterpret_cast<int*>(amax + b * NSRC), __float_as_int(m));
  }
}

// Dynamic scheme: Q[p, q_off + c] = clip(rint(src[p, c] * f32(127 /
// max(amax[b][stage], 1e-8)))) for the SRC_C channels of each pixel, 16 a
// thread (one 16-byte store); src is the bf16 x (64 channels) or the f32
// stage scratch (32). Grid (blocks over one frame's n16_frame threads,
// frames): a thread's pixel and frame need no division.
template <typename T, int SRC_C>
__global__ void rdb_dyn_quant_kernel(const T* __restrict__ src, int8_t* __restrict__ q, int q_off,
                                     int n16_frame, const float* __restrict__ amax, int stage) {
  constexpr int PER_PIX = SRC_C / 16;
  const int i = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (i >= n16_frame) return;
  const long long p = (long long)b * (n16_frame / PER_PIX) + i / PER_PIX;
  const int c = (i % PER_PIX) * 16;
  const float inv = __fdiv_rn(127.f, fmaxf(amax[b * NSRC + stage], 1e-8f));
  float v[16];
  if constexpr (sizeof(T) == 2) {
    const uint4* r = reinterpret_cast<const uint4*>(src + p * SRC_C + c);
    const uint4 r0 = r[0], r1 = r[1];
    const bf16* h0 = reinterpret_cast<const bf16*>(&r0);
    const bf16* h1 = reinterpret_cast<const bf16*>(&r1);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = bf(h0[j]), v[8 + j] = bf(h1[j]);
  } else {
    const float4* f = reinterpret_cast<const float4*>(src + p * SRC_C + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 a = f[j];
      v[4 * j] = a.x, v[4 * j + 1] = a.y, v[4 * j + 2] = a.z, v[4 * j + 3] = a.w;
    }
  }
  union {
    int8_t s[16];
    uint4 u;
  } out;
#pragma unroll
  for (int j = 0; j < 16; ++j) out.s[j] = code(__fmul_rn(v[j], inv));
  *reinterpret_cast<uint4*>(q + p * Q_C + q_off + c) = out.u;
}

// Dynamic stages 1-4: act[..., 0:32] = lrelu(conv(Q[..., :cin]) + b) in
// f32 (0 outside the valid rectangle), and max|act| over the pixels that
// count (inner) folded into amax[frame][stage] (stage = the source index
// of this stage's output). sc = ws_row (32 x 5), bias = b.
template <bool BLOCKS>
struct DynDenseEpi {
  int H, W;
  const float* __restrict__ sc;
  const float* __restrict__ bias;
  float* amax;
  int stage_src;
  float* __restrict__ act;
  const int* __restrict__ ext;
  int per_frame, halo;

  static constexpr bool FLUSH = true;
  // the f32 sums, and the running maximum of this thread for frame fr
  // (from Part{}: frame 0, maximum 0, which publishes as a no-op)
  struct Part : Sums<32, true> {
    float m;
    int fr;
  };
  // 256 pixels x 32 f32, rows padded by 16 bytes: 8 runs of 16 bytes a
  // pixel, 16 a thread, 4 a slice, written while the next tile's products
  // run
  static constexpr int ROW = 4 * A_C + 16, BUF = wg::TPX * ROW;
  static constexpr int SLICES = 4;
  static constexpr bool DEFER = true;
  struct Slice {};

  __device__ __forceinline__ int frame(int b) const { return BLOCKS ? b / per_frame : b; }

  __device__ __forceinline__ bool live(int b, int y0, int x0) const {
    return !BLOCKS || wg::tile_meets(valid_rect(ext, b, H, W), y0, x0);
  }

  __device__ __forceinline__ bool flushes(int c) const { return c >= 1; }

  __device__ __forceinline__ void flush(const int (&acc)[4][16], Part& part, int c, int b) const {
    fold<DYN, 32>(acc, part.f, sc, amax + frame(b) * NSRC, chunk_source(c), 0);
  }

  // this warp's maximum of frame part.fr into amax (every lane of the warp
  // calls this; the frame is the warpgroup's)
  __device__ __forceinline__ void publish(const Part& part) const {
    float m = part.m;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0)
      atomicMax(reinterpret_cast<int*>(amax + part.fr * NSRC + stage_src), __float_as_int(m));
  }

  __device__ __forceinline__ void drain(Part& part) const { publish(part); }

  __device__ __forceinline__ void stage(const int (&)[4][16], Part& part, int b, int y0, int x0,
                                        bool lv, uint8_t* buf) const {
    const wg::Frag f;
    if (part.fr != frame(b)) {
      publish(part);
      part.fr = frame(b), part.m = 0.f;
    }
    const Rect valid = valid_rect(ext, b, H, W);
    // the pixels whose values enter the frame's range
    const Rect inner{max(valid.r0, halo), min(valid.r1, H - halo), max(valid.c0, halo),
                     min(valid.c1, W - halo)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = y0 + 4 * f.q + j, x = x0 + f.g + 8 * h;
        const bool ok = !BLOCKS || (lv && valid.has(y, x));
        const bool counts = (!BLOCKS || inner.has(y, x)) && y < H && x < W;
        float* row = reinterpret_cast<float*>(buf + f.px(j, h) * ROW);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = 8 * i + 2 * f.t, r = 4 * i + 2 * h;
          float2 v = make_float2(0.f, 0.f);
          if (ok) {
            v.x = lrelu_rn(__fadd_rn(part.f[j][r], bias[n]));
            v.y = lrelu_rn(__fadd_rn(part.f[j][r + 1], bias[n + 1]));
          }
          if (counts) part.m = fmaxf(part.m, fmaxf(fabsf(v.x), fabsf(v.y)));
          *reinterpret_cast<float2*>(row + n) = v;
        }
      }
    }
    clear(part);
  }

  __device__ __forceinline__ void load(Slice&, int, int, int, int, const uint8_t*) const {}

  __device__ __forceinline__ void finish(const Slice&, int k, int b, int y0, int x0,
                                         const uint8_t* buf) const {
    const wg::Frag f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (4 * k + e) * 128 + f.wt, p = r >> 3, c4 = r & 7;
      const int y = y0 + p / wg::TS, x = x0 + p % wg::TS;
      if (y < H && x < W)
        *reinterpret_cast<uint4*>(act + (((size_t)b * H + y) * W + x) * A_C + 4 * c4) =
            *reinterpret_cast<const uint4*>(buf + p * ROW + 16 * c4);
    }
  }
};

}  // namespace fw

using namespace fw;

extern "C" {

// Dynamic scheme: amax[b * 5] = max(amax[b * 5], max|x[b]|) for B frames
// of pix_frame pixels x 64 channels.
int fw_rdb_dyn_absmax(const void* x, int B, long long pix_frame, void* amax, void* stream) {
  const long long n8 = pix_frame * 8;
  const int threads = 256;
  const long long want = (n8 + threads - 1) / threads;
  const dim3 grid((unsigned)(want < 1024 ? want : 1024), B);
  rdb_dyn_absmax_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>((const bf16*)x, n8,
                                                                   (float*)amax);
  return (int)cudaGetLastError();
}

// Dynamic scheme: codes of src (B * pix_frame pixels x src_c channels,
// bf16 when src_f32 == 0, else f32) into Q[..., q_off:q_off + src_c] with
// the ranges amax[b][stage].
int fw_rdb_dyn_quant(const void* src, int src_f32, int src_c, void* q, int q_off, int B,
                     long long pix_frame, const void* amax, int stage, void* stream) {
  if (src_c != (src_f32 ? A_C : X_C) || pix_frame * (src_c / 16) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int n16 = (int)(pix_frame * (src_c / 16)), threads = 256;
  const dim3 grid((n16 + threads - 1) / threads, B);
  if (src_f32)
    rdb_dyn_quant_kernel<float, A_C><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)src, (int8_t*)q, q_off, n16, (const float*)amax, stage);
  else
    rdb_dyn_quant_kernel<bf16, X_C><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const bf16*)src, (int8_t*)q, q_off, n16, (const float*)amax, stage);
  return (int)cudaGetLastError();
}

// Dynamic scheme, dense stage k in 1..4 (cin = 64 + 32 (k - 1)): the f32
// activation into act (B, H, W, 32) and its range into amax[frame][k].
// Images: ext = NULL, per_frame = 1, halo = 0. Halo blocks: ext (B, 4)
// int32 valid rectangles, per_frame blocks to a frame, the ring width halo.
int fw_rdb_dyn_dense(const void* q, int B, int H, int W, int cin, const void* w, const void* ws,
                     const void* bias, void* amax, void* act, const void* ext, int per_frame,
                     int halo, void* stream) {
  const int stage = (cin - 64) / 32 + 1;
  if (ext != nullptr)
    return (int)wg::launch_conv3x3<32>(
        (const int8_t*)q, Q_C, cin, B, H, W, (const int8_t*)w,
        DynDenseEpi<true>{H, W, (const float*)ws, (const float*)bias, (float*)amax, stage,
                          (float*)act, (const int*)ext, per_frame, halo},
        (cudaStream_t)stream);
  return (int)wg::launch_conv3x3<32>(
      (const int8_t*)q, Q_C, cin, B, H, W, (const int8_t*)w,
      DynDenseEpi<false>{H, W, (const float*)ws, (const float*)bias, (float*)amax, stage,
                         (float*)act, nullptr, 1, 0},
      (cudaStream_t)stream);
}

// Stage 5 with the frames' ranges amax (frames, 5), the RDB residual, and
// the RRDB residual when carry != NULL; ext and per_frame as for the
// dense stages; w in the chunk-major int8 layout, as there.
int fw_rdb_dyn_final(const void* q, int B, int H, int W, const void* w, const void* ws,
                     const void* bias, const void* amax, const void* x, void* dst,
                     const void* carry, const void* ext, int per_frame, void* stream) {
  return (int)launch_final8<DYN>((const int8_t*)q, B, H, W, (const int8_t*)w, (const float*)ws,
                                 (const float*)bias, (const float*)amax, per_frame,
                                 (const bf16*)x, (bf16*)dst, (const bf16*)carry,
                                 (const int*)ext, (cudaStream_t)stream);
}

}  // extern "C"
