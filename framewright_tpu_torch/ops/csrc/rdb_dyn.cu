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
// (B, H, W, 32) scratch and folds max|.| of its tile into amax[b][k] with
// one atomicMax on the float's bits (an order-free maximum, valid for
// values >= 0); a quantization launch then turns the scratch into codes.
// The scales never leave the device.
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
// 540x960 RDB, 0.126 ms. This first version adds the f32 scratch (128 B a
// pixel written and read per stage) and the reductions as device-memory
// traffic; fusing them is work for a later PR.
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
// max(amax[b][stage], 1e-8)))) for the src_c channels of each pixel, 8 a
// thread; src is the bf16 x (64 channels) or the f32 stage scratch (32).
template <typename T>
__global__ void rdb_dyn_quant_kernel(const T* __restrict__ src, int src_c, int8_t* __restrict__ q,
                                     int q_off, long long n8, long long pix_frame,
                                     const float* __restrict__ amax, int stage) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const int per_pix = src_c / 8;
  const long long p = i / per_pix;
  const int c = (int)(i % per_pix) * 8;
  const int b = (int)(p / pix_frame);
  const float inv = __fdiv_rn(127.f, fmaxf(amax[b * NSRC + stage], 1e-8f));
  float v[8];
  if constexpr (sizeof(T) == 2) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + p * src_c + c);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = bf(h[j]);
  } else {
    const float4* f = reinterpret_cast<const float4*>(src + p * src_c + c);
    const float4 a = f[0], d = f[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = d.x, v[5] = d.y, v[6] = d.z, v[7] = d.w;
  }
  union {
    int8_t s[8];
    uint2 u;
  } out;
#pragma unroll
  for (int j = 0; j < 8; ++j) out.s[j] = code(__fmul_rn(v[j], inv));
  *reinterpret_cast<uint2*>(q + p * Q_C + q_off + c) = out.u;
}

// Dynamic stages 1-4: act[..., 0:32] = lrelu(conv(Q[..., :cin]) + b) in
// f32 (0 outside the valid rectangle), and max|act| of the tile folded
// into amax[frame][stage] (stage = the source index of this stage's
// output). sc = ws_row (32 x 5), bias = b.
template <bool BLOCKS>
__global__ void __launch_bounds__(NTHREADS, 2)
    rdb_dyn_dense_kernel(const int8_t* q, int H, int W, int cin, const int8_t* __restrict__ w,
                         const float* __restrict__ sc, const float* __restrict__ bias, float* amax,
                         int stage, float* __restrict__ act, const int* __restrict__ ext,
                         int per_frame, int halo) {
  extern __shared__ uint4 smem_u4[];
  int8_t* s_in = reinterpret_cast<int8_t*>(smem_u4);
  int8_t* s_w = s_in + HT * HW * KP8;
  const int b = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  int acc[2][4][4];
  float facc[2][4][4];
  float* amax_f = amax + (BLOCKS ? b / per_frame : b) * NSRC;
  accumulate<4, DYN>(acc, facc, q, cin, H, W, b, ty0, tx0, w, sc, amax_f, s_in, s_w);
  const Rect valid = valid_rect(ext, b, H, W);
  // the pixels whose values enter the frame's range
  const Rect inner{max(valid.r0, halo), min(valid.r1, H - halo), max(valid.c0, halo),
                   min(valid.c1, W - halo)};

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float m = 0.f;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    const int y = ty0 + 2 * warp + mf;
    if (y >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = tx0 + g + 8 * h;
      if (x >= W) continue;
      float* dst = act + (((size_t)b * H + y) * W + x) * A_C;
      const bool ok = !BLOCKS || valid.has(y, x), counts = !BLOCKS || inner.has(y, x);
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const int n = nf * 8 + 2 * t;
        float2 v = make_float2(0.f, 0.f);
        if (ok) {
          v.x = lrelu_rn(__fadd_rn(facc[mf][nf][2 * h], bias[n]));
          v.y = lrelu_rn(__fadd_rn(facc[mf][nf][2 * h + 1], bias[n + 1]));
        }
        if (counts) m = fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y)));
        *reinterpret_cast<float2*>(dst + n) = v;
      }
    }
  }
  // accumulate ended with a barrier, so the staging memory is free
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float* s_red = reinterpret_cast<float*>(smem_u4);
  if (lane == 0) s_red[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < NTHREADS / 32; ++i) m = fmaxf(m, s_red[i]);
    atomicMax(reinterpret_cast<int*>(amax_f + stage), __float_as_int(m));
  }
}

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
  const long long n8 = (long long)B * pix_frame * (src_c / 8);
  const int threads = 256;
  const long long blocks = (n8 + threads - 1) / threads;
  if (src_f32)
    rdb_dyn_quant_kernel<float><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)src, src_c, (int8_t*)q, q_off, n8, pix_frame, (const float*)amax, stage);
  else
    rdb_dyn_quant_kernel<bf16><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const bf16*)src, src_c, (int8_t*)q, q_off, n8, pix_frame, (const float*)amax, stage);
  return (int)cudaGetLastError();
}

// Dynamic scheme, dense stage k in 1..4 (cin = 64 + 32 (k - 1)): the f32
// activation into act (B, H, W, 32) and its range into amax[frame][k].
// Images: ext = NULL, per_frame = 1, halo = 0. Halo blocks: ext (B, 4)
// int32 valid rectangles, per_frame blocks to a frame, the ring width halo.
int fw_rdb_dyn_dense(const void* q, int B, int H, int W, int cin, const void* w, const void* ws,
                     const void* bias, void* amax, void* act, const void* ext, int per_frame,
                     int halo, void* stream) {
  return (int)launch_tiles(ext, rdb_dyn_dense_kernel<true>, rdb_dyn_dense_kernel<false>,
                           conv_s8_smem_bytes(32), B, H, W, (cudaStream_t)stream,
                           (const int8_t*)q, H, W, cin, (const int8_t*)w, (const float*)ws,
                           (const float*)bias, (float*)amax, (cin - 64) / 32 + 1, (float*)act,
                           (const int*)ext, per_frame, halo);
}

// Stage 5 with the frames' ranges amax (frames, 5), the RDB residual, and
// the RRDB residual when carry != NULL; ext and per_frame as for the
// dense stages.
int fw_rdb_dyn_final(const void* q, int B, int H, int W, const void* w, const void* ws,
                     const void* bias, const void* amax, const void* x, void* dst,
                     const void* carry, const void* ext, int per_frame, void* stream) {
  return (int)launch_tiles(ext, rdb_i8_final_kernel<DYN, true>,
                           rdb_i8_final_kernel<DYN, false>, conv_s8_smem_bytes(64), B, H, W,
                           (cudaStream_t)stream, (const int8_t*)q, H, W, (const int8_t*)w,
                           (const float*)ws, (const float*)bias, (const float*)amax,
                           (const bf16*)x, (bf16*)dst, (const bf16*)carry, (const int*)ext,
                           per_frame);
}

}  // extern "C"
