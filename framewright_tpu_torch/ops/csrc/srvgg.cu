// SRVGGNetCompact conv chain: one 3x3 64->64 conv + bias + PReLU per
// launch, in bf16 and in int8 (static activation scales).
//
// Replaces framewright_tpu/ops/fused_srvgg.py:
//   _make_chain_kernel (via fused_conv_chain): bf16 operands, f32 sums,
//     v = acc + b, PReLU v >= 0 ? v : v alpha in f32, one rounding to
//     bf16 per conv;
//   _make_chain_kernel_int8 (via fused_conv_chain_int8): the group input
//     quantized at inv_0, s8 x s8 products whose int32 partials are
//     flushed to f32 per chunk of 4 taps (taps 0-3, 4-7, 8 of the
//     row-major TAPS, each over all 64 input channels) as f32(p) (ws sa),
//     summed in that order, + b, PReLU, requantized at inv_{i+1} within
//     the group and rounded to bf16 at the group's last conv.
// Both run for every chain conv of the SRVGG restore (16 convs, two
// groups of 8, for realesr-animevideov3).
//
// Bound: tensor-core operations. A 540x960 frame does 9 x 64 x 64 MAC
// per pixel per conv, 38.2 G operations per conv, 0.039 ms at the bf16
// peak (989 TFLOP/s) and 0.019 ms at the int8 peak (1,979 TOP/s), against
// 132.7 MB of bf16 input and output (0.040 ms at 3.35 TB/s) for a group
// of 8 that keeps its intermediates on the card, so a whole group is
// bound by operations. Each conv is one launch, from one buffer to the
// other, so each moves its input and output through device memory (66 MB
// each in bf16, 33 MB as codes): measured on an H100 (PERF.md), a conv
// without its products takes 60-70% of its time. Fusing a group's
// eight convs on chip would recompute a halo (a 16x16 output after eight
// 3x3 convs needs a 32x32 input, ~2.1x the MACs summed over the group)
// to save ~0.05 ms of traffic a conv; not done.
//
// Design:
//   bf16: conv_wgmma.cuh's main loop as the tail's conv_hr runs it
//     (launch_conv3x3<64>, Taps3x3: wgmma m64n64k16 with A by ldmatrix
//     from TMA halo boxes, B from the chunk-major weights, a ring kept
//     full by a producer warpgroup, a persistent grid) with PreluEpi,
//     which stages the bf16 tile in shared memory and writes it as
//     16-byte runs while the next tile's products run (as epi_bf16.cuh's
//     BiasActEpi). Weights: fused_rrdb.wgmma_weights of each conv
//     (ChainGroup.wk).
//   int8: the flush groups are the semantics. Each conv's int32 partial
//     is flushed per group of taps, {0-3}, {4-7}, {8} of the row-major
//     window, each over all 64 input channels, so a tile makes three
//     passes over both 32-channel chunks of its halo, one per group, and
//     folds each pass's s32 sums into its f32 sums in pass order (f =
//     f32(p) dq, then f += f32(p) dq). The taps of a group are not a
//     rectangle of the window, and a pass of 4 or 1 taps reads a whole
//     halo box: on conv3x3 with these passes as a tap table (as first
//     written) each box was loaded three times, by TMA at a few bytes a
//     clock, and the conv was no faster than on mma.sync. So the int8
//     conv has its own loop, built from conv_wgmma.cuh's pieces (below):
//     the conv's 48 KB of weights stay in shared memory for the launch, a
//     tile's two boxes stay from its first pass to its last, and each
//     pass's products are laid out at compile time, one wgmma group per
//     column of its taps. The two consumer warpgroups split a tile by
//     rows, 8 x 16 pixels and all 64 output channels each (two m64n64k32
//     M tiles: 64 s32 accumulators and 64 f32 sums a thread fit beside
//     each other, where 16 x 16 x 64 would need 128 + 128 registers of
//     the consumers' 232; a split by channels runs m64n32k32, at two
//     thirds of the rate). The epilogue (I8Epi) writes the next conv's
//     codes at inv_next, or bf16 at the group's last conv. Emulating the
//     tap groups with zeroed taps of 3x3 passes would run 3x the
//     products.
//   The group input's codes come from an elementwise launch
//   (vgg_i8_quant_kernel).
// Every f32 multiply and add is __fmul_rn/__fadd_rn (no FMA contraction).
// Codes round half to even as rintf and jnp.round do (conv_common.cuh's
// code(), by adding 1.5 * 2^23 after the clip), and an s32 partial goes to
// f32 by the same constant (i2f_exact): both exact, neither a conversion
// instruction (a quarter of the FMA rate). The TPU kernels' 112x112
// windows, halo 8, packed words and cyclic rolls are Mosaic workarounds
// and have no counterpart here.
#include "conv_wgmma.cuh"

namespace fw {
namespace {

constexpr int VC = 64;            // channels of every chain activation

__device__ __forceinline__ float prelu_rn(float v, float a) { return v >= 0.f ? v : __fmul_rn(v, a); }

// f32(p), exactly for |p| < 2^22, with code()'s constant: 1.5 * 2^23 + p
// as float bits, minus 1.5 * 2^23. A flush group's partial is at most
// 4 taps x 64 channels x 127 x 127 = 4,129,024 < 2^22 in magnitude.
__device__ __forceinline__ float i2f_exact(int p) {
  return __fsub_rn(__int_as_float(p + 0x4B400000), 12582912.f);
}

// out = bf16(prelu(acc + b)), 64 channels (B, H, W, 64).
struct PreluEpi {
  int H, W;
  const float* __restrict__ bias;
  const float* __restrict__ alpha;
  bf16* __restrict__ out;

  __device__ __forceinline__ bool live(int, int, int) const { return true; }

  static constexpr int ROW = wg::epi_row(64), BUF = wg::epi_bytes(64);
  // 256 pixels x 8 runs of 8 channels: 16 runs a thread, 4 a slice,
  // written while the next tile's products run
  static constexpr int SLICES = 4;
  static constexpr bool DEFER = true;
  struct Slice {};

  __device__ __forceinline__ void stage(const float (&acc)[4][32], wg::NoPart&, int, int, int,
                                        bool, uint8_t* buf) const {
    const wg::Frag f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = 8 * i + 2 * f.t;
      const float b0 = bias[n], b1 = bias[n + 1], a0 = alpha[n], a1 = alpha[n + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          st_bf16x2(reinterpret_cast<bf16*>(buf + f.px(j, h) * ROW) + n,
                    prelu_rn(__fadd_rn(acc[j][4 * i + 2 * h], b0), a0),
                    prelu_rn(__fadd_rn(acc[j][4 * i + 2 * h + 1], b1), a1));
      }
    }
  }

  __device__ __forceinline__ void load(Slice&, int, int, int, int, const uint8_t*) const {}

  __device__ __forceinline__ void finish(const Slice&, int k, int b, int y0, int x0,
                                         const uint8_t* buf) const {
    const wg::Frag f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (4 * k + e) * 128 + f.wt, p = r >> 3, c8 = r & 7;
      const int y = y0 + p / wg::TS, x = x0 + p % wg::TS;
      if (y >= H || x >= W) continue;
      *reinterpret_cast<uint4*>(out + (((size_t)b * H + y) * W + x) * VC + 8 * c8) =
          *reinterpret_cast<const uint4*>(buf + p * ROW + 16 * c8);
    }
  }
};

// --- the int8 chain conv ------------------------------------------------
//
// A CTA: one producer warpgroup, whose one thread loads the weights
// (W8_BYTES, one barrier) and then each 16x16 tile's two 32-channel halo
// boxes into a ring of NT8 tiles' slots; two consumer warpgroups on the
// same tile, rows 8 wgi .. 8 wgi + 7 each. A consumer walks its tiles'
// (pass, chunk) iterations as conv3x3 does (the pass picked by a
// warp-uniform branch, so that one copy of each pass's products exists),
// folds each pass's partial after its second chunk, and after the last
// pass releases the tile's slots, stages its 8 x 16 pixels in shared
// memory and writes them as 16-byte runs.
constexpr int NCH8 = VC / 32;                  // 32-channel chunks (boxes) a tile
constexpr int SLOTS8 = 4;                      // weight tap slots a pass (TPC_I8)
constexpr int NP8 = (9 + SLOTS8 - 1) / SLOTS8;  // passes: the flush groups 0-3, 4-7, 8
constexpr int MT8 = 2;                         // M tiles (64 pixels each) a consumer holds
constexpr int WCH8 = SLOTS8 * VC * wg::KB;     // one (pass, chunk): slots x 64 rows x 32 B
constexpr int W8_BYTES = NP8 * NCH8 * WCH8;    // the conv's weights (wgmma_weights_s8_runs)
constexpr int NT8 = 3;                         // tiles of boxes in flight
constexpr int SLOTS = NT8 * NCH8;              // box slots
static_assert(W8_BYTES % 256 == 0 && wg::HALO_BYTES % 256 == 0, "alignment");

// Pass P's products on one box: for each column v of the 3x3 window
// that holds taps of run [T0, T1), the A rows u0 .. u1 + MT8 - 1 by
// ldmatrix (they serve the MT8 M tiles of every row tap u0 .. u1), then
// one wgmma group. acc[j] += A rows j + u (column v) x weight slot t - T0.
template <int P>
__device__ __forceinline__ void i8_pass_products(int (&acc)[MT8][VC / 2], uint32_t box,
                                                 uint32_t wp, int p0, int half) {
  constexpr int T0 = SLOTS8 * P, T1 = T0 + SLOTS8 < 9 ? T0 + SLOTS8 : 9;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    // the rows of the run's taps in column v (none when u0 > u1)
    const int u0 = (T0 + 2 - v) / 3, u1 = T1 - 1 < v ? -1 : (T1 - 1 - v) / 3;
    if (u0 > u1) continue;
    uint32_t a[MT8 + 2][4];
#pragma unroll
    for (int r = 0; r < MT8 + 2; ++r) {
      if (r < u0 || r > u1 + MT8 - 1) continue;
      const int p = p0 + r * wg::HS + v;
      wg::ldmatrix_x4(a[r], box + p * 32 + ((half ^ ((p >> 2) & 1)) << 4));
    }
    wg::wgmma_fence();
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      if (u < u0 || u > u1) continue;
      const uint64_t desc = wg::desc_b(wp + (3 * u + v - T0) * VC * 32, VC * 16);
#pragma unroll
      for (int j = 0; j < MT8; ++j) wg::wgmma_rs(acc[j], a[j + u], desc);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<1>();
  }
}

// The epilogue of one int8 chain conv. fold<P> folds pass P's s32
// partial into the f32 sums: f = f32(p) dq at the first pass (as the TPU
// kernel's acc = contrib), f += f32(p) dq after. After the last pass,
// v = prelu(f + b) goes out as codes clip(rint(v inv_next)) into qout
// (!LAST) or as bf16 into out (LAST), both (B, H, W, 64).
template <bool LAST>
struct I8Epi {
  int H, W;
  const float* __restrict__ dq;   // (64,) ws_row sa_i
  const float* __restrict__ bias;
  const float* __restrict__ alpha;
  float inv_next;
  int8_t* __restrict__ qout;
  bf16* __restrict__ out;

  // the consumer's 8 x 16 pixels x 64 channels, 128 bytes (bf16) or 64
  // (codes) a pixel, rows padded by 16 bytes: RUNS runs of 16 bytes a pixel
  static constexpr int PX = 16 * 4 * MT8;
  static constexpr int RUNS = LAST ? 8 : 4;
  static constexpr int ROW = 16 * RUNS + 16, BUF = PX * ROW;

  template <int P>   // 0: the first pass, else a later one
  __device__ __forceinline__ void fold(const int (&acc)[MT8][VC / 2],
                                       float (&f)[MT8][VC / 2]) const {
    const int t = threadIdx.x & 3;
    float s[VC / 8][2];
#pragma unroll
    for (int i = 0; i < VC / 8; ++i) {
      s[i][0] = dq[8 * i + 2 * t];
      s[i][1] = dq[8 * i + 2 * t + 1];
    }
#pragma unroll
    for (int j = 0; j < MT8; ++j) {
#pragma unroll
      for (int r = 0; r < VC / 2; ++r) {
        const float v = __fmul_rn(i2f_exact(acc[j][r]), s[r >> 2][r & 1]);
        f[j][r] = P == 0 ? v : __fadd_rn(f[j][r], v);
      }
    }
  }

  // this thread's values at their pixels of the staging buffer: M tile j
  // of warp q is the consumer's row MT8 q + j
  __device__ __forceinline__ void stage(const float (&f)[MT8][VC / 2], uint8_t* buf) const {
    const wg::Frag fr;
#pragma unroll
    for (int i = 0; i < VC / 8; ++i) {
      const int n = 8 * i + 2 * fr.t;
      const float b0 = bias[n], b1 = bias[n + 1], a0 = alpha[n], a1 = alpha[n + 1];
#pragma unroll
      for (int j = 0; j < MT8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 4 * i + 2 * h;
          const float v0 = prelu_rn(__fadd_rn(f[j][r], b0), a0);
          const float v1 = prelu_rn(__fadd_rn(f[j][r + 1], b1), a1);
          uint8_t* row = buf + ((MT8 * fr.q + j) * wg::TS + fr.g + 8 * h) * ROW;
          if constexpr (LAST) {
            st_bf16x2(reinterpret_cast<bf16*>(row) + 8 * i + 2 * fr.t, v0, v1);
          } else {
            char2 c;
            c.x = code(__fmul_rn(v0, inv_next));
            c.y = code(__fmul_rn(v1, inv_next));
            *reinterpret_cast<char2*>(row + 8 * i + 2 * fr.t) = c;
          }
        }
      }
    }
  }

  // the staged pixels (rows y0 .. y0 + 4 MT8 - 1) as 16-byte runs,
  // neighbouring threads on neighbouring runs
  __device__ __forceinline__ void write(int b, int y0, int x0, const uint8_t* buf) const {
    const int wt = wg::Frag().wt;
#pragma unroll
    for (int e = 0; e < PX * RUNS / 128; ++e) {
      const int r = e * 128 + wt, p = r / RUNS, c = r % RUNS;
      const int y = y0 + p / wg::TS, x = x0 + p % wg::TS;
      if (y >= H || x >= W) continue;
      const size_t o = ((size_t)b * H + y) * W + x;
      const uint4 v = *reinterpret_cast<const uint4*>(buf + p * ROW + 16 * c);
      if constexpr (LAST)
        *reinterpret_cast<uint4*>(out + o * VC + 8 * c) = v;
      else
        *reinterpret_cast<uint4*>(qout + o * VC + 16 * c) = v;
    }
  }
};

template <bool LAST>
constexpr int i8_smem_bytes() {
  // + 256 to align, + the weights' barrier and two a box slot
  return 256 + W8_BYTES + SLOTS * wg::HALO_BYTES + wg::NWG * I8Epi<LAST>::BUF + 8 + 16 * SLOTS;
}
static_assert(i8_smem_bytes<true>() <= 232448, "shared memory");

// One int8 chain conv from the codes (tensor map `in`, (B, H, W, 64)
// int8); w: the pass-major weights (W8_BYTES).
template <bool LAST>
__global__ void __launch_bounds__(128 * (wg::NWG + 1), 1)
    vgg_i8_conv_kernel(const __grid_constant__ CUtensorMap in, const int8_t* __restrict__ w,
                       int B, int H, int W, I8Epi<LAST> epi) {
  using namespace wg;
  extern __shared__ uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, q = (tid >> 5) & 3;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);   // warp-uniform
  const int wgi = warp >> 2;
  const Tiles tiles(B, H, W);
  const int mine = (int)blockIdx.x < tiles.count
                       ? (tiles.count - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const uint32_t wsm = (smem_u32(smem) + 255u) & ~255u;
  const uint32_t boxes = wsm + W8_BYTES, bufs = boxes + SLOTS * HALO_BYTES;
  // wbar: the weights landed; full[s]: box slot s loaded; empty[s]: every
  // consumer warp is done with slot s
  const uint32_t wbar = bufs + NWG * I8Epi<LAST>::BUF, full = wbar + 8, empty = full + 8 * SLOTS;

  if (tid == 0) {
    mbar_init(wbar, 1);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == NWG) {
    // the producer: the weights once, then tile g's box c into slot
    // (g % NT8) NCH8 + c once the consumers have released tile g - NT8's
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (tid == 128 * NWG) {
      mbar_expect_tx(wbar, W8_BYTES);
#pragma unroll
      for (int i = 0; i < NP8 * NCH8; ++i)
        bulk_load(wsm + i * WCH8, w + (size_t)i * WCH8, WCH8, wbar);
      for (int g = 0; g < mine; ++g) {
        int b, y0, x0;
        tiles.at((int)blockIdx.x + g * (int)gridDim.x, b, y0, x0);
#pragma unroll
        for (int c = 0; c < NCH8; ++c) {
          const int s = (g % NT8) * NCH8 + c;
          if (g >= NT8) mbar_wait(empty + 8 * s, ((g / NT8) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, HS * HS * KB);
          tma_load_4d(boxes + s * HALO_BYTES, &in, full + 8 * s, 32 * c, x0 - 1, y0 - 1, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    int acc[MT8][VC / 2];
    float f[MT8][VC / 2];
    auto clear = [&]() {
#pragma unroll
      for (int j = 0; j < MT8; ++j) {
#pragma unroll
        for (int r = 0; r < VC / 2; ++r) acc[j][r] = 0;
        fence_acc(acc[j]);
      }
    };
    clear();
    // this lane's ldmatrix rows (as conv_wgmma.cuh's conv3x3, with MT8
    // rows a warp): pixel column lane % 16 (+ v) of halo row r0 + MT8 q
    // (+ r), r0 = 4 MT8 wgi the consumer's first row of the tile
    const int p0 = (4 * MT8 * wgi + MT8 * q) * HS + (lane & 15), half = lane >> 4;
    uint8_t* buf = smem + (bufs + wgi * I8Epi<LAST>::BUF - smem_u32(smem));
    mbar_wait(wbar, 0);
    // iteration it: tile it / 6, pass k / 2 and chunk k % 2 of k = it % 6,
    // as conv3x3 iterates, so that one copy of each pass's products runs
    // on a warp-uniform branch
    constexpr int PER_TILE = NP8 * NCH8;
    int b = 0, y0 = 0, x0 = 0, s0 = 0;
    uint32_t par = 0;
    for (int it = 0; it < mine * PER_TILE; ++it) {
      const int k = it % PER_TILE, c = k % NCH8;
      // the pass, warp-uniform; the broadcast lets ptxas see it
      const int ps = __shfl_sync(0xffffffffu, k / NCH8, 0);
      if (k == 0) {
        const int g = it / PER_TILE;
        tiles.at((int)blockIdx.x + g * (int)gridDim.x, b, y0, x0);
        s0 = (g % NT8) * NCH8;
        par = (g / NT8) & 1;
      }
      const uint32_t box = boxes + (s0 + c) * HALO_BYTES, wp = wsm + k * WCH8;
      static_assert(NP8 == 3, "three passes");
      if (ps == 0) {
        mbar_wait(full + 8 * (s0 + c), par);
        i8_pass_products<0>(acc, box, wp, p0, half);
      }
      if (ps == 1) i8_pass_products<1>(acc, box, wp, p0, half);
      if (ps == 2) i8_pass_products<2>(acc, box, wp, p0, half);
      if (c == NCH8 - 1) {
        // every product of the pass retired: its partial into the sums
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < MT8; ++j) fence_acc(acc[j]);
        if (ps == 0)
          epi.template fold<0>(acc, f);
        else
          epi.template fold<1>(acc, f);
        clear();
        if (ps == NP8 - 1) {
          // the tile's products have retired: its box slots are free
          if (lane == 0) {
#pragma unroll
            for (int cc = 0; cc < NCH8; ++cc) mbar_arrive(empty + 8 * (s0 + cc));
          }
          wg_sync(wgi);   // the warpgroup is done reading the buffer
          epi.stage(f, buf);
          wg_sync(wgi);   // the staged tile is visible to the whole warpgroup
          epi.write(b, y0 + 4 * MT8 * wgi, x0, buf);
        }
      }
    }
  }
}

template <bool LAST>
cudaError_t launch_i8_conv(const int8_t* q, int B, int H, int W, const int8_t* w,
                           const I8Epi<LAST>& epi, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = wg::grid_size(B, H, W, 1, &grid);
  if (err != cudaSuccess || grid == 0) return err;
  CUtensorMap map;
  err = wg::input_map(&map, q, VC, B, H, W);
  if (err != cudaSuccess) return err;
  constexpr int smem = i8_smem_bytes<LAST>();
  err = allow_smem(vgg_i8_conv_kernel<LAST>, smem);
  if (err != cudaSuccess) return err;
  vgg_i8_conv_kernel<LAST><<<grid, 128 * (wg::NWG + 1), smem, stream>>>(map, w, B, H, W, epi);
  return cudaGetLastError();
}

// q[p, c] = clip(rint(f32(x[p, c]) inv0)), 8 channels a thread.
__global__ void vgg_i8_quant_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q,
                                    long long n8, float inv0) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const uint4 raw = *reinterpret_cast<const uint4*>(x + i * 8);
  const bf16* v = reinterpret_cast<const bf16*>(&raw);
  union {
    int8_t s[8];
    uint2 u;
  } out;
#pragma unroll
  for (int j = 0; j < 8; ++j) out.s[j] = code(__fmul_rn(bf(v[j]), inv0));
  *reinterpret_cast<uint2*>(q + i * 8) = out.u;
}

}  // namespace
}  // namespace fw

using namespace fw;

extern "C" {

// One bf16 chain conv: out = bf16(prelu(conv(in) + bias)), (B, H, W, 64);
// w: fused_rrdb.wgmma_weights of the conv (ChainGroup.wk[i]).
int fw_vgg_conv(const void* in, int B, int H, int W, const void* w, const void* bias,
                const void* alpha, void* out, void* stream) {
  return (int)wg::launch_conv3x3<64>(
      (const bf16*)in, VC, VC, B, H, W, (const bf16*)w,
      PreluEpi{H, W, (const float*)bias, (const float*)alpha, (bf16*)out}, (cudaStream_t)stream);
}

// The codes of a group's bf16 input x at inv0, npix pixels x 64 channels.
int fw_vgg_i8_quant(const void* x, void* q, long long npix, float inv0, void* stream) {
  const long long n8 = npix * (VC / 8);
  const int threads = 256;
  const long long blocks = (n8 + threads - 1) / threads;
  vgg_i8_quant_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (int8_t*)q, n8, inv0);
  return (int)cudaGetLastError();
}

// One int8 chain conv from the codes q: the next codes into qout at
// inv_next, or, when qout is NULL (the group's last conv), bf16 into out;
// w: fused_rrdb.wgmma_weights_s8_runs of the conv (ChainGroupInt8.wk[i]).
int fw_vgg_i8_conv(const void* q, int B, int H, int W, const void* w, const void* dq,
                   const void* bias, const void* alpha, float inv_next, void* qout, void* out,
                   void* stream) {
  const int8_t* qi = (const int8_t*)q;
  const int8_t* wi = (const int8_t*)w;
  const float *d = (const float*)dq, *bi = (const float*)bias, *al = (const float*)alpha;
  if (qout == nullptr)
    return (int)launch_i8_conv(qi, B, H, W, wi,
                               I8Epi<true>{H, W, d, bi, al, 0.f, nullptr, (bf16*)out},
                               (cudaStream_t)stream);
  return (int)launch_i8_conv(qi, B, H, W, wi,
                             I8Epi<false>{H, W, d, bi, al, inv_next, (int8_t*)qout, nullptr},
                             (cudaStream_t)stream);
}

}  // extern "C"
