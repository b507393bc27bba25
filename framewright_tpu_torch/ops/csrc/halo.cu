// Halo ring refresh of the resident RRDB body, in place, between RDBs.
//
// Replaces framewright_tpu/ops/fused_rrdb.py: _make_refresh_kernel_hbm
// (via halo_refresh_hbm), with the semantics of halo_refresh_xla and
// halo_refresh (fused_rrdb.py:1244-1283): every block's HALO ring is
// rebuilt from its neighbours' interiors, corners from the diagonal
// neighbour, zeros where the ring lies outside the block grid.
//
// Data: halo blocks (nb, S, S, cs) NHWC bf16 in frame-major order
// (b, i, j), nb = frames * nh * nw; block (i, j) of a frame covers frame
// rows i*BH - HALO .. i*BH + BH + HALO (BH = S - 2 HALO), columns alike.
// Channels [0, 64) are refreshed: cs is 192 (the bf16 RDB workspace) or
// 64 (the int8 body's carries).
//
// The TPU kernel moves rings as HBM->HBM DMAs in waves of 8, in two
// phases (rows, then full-height columns) so that corners come out right:
// that is how Mosaic had to move strips that its (8, 128) tiling does not
// allow in VMEM. Here one launch gathers each ring pixel from the block
// whose interior owns its frame position. Writes go to rings only and
// reads come from interiors only, so no pixel is both read and written
// and one launch is safe in place.
//
// Bound: bytes. At the 540x960 body (S=112, 60 blocks) 3,328 ring pixels
// a block x 128 B written, and read for the 171,264 of the 199,680 that
// lie in the grid: 47.5 MB, 0.0142 ms at 3.35 TB/s. One
// thread moves 16 bytes (8 channels); neighbouring threads take the
// neighbouring 16-byte chunks of one pixel, then the next pixel of the
// ring row, so warps read and write whole 128-byte pixels.
#include "conv_common.cuh"

namespace fw {

__global__ void halo_refresh_kernel(bf16* blk, int nh, int nw, int S, int halo, int cs) {
  const int BH = S - 2 * halo;
  const int band = halo * S;                          // one top or bottom ring band
  const int ring = 2 * band + 2 * halo * BH;          // ring pixels of a block
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ring * 8) return;
  const int r = i >> 3, q = i & 7;
  int y, x;
  if (r < 2 * band) {                                 // top, then bottom band
    y = r < band ? r / S : S - halo + (r - band) / S;
    x = r % S;
  } else {                                            // left and right strips
    const int m = r - 2 * band, c = m % (2 * halo);
    y = halo + m / (2 * halo);
    x = c < halo ? c : S - 2 * halo + c;
  }
  const int k = blockIdx.y, per = nh * nw;
  const int f = k / per, bi = (k % per) / nw, bj = k % nw;
  // the pixel's position in the frame's grid of interiors
  const int gy = bi * BH + y - halo, gx = bj * BH + x - halo;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (gy >= 0 && gy < nh * BH && gx >= 0 && gx < nw * BH) {
    const int oi = gy / BH, oj = gx / BH;
    const size_t src = ((size_t)(f * per + oi * nw + oj) * S + gy - oi * BH + halo) * S +
                       gx - oj * BH + halo;
    v = *reinterpret_cast<const uint4*>(blk + src * cs + q * 8);
  }
  *reinterpret_cast<uint4*>(blk + (((size_t)k * S + y) * S + x) * cs + q * 8) = v;
}

}  // namespace fw

using namespace fw;

// Refresh the rings of nb = frames * nh * nw blocks of S x S pixels with
// channel stride cs, in place over channels [0, 64).
extern "C" int fw_halo_refresh(void* blocks, int nb, int nh, int nw, int S, int halo, int cs,
                               void* stream) {
  const int BH = S - 2 * halo;
  const int threads = 256, work = (2 * halo * S + 2 * halo * BH) * 8;
  const dim3 grid((work + threads - 1) / threads, nb);
  halo_refresh_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>((bf16*)blocks, nh, nw, S, halo,
                                                                   cs);
  return (int)cudaGetLastError();
}
