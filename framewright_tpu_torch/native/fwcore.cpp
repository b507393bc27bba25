// fwcore: native host-side media kernels of the PyTorch/CUDA port.
//
// The port's own copy of the JAX package's native/fwcore.cpp, the same
// code: the Y4M reader and writer convert 4:2:0 YUV<->RGB for every frame
// on the host, here in single-pass 16.16 fixed point with OpenMP over
// rows (the numpy copy of the same arithmetic is tens of times slower);
// plus a batch dHash. Built by g++ at first use into the port's build directory
// and bound with ctypes (framewright_tpu_torch/native/__init__.py), with
// the numpy copies in framewright_tpu_torch/io/y4m.py and ops/dhash.py as
// the fallback.

#include <cstdint>
#include <cstring>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

static inline uint8_t clamp_u8(int v) {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

extern "C" {

// BT.601 YUV420 planar -> interleaved RGB24.
// full_range: 1 = JPEG levels, 0 = studio levels (16-235).
void yuv420_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                   uint8_t* rgb, int h, int w, int full_range) {
    const int cw = w / 2;
#pragma omp parallel for schedule(static)
    for (int r = 0; r < h; ++r) {
        const uint8_t* yrow = y + (size_t)r * w;
        const uint8_t* urow = u + (size_t)(r / 2) * cw;
        const uint8_t* vrow = v + (size_t)(r / 2) * cw;
        uint8_t* out = rgb + (size_t)r * w * 3;
        for (int c = 0; c < w; ++c) {
            int Y = yrow[c];
            int U = urow[c / 2] - 128;
            int V = vrow[c / 2] - 128;
            int yf;
            if (full_range) {
                yf = Y << 16;
            } else {
                // (Y-16) * 255/219 in 16.16 fixed point
                yf = (Y - 16) * 76309;
                U = (U * 74313) >> 16;   // *255/224
                V = (V * 74313) >> 16;
            }
            int R = (yf + 91881 * V + 32768) >> 16;            // 1.402
            int G = (yf - 22554 * U - 46802 * V + 32768) >> 16; // 0.344136, 0.714136
            int B = (yf + 116130 * U + 32768) >> 16;           // 1.772
            out[c * 3 + 0] = clamp_u8(R);
            out[c * 3 + 1] = clamp_u8(G);
            out[c * 3 + 2] = clamp_u8(B);
        }
    }
}

// Interleaved RGB24 -> BT.601 YUV420 planar with 2x2 chroma box filter.
void rgb_to_yuv420(const uint8_t* rgb, uint8_t* y, uint8_t* u, uint8_t* v,
                   int h, int w, int full_range) {
    const int cw = w / 2;
#pragma omp parallel for schedule(static)
    for (int r = 0; r < h; ++r) {
        const uint8_t* in = rgb + (size_t)r * w * 3;
        uint8_t* yrow = y + (size_t)r * w;
        for (int c = 0; c < w; ++c) {
            int R = in[c * 3], G = in[c * 3 + 1], B = in[c * 3 + 2];
            // 0.299, 0.587, 0.114 in 16.16
            int Y = (19595 * R + 38470 * G + 7471 * B + 32768) >> 16;
            if (!full_range) Y = ((Y * 56283 + 32768) >> 16) + 16;  // *219/255
            yrow[c] = clamp_u8(Y);
        }
    }
#pragma omp parallel for schedule(static)
    for (int cr = 0; cr < h / 2; ++cr) {
        uint8_t* urow = u + (size_t)cr * cw;
        uint8_t* vrow = v + (size_t)cr * cw;
        for (int cc = 0; cc < cw; ++cc) {
            int sr = 0, sg = 0, sb = 0;
            for (int dy = 0; dy < 2; ++dy) {
                const uint8_t* in = rgb + (size_t)(cr * 2 + dy) * w * 3 + (size_t)cc * 6;
                sr += in[0] + in[3];
                sg += in[1] + in[4];
                sb += in[2] + in[5];
            }
            int R = sr / 4, G = sg / 4, B = sb / 4;
            int Yf = (19595 * R + 38470 * G + 7471 * B) >> 16;
            // Cb = (B - Y)/1.772, Cr = (R - Y)/1.402 in 16.16
            int U = ((B - Yf) * 36984) >> 16;
            int V = ((R - Yf) * 46727) >> 16;
            if (!full_range) {
                U = (U * 57475) >> 16;  // *224/255
                V = (V * 57475) >> 16;
            }
            urow[cc] = clamp_u8(U + 128);   // +0.5 handled by fixed-point bias
            vrow[cc] = clamp_u8(V + 128);
        }
    }
}

// Batch dHash: frames (n, h, w, 3) uint8 -> bits (n, hs*hs) uint8 {0,1}.
// As ops/dhash.py (which averages in float32, here in double): gray ->
// area-resize to (hs, hs+1) -> horizontal
// neighbor comparison.
void dhash_batch(const uint8_t* frames, uint8_t* bits,
                 int n, int h, int w, int hs) {
#pragma omp parallel for schedule(static)
    for (int i = 0; i < n; ++i) {
        const uint8_t* f = frames + (size_t)i * h * w * 3;
        // area resize gray to (hs, hs+1), matching ops/dhash.py
        // semantics exactly: pad H/W to multiples with EDGE replication,
        // then mean fixed-size blocks (so bits agree with the python
        // fallback bit-for-bit up to float ties)
        double cell[64 * 65];
        const int gw = hs + 1;
        const int ph = ((h + hs - 1) / hs) * hs;
        const int pw = ((w + gw - 1) / gw) * gw;
        const int bh = ph / hs, bw = pw / gw;
        for (int gy = 0; gy < hs; ++gy) {
            for (int gx = 0; gx < gw; ++gx) {
                double acc = 0.0;
                for (int yy = gy * bh; yy < (gy + 1) * bh; ++yy) {
                    int sy = yy < h ? yy : h - 1;
                    for (int xx = gx * bw; xx < (gx + 1) * bw; ++xx) {
                        int sx = xx < w ? xx : w - 1;
                        const uint8_t* px = f + ((size_t)sy * w + sx) * 3;
                        acc += 0.299 * px[0] + 0.587 * px[1] + 0.114 * px[2];
                    }
                }
                cell[gy * gw + gx] = acc / (bh * bw);
            }
        }
        uint8_t* out = bits + (size_t)i * hs * hs;
        for (int gy = 0; gy < hs; ++gy)
            for (int gx = 0; gx < hs; ++gx)
                out[gy * hs + gx] =
                    cell[gy * gw + gx + 1] > cell[gy * gw + gx] ? 1 : 0;
    }
}

int fwcore_version() { return 1; }

}  // extern "C"
