#!/usr/bin/env python3
"""Where the wgmma main loop's cycles go in each launch of the int8 RDBs, on one GPU.

    python3 scripts/torch_wgmma_probe.py [--iters N]

Copies framewright_tpu_torch/ops/csrc into a temporary directory, adds
clock64() counters to the copy of conv_wgmma.cuh (the package's kernels
carry none), builds the int8 RDB sources from it, and runs each launch of
the i32 and f32acc RDBs at the x2plus body's size (one 540x960 frame,
seeded random weights of a one-block model, static ranges calibrated on a
seeded image). Prints the card's name and power limit, then one line per
launch: the mean cycles of a consumer warpgroup over the launch, by phase

    wait_full   waiting for a stage's loads
    products    ldmatrix and wgmma of the chunks, with their waits
    drain       at a tile's end: the last wait, the last flush, the
                deferred slices still pending
    stage       the two warpgroup barriers and the epilogue's stage()
    slices      the slices written at once (stage 5) and the zeroing
    flush       the flushes inside a tile (f32acc)
    total

and of the producer thread: its waits for a free stage, its total. The
counters patch exact lines of conv_wgmma.cuh and fail loudly if those
lines change. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from framewright_tpu_torch.models import rrdb  # noqa: E402
from framewright_tpu_torch.models.registry import from_jax_params, init_params  # noqa: E402
from framewright_tpu_torch.ops import _build  # noqa: E402

# counters: 0-7 consumer phases, 8 consumers counted, 9-10 producer
PHASES = ("wait_full", "products", "drain", "stage", "slices", "flush", "total")

# (old, new) replacements in the copy of conv_wgmma.cuh
PATCHES = [
    ("namespace fw {\nnamespace wg {",
     "namespace fw {\nnamespace wg {\nstatic __device__ unsigned long long g_probe[16];"),
    ("""    for (int k = 0; tid == 128 * NWG && k < total; ++k) {
      const int s = k % NST;
      if (k >= NST) mbar_wait(empty + 8 * s, ((k / NST) & 1) ^ 1);""",
     """    long long pe = 0, p0 = clock64();
    for (int k = 0; tid == 128 * NWG && k < total; ++k) {
      const int s = k % NST;
      const long long q0 = clock64();
      if (k >= NST) mbar_wait(empty + 8 * s, ((k / NST) & 1) ^ 1);
      pe += clock64() - q0;
      if (k == total - 1) {
        atomicAdd(&g_probe[9], (unsigned long long)pe);
        atomicAdd(&g_probe[10], (unsigned long long)(clock64() - p0));
      }"""),
    ("""    for (int it = 0; it < total; ++it) {
      mbar_wait(full + 8 * (it % NST), (it / NST) & 1);""",
     """    long long ph[7] = {}, ta, t00 = clock64();
    for (int it = 0; it < total; ++it) {
      ta = clock64();
      mbar_wait(full + 8 * (it % NST), (it / NST) & 1);
      ph[0] += clock64() - ta, ta = clock64();"""),
    ("""      if (c == nchunk - 1) {
        wgmma_wait<0>();""",
     """      ph[1] += clock64() - ta, ta = clock64();
      if (c == nchunk - 1) {
        wgmma_wait<0>();"""),
    ("""        wg_sync(wgi);   // the warpgroup is done reading the buffer""",
     """        ph[2] += clock64() - ta, ta = clock64();
        wg_sync(wgi);   // the warpgroup is done reading the buffer"""),
    ("""        if (has) pend = Epi::SLICES, pb = b, py0 = y0, px0 = x0;""",
     """        if (has) pend = Epi::SLICES, pb = b, py0 = y0, px0 = x0;
        ph[3] += clock64() - ta, ta = clock64();"""),
    ("""          for (int r = 0; r < N / 2; ++r) acc[j][r] = 0;
          fence_acc(acc[j]);
        }
      } else if constexpr (FLUSH) {""",
     """          for (int r = 0; r < N / 2; ++r) acc[j][r] = 0;
          fence_acc(acc[j]);
        }
        ph[4] += clock64() - ta;
      } else if constexpr (FLUSH) {"""),
    ("""            for (int r = 0; r < N / 2; ++r) acc[j][r] = 0;
            fence_acc(acc[j]);
          }
        }""",
     """            for (int r = 0; r < N / 2; ++r) acc[j][r] = 0;
            fence_acc(acc[j]);
          }
          ph[5] += clock64() - ta;
        }"""),
    ("""    if constexpr (FLUSH) epi.drain(part);""",
     """    if constexpr (FLUSH) epi.drain(part);
    ph[6] = clock64() - t00;
    if ((tid & 127) == 0) {
      for (int i = 0; i < 7; ++i) atomicAdd(&g_probe[i], (unsigned long long)ph[i]);
      atomicAdd(&g_probe[8], 1ull);
    }"""),
]
READ = """
extern "C" int fw_probe_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, fw::wg::g_probe, 128);
}
extern "C" int fw_probe_zero() {
  unsigned long long z[16] = {};
  return (int)cudaMemcpyToSymbol(fw::wg::g_probe, z, 128);
}
"""


def build(tmp: Path) -> ctypes.CDLL:
    """The int8 RDB sources with counters, as a library of their launchers
    and the counters' accessors."""
    csrc = tmp / "csrc"
    shutil.copytree(ROOT / "framewright_tpu_torch" / "ops" / "csrc", csrc)
    for f in csrc.glob("*.cu"):
        if f.name != "rdb_int8.cu":
            f.unlink()
    head = csrc / "conv_wgmma.cuh"
    s = head.read_text()
    for old, new in PATCHES:
        if s.count(old) != 1:
            raise SystemExit(f"torch_wgmma_probe: conv_wgmma.cuh changed, no unique {old!r}")
        s = s.replace(old, new)
    head.write_text(s)
    (csrc / "rdb_int8.cu").write_text((csrc / "rdb_int8.cu").read_text() + READ)
    _build.CSRC, _build.BUILD_ROOT = csrc, tmp / "build"
    lib = ctypes.CDLL(str(_build.build(verbose=False).path))
    for name in ("fw_rdb_i8_quant", "fw_rdb_i8_dense", "fw_rdb_i8_final"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
    lib.fw_probe_read.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_wgmma_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp))
        cfg = rrdb.RRDBConfig(num_block=1, scale=2)
        model = rrdb.RRDBNet.from_state_dict(
            cfg, from_jax_params(init_params(cfg, seed=0), torch.float32), dev)
        g = np.random.default_rng(0)
        feat = torch.from_numpy(g.uniform(-1, 1, (1, 540, 960, 64)).astype(np.float32)).to(
            dev).to(torch.bfloat16)
        amax = rrdb.calibrate_act_scales(model, torch.from_numpy(
            g.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)))
        b, h, w = 1, 540, 960
        q = torch.zeros(b, h, w, 192, dtype=torch.int8, device=dev)
        out = torch.empty_like(feat)
        stream = torch.cuda.current_stream().cuda_stream

        def probe(fn) -> dict:
            fn()
            torch.cuda.synchronize()
            lib.fw_probe_zero()
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
            v = (ctypes.c_ulonglong * 16)()
            lib.fw_probe_read(v)
            n = max(v[8], 1)
            res = {k: v[i] / n for i, k in enumerate(PHASES)}
            res.update(producer_wait_empty=2 * v[9] / n, producer_total=2 * v[10] / n)
            return res

        for scheme in ("i32", "f32acc"):
            wts = model.fast_weights_int8(amax, scheme).body[0][0]
            f32acc = int(scheme != "i32")
            inv = [float(x) for x in wts.act_q[5:]]
            lib.fw_rdb_i8_quant(feat.data_ptr(), q.data_ptr(), b * h * w, inv[0], stream)
            for k in range(4):
                r = probe(lambda k=k: lib.fw_rdb_i8_dense(
                    q.data_ptr(), b, h, w, 64 + 32 * k, wts.wk[k].data_ptr(),
                    wts.scale[k].data_ptr(), wts.bias[k].data_ptr(), inv[k + 1], f32acc, None,
                    stream))
                print(f"{scheme}_stage{k + 1}", json.dumps({k_: round(v_) for k_, v_ in r.items()}))
            r = probe(lambda: lib.fw_rdb_i8_final(
                q.data_ptr(), b, h, w, wts.wk[4].data_ptr(), wts.scale[4].data_ptr(),
                wts.bias[4].data_ptr(), f32acc, feat.data_ptr(), out.data_ptr(), None, None,
                stream))
            print(f"{scheme}_stage5", json.dumps({k_: round(v_) for k_, v_ in r.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
