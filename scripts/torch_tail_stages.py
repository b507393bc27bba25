#!/usr/bin/env python3
"""Per-launch times of the port's K2 and tail1 (csrc/tail.cu) on one GPU.

    python3 scripts/torch_tail_stages.py [--iters N] [--profile] [--variants NAME ...]

Builds the kernels, then times with CUDA events, at the x2plus tail's
size (one 540x960 body frame to 2160x3840, seeded random weights of a
one-block model, seeded random features): each of K2's launches through
its C entry point, conv_up1 (540x960 -> 1080x1920), conv_up2 (-> 2160x3840),
conv_hr at 2160x3840 and conv_last with each of its three epilogues
(bf16 RGB, rgb_u8, yuv420_u8), then the whole K2 (``fused_tail``,
yuv420_u8) and tail1 (``fused_tail1`` from 1080x1920). Beside each
launch: its GFLOP, the bytes it must move (input read once, output
written once) and the rate they give. With ``--profile`` also, for K2 and
tail1, the host's time to issue one call (no synchronisation) and
torch.profiler's device time per kernel. With ``--variants``, the
launches again from variant builds: text replacements applied to a copy
of framewright_tpu_torch/ops/csrc (the package's sources stay as they
are), each build's outputs compared with the package's ("equal"):

    lag1, lag2  consumer warpgroup 1 starts 1 or 2 us after consumer 0
                (the two consumers' epilogues apart)
    nostage     no epilogue stage() (wrong outputs: its cost, by
                difference)
    nst8        eight ring stages at N = 8 (conv_last) instead of five
    up2group1   the phase convs' two tap columns in two wgmma groups a
                chunk instead of one
    group3      the 3x3 convs' (conv_hr, conv_last) three tap columns in
                one wgmma group a chunk instead of three
    noproducts  no wgmma (wrong outputs: the loads' and epilogues' time)

Prints the card's name and power limit, then one JSON line of
milliseconds (and one a variant). Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from torch_rdb_stages import cuda_ms, host_and_device_ms, patched_library  # noqa: E402

from framewright_tpu_torch.models import rrdb  # noqa: E402
from framewright_tpu_torch.models.registry import from_jax_params, init_params  # noqa: E402
from framewright_tpu_torch.ops import _build, fused_tail  # noqa: E402


_PART = "    typename EpiTraits<Epi>::Part part{};"
_STAGE = "        if (has) epi.stage(acc, part, b, y0, x0, live, buf);"
_NSTAGE = "constexpr int nstage(int n) { return n <= 32 ? 5 : 4; }"
VARIANTS = {
    "lag1": [(_PART, _PART + "\n    if (wgi == 1) __nanosleep(1000);")],
    "lag2": [(_PART, _PART + "\n    if (wgi == 1) __nanosleep(2000);")],
    "nostage": [(_STAGE, _STAGE.replace("if (has)", "if (has && b < 0)"))],
    "nst8": [(_NSTAGE, _NSTAGE.replace("n <= 32 ? 5", "n <= 8 ? 8 : n <= 32 ? 5"))],
    "up2group1": [("NPASS = 4, NU = 2, NV = 2, VG = 2", "NPASS = 4, NU = 2, NV = 2, VG = 1")],
    "group3": [("NPASS = 1, NU = 3, NV = 3, VG = 1", "NPASS = 1, NU = 3, NV = 3, VG = 3")],
    "noproducts": [("for (int j = 0; j < 4; ++j) wgmma_rs(acc[j], a[e][j + u], desc);", "")],
}


def _kernel_w(wts, name: str) -> torch.Tensor:
    """A conv's weights as the tail kernels take them: the chunk-major copy
    ``<name>_k`` (trees before the wgmma tail took the plain layouts)."""
    return getattr(wts, f"{name}_k", getattr(wts, name))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="host issue time and device time per kernel of K2 and tail1")
    ap.add_argument("--variants", nargs="*", default=[], choices=sorted(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tail_stages: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = rrdb.RRDBConfig(num_block=1, scale=2)
    model = rrdb.RRDBNet.from_state_dict(
        cfg, from_jax_params(init_params(cfg, seed=0), torch.float32), dev)
    wts = model.fast_weights().tail
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.uniform(-1, 1, (1, 540, 960, 64)).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    b, h, w, _ = x.shape
    a0 = torch.empty(b, 2 * h, 2 * w, 64, dtype=torch.bfloat16, device=dev)
    a = torch.empty(b, 4 * h, 4 * w, 64, dtype=torch.bfloat16, device=dev)
    c = torch.empty_like(a)
    libs = [_build.library()]
    lib = lambda: libs[-1]   # noqa: E731  (the build being timed)
    stream = torch.cuda.current_stream().cuda_stream
    coef = (ctypes.c_float * 11)(*fused_tail.yuv420_coefficients(True).tolist())
    rgb = {0: torch.empty(b, 4 * h, 4 * w, 3, dtype=torch.bfloat16, device=dev),
           1: torch.empty(b, 4 * h, 4 * w, 3, dtype=torch.uint8, device=dev)}
    yuv = (torch.empty(b, 4 * h, 4 * w, dtype=torch.uint8, device=dev),
           torch.empty(b, 2 * h, 2 * w, dtype=torch.uint8, device=dev),
           torch.empty(b, 2 * h, 2 * w, dtype=torch.uint8, device=dev))

    def up2(src, dst, hh, ww, name):
        return lambda: _build.check(lib().fw_tail_up2(
            src.data_ptr(), b, hh, ww, _kernel_w(wts, name).data_ptr(),
            getattr(wts, f"{name}_b").data_ptr(), dst.data_ptr(), stream), "fw_tail_up2")

    def last(mode):
        outs = [o.data_ptr() for o in (yuv if mode == 2 else (rgb[mode],))]
        outs += [None] * (3 - len(outs))
        return lambda: _build.check(lib().fw_tail_last(
            c.data_ptr(), b, 4 * h, 4 * w, _kernel_w(wts, "last").data_ptr(),
            wts.last_b.data_ptr(), mode, ctypes.addressof(coef), *outs, stream), "fw_tail_last")

    px, px2, px4 = b * h * w, 4 * b * h * w, 16 * b * h * w
    # launch -> (call, MACs, bytes: input read once, output written once)
    launches = {
        "conv_up1": (up2(x, a0, h, w, "up1"), px2 * 4 * 64 * 64, 128 * (px + px2)),
        "conv_up2": (up2(a0, a, 2 * h, 2 * w, "up2"), px4 * 4 * 64 * 64, 128 * (px2 + px4)),
        "conv_hr": (lambda: _build.check(lib().fw_tail_hr(
            a.data_ptr(), b, 4 * h, 4 * w, _kernel_w(wts, "hr").data_ptr(), wts.hr_b.data_ptr(),
            c.data_ptr(), stream), "fw_tail_hr"), px4 * 9 * 64 * 64, 256 * px4),
        "conv_last_bf16": (last(0), px4 * 9 * 64 * 3, (128 + 6) * px4),
        "conv_last_rgb_u8": (last(1), px4 * 9 * 64 * 3, (128 + 3) * px4),
        "conv_last_yuv420_u8": (last(2), px4 * 9 * 64 * 3, (128 + 1.5) * px4),
    }

    def outputs() -> list:
        """Every launch once, in K2's order; the intermediates and outputs."""
        for fn, _, _ in launches.values():
            fn()
        torch.cuda.synchronize()
        return [t.clone() for t in (a0, a, c, rgb[0], rgb[1], *yuv)]

    want = outputs()
    ms, rates = {}, {}
    for name, (fn, macs, nbytes) in launches.items():
        ms[name] = cuda_ms(fn, args.iters)
        rates[name] = {"gflop": 2 * macs / 1e9, "gbytes": nbytes / 1e9,
                       "tflops": 2 * macs / ms[name] / 1e9, "tbytes_s": nbytes / ms[name] / 1e9}
    ms["k2"] = cuda_ms(lambda: fused_tail.fused_tail(x, wts, "yuv420_u8", True), args.iters)
    ms["tail1"] = cuda_ms(lambda: fused_tail.fused_tail1(a0, wts), args.iters)
    prof = None
    if args.profile:
        prof = host_and_device_ms({
            "k2": lambda: fused_tail.fused_tail(x, wts, "yuv420_u8", True),
            "tail1": lambda: fused_tail.fused_tail1(a0, wts)}, args.iters)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "shape": [b, h, w],
                      "ms": ms, "per_launch": rates, "profile": prof}))
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.variants:
            patches = [("conv_wgmma.cuh", old, new) for old, new in VARIANTS[name]]
            libs.append(patched_library(Path(tmp) / name, {"tail.cu"}, patches, ("fw_tail",))[0])
            equal = all(torch.equal(g, w) for g, w in zip(outputs(), want))
            vms = {n: cuda_ms(fn, args.iters) for n, (fn, _, _) in launches.items()}
            print(json.dumps({"variant": name, "equal": equal, "ms": vms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
