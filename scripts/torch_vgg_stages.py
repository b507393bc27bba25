#!/usr/bin/env python3
"""Per-launch times of the port's SRVGG chain kernels (csrc/srvgg.cu) on
one GPU.

    python3 scripts/torch_vgg_stages.py [--iters N] [--profile] [--variants NAME ...]

Builds the kernels, then times with CUDA events, at the realesr-animevideov3
chain's size (one 540x960x64 frame, the model's seeded random weights,
int8 scales calibrated on a seeded 128x128 sample, seeded random
features): one chain conv's launches through their C entry points, the
bf16 conv, the int8 quantization of the group input, an int8 conv to the
next codes and the group's last int8 conv to bf16; then a whole group of
8 through each chain wrapper (``fused_conv_chain``, ``fused_conv_chain_int8``,
GROUP = 8). Beside each conv: its GFLOP (GOP for int8), the bytes it
must move (input read once, output written once) and the rates they
give. With ``--profile`` also, for the two groups, the host's time to
issue one call and torch.profiler's device time per kernel. With
``--variants``, the launches again from variant builds of srvgg.cu: text
replacements applied to a copy of framewright_tpu_torch/ops/csrc (the
package's sources stay as they are), each build's outputs compared with
the package's ("equal"):

    noproducts  no wgmma (wrong outputs: the loads' and epilogues' time)
    nostage     no epilogue stage() (wrong outputs: its cost, by
                difference)
    noflush     the int8 epilogue's flushes return at once (wrong
                outputs: the cost of folding each pass into the f32 sums)
    noload      the int8 conv loads the halo boxes of its first tiles
                only (wrong outputs: the cost of the boxes' TMA loads)
    nowrite     the int8 conv writes no output (its stores' cost)

The script runs from any tree of the repository that has the chain's C
entry points: the weights are the kernels' copies ``wk`` where the tree's
groups have them (trees before the wgmma chains took ``w`` and ``wq``).
Prints the card's name and power limit, then one JSON line of
milliseconds (and one a variant). Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
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

from framewright_tpu_torch.models import srvgg  # noqa: E402
from framewright_tpu_torch.models.registry import (  # noqa: E402
    MODEL_SPECS,
    bf16_masters,
    from_jax_params,
    init_params,
)
from framewright_tpu_torch.ops import _build, fused_srvgg  # noqa: E402

_STAGE = "        if (has) epi.stage(acc, part, b, y0, x0, live, buf);"
_FLUSH = "    const int t = threadIdx.x & 3;\n    float s[VC / 8][2];"
_EXPECT = "mbar_expect_tx(full + 8 * s, HS * HS * KB);"
_TMA = "tma_load_4d(boxes + s * HALO_BYTES, &in, full + 8 * s, 32 * c, x0 - 1, y0 - 1, b);"
_WRITE = "epi.write(b, y0 + 4 * MT8 * wgi, x0, buf);"
VARIANTS = {
    "noproducts": [("conv_wgmma.cuh", "wgmma_rs(acc[j], a[e][j + u], desc);", "{}"),
                   ("srvgg.cu", "wg::wgmma_rs(acc[j], a[j + u], desc);", "{}")],
    "nostage": [("conv_wgmma.cuh", _STAGE, _STAGE.replace("if (has)", "if (has && b < 0)")),
                ("srvgg.cu", "      epi.stage(f, buf);", "      if (b < 0) epi.stage(f, buf);")],
    "noflush": [("srvgg.cu", _FLUSH, "    if (acc[0][0] != 12345) return;\n" + _FLUSH)],
    "noload": [("srvgg.cu", _EXPECT, _EXPECT.replace("HS * HS * KB", "g < NT8 ? HS * HS * KB : 0")),
               ("srvgg.cu", _TMA, "if (g < NT8) " + _TMA)],
    "nowrite": [("srvgg.cu", _WRITE, _WRITE.replace("epi.write", "if (b < 0) epi.write"))],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="host issue time and device time per kernel of the two groups")
    ap.add_argument("--variants", nargs="*", default=[], choices=sorted(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_vgg_stages: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = MODEL_SPECS["realesr-animevideov3"].arch_config
    model = srvgg.SRVGGNet.from_state_dict(cfg, bf16_masters(
        from_jax_params(init_params(cfg, seed=0), torch.float32)), dev)
    g = np.random.default_rng(0)
    sample = torch.from_numpy(g.random((1, 128, 128, 3), dtype=np.float32))
    grp = model.fast_weights().groups[0]
    grp8 = model.fast_weights_int8(srvgg.calibrate_act_scales(model, sample)).groups[0]
    x = torch.from_numpy(g.uniform(-1, 1, (1, 540, 960, 64)).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    b, h, w, _ = x.shape
    out = torch.empty_like(x)
    q, q2 = (torch.empty(x.shape, dtype=torch.int8, device=dev) for _ in range(2))
    n = len(grp8.alpha)
    inv0, inv1 = float(grp8.aq[n + 1]), float(grp8.aq[n + 2])
    w16 = getattr(grp, "wk", grp.w)
    w8 = getattr(grp8, "wk", grp8.wq)
    libs = [_build.library()]
    lib = lambda: libs[-1]   # noqa: E731  (the build being timed)
    stream = torch.cuda.current_stream().cuda_stream

    def i8_conv(qout, o):
        return lambda: _build.check(lib().fw_vgg_i8_conv(
            q.data_ptr(), b, h, w, w8[0].data_ptr(), grp8.dq[0].data_ptr(),
            grp8.b[0].data_ptr(), grp8.alpha[0].data_ptr(), inv1, qout, o, stream),
            "fw_vgg_i8_conv")

    px = b * h * w
    macs = 9 * 64 * 64 * px
    # launch -> (call, MACs, bytes: input read once, output written once)
    outs = {"bf16_conv": out, "int8_quant": q, "int8_conv_codes": q2, "int8_conv_last": out}
    launches = {
        "bf16_conv": (lambda: _build.check(lib().fw_vgg_conv(
            x.data_ptr(), b, h, w, w16[0].data_ptr(), grp.b[0].data_ptr(),
            grp.alpha[0].data_ptr(), out.data_ptr(), stream), "fw_vgg_conv"), macs, 256 * px),
        "int8_quant": (lambda: _build.check(lib().fw_vgg_i8_quant(
            x.data_ptr(), q.data_ptr(), px, inv0, stream), "fw_vgg_i8_quant"), 0, 192 * px),
        "int8_conv_codes": (i8_conv(q2.data_ptr(), None), macs, 128 * px),
        "int8_conv_last": (i8_conv(None, out.data_ptr()), macs, 192 * px),
    }

    def outputs() -> list:
        """Every launch once, in a group's order; each one's output."""
        res = []
        for name, (fn, _, _) in launches.items():
            fn()
            torch.cuda.synchronize()
            res.append(outs[name].clone())
        return res

    want = outputs()
    ms, rates = {}, {}
    for name, (fn, mac, nbytes) in launches.items():
        ms[name] = cuda_ms(fn, args.iters)
        rates[name] = {"gop": 2 * mac / 1e9, "gbytes": nbytes / 1e9,
                       "tops": 2 * mac / ms[name] / 1e9, "tbytes_s": nbytes / ms[name] / 1e9}
    ms["bf16_group_8"] = cuda_ms(lambda: fused_srvgg.fused_conv_chain(x, out, grp), args.iters)
    ms["int8_group_8"] = cuda_ms(lambda: fused_srvgg.fused_conv_chain_int8(x, out, grp8),
                                 args.iters)
    prof = None
    if args.profile:
        prof = host_and_device_ms({
            "bf16_group_8": lambda: fused_srvgg.fused_conv_chain(x, out, grp),
            "int8_group_8": lambda: fused_srvgg.fused_conv_chain_int8(x, out, grp8)}, args.iters)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "shape": [b, h, w],
                      "ms": ms, "per_launch": rates, "profile": prof}))
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.variants:
            libs.append(patched_library(Path(tmp) / name, {"srvgg.cu"}, VARIANTS[name],
                                        ("fw_vgg",))[0])
            equal = [torch.equal(g, w) for g, w in zip(outputs(), want)]
            vms = {k: cuda_ms(fn, args.iters) for k, (fn, _, _) in launches.items()}
            print(json.dumps({"variant": name, "equal": dict(zip(launches, equal)), "ms": vms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
