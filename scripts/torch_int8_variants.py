#!/usr/bin/env python3
"""Per-launch times of variant builds of the int8 RDB kernels, on one GPU.

    python3 scripts/torch_int8_variants.py [VARIANT ...] [--iters N]

Each variant is a list of text replacements applied to a copy of
framewright_tpu_torch/ops/csrc (the package's sources stay as they are);
the int8 RDB sources are built from the copy and every launch of the i32,
f32acc and dynamic RDBs is timed with CUDA events at the x2plus body's size
(one 540x960 frame, seeded random weights of a one-block model, static
ranges calibrated on a seeded image), after one run whose codes, output and
ranges are compared with the plain versions ("ok"). Variants:

    base      the sources as they are
    lag       consumer warpgroup 1 starts 1 us after consumer 0
    nostage   no epilogue stage() (wrong outputs: its cost, by difference)
    wait2     two wgmma groups in flight instead of one (release a step
              later)
    defer5    stage 5's writes deferred into the next tile's chunks

Prints the card's name and power limit, then per variant the build's
spilling ptxas lines and one line of milliseconds per scheme. Exits
non-zero without a CUDA device.
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from framewright_tpu_torch.models import rrdb  # noqa: E402
from framewright_tpu_torch.models.registry import from_jax_params, init_params  # noqa: E402
from framewright_tpu_torch.ops import _build, fused_rrdb  # noqa: E402

sys.path.insert(0, str(ROOT / "scripts"))
from torch_rdb_stages import patched_library  # noqa: E402

_STAGE = "        if (has) epi.stage(acc, part, b, y0, x0, live, buf);"
_PART = "    typename EpiTraits<Epi>::Part part{};"
_FINAL = "  static constexpr int RUNS = NC / 8, SLICES = NC / 16;\n  static constexpr bool DEFER = false;"
VARIANTS = {
    "base": [],
    "lag": [("conv_wgmma.cuh", _PART, _PART + "\n    if (wgi == 1) __nanosleep(1000);")],
    "nostage": [("conv_wgmma.cuh", _STAGE, _STAGE.replace("if (has)", "if (has && b < 0)"))],
    "wait2": [("conv_wgmma.cuh", "          wgmma_wait<1>();\n          if (v == 0) release(it);",
               "          wgmma_wait<2>();\n          if (v == 1) release(it);")],
    "defer5": [("rdb_int8.cuh", _FINAL, _FINAL.replace("DEFER = false", "DEFER = true"))],
}
KEEP = {"rdb_int8.cu", "rdb_dyn.cu"}


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=["base"], choices=sorted(VARIANTS))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_int8_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
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
    amx = torch.zeros(b, 5, device=dev)
    act = torch.empty(b, h, w, 32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    w8 = {s: model.fast_weights_int8(amax, s).body[0][0] for s in ("i32", "f32acc")}
    wd = model.fast_weights_int8(None).body[0][0]
    ref = {}
    for s, wts in w8.items():
        qp, op = torch.zeros_like(q), torch.empty_like(feat)
        fused_rrdb.fused_rdb_int8_plain(feat, qp, op, wts)
        ref[s] = (qp, op, None)
    qp, op = torch.zeros_like(q), torch.empty_like(feat)
    ref["dynamic"] = (qp, op, fused_rrdb.fused_rdb_dynamic_plain(feat, qp, op, wd))

    def launches(lib) -> dict:
        """scheme -> [(name, launch)] in the RDB's order."""
        out_l = {}
        for s, wts in w8.items():
            f = int(s != "i32")
            inv = [float(x) for x in wts.act_q[5:]]
            calls = [("quant", lambda inv=inv: lib.fw_rdb_i8_quant(
                feat.data_ptr(), q.data_ptr(), b * h * w, inv[0], stream))]
            for k in range(4):
                calls.append((f"stage{k + 1}", lambda k=k, wts=wts, f=f, inv=inv: lib.fw_rdb_i8_dense(
                    q.data_ptr(), b, h, w, 64 + 32 * k, wts.wk[k].data_ptr(),
                    wts.scale[k].data_ptr(), wts.bias[k].data_ptr(), inv[k + 1], f, None,
                    stream)))
            calls.append(("stage5", lambda wts=wts, f=f: lib.fw_rdb_i8_final(
                q.data_ptr(), b, h, w, wts.wk[4].data_ptr(), wts.scale[4].data_ptr(),
                wts.bias[4].data_ptr(), f, feat.data_ptr(), out.data_ptr(), None, None, stream)))
            out_l[s] = calls
        calls = [("absmax", lambda: lib.fw_rdb_dyn_absmax(
                     feat.data_ptr(), b, h * w, amx.data_ptr(), stream)),
                 ("quant_x", lambda: lib.fw_rdb_dyn_quant(
                     feat.data_ptr(), 0, 64, q.data_ptr(), 0, b, h * w, amx.data_ptr(), 0,
                     stream))]
        for k in range(4):
            calls.append((f"stage{k + 1}", lambda k=k: lib.fw_rdb_dyn_dense(
                q.data_ptr(), b, h, w, 64 + 32 * k, wd.wk[k].data_ptr(), wd.scale[k].data_ptr(),
                wd.bias[k].data_ptr(), amx.data_ptr(), act.data_ptr(), None, 1, 0, stream)))
            calls.append((f"quant{k + 1}", lambda k=k: lib.fw_rdb_dyn_quant(
                act.data_ptr(), 1, 32, q.data_ptr(), 64 + 32 * k, b, h * w, amx.data_ptr(),
                k + 1, stream)))
        calls.append(("stage5", lambda: lib.fw_rdb_dyn_final(
            q.data_ptr(), b, h, w, wd.wk[4].data_ptr(), wd.scale[4].data_ptr(),
            wd.bias[4].data_ptr(), amx.data_ptr(), feat.data_ptr(), out.data_ptr(), None, None,
            1, stream)))
        out_l["dynamic"] = calls
        return out_l

    with tempfile.TemporaryDirectory() as tmp:
        for name in args.variants:
            lib, spills = patched_library(Path(tmp) / name, KEEP, VARIANTS[name],
                                          ("fw_rdb_i8", "fw_rdb_dyn"))
            print(name, "spills:", spills)
            for s, calls in launches(lib).items():
                q.zero_()
                amx.zero_()
                for _, fn in calls:
                    _build.check(fn(), s)
                torch.cuda.synchronize()
                qr, orf, ar = ref[s]
                ok = torch.equal(q, qr) and torch.equal(out, orf) and (
                    ar is None or torch.equal(amx, ar))
                ms = {n: cuda_ms(fn, args.iters) for n, fn in calls}
                print(" ", s, json.dumps({"ok": ok, "rdb": round(sum(ms.values()), 4),
                                          **{n: round(t, 4) for n, t in ms.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
