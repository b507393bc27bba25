#!/usr/bin/env python3
"""Per-stage times of the port's RDBs (bf16 and int8) and of K1 on one GPU.

    python3 scripts/torch_rdb_stages.py [--iters N] [--profile]

Builds the kernels, then times with CUDA events, at the x2plus body's
size (one 540x960 frame, seeded random weights of a one-block model):
each of the bf16 RDB's five launches through its C entry point
(framewright_tpu_torch/ops/csrc/rdb.cu), the whole RDB (fused_rdb), the
RDB on the frame's 60 halo blocks, and K1 (conv_body_skip); then the
int8 RDBs: the six launches of the static schemes i32 and f32acc
(csrc/rdb_int8.cu: the codes of x, four dense stages, stage 5) and the
eleven of the dynamic one (csrc/rdb_dyn.cu: max|x|, the codes of x, four
dense stages each followed by its quantization, stage 5), each whole
RDB, and the dynamic RDB on the 60 blocks. With ``--profile`` also, for
each whole RDB and the halo refresh, the host's time to issue one call
(no synchronisation) and torch.profiler's device time per kernel: a call
whose host time exceeds its device time is timed at the host's pace by
CUDA events. Prints the card's name and power limit, then one JSON line
of milliseconds. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from framewright_tpu_torch.models import rrdb  # noqa: E402
from framewright_tpu_torch.models.registry import from_jax_params, init_params  # noqa: E402
from framewright_tpu_torch.ops import _build, fused_rrdb, fused_tail3  # noqa: E402


def patched_library(tmp: Path, keep, patches, prefixes) -> tuple:
    """The sources ``keep`` (file names of framewright_tpu_torch/ops/csrc)
    built from a copy of csrc in ``tmp`` with ``patches`` applied, (file,
    old, new) text replacements, each ``old`` found once (the package's
    sources stay as they are): the loaded library, with the launchers whose
    names start with ``prefixes`` typed, and ptxas's lines about spills."""
    csrc = tmp / "csrc"
    shutil.copytree(Path(_build.__file__).resolve().parent / "csrc", csrc)
    for f in csrc.glob("*.cu"):
        if f.name not in keep:
            f.unlink()
    for fname, old, new in patches:
        f = csrc / fname
        s = f.read_text()
        if s.count(old) != 1:
            raise SystemExit(f"{fname} changed, no unique {old!r}")
        f.write_text(s.replace(old, new))
    _build.CSRC, _build.BUILD_ROOT = csrc, tmp / "build"
    info = _build.build(verbose=False)
    lib = ctypes.CDLL(str(info.path))
    for k, v in _build._SIGNATURES.items():
        if k.startswith(tuple(prefixes)):
            getattr(lib, k).argtypes = v
    return lib, [ln for ln in info.ptxas if "spill" in ln and " 0 bytes spill stores" not in ln]


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


def host_and_device_ms(fns: dict, reps: int) -> dict:
    """For each call: the host's ms to issue it (mean of ``reps``, the
    queue empty first, no synchronisation inside), and the device ms per
    call of each kernel it launches (torch.profiler, summed by name)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            if t > 0:   # names cut to 90 characters: instances that share them add up
                dev[e.key[:90]] = dev.get(e.key[:90], 0.0) + t / reps / 1e3
        out[label] = {"host_ms": host, "device_ms": dev, "device_sum_ms": sum(dev.values())}
    return out


def _kernel_w(wts, k: int) -> torch.Tensor:
    """Conv k's weights as the int8 kernels take them: the chunk-major copy
    ``wk`` (trees without it, before the s8 wgmma loop, took the OHWI ``w``)."""
    return (wts.wk if hasattr(wts, "wk") else wts.w)[k]


def int8_stages(model, feat: torch.Tensor, ext, iters: int) -> dict:
    """Each launch of the int8 RDBs through its C entry point, and the whole
    RDBs, on the first RDB of ``model`` with static scales calibrated on a
    seeded image (i32, f32acc) and with dynamic scales."""
    dev = feat.device
    g = np.random.default_rng(1)
    img = torch.from_numpy(g.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32))
    amax = rrdb.calibrate_act_scales(model, img)
    b, h, w, _ = feat.shape
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    q = torch.zeros(b, h, w, 192, dtype=torch.int8, device=dev)
    out = torch.empty_like(feat)
    ms = {}
    for scheme in ("i32", "f32acc"):
        wts = model.fast_weights_int8(amax, scheme).body[0][0]
        f32acc = int(scheme != "i32")
        inv = [float(v) for v in wts.act_q[5:]]
        fused_rrdb.fused_rdb_int8(feat, q, out, wts)      # codes in q for the stages
        ms[f"{scheme}_quant"] = cuda_ms(lambda: _build.check(lib.fw_rdb_i8_quant(
            feat.data_ptr(), q.data_ptr(), b * h * w, inv[0], stream), "fw_rdb_i8_quant"), iters)
        for k in range(4):
            ms[f"{scheme}_stage{k + 1}"] = cuda_ms(lambda k=k: _build.check(lib.fw_rdb_i8_dense(
                q.data_ptr(), b, h, w, 64 + 32 * k, _kernel_w(wts, k).data_ptr(),
                wts.scale[k].data_ptr(), wts.bias[k].data_ptr(), inv[k + 1], f32acc, None,
                stream), "fw_rdb_i8_dense"), iters)
        ms[f"{scheme}_stage5"] = cuda_ms(lambda: _build.check(lib.fw_rdb_i8_final(
            q.data_ptr(), b, h, w, _kernel_w(wts, 4).data_ptr(), wts.scale[4].data_ptr(),
            wts.bias[4].data_ptr(), f32acc, feat.data_ptr(), out.data_ptr(), None, None,
            stream), "fw_rdb_i8_final"), iters)
        ms[f"{scheme}_rdb"] = cuda_ms(lambda: fused_rrdb.fused_rdb_int8(feat, q, out, wts), iters)
    wts = model.fast_weights_int8(None).body[0][0]
    amx = torch.zeros(b, 5, dtype=torch.float32, device=dev)
    act = torch.empty(b, h, w, 32, dtype=torch.float32, device=dev)
    fused_rrdb.fused_rdb_dynamic(feat, q, out, wts)
    ms["dyn_absmax"] = cuda_ms(lambda: _build.check(lib.fw_rdb_dyn_absmax(
        feat.data_ptr(), b, h * w, amx.data_ptr(), stream), "fw_rdb_dyn_absmax"), iters)
    ms["dyn_quant_x"] = cuda_ms(lambda: _build.check(lib.fw_rdb_dyn_quant(
        feat.data_ptr(), 0, 64, q.data_ptr(), 0, b, h * w, amx.data_ptr(), 0, stream),
        "fw_rdb_dyn_quant"), iters)
    for k in range(4):
        cin = 64 + 32 * k
        ms[f"dyn_stage{k + 1}"] = cuda_ms(lambda k=k, cin=cin: _build.check(lib.fw_rdb_dyn_dense(
            q.data_ptr(), b, h, w, cin, _kernel_w(wts, k).data_ptr(), wts.scale[k].data_ptr(),
            wts.bias[k].data_ptr(), amx.data_ptr(), act.data_ptr(), None, 1, 0, stream),
            "fw_rdb_dyn_dense"), iters)
        ms[f"dyn_quant{k + 1}"] = cuda_ms(lambda k=k, cin=cin: _build.check(lib.fw_rdb_dyn_quant(
            act.data_ptr(), 1, 32, q.data_ptr(), cin, b, h * w, amx.data_ptr(), k + 1, stream),
            "fw_rdb_dyn_quant"), iters)
    ms["dyn_stage5"] = cuda_ms(lambda: _build.check(lib.fw_rdb_dyn_final(
        q.data_ptr(), b, h, w, _kernel_w(wts, 4).data_ptr(), wts.scale[4].data_ptr(),
        wts.bias[4].data_ptr(), amx.data_ptr(), feat.data_ptr(), out.data_ptr(), None, None, 1,
        stream), "fw_rdb_dyn_final"), iters)
    ms["dyn_rdb"] = cuda_ms(lambda: fused_rrdb.fused_rdb_dynamic(feat, q, out, wts), iters)
    x_blk = fused_rrdb.extract_blocks(feat)
    q_blk = torch.zeros(*x_blk.shape[:3], 192, dtype=torch.int8, device=dev)
    o_blk = torch.empty_like(x_blk)
    ms["dyn_rdb_blocks"] = cuda_ms(
        lambda: fused_rrdb.fused_rdb_dynamic(x_blk, q_blk, o_blk, wts, ext=ext), iters)
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="host issue time and device time per kernel of each whole RDB")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_rdb_stages: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = rrdb.RRDBConfig(num_block=1, scale=2)
    model = rrdb.RRDBNet.from_state_dict(
        cfg, from_jax_params(init_params(cfg, seed=0), torch.float32), dev)
    fw = model.fast_weights()
    wts = fw.body[0][0]
    g = np.random.default_rng(0)
    feat = torch.from_numpy(g.uniform(-1, 1, (1, 540, 960, 64)).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    ws = fused_rrdb.new_workspace(feat)
    dst = torch.empty_like(ws)
    b, h, w, _ = ws.shape
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    ms = {}
    for k in range(4):
        ms[f"stage{k + 1}"] = cuda_ms(lambda k=k: _build.check(lib.fw_rdb_dense(
            ws.data_ptr(), b, h, w, 64 + 32 * k, wts.wk[k].data_ptr(), wts.b[k].data_ptr(),
            None, stream), "fw_rdb_dense"), args.iters)
    ms["stage5"] = cuda_ms(lambda: _build.check(lib.fw_rdb_final(
        ws.data_ptr(), b, h, w, wts.wk[4].data_ptr(), wts.b[4].data_ptr(), dst.data_ptr(),
        None, None, stream), "fw_rdb_final"), args.iters)
    ms["rdb"] = cuda_ms(lambda: fused_rrdb.fused_rdb(ws, dst, wts), args.iters)
    ext = fused_rrdb.BlockExtents.of(b, h, w, dev)
    wsb = fused_rrdb.new_workspace(fused_rrdb.extract_blocks(feat))
    dstb = torch.empty_like(wsb)
    ms["rdb_blocks"] = cuda_ms(lambda: fused_rrdb.fused_rdb(wsb, dstb, wts, ext=ext),
                               args.iters)
    ms["k1"] = cuda_ms(lambda: fused_tail3.conv_body_skip(ws, feat, fw.cbody), args.iters)
    ms.update(int8_stages(model, feat, ext, args.iters))
    prof = None
    if args.profile:
        g8 = np.random.default_rng(1)
        amax = rrdb.calibrate_act_scales(model, torch.from_numpy(
            g8.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)))
        q = torch.zeros(b, h, w, 192, dtype=torch.int8, device=dev)
        out = torch.empty_like(feat)
        w8 = {s: model.fast_weights_int8(amax, s).body[0][0] for s in ("i32", "f32acc")}
        wd = model.fast_weights_int8(None).body[0][0]
        prof = host_and_device_ms({
            "rdb": lambda: fused_rrdb.fused_rdb(ws, dst, wts),
            "i32_rdb": lambda: fused_rrdb.fused_rdb_int8(feat, q, out, w8["i32"]),
            "f32acc_rdb": lambda: fused_rrdb.fused_rdb_int8(feat, q, out, w8["f32acc"]),
            "dyn_rdb": lambda: fused_rrdb.fused_rdb_dynamic(feat, q, out, wd),
            "halo_refresh": lambda: fused_rrdb.halo_refresh(wsb, b, *fused_rrdb.grid_dims(h, w))},
            args.iters)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "shape": [b, h, w],
                      "blocks": list(wsb.shape), "ms": ms, "profile": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
