#!/usr/bin/env python3
"""Per-stage times of the port's bf16 RDB and of K1 on one GPU.

    python3 scripts/torch_rdb_stages.py [--iters N]

Builds the kernels, then times with CUDA events, at the x2plus body's
size (one 540x960 frame, seeded random weights of a one-block model):
each of the RDB's five launches through its C entry point
(framewright_tpu_torch/ops/csrc/rdb.cu), the whole RDB (fused_rdb), the
RDB on the frame's 60 halo blocks, and K1 (conv_body_skip). Prints the
card's name and power limit, then one JSON line of milliseconds. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from framewright_tpu_torch.models import rrdb  # noqa: E402
from framewright_tpu_torch.models.registry import from_jax_params, init_params  # noqa: E402
from framewright_tpu_torch.ops import _build, fused_rrdb, fused_tail3  # noqa: E402


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
    ap.add_argument("--iters", type=int, default=20)
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
    print(json.dumps({"device": torch.cuda.get_device_name(0), "shape": [b, h, w],
                      "blocks": list(wsb.shape), "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
