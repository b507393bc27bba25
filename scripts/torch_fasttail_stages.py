#!/usr/bin/env python3
"""Per-part times of the port's band-conv RRDB tail (``FastTail``,
framewright_tpu_torch/ops/pallas_conv.py) on one GPU.

    python3 scripts/torch_fasttail_stages.py [--iters N] [--profile]

Builds the kernels, then times with CUDA events, at RealESRGAN_x2plus's
size (a 540x960 body to 2160x3840, seeded random weights of a one-block
model, seeded random features; the body output, as the merge body gives
it, the first 64 channels of a 192-channel workspace), each part of one
``FastTail`` call in its order: the body's copy to a contiguous tensor,
conv_body (band conv, no act, 540x960), the bf16 add of the skip,
the first nearest 2x copy (``_up2``), conv_up1 + lrelu (1080x1920), the
second copy, conv_up2 + lrelu and conv_hr + lrelu (2160x3840), conv_last
(64 -> 3 padded to 8, 2160x3840) and the crop to 3 channels (a view: no
device work); then the whole call. Beside each part: its GFLOP, the bytes
it must move (each input read once, each output written once) and the
rates they give. With ``--profile`` also the whole call's host issue time
and torch.profiler's device time per kernel. It uses only the package's
public names, so it runs in any tree of the port that has ``FastTail``
(copy it into an older tree to compare the two in one call). Prints the
card's name and power limit, then one JSON line. Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from torch_rdb_stages import cuda_ms, host_and_device_ms  # noqa: E402

from framewright_tpu_torch.models import rrdb  # noqa: E402
from framewright_tpu_torch.models.registry import from_jax_params, init_params  # noqa: E402
from framewright_tpu_torch.ops import pallas_conv  # noqa: E402

MAC_PER_PX = 9 * 64 * 64       # a 64 -> 64 band conv


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="host issue time and device time per kernel of the whole call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fasttail_stages: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = rrdb.RRDBConfig(num_block=1, scale=2)
    model = rrdb.RRDBNet.from_state_dict(
        cfg, from_jax_params(init_params(cfg, seed=0), torch.float32), dev)
    tail = pallas_conv.FastTail(model)
    conv, up2 = pallas_conv.band_conv3x3, pallas_conv._up2
    g = np.random.default_rng(0)
    feat, ws = (torch.from_numpy(g.uniform(-1, 1, (1, 540, 960, c)).astype(np.float32))
                .to(dev).to(torch.bfloat16) for c in (64, 192))
    body_view = ws[..., :64]
    # each part's input, as the whole call makes it
    body = body_view.contiguous()
    cb = conv(body, tail.body, act=False)
    f0 = feat + cb
    u1 = up2(f0)
    f1 = conv(u1, tail.up1)
    u2 = up2(f1)
    f2 = conv(u2, tail.up2)
    f3 = conv(f2, tail.hr)
    out = conv(f3, tail.last, act=False)
    px1, px2, px4 = (t.shape[0] * t.shape[1] * t.shape[2] for t in (body, u1, u2))
    cout = out.shape[-1]
    # part -> (call, FLOP, bytes: each input read once, each output written once)
    parts = {
        "body_copy": (lambda: body_view.contiguous(), 0, 256 * px1),
        "conv_body": (lambda: conv(body, tail.body, act=False), 2 * MAC_PER_PX * px1,
                      256 * px1),
        "add": (lambda: feat + cb, 0, 3 * 128 * px1),
        "up2_1": (lambda: up2(f0), 0, 128 * (px1 + px2)),
        "conv_up1": (lambda: conv(u1, tail.up1), 2 * MAC_PER_PX * px2, 256 * px2),
        "up2_2": (lambda: up2(f1), 0, 128 * (px2 + px4)),
        "conv_up2": (lambda: conv(u2, tail.up2), 2 * MAC_PER_PX * px4, 256 * px4),
        "conv_hr": (lambda: conv(f2, tail.hr), 2 * MAC_PER_PX * px4, 256 * px4),
        "conv_last": (lambda: conv(f3, tail.last, act=False), 2 * 9 * 64 * cout * px4,
                      (128 + 2 * cout) * px4),
        "crop": (lambda: out[..., :tail.last.cout], 0, 0),
    }
    whole_flop = sum(p[1] for p in parts.values())
    whole_bytes = 128 * 2 * px1 + 2 * 3 * px4          # feat, body in; 3 channels out
    parts["whole"] = (lambda: tail(feat, body_view), whole_flop, whole_bytes)
    n = conv.launches
    tail(feat, body_view)
    launches = conv.launches - n
    res = {}
    for name, (fn, flop, nbytes) in parts.items():
        ms = cuda_ms(fn, args.iters)
        res[name] = {"ms": ms, "gflop": flop / 1e9, "gbytes": nbytes / 1e9,
                     "tflops": flop / ms / 1e9, "tbytes_s": nbytes / ms / 1e9}
    res["sum_of_parts_ms"] = sum(v["ms"] for k, v in res.items() if k != "whole")
    prof = host_and_device_ms({"whole": lambda: tail(feat, body_view)}, args.iters) \
        if args.profile else None
    print(json.dumps({"device": torch.cuda.get_device_name(0), "shape_body": list(body.shape),
                      "band_conv_launches": launches, "ms": res, "profile": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
