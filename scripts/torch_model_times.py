"""Where the time of the models without a kernel goes, on the card:

    python3 scripts/torch_model_times.py [--models hat tvsr basicvsr restormer raft]
                                         [--iters N] [--top K]

Seeded weights at the published widths (as ``chip_smoke.py``'s models
phase draws them): HAT_SRx4 bf16 on one 960x540 frame, TVSR_x4 and
BasicVSR bf16 on a window of 10 frames of 960x540, Restormer (JAX's
``RestormerConfig()``) f32 on a 1080p frame, RAFT (iters 8) f32 on one
1080p pair, f32 without TF32 as the restore runs them. Prints, per model,
one JSON line: ms a call by CUDA events (``--iters`` calls after one
warm-up), the peak bytes, and torch.profiler's device time grouped by
kernel name, the ``--top`` largest, with the share of the call they take.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def frames(n: int, h: int, w: int, seed: int) -> torch.Tensor:
    """Smooth seeded frames in [0, 1] (a coarse grid, bilinear, panning)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((1, 3, h // 8 + 2, w // 8 + n + 2), dtype=np.float32))
    big = F.interpolate(coarse, size=(h, w + 4 * n), mode="bilinear", align_corners=False)
    big = big[0].permute(1, 2, 0)
    return torch.stack([big[:, 4 * t:4 * t + w] for t in range(n)]).clamp(0, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", nargs="+",
                    default=["hat", "tvsr", "basicvsr", "restormer", "raft"])
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_model_times: no CUDA device", file=sys.stderr)
        return 2
    from framewright_tpu_torch.hw import full_f32
    from framewright_tpu_torch.models import hat, raft, restormer, tvsr, vsr
    from framewright_tpu_torch.models.layers import tree_to_torch
    from framewright_tpu_torch.models.registry import MODEL_SPECS

    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    bf16, f32 = torch.bfloat16, torch.float32

    def case(name):
        if name == "hat":
            cfg = MODEL_SPECS["HAT_SRx4"].arch_config
            p = tree_to_torch(hat.init_params(cfg, 0), dev, bf16)
            x = frames(1, 540, 960, 1).to(dev, bf16)
            return lambda: hat.apply(p, x, cfg)
        if name in ("tvsr", "basicvsr"):
            key, mod = ("TVSR_x4", tvsr) if name == "tvsr" else ("BasicVSR", vsr)
            cfg = MODEL_SPECS[key].arch_config
            p = tree_to_torch(mod.init_params(cfg, 0), dev, bf16)
            x = frames(10, 544, 960, 2).to(dev, bf16)[None]
            return lambda: mod.apply(p, x, cfg)
        if name == "restormer":
            cfg = restormer.RestormerConfig()
            p = tree_to_torch(restormer.init_params(cfg, 81), dev, f32)
            x = frames(1, 1080, 1920, 3).to(dev)
            return lambda: restormer.apply_padded(p, x, cfg)
        cfg = raft.RAFTConfig(iters=8)
        p = tree_to_torch(raft.init_params(raft.RAFTConfig(), 82), dev, f32)
        x = frames(2, 1080, 1920, 4).to(dev)
        return lambda: raft.estimate_flow(p, x[:1], x[1:], cfg)

    for name in args.models:
        with full_f32(), torch.no_grad():
            fn = case(name)
            fn()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / args.iters
            peak = torch.cuda.max_memory_allocated() - base
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        rows = {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = ev.cuda_time_total
            if t > 0:
                rows[ev.key] = rows.get(ev.key, 0.0) + t / 1e3
        total = sum(rows.values())
        top = sorted(rows.items(), key=lambda kv: -kv[1])[: args.top]
        print(json.dumps({"model": name, "ms": ms, "peak_bytes": peak,
                          "profiled_device_ms": total,
                          "top": [{"kernel": k[:120], "ms": v, "share": v / total if total else 0}
                                  for k, v in top]}), flush=True)
        del fn
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
