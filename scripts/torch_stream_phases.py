"""The diffusion, stream, color_gap, av_scaleout, train, surfaces,
frontends, split2d and network phases of chip_smoke.py alone on the card:

    python3 scripts/torch_stream_phases.py [--only PHASE [PHASE ...]]

(PHASE: diffusion, stream, color_gap, av_scaleout, train, surfaces,
frontends, split2d, network)

builds the kernels, then runs ``chip_smoke.diffusion_phase``,
``chip_smoke.stream_phase``, ``chip_smoke.color_gap_phase``,
``chip_smoke.av_scaleout_phase`` (without the stats phase's ms a frame,
which it only prints), ``chip_smoke.train_phase``,
``chip_smoke.surfaces_phase``, ``chip_smoke.frontends_phase``,
``chip_smoke.split2d_phase`` and ``chip_smoke.network_phase`` with the launch counters, the CLI runner and
the kernel path as ``chip_smoke.main`` builds them; prints the phases'
JSON lines, each peak against the planner's count, and ``{"ok": ...}``
last (exit 1 when a check failed)."""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from torch_models_phase import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="+", choices=("diffusion", "stream", "color_gap",
                                                  "av_scaleout", "train", "surfaces",
                                                  "frontends", "split2d", "network"),
                    default=None)
    args = ap.parse_args(argv)
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print("torch_stream_phases: no CUDA device", file=sys.stderr)
        return 2
    dev, x = harness()
    ok = True
    with tempfile.TemporaryDirectory(prefix="fw_stream_") as tmp:
        tmp = Path(tmp)
        x["nw"] = str(tmp / "no_weights")
        try:
            if args.only is None or "diffusion" in args.only:
                cs.diffusion_phase(tmp, dev, x)
            if args.only is None or "stream" in args.only:
                cs.stream_phase(tmp, dev, x)
            if args.only is None or "color_gap" in args.only:
                cs.color_gap_phase(tmp, dev, x)
            if args.only is None or "av_scaleout" in args.only:
                cs.av_scaleout_phase(tmp, dev, x)
            if args.only is None or "train" in args.only:
                cs.train_phase(tmp, dev, x)
            if args.only is None or "surfaces" in args.only:
                cs.surfaces_phase(tmp, dev, x)
            if args.only is None or "frontends" in args.only:
                cs.frontends_phase(tmp, dev, x)
            if args.only is None or "split2d" in args.only:
                cs.split2d_phase(tmp, dev, x)
            if args.only is None or "network" in args.only:
                cs.network_phase(tmp, dev, x)
        except cs.SmokeFailure as exc:
            ok = False
            print(f"torch_stream_phases: FAILED: {exc}", file=sys.stderr)
        for key, peak, plan in x["plan_checks"]:
            cs.emit({"plan_check": key, "peak": peak, "plan": plan, "ok": peak <= plan})
            ok = ok and peak <= plan
    print(json.dumps({"ok": ok, "seconds": time.perf_counter() - t_all}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
