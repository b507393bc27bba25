"""Command line of the port.

    python -m framewright_tpu_torch.cli restore IN.y4m -o OUT.y4m \\
        [--model RealESRGAN_x2plus|realesr-animevideov3|...] \\
        [--dtype bfloat16|int8] \\
        [--device cuda|cpu] [--weights-dir DIR] [--max-frames N] \\
        [--project-dir DIR]

Runs on the card unless ``--device cpu`` is given. Prints a JSON
summary on success; errors print ``error: ...`` and exit 1.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional

from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import FramewrightError


def cmd_restore(args: argparse.Namespace) -> int:
    from framewright_tpu_torch.restorer import VideoRestorer

    try:
        cfg = Config(
            project_dir=args.project_dir, sr_model=args.model,
            scale_factor=_model_scale(args.model), compute_dtype=args.dtype,
            device_platform=args.device, weights_dir=args.weights_dir,
            max_frames=args.max_frames)

        def progress(done: int, total: int) -> None:
            print(f"\r  {done}/{total} frames", end="", file=sys.stderr)

        result = VideoRestorer(cfg, progress).restore_video(args.source,
                                                           output=args.output)
    except FramewrightError as exc:
        print(f"\nerror: {exc}", file=sys.stderr)
        return 1
    print("", file=sys.stderr)
    print(json.dumps({
        "output": str(result.output_path),
        "frames": result.frames_out,
        "batches": result.batches,
        "batch_size": result.batch_size,
        "seconds": round(result.duration_s, 3),
        "fps": round(result.fps, 3),
    }, indent=2))
    return 0


def _model_scale(name: str) -> int:
    from framewright_tpu_torch.models.registry import get_model

    return get_model(name).scale


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="framewright-torch",
        description="Video restoration on an NVIDIA GPU (PyTorch/CUDA port)")
    sub = parser.add_subparsers(dest="verb", required=True)
    p = sub.add_parser("restore", help="restore a .y4m clip")
    p.add_argument("source")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--model", default="RealESRGAN_x2plus",
                   help="a model of the registry: RRDB (RealESRGAN_x2plus, "
                        "RealESRGAN_x4plus, ...) or SRVGG (realesr-animevideov3, "
                        "realesr-general-x4v3, FW_fastvgg_x2, ...); the scale "
                        "is the model's")
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "int8"),
                   help="compute dtype (int8: static scales calibrated on "
                        "the first batch)")
    p.add_argument("--device", default="auto", choices=("auto", "cuda", "cpu"))
    p.add_argument("--weights-dir", default=None)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--project-dir", default="./framewright_project")
    p.set_defaults(func=cmd_restore)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
