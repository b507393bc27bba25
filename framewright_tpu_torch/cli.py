"""Command line of the port.

    python -m framewright_tpu_torch.cli restore IN.y4m -o OUT.y4m \\
        [--model RealESRGAN_x2plus|realesr-animevideov3|...] \\
        [--dtype bfloat16|float32|int8] \\
        [--device cuda|cpu] [--weights-dir DIR] [--max-frames N] \\
        [--project-dir DIR] [--no-checkpoint] [--no-resume] [--no-validate]

Runs on the card unless ``--device cpu`` is given. By default, as the
JAX package's default ``Config()``: the run checkpoints its progress in
``<project-dir>/checkpoints`` and a rerun of the same command resumes a
killed run; the quality gate scores every frame against the bicubic
upscale of its input and writes ``<project-dir>/qa_report.json``; a batch
that runs the card out of memory is written as bicubic copies and counted
in ``errors`` (any other failure ends the run). After a resume,
``quality`` and ``errors`` cover the frames from ``resumed_from`` on. Prints a JSON summary on success; errors print
``error: ...`` and exit 1.
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
            max_frames=args.max_frames, checkpoint_enabled=args.checkpoint,
            resume=args.resume, validate_output=args.validate)

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
        "quality": result.quality.to_dict() if result.quality is not None else None,
        "errors": result.errors,
        "resumed_from": result.resumed_from,
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
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32", "int8"),
                   help="compute dtype (float32: f32 weights and head, the "
                        "RRDB body and tail on the bf16 kernels, SRVGG's plain "
                        "f32 forward; int8: static scales calibrated on the "
                        "first batch)")
    p.add_argument("--device", default="auto", choices=("auto", "cuda", "cpu"))
    p.add_argument("--weights-dir", default=None)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--project-dir", default="./framewright_project",
                   help="checkpoints and the QA report go here")
    p.add_argument("--no-checkpoint", dest="checkpoint", action="store_false",
                   help="do not checkpoint (nor resume)")
    p.add_argument("--no-resume", dest="resume", action="store_false",
                   help="start over even if a checkpoint of this run exists")
    p.add_argument("--no-validate", dest="validate", action="store_false",
                   help="no quality gate, no per-frame stats, no QA report")
    p.set_defaults(func=cmd_restore)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
