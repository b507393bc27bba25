"""Command line of the port.

    python -m framewright_tpu_torch.cli restore IN.y4m -o OUT.y4m \\
        [--preset fast|quality] \\
        [--model RealESRGAN_x2plus|realesr-animevideov3|...] \\
        [--dtype bfloat16|float32|int8] \\
        [--denoise] [--denoise-method auto|temporal|nafnet|bilateral] \\
        [--temporal-consistency] [--temporal-model attention|ema] \\
        [--flow-model ifnet] [--long-form auto|on|off] \\
        [--deduplicate] [--defect-repair] \\
        [--grain auto|off|preserve|remove|match] \\
        [--device cuda|cpu] [--weights-dir DIR] [--max-frames N] \\
        [--project-dir DIR] [--no-checkpoint] [--no-resume] [--no-validate]

Runs on the card unless ``--device cpu`` is given. By default, as the
JAX package's default ``Config()``: the run checkpoints its progress in
``<project-dir>/checkpoints`` and a rerun of the same command resumes a
killed run; the quality gate scores every frame against the bicubic
upscale of its input and writes ``<project-dir>/qa_report.json``; a batch
that runs the card out of memory is written as bicubic copies and counted
in ``errors`` (any other failure ends the run). After a resume,
``quality`` and ``errors`` cover the frames from ``resumed_from`` on.
``--preset`` takes a JAX preset's fields (``quality``: RealESRGAN_x2plus
after the auto-profiled temporal denoiser and cross-frame attention;
``fast``: FW_fastvgg_x2); flags override it, as in the JAX CLI.
``--deduplicate`` runs SR on the unique frames only and repeats their
outputs, ``--defect-repair`` repairs scratches and dust before SR,
``--grain`` handles film grain after SR (match: the source's level,
measured once, seeded by the config's ``seed``). Prints a JSON summary on
success (``pre_sr`` says what the pre-SR stream did, ``post_sr`` the
grain, ``duplicates_removed`` the frames SR did not run on); errors print
``error: ...`` and exit 1.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional

from framewright_tpu_torch.config import PRESETS, build_config
from framewright_tpu_torch.errors import FramewrightError


def cmd_restore(args: argparse.Namespace) -> int:
    from framewright_tpu_torch.restorer import VideoRestorer

    try:
        cfg = build_config(args.preset, {
            "project_dir": args.project_dir, "sr_model": args.model,
            "scale_factor": _model_scale(args.model) if args.model else None,
            "compute_dtype": args.dtype, "device_platform": args.device,
            "weights_dir": args.weights_dir, "max_frames": args.max_frames,
            "checkpoint_enabled": args.checkpoint, "resume": args.resume,
            "validate_output": args.validate, "denoise": args.denoise,
            "denoise_model": args.denoise_model,
            "temporal_consistency": args.temporal_consistency,
            "temporal_model": args.temporal_model, "flow_model": args.flow_model,
            "long_form": args.long_form, "deduplicate": args.deduplicate,
            "defect_repair": args.defect_repair, "grain_mode": args.grain_mode})

        def progress(done: int, total: int) -> None:
            print(f"\r  {done}/{total} frames", end="", file=sys.stderr)

        result = VideoRestorer(cfg, progress).restore_video(args.source,
                                                           output=args.output)
    except FramewrightError as exc:
        print(f"\nerror: {exc}", file=sys.stderr)
        return 1
    print("", file=sys.stderr)
    summary = {
        "output": str(result.output_path),
        "frames": result.frames_out,
        "batches": result.batches,
        "batch_size": result.batch_size,
        "seconds": round(result.duration_s, 3),
        "fps": round(result.fps, 3),
        "quality": result.quality.to_dict() if result.quality is not None else None,
        "errors": result.errors,
        "resumed_from": result.resumed_from,
        "pre_sr": result.pre_sr,
        "post_sr": result.post_sr,
    }
    if result.dedup is not None:
        summary["duplicates_removed"] = result.dedup.duplicates
    print(json.dumps(summary, indent=2))
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
    p.add_argument("--preset", choices=sorted(PRESETS), default="",
                   help="a JAX preset's fields; the flags below override them")
    p.add_argument("--model", default=None,
                   help="a model of the registry: RRDB (RealESRGAN_x2plus, the "
                        "default, RealESRGAN_x4plus, ...) or SRVGG "
                        "(realesr-animevideov3, realesr-general-x4v3, "
                        "FW_fastvgg_x2, ...); the scale is the model's")
    p.add_argument("--dtype", default=None, choices=("bfloat16", "float32", "int8"),
                   help="compute dtype (float32: f32 weights and head, the "
                        "RRDB body and tail on the bf16 kernels, SRVGG's plain "
                        "f32 forward; int8: static scales calibrated on the "
                        "first batch)")
    p.add_argument("--denoise", action="store_true", default=None,
                   help="the temporal denoiser before SR")
    p.add_argument("--denoise-method", dest="denoise_model",
                   choices=("auto", "temporal", "nafnet", "restormer", "bilateral"),
                   help="auto profiles the noise and picks the method and "
                        "strength (restormer is not ported yet)")
    p.add_argument("--temporal-consistency", action="store_true", default=None,
                   help="flicker reduction before SR")
    p.add_argument("--temporal-model", choices=("attention", "ema"))
    p.add_argument("--flow-model", choices=("ifnet", "raft"),
                   help="the denoiser's alignment flow net (raft is not ported yet)")
    p.add_argument("--long-form", choices=("auto", "on", "off"),
                   help="global anchor drift correction for long videos")
    p.add_argument("--deduplicate", action="store_true", default=None,
                   help="SR on the unique frames only, their outputs repeated")
    p.add_argument("--defect-repair", dest="defect_repair", action="store_true",
                   default=None, help="film scratch and dust repair before SR")
    p.add_argument("--grain", dest="grain_mode",
                   choices=("auto", "off", "preserve", "remove", "match"),
                   help="post-SR film-grain handling")
    p.add_argument("--device", default=None, choices=("auto", "cuda", "cpu"))
    p.add_argument("--weights-dir", default=None)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--project-dir", default=None,
                   help="checkpoints and the QA report go here "
                        "(./framewright_project)")
    p.add_argument("--no-checkpoint", dest="checkpoint", action="store_false", default=None,
                   help="do not checkpoint (nor resume)")
    p.add_argument("--no-resume", dest="resume", action="store_false", default=None,
                   help="start over even if a checkpoint of this run exists")
    p.add_argument("--no-validate", dest="validate", action="store_false", default=None,
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
