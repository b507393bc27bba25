"""Command line of the port.

    python -m framewright_tpu_torch.cli restore IN -o OUT \\
        [--preset fast|quality|archive|ultimate] \\
        [--model RealESRGAN_x2plus|realesr-animevideov3|HAT_SRx4|DiffusionSR_x4|...] \\
        [--scale 1|2|3|4] [--tile N] [--batch N] \\
        [--ensemble M1,M2] [--ensemble-strategy weighted|median|max_sharpness] \\
        [--max-enhancement S] [--prompt P] [--style S] [--reference-dir DIR] \\
        [--dtype bfloat16|float32|int8] \\
        [--denoise] [--denoise-method auto|temporal|nafnet|restormer|bilateral] \\
        [--temporal-consistency] [--temporal-model attention|ema|latent] \\
        [--vhs] [--stabilize] [--stabilize-smoothing N] [--stabilize-crop F] \\
        [--qp-removal] [--qp-strength T] [--scene-adaptive] \\
        [--hdr none|hdr10|hdr10plus|hlg] [--auto-enhance] \\
        [--flow-model ifnet|raft] [--long-form auto|on|off] \\
        [--deduplicate] [--defect-repair] [--fill-missing-frames] \\
        [--colorize] [--colorize-method palette|eccv16|ddcolor] \\
        [--grain auto|off|preserve|remove|match] \\
        [--interpolate] [--target-fps F] \\
        [--face-restore] [--face-model gfpgan|codeformer|sr] [--face-fidelity W] \\
        [--output-format auto|y4m|png|mp4|mkv] [--codec C] [--crf N] \\
        [--encode-preset P] \\
        [--device cuda|cpu] [--weights-dir DIR] [--max-frames N] \\
        [--project-dir DIR] [--no-checkpoint] [--no-resume] [--no-validate] \\
        [--min-vmaf V] [--dry-run] [--verbose]
    python -m framewright_tpu_torch.cli extend IN [-o OUT] [--frames N] \\
        [--direction forward|backward|both] [--flow-model ifnet|raft] \\
        [--device auto|cuda|cpu]

IN and OUT are ``.y4m`` files, PNG frame directories (``frame_%06d.png``;
an OUT without a suffix is one) or, with ffmpeg on ``PATH``, mp4, mkv
and the other containers it reads and writes (``--codec``, ``--crf``,
``--encode-preset`` reach its encoder). Runs on the card unless
``--device cpu`` is given. By default, as the
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
measured once, seeded by the config's ``seed``). ``--face-restore``
restores faces after SR (``gfpgan``: ``<weights-dir>/GFPGANv1.4.npz``;
``sr``: realesr-general-x4v3 on the crop; RetinaFace finds them when
``RetinaFace_mnet025.npz`` is there, else the skin-chroma detector);
``--face-model codeformer`` restores them with CodeFormer
(``<weights-dir>/CodeFormer.npz``, or sczhou's ``CodeFormer.pth``;
``--face-fidelity`` is its w);
``--model HAT_SRx4`` runs HAT (``<weights-dir>/HAT_SRx4.npz`` or the
published ``.pth``, else seeded weights), ``BasicVSR`` and ``TVSR_x4``
the chunked video SR (chunks of 8 frames and 2 of context, dedup's
mapping bypassed); ``--ensemble`` votes extra SR models of the same scale
with ``--model``; ``--max-enhancement`` lerps the SR output toward the
bilinear upscale; ``--prompt``, ``--style`` and ``--reference-dir`` steer
the guided enhancement after SR. ``--model DiffusionSR_x4`` runs the
diffusion SR trained in this repository (8 DDIM steps). ``--vhs``, ``--stabilize``, ``--qp-removal``,
``--temporal-model latent`` and ``--scene-adaptive`` add pre-SR stages,
``--hdr`` expands the output to HDR last (``hdr10plus`` writes
``<output>.hdr10plus.json``), ``--auto-enhance`` picks stages from an
analysis of the source. ``--denoise-method restormer`` needs
``<weights-dir>/restormer.npz`` and ``--flow-model raft``
``raft-things.npz`` (or princeton-vl's ``.pth``).
``--interpolate`` raises the frame rate by a power of two with IFNet
(``<weights-dir>/rife-v4.6.npz``), from the deduplicated cadence when
``--deduplicate`` found one; ``--preset archive`` and ``ultimate`` run
RealESRGAN_x4plus with all of these and need both checkpoints. Prints a
JSON summary on success (``pre_sr`` says what the pre-SR stream did,
``post_sr`` the grain, ``duplicates_removed`` the frames SR did not run
on, ``faces_restored``, ``output_fps`` and ``interpolation``); errors
print ``error: ...`` and exit 1. Progress goes to stderr, a line a stage
(frames, percent, fps, ETA), as the JAX CLI prints it. ``--min-vmaf``
gates the sampled RGB pairs on the VMAF proxy as well (the RGB writer
path, as in JAX); ``--dry-run`` prints the plan as JSON (the probe, the
preflight's blockers and warnings, the stages that would run) and
writes nothing. ``--scale`` must be the model's scale (the port refuses
another with ``ConfigError``), ``--tile`` sets the tile side (0: the
planner decides), ``--batch`` the frames a device step (0: the planner's),
``--verbose`` logs at DEBUG. ``--fill-missing-frames`` detects dropped
frames after defect repair and inserts an IFNet midpoint for each (the
output then has more frames than the source); ``--colorize`` colourises
after inpainting with ``--colorize-method`` (``ddcolor``, the default:
``<weights-dir>/ddcolor.npz``; ``eccv16``: ``eccv16.npz``; ``palette``: no
checkpoint), keyframes propagated along IFNet flow.

``extend`` appends (``forward``), prepends (``backward``) or both
``--frames`` frames extrapolated along the boundary flow
(``FrameExtender``; ``--flow-model raft`` reads ``raft-things.npz`` from
``$FRAMEWRIGHT_WEIGHTS_DIR``) and prints JAX's JSON (output, frames,
added_before, added_after); OUT defaults to ``<stem>_extended.y4m``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional

from pathlib import Path

from framewright_tpu_torch.config import PRESETS, build_config
from framewright_tpu_torch.errors import FramewrightError


def cmd_restore(args: argparse.Namespace) -> int:
    from framewright_tpu_torch.restorer import ProgressInfo, VideoRestorer

    try:
        cfg = build_config(args.preset, {
            "project_dir": args.project_dir, "sr_model": args.model,
            "scale_factor": (args.scale_factor if args.scale_factor is not None
                             else _model_scale(args.model) if args.model else None),
            "tile_size": args.tile_size, "batch_size": args.batch_size,
            "verbose": args.verbose,
            "colorize": args.colorize, "colorize_model": args.colorize_model,
            "fill_missing_frames": args.fill_missing_frames,
            "compute_dtype": args.dtype, "device_platform": args.device,
            "weights_dir": args.weights_dir, "max_frames": args.max_frames,
            "checkpoint_enabled": args.checkpoint, "resume": args.resume,
            "validate_output": args.validate, "denoise": args.denoise,
            "denoise_model": args.denoise_model,
            "temporal_consistency": args.temporal_consistency,
            "temporal_model": args.temporal_model, "flow_model": args.flow_model,
            "long_form": args.long_form, "deduplicate": args.deduplicate,
            "defect_repair": args.defect_repair, "grain_mode": args.grain_mode,
            "interpolation": args.interpolation, "target_fps": args.target_fps,
            "face_restore": args.face_restore, "face_model": args.face_model,
            "face_fidelity": args.face_fidelity, "output_format": args.output_format,
            "codec": args.codec, "crf": args.crf, "encode_preset": args.encode_preset,
            "min_vmaf": args.min_vmaf, "dry_run": args.dry_run,
            "sr_ensemble": args.sr_ensemble, "ensemble_strategy": args.ensemble_strategy,
            "max_enhancement_strength": args.max_enhancement_strength,
            "sr_prompt": args.sr_prompt, "sr_style_preset": args.sr_style_preset,
            "reference_images_dir": args.reference_images_dir,
            "vhs_restore": args.vhs_restore, "stabilize": args.stabilize,
            "stabilize_smoothing": args.stabilize_smoothing,
            "stabilize_crop": args.stabilize_crop, "qp_removal": args.qp_removal,
            "qp_strength": args.qp_strength, "scene_adaptive": args.scene_adaptive,
            "hdr_output": args.hdr_output, "auto_enhance": args.auto_enhance})
        if cfg.verbose:
            logging.getLogger().setLevel(logging.DEBUG)
        last = {"stage": None}

        def on_progress(info: ProgressInfo) -> None:
            if info.stage != last["stage"]:
                print(f"\n[{info.stage}]", file=sys.stderr)
                last["stage"] = info.stage
            print(f"\r  {info.frames_done}/{info.total_frames} frames "
                  f"({info.percent:.1f}%)  {info.fps:.2f} fps  ETA {info.eta_s:.0f}s ",
                  end="", file=sys.stderr)

        result = VideoRestorer(cfg, on_progress).restore_video(args.source,
                                                              output=args.output)
    except FramewrightError as exc:
        print(f"\nerror: {exc}", file=sys.stderr)
        return 1
    print("", file=sys.stderr)
    if cfg.dry_run:
        print(json.dumps(result.stage_summary, indent=2))
        return 0
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
        "output_fps": result.output_fps,
        "interpolation": result.interpolation,
        "faces_restored": result.faces_restored,
    }
    if result.dedup is not None:
        summary["duplicates_removed"] = result.dedup.duplicates
    print(json.dumps(summary, indent=2))
    return 0


def cmd_extend(args: argparse.Namespace) -> int:
    """Extend a clip with frames extrapolated along its boundary flow
    (JAX ``cmd_extend``): the whole clip is read, the new frames written
    before and after it."""
    from framewright_tpu_torch.io.video import open_reader, open_writer, probe
    from framewright_tpu_torch.processors.frame_generation import FrameExtender

    try:
        meta = probe(args.source)
        with open_reader(args.source) as r:
            frames = list(r)
        if not frames:
            print("error: empty input", file=sys.stderr)
            return 1
        ext = FrameExtender(flow_backend=args.flow_model,
                            device="cuda" if args.device == "auto" else args.device)
        before = (ext.extend_backward(frames, args.frames)
                  if args.direction in ("backward", "both") else [])
        after = (ext.extend_forward(frames, args.frames)
                 if args.direction in ("forward", "both") else [])
        out = args.output or Path(args.source).with_name(
            Path(args.source).stem + "_extended.y4m")
        with open_writer(out, meta.width, meta.height, fps=meta.fps) as writer:
            for f in [*before, *frames, *after]:
                writer.write_frame(f)
    except FramewrightError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"output": str(out),
                      "frames": len(before) + len(frames) + len(after),
                      "added_before": len(before),
                      "added_after": len(after)}, indent=2))
    return 0


def _model_scale(name: str) -> int:
    from framewright_tpu_torch.models.registry import get_model

    return get_model(name).scale


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="framewright-torch",
        description="Video restoration on an NVIDIA GPU (PyTorch/CUDA port)")
    sub = parser.add_subparsers(dest="verb", required=True)
    p = sub.add_parser("restore", help="restore a clip (.y4m, a frame directory, or a "
                                       "container ffmpeg reads)")
    p.add_argument("source")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--preset", choices=sorted(PRESETS), default="",
                   help="a JAX preset's fields; the flags below override them")
    p.add_argument("--model", default=None,
                   help="a model of the registry: RRDB (RealESRGAN_x2plus, the "
                        "default, RealESRGAN_x4plus, ...), SRVGG "
                        "(realesr-animevideov3, realesr-general-x4v3, "
                        "FW_fastvgg_x2, ...), HAT_SRx4, DiffusionSR_x4, or the "
                        "video SR models BasicVSR and TVSR_x4; the scale is the "
                        "model's")
    p.add_argument("--scale", dest="scale_factor", type=int, choices=[1, 2, 3, 4],
                   help="the output scale (the model's; another raises ConfigError)")
    p.add_argument("--tile", dest="tile_size", type=int,
                   help="tile side in pixels, a multiple of 8 (0: the planner decides)")
    p.add_argument("--batch", dest="batch_size", type=int,
                   help="frames a device step (0: the planner's)")
    p.add_argument("--ensemble", dest="sr_ensemble",
                   help="comma list of extra SR models to ensemble with --model")
    p.add_argument("--ensemble-strategy", dest="ensemble_strategy",
                   choices=("weighted", "median", "max_sharpness"))
    p.add_argument("--max-enhancement", dest="max_enhancement_strength", type=float,
                   help="authenticity guard: cap enhancement blend (0-1)")
    p.add_argument("--prompt", dest="sr_prompt",
                   help="guided enhancement style prompt (e.g. 'sharp warm cinematic grain')")
    p.add_argument("--style", dest="sr_style_preset",
                   help="named style preset (natural, cinematic, anime, vintage, "
                        "documentary, portrait)")
    p.add_argument("--reference-dir", dest="reference_images_dir",
                   help="match color/grain statistics to the *.png stills in this dir")
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
                        "strength; restormer needs <weights-dir>/restormer.npz")
    p.add_argument("--temporal-consistency", action="store_true", default=None,
                   help="flicker reduction before SR")
    p.add_argument("--temporal-model", choices=("attention", "ema", "latent"),
                   help="latent: the clip-adaptive latent low-pass on the card")
    p.add_argument("--flow-model", choices=("ifnet", "raft"),
                   help="the denoiser's alignment flow net (raft: "
                        "<weights-dir>/raft-things.npz or .pth)")
    p.add_argument("--long-form", choices=("auto", "on", "off"),
                   help="global anchor drift correction for long videos")
    p.add_argument("--deduplicate", action="store_true", default=None,
                   help="SR on the unique frames only, their outputs repeated")
    p.add_argument("--defect-repair", dest="defect_repair", action="store_true",
                   default=None, help="film scratch and dust repair before SR")
    p.add_argument("--grain", dest="grain_mode",
                   choices=("auto", "off", "preserve", "remove", "match"),
                   help="post-SR film-grain handling")
    p.add_argument("--fill-missing-frames", dest="fill_missing_frames", action="store_true",
                   default=None, help="synthesize dropped frames (motion-gap detection, "
                                      "IFNet midpoints)")
    p.add_argument("--colorize", action="store_true", default=None,
                   help="colourise before SR")
    p.add_argument("--colorize-method", dest="colorize_model",
                   choices=["palette", "exemplar", "eccv16", "ddcolor"],
                   help="keyframe colouriser: ddcolor (<weights-dir>/ddcolor.npz), eccv16 "
                        "(<weights-dir>/eccv16.npz) or palette; exemplar needs the "
                        "processor API")
    p.add_argument("--vhs", dest="vhs_restore", action="store_true", default=None,
                   help="VHS artifact repair (tracking/dropouts/chroma/dot crawl)")
    p.add_argument("--stabilize", action="store_true", default=None,
                   help="full-frame stabilization (camera shake removal)")
    p.add_argument("--stabilize-smoothing", dest="stabilize_smoothing", type=int,
                   help="trajectory smoothing radius, frames")
    p.add_argument("--stabilize-crop", dest="stabilize_crop", type=float,
                   help="retained frame fraction after crop-zoom")
    p.add_argument("--qp-removal", dest="qp_removal", action="store_true", default=None,
                   help="codec deblocking/deringing")
    p.add_argument("--qp-strength", dest="qp_strength", type=float,
                   help="DCT threshold; 0 = auto from blockiness")
    p.add_argument("--scene-adaptive", dest="scene_adaptive", action="store_true",
                   default=None, help="per-scene content-aware strength modulation")
    p.add_argument("--hdr", dest="hdr_output", choices=("none", "hdr10", "hdr10plus", "hlg"),
                   help="export expanded HDR (PQ/HLG-encoded; hdr10plus adds an ST "
                        "2094-40 dynamic-metadata sidecar)")
    p.add_argument("--auto-enhance", dest="auto_enhance", action="store_true", default=None,
                   help="analyze content and toggle restoration stages")
    p.add_argument("--interpolate", dest="interpolation", action="store_true", default=None,
                   help="frame interpolation after SR (IFNet, <weights-dir>/rife-v4.6.npz)")
    p.add_argument("--target-fps", dest="target_fps", type=float,
                   help="interpolation's target rate (0: twice the source's)")
    p.add_argument("--face-restore", dest="face_restore", action="store_true", default=None,
                   help="face restoration after SR")
    p.add_argument("--face-model", dest="face_model", choices=("gfpgan", "codeformer", "sr"),
                   help="gfpgan (<weights-dir>/GFPGANv1.4.npz), codeformer "
                        "(<weights-dir>/CodeFormer.npz or .pth) or sr")
    p.add_argument("--face-fidelity", dest="face_fidelity", type=float,
                   help="codeformer fidelity weight (0 quality .. 1 fidelity)")
    p.add_argument("--output-format", dest="output_format",
                   choices=("auto", "y4m", "png", "mp4", "mkv"),
                   help="the output's format when -o is not given (png: a frame directory)")
    p.add_argument("--codec", help="the ffmpeg encoder (libx265)")
    p.add_argument("--crf", type=int, help="the ffmpeg encoder's CRF (18)")
    p.add_argument("--encode-preset", dest="encode_preset",
                   help="the ffmpeg encoder's preset (medium)")
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
    p.add_argument("--min-vmaf", dest="min_vmaf", type=float,
                   help="VMAF-proxy gate (0-100) on the sampled frame pairs; 0 = off")
    p.add_argument("--dry-run", dest="dry_run", action="store_true", default=None,
                   help="print the plan as JSON and exit: nothing is processed or written")
    p.add_argument("--verbose", "-v", action="store_true", default=None)
    p.set_defaults(func=cmd_restore)

    p = sub.add_parser("extend",
                       help="extend a clip forward/backward by motion extrapolation")
    p.add_argument("source")
    p.add_argument("-o", "--output", type=Path, default=None)
    p.add_argument("--frames", type=int, default=24,
                   help="number of frames to synthesize")
    p.add_argument("--direction", choices=["forward", "backward", "both"],
                   default="forward")
    p.add_argument("--flow-model", dest="flow_model", default="ifnet",
                   choices=["ifnet", "raft"])
    p.add_argument("--device", choices=["auto", "cuda", "cpu"], default="auto")
    p.set_defaults(func=cmd_extend)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
