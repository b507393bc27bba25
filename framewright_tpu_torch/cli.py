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
    python -m framewright_tpu_torch.cli subtitles IN [-o SRT] [--lang L] \\
        [--region bottom|top|full] [--no-ocr] [--sync SRT] [--enhance SRT] [--scale S]
    python -m framewright_tpu_torch.cli audio IN [OUT] [--separate DIR] [--dialog] \\
        [--no-denoise] [--denoise-model ai|wiener|spectral] [--no-hum] [--no-clicks] \\
        [--no-normalize] [--hum-freq F] [--device auto|cuda|cpu]
    python -m framewright_tpu_torch.cli audio-sync REF TEST [--fix OUT]
    python -m framewright_tpu_torch.cli farm run IN WORK_DIR -o OUT [--model M] \\
        [--dtype D] [--scale S] [--chunk-frames N] [--job-id J] [--timeout S] \\
        [--burst none]
    python -m framewright_tpu_torch.cli farm work WORK_DIR [--worker-id W] \\
        [--device auto|cuda|cpu]
    python -m framewright_tpu_torch.cli farm status WORK_DIR
    python -m framewright_tpu_torch.cli quick|best|archive IN [restore's flags]
    python -m framewright_tpu_torch.cli recipe NAME IN [-o OUT] [--project-dir D] [--device D]
    python -m framewright_tpu_torch.cli auto IN [-o OUT] [--project-dir D] [--device D]
    python -m framewright_tpu_torch.cli do "TEXT" [--source IN] [-o OUT] [--dry-run]
    python -m framewright_tpu_torch.cli analyze|recipes|qa-report|export-presets|wizard|
        interpolate|extract-frames|reassemble|compare|notify|completion|report|proxy ...

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

The one-word verbs ``quick``, ``best`` and ``archive`` are ``restore``
with ``--preset fast``, ``ultimate`` and ``archive``. ``recipes`` lists
the recipes, ``recipe NAME IN`` runs one (its pre-stages, then the
restore), ``auto IN`` restores with the preset and overrides the content
analysis picks, ``do "TEXT"`` with the config a phrase names
(``--dry-run`` prints it), ``wizard`` asks for one. ``analyze``,
``qa-report``, ``export-presets``, ``interpolate`` (IFNet alone,
``rife-v4.6.npz`` from ``$FRAMEWRIGHT_WEIGHTS_DIR``), ``extract-frames``,
``reassemble``, ``compare``, ``notify``, ``completion``, ``report
trends|estimate`` and ``proxy create|apply`` take the JAX CLI's
arguments and print its output; ``analyze``, ``compare`` and ``wizard``
also take ``--device`` (JAX's run on its default device), and ``report
estimate`` uses the card's figures (``reports.estimate_cost``). A first
argument that is not a verb means ``restore``. ``bench`` and ``suite``
(the benchmark, ROADMAP A4) and ``upload`` (outside services) are
refused, naming why.

``subtitles``, ``audio``, ``audio-sync`` and ``farm`` take the JAX CLI's
arguments and print its lines and JSON. ``subtitles`` writes the burnt-in
subtitle events as SRT (text when tesseract is on ``PATH``, else timing
only), or re-times (``--sync``) and cleans (``--enhance``) an existing
SRT. ``audio`` denoises a WAV (``ai``: the packaged mask net; a missing or
unreadable checkpoint is an error, where JAX falls back to Wiener),
splits it into stems (``--separate``) or runs the dialog chain; the
Wiener and mask-net stages run on ``--device``. ``farm run`` publishes a
job in WORK_DIR, waits for ``farm work`` processes (on this host or any
that shares the directory) to restore its chunks and merges them;
``--burst`` takes ``none`` only (the cloud burst reaches the network and
is not ported: anything else is a ``ConfigError``).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional

from pathlib import Path

from framewright_tpu_torch.config import PRESETS, Config, build_config, with_model_scale
from framewright_tpu_torch.errors import FramewrightError


def _config_from_args(args: argparse.Namespace) -> Config:
    """The restore's config (JAX's ``_config_from_args``): the flags that
    were given, over ``--profile``'s saved config, over the environment,
    ``--config-file`` and ``--preset``; ``--save-profile`` saves the
    result."""
    flags = {
        "project_dir": args.project_dir, "sr_model": args.model,
        "scale_factor": args.scale_factor,
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
        "hdr_output": args.hdr_output, "auto_enhance": args.auto_enhance}
    overrides = with_model_scale({k: v for k, v in flags.items() if v is not None})
    if args.profile:
        from framewright_tpu_torch.profiles import load_profile

        overrides = {**load_profile(args.profile).to_dict(), **overrides}
    cfg = build_config(args.preset, args.config_file, overrides)
    if args.save_profile:
        from framewright_tpu_torch.profiles import save_profile

        save_profile(args.save_profile, cfg)
    return cfg


def cmd_restore(args: argparse.Namespace) -> int:
    from framewright_tpu_torch.logging_utils import setup_logging
    from framewright_tpu_torch.restorer import ProgressInfo, VideoRestorer

    try:
        cfg = _config_from_args(args)
        if cfg.verbose:
            setup_logging(logging.DEBUG)
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
        ext = FrameExtender(flow_backend=args.flow_model, device=_device_arg(args.device))
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


def cmd_audio_sync(args: argparse.Namespace) -> int:
    """Detect (and with ``--fix`` correct) the offset and drift between
    two WAV tracks (JAX ``cmd_audio_sync``)."""
    from framewright_tpu_torch.audio import (
        AudioSyncAnalyzer,
        AudioSyncCorrector,
        read_wav,
        write_wav,
    )

    ref_audio, sr = read_wav(Path(args.reference))
    test_audio, sr2 = read_wav(Path(args.test))
    if sr != sr2:
        print(f"error: sample-rate mismatch {sr} vs {sr2}", file=sys.stderr)
        return 1
    rep = AudioSyncAnalyzer().analyze(ref_audio, test_audio, sr)
    out = {"offset_s": round(rep["offset_s"], 4),
           "drift_s_per_s": round(rep["drift_s_per_s"], 6),
           "windows": rep["points"]}
    if args.fix:
        fixed = AudioSyncCorrector.correct(test_audio, sr, offset_s=rep["offset_s"],
                                           drift_s_per_s=rep["drift_s_per_s"])
        write_wav(Path(args.fix), fixed, sr)
        out["fixed"] = args.fix
    print(json.dumps(out, indent=2))
    return 0


def cmd_subtitles(args: argparse.Namespace) -> int:
    """Burnt-in subtitle events to SRT (text when tesseract is on PATH),
    or ``--sync`` / ``--enhance`` an existing SRT (JAX ``cmd_subtitles``)."""
    from framewright_tpu_torch.io.video import open_reader, probe
    from framewright_tpu_torch.processors.ocr import default_ocr_fn
    from framewright_tpu_torch.processors.subtitles import (
        SubtitleEnhancer,
        SubtitleTimeSync,
        SubtitleTimingExtractor,
        export_srt,
        format_srt,
        parse_srt,
    )

    try:
        meta = probe(args.source)
        if args.sync or args.enhance:
            srt_path = Path(args.sync or args.enhance)
            track = parse_srt(srt_path.read_text())
            if args.sync:
                with open_reader(args.source) as r:
                    events = SubtitleTimingExtractor(region=args.region).analyze(iter(r))
                track = SubtitleTimeSync.sync_to_events(track, events, meta.fps)
            if args.enhance:
                track = SubtitleEnhancer.enhance(track, scale=args.scale)
            out = Path(args.output) if args.output else srt_path.with_suffix(".synced.srt")
            out.write_text(format_srt(track))
            print(f"{len(track.lines)} lines -> {out}")
            return 0
        ocr_fn = None if args.no_ocr else default_ocr_fn(lang=args.lang)
        if ocr_fn is None and not args.no_ocr:
            print("note: no OCR backend (tesseract) found; SRT will carry timing only",
                  file=sys.stderr)
        with open_reader(args.source) as r:
            events = SubtitleTimingExtractor(ocr_fn=ocr_fn, region=args.region).analyze(iter(r))
        out = Path(args.output) if args.output else Path(args.source).with_suffix(".srt")
        out.write_text(export_srt(events, meta.fps))
    except FramewrightError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(f"{len(events)} subtitle events -> {out}")
    return 0


def cmd_audio(args: argparse.Namespace) -> int:
    """Enhance a WAV (clicks, hum, denoise, loudness), or ``--separate``
    it into stems, or run the ``--dialog`` chain (JAX ``cmd_audio``)."""
    from framewright_tpu_torch.audio import AudioEnhanceConfig, AudioEnhancer
    from framewright_tpu_torch.audio_separation import (
        AudioSeparator,
        DialogEnhancer,
        SeparationConfig,
    )

    try:
        if args.separate:
            paths = AudioSeparator(SeparationConfig(device=args.device)).separate_file(
                Path(args.source), Path(args.separate))
            for name, p in paths.items():
                print(f"{name}: {p}")
            return 0
        if args.output is None:
            print("error: output path required (or use --separate DIR)", file=sys.stderr)
            return 1
        if args.dialog:
            print(str(DialogEnhancer().process_file(Path(args.source), Path(args.output))))
            return 0
        cfg = AudioEnhanceConfig(
            denoise=not args.no_denoise, denoise_model=args.denoise_model,
            hum_removal=not args.no_hum, click_removal=not args.no_clicks,
            normalize=not args.no_normalize, hum_freq=args.hum_freq, device=args.device)
        out = AudioEnhancer(cfg).process_file(Path(args.source), Path(args.output))
    except FramewrightError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(str(out))
    return 0


def cmd_farm(args: argparse.Namespace) -> int:
    """The shared-directory render farm (JAX ``cmd_farm``): ``work`` runs a
    worker, ``status`` prints the chunks and live workers, ``run``
    publishes the job, waits for the workers and merges. ``--burst``
    takes ``none`` only: the cloud burst reaches the network and is not
    ported."""
    import shutil

    from framewright_tpu_torch.errors import ConfigError
    from framewright_tpu_torch.parallel.multihost import (
        RenderJob,
        SharedDirCoordinator,
        run_coordinator,
        run_worker,
    )

    work_dir = Path(args.work_dir)
    try:
        if args.farm_cmd == "work":
            done = run_worker(work_dir, worker_id=args.worker_id or None,
                              device=None if args.device == "auto" else args.device)
            print(json.dumps({"worker_chunks_done": done}))
            return 0
        if args.farm_cmd == "status":
            coord = SharedDirCoordinator(work_dir)
            n = len(coord.load_job().chunks())
            print(json.dumps({"chunks": coord.chunk_status(n), "workers": coord.live_workers(),
                              "complete": coord.is_complete(n)}, indent=2))
            return 0
        if args.burst != "none":
            raise ConfigError(f"--burst {args.burst}: the cloud burst reaches the network "
                              "and is not ported; run workers with 'farm work' (--burst none)")
        from framewright_tpu_torch.io.video import probe

        meta = probe(Path(args.source))
        job = RenderJob(
            job_id=args.job_id, source=str(Path(args.source).resolve()),
            output=str(work_dir / "merged.y4m"),
            config={"sr_model": args.model, "compute_dtype": args.dtype,
                    "scale_factor": args.scale},
            total_frames=meta.nb_frames, chunk_frames=args.chunk_frames)
        out = run_coordinator(work_dir, job, timeout=args.timeout)
        shutil.copyfile(out, args.output)
    except FramewrightError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"output": str(args.output)}))
    return 0


def cmd_probe(args: argparse.Namespace) -> int:
    from framewright_tpu_torch.io.video import probe

    try:
        meta = probe(args.source)
    except FramewrightError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"width": meta.width, "height": meta.height, "fps": float(meta.fps),
                      "frames": meta.nb_frames, "container": meta.container,
                      "has_audio": meta.has_audio}, indent=2))
    return 0


def cmd_check(args: argparse.Namespace) -> int:
    from framewright_tpu_torch.hw import check_hardware

    print(json.dumps(check_hardware(), indent=2))
    return 0


def cmd_presets(args: argparse.Namespace) -> int:
    for name, preset in sorted(PRESETS.items()):
        print(f"{name:10s} - {preset.get('description', '')}")
    return 0


def cmd_models(args: argparse.Namespace) -> int:
    from framewright_tpu_torch.models import registry

    wdir = registry.default_weights_dir()
    if args.action == "list":
        specs = {**registry.MODEL_SPECS, **registry.AUX_SPECS}
        for name, spec in sorted(specs.items()):
            if (wdir / f"{name}.npz").exists() or (wdir / f"{name}.pth").exists():
                have = "cached"
            elif (registry.packaged_weights_dir() / f"{name}.npz").exists():
                have = "packaged"      # trained in this repository
            else:
                have = "missing"
            print(f"{name:32s} x{spec.scale}  {spec.family:8s} [{have}]")
            if args.verbose:
                print(f"    {spec.url}")
        return 0
    if args.action == "guide":
        for name, spec in sorted(registry.MODEL_SPECS.items()):
            tip = registry.MODEL_GUIDE.get(name)
            if tip:
                print(f"{name:32s} x{spec.scale}  {tip}")
        return 0
    if args.action == "port":
        src = Path(args.path) if args.path else wdir / f"{args.name}.pth"
        if not src.exists():
            print(f"error: checkpoint not found: {src}", file=sys.stderr)
            return 1
        try:
            out = registry.write_npz(registry.port_checkpoint(args.name, src),
                                     wdir / f"{args.name}.npz")
        except FramewrightError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1
        print(str(out))
        return 0
    print(f"error: models {args.action} is not ported (download needs the network; verify "
          "is ROADMAP A12b)", file=sys.stderr)
    return 1


def cmd_warmup(args: argparse.Namespace) -> int:
    """Build the kernels and the host codec and run the SR processor a
    restore of the geometry builds, one batch of each size."""
    from framewright_tpu_torch.warmup import warmup_sr

    height, width, output_color = args.height, args.width, args.output_color
    batches = [int(b) for b in args.batches.split(",")] if args.batches else None
    try:
        cfg = _config_from_args(args)
        res = warmup_sr(height, width, cfg, output_color=output_color, batches=batches,
                        progress=print)
    except FramewrightError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(f"cache: {res['cache_dir']}  plan batch: {res['plan_batch']}")
    return 0


def cmd_batch(args: argparse.Namespace) -> int:
    from framewright_tpu_torch.batch import BatchQueueProcessor
    from framewright_tpu_torch.persistence import JobStore

    store = JobStore(Path(args.db))
    q = BatchQueueProcessor(store)
    if args.action == "submit":
        print(q.submit(args.source, args.output or ""))
    elif args.action == "list":
        for job in store.list_jobs():
            print(f"{job.job_id}  {job.state:10s} {job.frames_done:6d}f  {job.source}")
    else:
        q.resume_crashed()
        print(f"processed {q.run_until_empty()} jobs")
    return 0


def cmd_watch(args: argparse.Namespace) -> int:
    from framewright_tpu_torch.batch import BatchQueueProcessor, WatchFolder
    from framewright_tpu_torch.persistence import JobStore

    q = BatchQueueProcessor(JobStore(Path(args.db)))
    wf = WatchFolder(Path(args.directory), q, poll_s=args.poll,
                     output_dir=Path(args.output_dir) if args.output_dir else None)
    print(f"watching {args.directory} (ctrl-c to stop)", file=sys.stderr)
    try:
        wf.run(max_cycles=args.cycles)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_analyze(args: argparse.Namespace) -> int:
    """Dedup and scene report of a clip (JAX ``cmd_analyze``); with
    ``--intelligence`` the per-scene content map and the adaptive settings
    of its first 20 segments (faces by RetinaFace on ``--device`` when its
    weights are there, else the skin-chroma detector)."""
    from framewright_tpu_torch.io.video import open_reader, probe
    from framewright_tpu_torch.processors.deduplication import DedupConfig, FrameDeduplicator
    from framewright_tpu_torch.processors.scene_detection import SceneDetector

    meta = probe(args.source)
    fps = float(meta.fps)
    with open_reader(args.source) as r:
        dedup = FrameDeduplicator(DedupConfig()).analyze(iter(r), target_fps=fps)
    with open_reader(args.source) as r:
        scenes = SceneDetector().analyze(iter(r))
    report = {
        "input": f"{meta.width}x{meta.height}@{fps:.2f}",
        "frames": meta.nb_frames,
        "unique_frames": dedup.unique_frames,
        "duplicate_ratio": round(dedup.dedup_ratio, 3),
        "estimated_source_fps": dedup.estimated_source_fps,
        "scenes": len(scenes.scene_ranges()),
        "scene_boundaries": scenes.boundaries[:50],
        "recommendation": {"deduplicate": dedup.dedup_ratio > 0.1,
                           "interpolate_to_fps": fps if dedup.dedup_ratio > 0.1 else 0},
    }
    if args.intelligence:
        from framewright_tpu_torch.processors.scene_intelligence import SceneIntelligence

        si = SceneIntelligence(device=_device_arg(args.device))
        with open_reader(args.source) as r:
            analyses = si.analyze_video(iter(r))
        report["scene_intelligence"] = si.get_summary(analyses)
        report["adaptive_settings"] = {
            f: s.to_dict() for f, s in list(si.generate_processing_map(analyses).items())[:20]}
    print(json.dumps(report, indent=2))
    return 0


def cmd_recipes(args: argparse.Namespace) -> int:
    from framewright_tpu_torch.recipes import RECIPES

    for name, r in sorted(RECIPES.items()):
        print(f"{name:28s} - {r.description}")
    return 0


def cmd_recipe(args: argparse.Namespace) -> int:
    """A named recipe: its pre-stages, then the restore on ``--device``."""
    from framewright_tpu_torch.recipes import RecipeExecutor, get_recipe

    ex = RecipeExecutor(get_recipe(args.name), Path(args.project_dir), device=args.device)
    result = ex.execute(args.source, output=args.output)
    print(json.dumps({"output": str(result.output_path), "frames": result.frames_out,
                      "seconds": round(result.duration_s, 1)}, indent=2))
    return 0


def cmd_auto(args: argparse.Namespace) -> int:
    """Analyze the content, let ``SmartPresetSelector`` pick the preset and
    overrides, restore (JAX ``cmd_auto``: the selector's config, the
    project directory and ``--device``; not the environment's layers)."""
    from framewright_tpu_torch.io.video import open_reader, probe
    from framewright_tpu_torch.presets import PresetRegistry, SmartPresetSelector
    from framewright_tpu_torch.processors.analysis import ContentAnalyzer
    from framewright_tpu_torch.restorer import VideoRestorer

    meta = probe(args.source)
    with open_reader(args.source) as r:
        report = ContentAnalyzer().analyze(iter(r), height=meta.height)
    print("analysis:", json.dumps(report.to_dict(), indent=2), file=sys.stderr)
    cfg = SmartPresetSelector(PresetRegistry()).select(report, meta.nb_frames)
    cfg = cfg.with_overrides(project_dir=str(args.project_dir), device_platform=args.device)
    result = VideoRestorer(cfg).restore_video(args.source, output=args.output)
    print(json.dumps({"output": str(result.output_path), "preset": cfg.preset,
                      "frames": result.frames_out}, indent=2))
    return 0


def cmd_do(args: argparse.Namespace) -> int:
    """A natural-language command (``do "restore my vhs tape.mp4"``): the
    phrase's config (``nlp.build_config_from_text``) with the project
    directory and ``--device``; ``--dry-run`` prints it."""
    from framewright_tpu_torch.nlp import build_config_from_text

    cfg, cmd = build_config_from_text(args.text, project_dir=str(args.project_dir),
                                      device_platform=args.device)
    print(cmd.describe(), file=sys.stderr)
    source = args.source or cmd.source
    if not source:
        print("error: no input file found in the command; pass --source", file=sys.stderr)
        return 1
    if args.dry_run:
        print(json.dumps(cfg.to_dict(), indent=2))
        return 0
    from framewright_tpu_torch.restorer import VideoRestorer

    result = VideoRestorer(cfg).restore_video(source, output=args.output)
    print(json.dumps({"output": str(result.output_path), "frames": result.frames_out},
                     indent=2))
    return 0


def cmd_qa_report(args: argparse.Namespace) -> int:
    from framewright_tpu_torch.reports import QAReport

    print(str(QAReport(source=args.source, output=args.output or "").save(Path(args.report))))
    return 0


def cmd_export_presets(args: argparse.Namespace) -> int:
    from framewright_tpu_torch.export import EXPORT_PRESETS

    for name, p in sorted(EXPORT_PRESETS.items()):
        print(f"{name:16s} {p.codec:12s} crf={p.crf:<3d} - {p.description}")
    return 0


def cmd_wizard(args: argparse.Namespace) -> int:
    """The setup wizard's config (``--save-profile`` saves it); with a
    source, its restore on ``--device``."""
    from framewright_tpu_torch.wizard import Wizard

    cfg = Wizard().run(project_dir=str(args.project_dir), device_platform=args.device)
    if args.save_profile:
        from framewright_tpu_torch.profiles import save_profile

        save_profile(args.save_profile, cfg)
        print(f"saved profile {args.save_profile!r}", file=sys.stderr)
    if not args.source:
        print(json.dumps(cfg.to_dict(), indent=2))
        return 0
    from framewright_tpu_torch.restorer import VideoRestorer

    result = VideoRestorer(cfg).restore_video(args.source, output=args.output)
    print(json.dumps({"output": str(result.output_path), "frames": result.frames_out},
                     indent=2))
    return 0


def cmd_interpolate(args: argparse.Namespace) -> int:
    """Frame interpolation alone (IFNet, ``rife-v4.6.npz`` where the
    restore finds it: ``$FRAMEWRIGHT_WEIGHTS_DIR``); ``--dtype`` is
    accepted and read by nothing, as in JAX (IFNet runs in f32)."""
    from framewright_tpu_torch.io.video import open_reader, open_writer, probe
    from framewright_tpu_torch.processors.interpolation import (
        FrameInterpolator,
        InterpolationConfig,
        interpolation_factor,
    )

    meta = probe(args.source)
    fps = float(meta.fps)
    target = args.target_fps or fps * args.factor
    interp = FrameInterpolator(InterpolationConfig(target_fps=target,
                                                   device=_device_arg(args.device)))
    interp.setup(meta.height, meta.width)
    factor = interpolation_factor(fps, target)
    out = args.output or Path(args.source).with_name(
        Path(args.source).stem + f"_{int(fps * factor)}fps.y4m")
    n = 0
    with open_reader(args.source) as r, \
            open_writer(out, meta.width, meta.height, fps=fps * factor) as writer:
        for frame in interp.interpolate_to_fps(iter(r), fps):
            writer.write_frame(frame)
            n += 1
    print(json.dumps({"output": str(out), "frames": n, "factor": factor, "fps": fps * factor},
                     indent=2))
    return 0


def cmd_extract_frames(args: argparse.Namespace) -> int:
    """Decode a video to a numbered PNG frame directory."""
    from framewright_tpu_torch.io.png_seq import FrameDirWriter
    from framewright_tpu_torch.io.video import open_reader, probe

    meta = probe(args.source)
    w = FrameDirWriter(Path(args.directory), fps=float(meta.fps))
    n = 0
    with open_reader(args.source) as r:
        for frame in r:
            w.write_frame(frame)
            n += 1
    w.close()
    print(json.dumps({"directory": args.directory, "frames": n, "fps": float(meta.fps)},
                     indent=2))
    return 0


def cmd_reassemble(args: argparse.Namespace) -> int:
    """Encode a frame directory back to a video."""
    from framewright_tpu_torch.io.video import open_reader, open_writer

    n = 0
    with open_reader(args.directory, fps_hint=args.fps) as r, \
            open_writer(args.output, r.width, r.height, fps=args.fps) as writer:
        for frame in r:
            writer.write_frame(frame)
            n += 1
    print(json.dumps({"output": str(args.output), "frames": n}, indent=2))
    return 0


def cmd_compare(args: argparse.Namespace) -> int:
    """PSNR (float64 on the host, as JAX's), SSIM and the VMAF proxy (on
    ``--device``) of two videos frame by frame; PSNR capped at 99 dB."""
    import numpy as np
    import torch

    from framewright_tpu_torch.hw import resolve_device
    from framewright_tpu_torch.io.video import open_reader
    from framewright_tpu_torch.ops.metrics import ssim
    from framewright_tpu_torch.quality.vmaf import VMAFProxy

    dev = resolve_device(_device_arg(args.device))
    scores = {"psnr": [], "ssim": []}
    ref_frames, dis_frames = [], []
    with open_reader(args.reference) as ra, open_reader(args.distorted) as rb:
        for i, (fa, fb) in enumerate(zip(ra, rb)):
            if i % args.sample_every:
                continue
            if fa.shape != fb.shape:
                print(f"error: frame {i} shape mismatch {fa.shape} vs {fb.shape}",
                      file=sys.stderr)
                return 1
            mse = np.mean((fa.astype(np.float64) - fb.astype(np.float64)) ** 2)
            scores["psnr"].append(float("inf") if mse <= 1e-12
                                  else float(10.0 * np.log10(255.0 * 255.0 / mse)))
            a, b = (torch.from_numpy(f).to(dev).float() / 255.0 for f in (fa, fb))
            scores["ssim"].append(float(ssim(a, b)))
            if len(ref_frames) < 32:
                ref_frames.append(fa)
                dis_frames.append(fb)
    if not scores["psnr"]:
        print("error: no comparable frames", file=sys.stderr)
        return 1
    cap = 99.0          # lossless frames score inf; the JSON stays standard
    report = {
        "frames_compared": len(scores["psnr"]),
        "psnr_mean": round(min(float(np.mean(scores["psnr"])), cap), 2),
        "psnr_min": round(min(float(np.min(scores["psnr"])), cap), 2),
        "ssim_mean": round(float(np.mean(scores["ssim"])), 4),
        "vmaf_proxy": round(VMAFProxy(dev.type).score(np.stack(ref_frames),
                                                      np.stack(dis_frames)).score, 2),
    }
    print(json.dumps(report, indent=2))
    return 0


def cmd_notify(args: argparse.Namespace) -> int:
    """Send a test notification by email (SMTP) or SMS (an HTTP gateway)."""
    from framewright_tpu_torch.uploads import EmailConfig, EmailSender, SMSSender

    if args.channel == "email":
        ok = EmailSender(EmailConfig(smtp_host=args.smtp_host, smtp_port=args.smtp_port,
                                     username=args.username, password=args.password,
                                     recipients=[args.to])).send(args.subject, args.body)
    else:
        ok = SMSSender(args.gateway, api_key=args.api_key).send(args.to, args.body)
    print(json.dumps({"sent": ok}))
    return 0 if ok else 1


def cmd_completion(args: argparse.Namespace) -> int:
    """A bash completion script over ``KNOWN_VERBS``."""
    print(_COMPLETION_BASH % " ".join(sorted(KNOWN_VERBS)))
    return 0


def cmd_report(args: argparse.Namespace) -> int:
    """``trends``: the quality-trends database's summary and history;
    ``estimate``: the wall time and cost of restoring a clip with a model
    (``reports.estimate_cost``, the card's figures)."""
    if args.report_cmd == "trends":
        from framewright_tpu_torch.reports import QualityTrends

        tr = QualityTrends(Path(args.db))
        print(json.dumps({"summary": tr.summary(), "history": tr.history(limit=args.limit)},
                         indent=2))
        tr.close()
        return 0
    from framewright_tpu_torch.io.video import probe
    from framewright_tpu_torch.models.registry import get_model
    from framewright_tpu_torch.reports import estimate_cost

    meta = probe(args.source)
    est = estimate_cost(meta.nb_frames, meta.width, meta.height,
                        model_family=get_model(args.model).family, n_chips=args.chips)
    print(json.dumps(est.to_dict(), indent=2))
    return 0


def cmd_proxy(args: argparse.Namespace) -> int:
    """``create``: a low-resolution proxy (nearest rows and columns, JAX's
    sampling) and its sidecar; ``apply``: the restore, with the flags
    given, of the proxy's original source."""
    from framewright_tpu_torch.io.video import open_reader, open_writer, probe

    if args.proxy_cmd == "create":
        import numpy as np

        meta = probe(args.source)
        ph = args.height
        pw = max(2, round(meta.width * ph / meta.height / 2) * 2)
        out = Path(args.output) if args.output else \
            Path(args.source).with_name(Path(args.source).stem + "_proxy.y4m")
        ys = np.linspace(0, meta.height - 1, ph).astype(np.int32)
        xs = np.linspace(0, meta.width - 1, pw).astype(np.int32)
        n = 0
        with open_reader(args.source) as r, \
                open_writer(out, pw, ph, fps=float(meta.fps)) as writer:
            for frame in r:
                writer.write_frame(frame[ys][:, xs])
                n += 1
        sidecar = out.with_suffix(".proxy.json")
        sidecar.write_text(json.dumps({"source": str(Path(args.source).resolve()),
                                       "proxy": str(out), "height": ph, "frames": n}))
        print(json.dumps({"proxy": str(out), "frames": n, "sidecar": str(sidecar)}, indent=2))
        return 0
    sidecar = Path(args.proxy).with_suffix(".proxy.json")
    if not sidecar.exists():
        print(f"error: no proxy sidecar {sidecar}", file=sys.stderr)
        return 1
    args.source = json.loads(sidecar.read_text())["source"]
    return cmd_restore(args)


def _device_arg(device: str) -> str:
    """``--device``: ``auto`` is the card."""
    return "cuda" if device == "auto" else device


def _add_restore_args(p: argparse.ArgumentParser, with_source: bool = True) -> None:
    """The restore verb's flags (JAX's ``_add_restore_args``), on the
    ``restore`` and ``warmup`` parsers."""
    if with_source:
        p.add_argument("source")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--preset", choices=sorted(PRESETS), default="",
                   help="a JAX preset's fields; the flags below override them")
    p.add_argument("--profile", default="", help="a named saved profile (its config "
                   "under the flags given, over the environment, file and preset)")
    p.add_argument("--save-profile", default="", help="save the resolved config as a profile")
    p.add_argument("--config-file", type=Path, default=None,
                   help="a JSON (or, with PyYAML, YAML) config file, JAX's format")
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="framewright-torch",
        description="Video restoration on an NVIDIA GPU (PyTorch/CUDA port)")
    from framewright_tpu_torch import __version__

    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="verb")
    p = sub.add_parser("restore", help="restore a clip (.y4m, a frame directory, or a "
                                       "container ffmpeg reads)")
    _add_restore_args(p)
    p.set_defaults(func=cmd_restore)

    # one-word verbs: the restore with a pinned preset (JAX's `quick`,
    # `best`, `archive`)
    for word, preset_name, blurb in (("quick", "fast", "fast 2x upscale"),
                                     ("best", "ultimate", "maximum quality, every stage on"),
                                     ("archive", "archive", "film-archive restoration defaults")):
        p = sub.add_parser(word, help=f"one-word restore ({blurb})")
        _add_restore_args(p)
        p.set_defaults(func=cmd_restore, preset=preset_name)

    p = sub.add_parser("analyze", help="content analysis (dedup/scenes)")
    p.add_argument("source")
    p.add_argument("--intelligence", action="store_true",
                   help="per-scene content map + adaptive settings")
    p.add_argument("--device", choices=["auto", "cuda", "cpu"], default="auto",
                   help="where RetinaFace runs for --intelligence (when its weights exist)")
    p.set_defaults(func=cmd_analyze)

    p = sub.add_parser("recipes", help="list restoration recipes")
    p.set_defaults(func=cmd_recipes)

    p = sub.add_parser("recipe", help="run a named recipe")
    p.add_argument("name")
    p.add_argument("source")
    p.add_argument("-o", "--output", type=Path, default=None)
    p.add_argument("--project-dir", default="./framewright_project")
    p.add_argument("--device", choices=["auto", "cuda", "cpu"], default="auto")
    p.set_defaults(func=cmd_recipe)

    p = sub.add_parser("auto", help="analyze content and auto-restore")
    p.add_argument("source")
    p.add_argument("-o", "--output", type=Path, default=None)
    p.add_argument("--project-dir", default="./framewright_project")
    p.add_argument("--device", choices=["auto", "cuda", "cpu"], default="auto")
    p.set_defaults(func=cmd_auto)

    p = sub.add_parser("do", help='natural-language command: do "restore my vhs tape.mp4"')
    p.add_argument("text")
    p.add_argument("--source", default="")
    p.add_argument("-o", "--output", type=Path, default=None)
    p.add_argument("--project-dir", default="./framewright_project")
    p.add_argument("--device", choices=["auto", "cuda", "cpu"], default="auto")
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(func=cmd_do)

    p = sub.add_parser("qa-report", help="write a QA report skeleton")
    p.add_argument("source")
    p.add_argument("--output", default="")
    p.add_argument("--report", default="qa_report.html")
    p.set_defaults(func=cmd_qa_report)

    p = sub.add_parser("export-presets", help="list encode/export presets")
    p.set_defaults(func=cmd_export_presets)

    p = sub.add_parser("wizard", help="interactive setup wizard")
    p.add_argument("source", nargs="?", default="")
    p.add_argument("-o", "--output", type=Path, default=None)
    p.add_argument("--project-dir", default="./framewright_project")
    p.add_argument("--save-profile", default="")
    p.add_argument("--device", choices=["auto", "cuda", "cpu"], default="auto")
    p.set_defaults(func=cmd_wizard)

    p = sub.add_parser("interpolate", help="standalone frame interpolation")
    p.add_argument("source")
    p.add_argument("-o", "--output", type=Path, default=None)
    p.add_argument("--factor", type=int, default=2,
                   help="multiply fps by this (ignored with --target-fps)")
    p.add_argument("--target-fps", dest="target_fps", type=float, default=0.0)
    p.add_argument("--dtype", default="float32", choices=["bfloat16", "float32"],
                   help="read by nothing, as in JAX: IFNet runs in f32")
    p.add_argument("--device", choices=["auto", "cuda", "cpu"], default="auto")
    p.set_defaults(func=cmd_interpolate)

    p = sub.add_parser("extract-frames", help="decode a video to a PNG frame directory")
    p.add_argument("source")
    p.add_argument("directory")
    p.set_defaults(func=cmd_extract_frames)

    p = sub.add_parser("reassemble", help="encode a frame directory back to video")
    p.add_argument("directory")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--fps", type=float, default=25.0)
    p.set_defaults(func=cmd_reassemble)

    p = sub.add_parser("compare", help="frame-by-frame quality comparison of two videos")
    p.add_argument("reference")
    p.add_argument("distorted")
    p.add_argument("--sample-every", type=int, default=1)
    p.add_argument("--device", choices=["auto", "cuda", "cpu"], default="auto",
                   help="where SSIM and the VMAF proxy run")
    p.set_defaults(func=cmd_compare)

    p = sub.add_parser("notify", help="send a test notification")
    p.add_argument("channel", choices=["email", "sms"])
    p.add_argument("--to", required=True)
    p.add_argument("--subject", default="[framewright] test")
    p.add_argument("--body", default="notification test")
    p.add_argument("--smtp-host", default="localhost")
    p.add_argument("--smtp-port", type=int, default=587)
    p.add_argument("--username", default="")
    p.add_argument("--password", default="")
    p.add_argument("--gateway", default="", help="SMS gateway webhook URL")
    p.add_argument("--api-key", default="")
    p.set_defaults(func=cmd_notify)

    p = sub.add_parser("completion", help="print a bash completion script")
    p.set_defaults(func=cmd_completion)

    p = sub.add_parser("report", help="quality trends / job cost estimate")
    rsub = p.add_subparsers(dest="report_cmd", required=True)
    rt = rsub.add_parser("trends", help="quality-over-time history")
    rt.add_argument("--db", default="./framewright_trends.db")
    rt.add_argument("--limit", type=int, default=20)
    re_ = rsub.add_parser("estimate", help="wall-time + cost estimate (the card's figures)")
    re_.add_argument("source")
    re_.add_argument("--model", default="RealESRGAN_x2plus")
    re_.add_argument("--chips", type=int, default=1)
    p.set_defaults(func=cmd_report)

    p = sub.add_parser("proxy", help="low-res proxy workflow")
    psub = p.add_subparsers(dest="proxy_cmd", required=True)
    pc = psub.add_parser("create", help="cut a low-res proxy + sidecar")
    pc.add_argument("source")
    pc.add_argument("-o", "--output", default="")
    pc.add_argument("--height", type=int, default=360)
    pa = psub.add_parser("apply", help="restore the ORIGINAL source of a proxy")
    pa.add_argument("proxy")
    _add_restore_args(pa, with_source=False)
    p.set_defaults(func=cmd_proxy)

    p = sub.add_parser("probe", help="show video metadata")
    p.add_argument("source")
    p.set_defaults(func=cmd_probe)

    p = sub.add_parser("check", help="hardware report")
    p.set_defaults(func=cmd_check)

    p = sub.add_parser("presets", help="list presets")
    p.set_defaults(func=cmd_presets)

    p = sub.add_parser("models", help="model zoo: list/guide/port (download and verify "
                                      "are not ported)")
    p.add_argument("action", nargs="?", choices=["list", "guide", "port", "download", "verify"],
                   default="list")
    p.add_argument("name", nargs="?", default="")
    p.add_argument("--path", default="", help="explicit .pth path for port")
    p.add_argument("--verbose", "-v", action="store_true")
    p.set_defaults(func=cmd_models)

    p = sub.add_parser("warmup", help="build the kernels and the host codec and run the SR "
                                      "path once for a geometry")
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--output-color", default="yuv420", choices=["yuv420", "rgb"],
                   help="the writer's path (yuv420 = straight to Y4M)")
    p.add_argument("--batches", default="",
                   help="comma-separated frame-batch sizes (default: planner batch + 1)")
    _add_restore_args(p, with_source=False)
    p.set_defaults(func=cmd_warmup)

    p = sub.add_parser("batch", help="batch queue: submit/list/run")
    p.add_argument("action", choices=["submit", "list", "run"])
    p.add_argument("source", nargs="?", default="")
    p.add_argument("-o", "--output", default="")
    p.add_argument("--db", default="./framewright_jobs.db")
    p.set_defaults(func=cmd_batch)

    p = sub.add_parser("watch", help="watch a folder and restore new videos")
    p.add_argument("directory")
    p.add_argument("--output-dir", default="")
    p.add_argument("--db", default="./framewright_jobs.db")
    p.add_argument("--poll", type=float, default=2.0)
    p.add_argument("--cycles", type=int, default=None)
    p.set_defaults(func=cmd_watch)

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

    p = sub.add_parser("subtitles",
                       help="extract hardcoded subtitles to .srt (OCR when tesseract is "
                            "installed; timing always)")
    p.add_argument("source")
    p.add_argument("-o", "--output", type=Path, default=None)
    p.add_argument("--lang", default="eng")
    p.add_argument("--region", choices=["bottom", "top", "full"], default="bottom",
                   help="where on the frame subtitles live")
    p.add_argument("--no-ocr", action="store_true",
                   help="timing-only SRT (skip text recognition)")
    p.add_argument("--sync", metavar="SRT", default=None,
                   help="retime an existing SRT against detected on-screen events "
                        "(drift/offset correction)")
    p.add_argument("--enhance", metavar="SRT", default=None,
                   help="clean OCR artifacts + standardize formatting of an existing SRT")
    p.add_argument("--scale", type=float, default=1.0,
                   help="position scale factor for --enhance")
    p.set_defaults(func=cmd_subtitles)

    p = sub.add_parser("audio-sync", help="detect/fix offset + drift between WAV tracks")
    p.add_argument("reference")
    p.add_argument("test")
    p.add_argument("--fix", default="", help="write corrected WAV here")
    p.set_defaults(func=cmd_audio_sync)

    p = sub.add_parser("audio", help="enhance a WAV audio file")
    p.add_argument("source")
    p.add_argument("output", nargs="?", default=None)
    p.add_argument("--separate", metavar="DIR", default=None,
                   help="split into vocals/background stems (learned band-mask + "
                        "REPET/modulation separator)")
    p.add_argument("--dialog", action="store_true",
                   help="speech clarity chain: presence EQ, de-ess, compressor, limiter")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--denoise-model", default="ai", choices=["ai", "wiener", "spectral"],
                   help="ai = learned mask net (DeepFilterNet-class, the packaged "
                        "audio_mask_v1.npz; a missing or unreadable checkpoint is an "
                        "error, not a fall back to wiener)")
    p.add_argument("--no-hum", action="store_true")
    p.add_argument("--no-clicks", action="store_true")
    p.add_argument("--no-normalize", action="store_true")
    p.add_argument("--hum-freq", type=float, default=50.0)
    p.add_argument("--device", choices=["auto", "cuda", "cpu"], default="auto",
                   help="where the Wiener and mask-net stages run")
    p.set_defaults(func=cmd_audio)
    p = sub.add_parser("farm", help="distributed render farm over a shared directory")
    fsub = p.add_subparsers(dest="farm_cmd", required=True)
    fw = fsub.add_parser("work", help="run a worker against a shared job dir")
    fw.add_argument("work_dir")
    fw.add_argument("--worker-id", default="")
    fw.add_argument("--device", choices=["auto", "cuda", "cpu"], default="auto")
    fs = fsub.add_parser("status", help="show chunk/worker status")
    fs.add_argument("work_dir")
    fs.add_argument("--device", choices=["auto", "cuda", "cpu"], default="auto")
    fr = fsub.add_parser("run", help="coordinate a farm job")
    fr.add_argument("source")
    fr.add_argument("work_dir")
    fr.add_argument("-o", "--output", required=True)
    fr.add_argument("--model", default="realesr-animevideov3")
    fr.add_argument("--dtype", default="bfloat16")
    fr.add_argument("--scale", type=int, default=4)
    fr.add_argument("--chunk-frames", type=int, default=100)
    fr.add_argument("--job-id", default="farm")
    fr.add_argument("--burst", default="none",
                    choices=["none", "local", "runpod", "vastai", "gcp-tpu"],
                    help="none only: the cloud burst is not ported (ConfigError)")
    fr.add_argument("--api-key", default="")
    fr.add_argument("--workers", type=int, default=2)
    fr.add_argument("--timeout", type=float, default=86400.0)
    fr.add_argument("--device", choices=["auto", "cuda", "cpu"], default="auto")
    p.set_defaults(func=cmd_farm)
    return parser


KNOWN_VERBS = {
    "restore", "probe", "check", "presets", "models", "analyze", "warmup", "recipes",
    "recipe", "auto", "do", "batch", "watch", "qa-report", "export-presets", "audio",
    "wizard", "farm", "subtitles", "interpolate", "extend", "extract-frames", "reassemble",
    "compare", "notify", "completion", "report", "audio-sync", "proxy",
    # one-word preset verbs
    "quick", "best", "archive",
}
# JAX's verbs the port refuses, and why
REFUSED_VERBS = {
    "bench": "bench is not ported: the port's benchmark waits for ROADMAP A4",
    "suite": "suite is not ported: the benchmark suite waits for ROADMAP A4",
    "upload": "upload is not ported: it exists to reach outside services over the "
              "network (not queued)",
}

_COMPLETION_BASH = """\
_framewright() {
  local cur prev verbs
  COMPREPLY=()
  cur="${COMP_WORDS[COMP_CWORD]}"
  verbs="%s"
  if [ "$COMP_CWORD" -eq 1 ]; then
    COMPREPLY=( $(compgen -W "$verbs" -- "$cur") )
  else
    COMPREPLY=( $(compgen -f -- "$cur") )
  fi
}
complete -F _framewright framewright
"""


def main(argv: Optional[List[str]] = None) -> int:
    """``framewright-torch VERB ...``; a first argument that is not a verb
    (a video's path) means ``restore`` (JAX's sugar)."""
    from framewright_tpu_torch.logging_utils import setup_logging

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in REFUSED_VERBS:
        print(f"error: {REFUSED_VERBS[argv[0]]}", file=sys.stderr)
        return 1
    if argv and argv[0] not in KNOWN_VERBS | {"-h", "--help", "--version"} \
            and not argv[0].startswith("-"):
        argv = ["restore"] + argv
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "verb", None):
        parser.print_help()
        return 0
    setup_logging(logging.DEBUG if getattr(args, "verbose", None) else logging.INFO)
    try:
        return args.func(args)
    except FramewrightError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # the reader of stdout went away (| head): not an error
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
