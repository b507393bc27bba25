#!/usr/bin/env python3
"""Where the time of a ``--preset quality`` restore, a film restore and
an archive restore goes, on one GPU.

    python3 scripts/torch_presr_times.py [--frames 12 36] [--profile]
        [--presets default quality film archive]

Restores seeded 1080p clips to 4K through ``VideoRestorer`` (the CLI's
code path; seeded random RealESRGAN_x2plus weights from an empty weights
dir) with the default config, with the ``quality`` preset (progressive
frames, a darker shot from the middle on: ``chip_smoke.clip_with_cut``)
and as ``--deduplicate --defect-repair --grain match`` ("film": 18 fps
padded to 24 with a scratch and dust, ``chip_smoke.film_clip``), and
with ``--preset archive`` ("archive": RealESRGAN_x4plus from 960x540 to
4K on ``chip_smoke.archive_clip``, with the seeded weights at published
widths that ``chip_smoke.write_archive_weights`` writes for IFNet,
GFPGANv1.4 and RetinaFace), at each clip length of ``--frames``, for the
``--presets`` asked for (default: all but archive). For each run: the wall time, the peak
device memory allocated and reserved,
and the host time spent in each part, summed over its calls, by wrapping
the part's function with a clock: in the ring's producer thread the
Y4M decode (``Y4MReader.read_frame``), the scene score
(``frame_pair_scores``), the noise profile, the uploads, the denoiser's
window (card work and its copy back, ``denoise_window``) and the
attention's (``CrossFrameAttention._filter``) and the defect repair's
(``DefectRepairer._emit``); in the main thread the dedup pass
(``_stage_dedup``), the interlace probe's decode pass
(``InterlaceDetector.analyze``), the SR's ``dispatch`` (the enqueue:
staging, upload and launches; also per call) and ``materialize`` (the
wait for the card and the pinned copy back), the gate's RGB pairs
(``QualityValidator.observe``, then their scoring in ``validate``) and
the grain (``_PostSRGrain``), the face restorer (a frame's
``restore_frame``, its detector, each crop's ``_enhance_crop``); the
interpolate stage's IFNet steps (``FrameInterpolator._mid``: upload,
card, copy back) and scene scores; the writer's thread (4:2:0 planes, or
RGB encoded on the host). The parts overlap across the threads, so they do
not add up to the wall time. A 4-frame restore first builds the kernels and
warms the card. Steady-state ms a frame is the difference of two
lengths' walls over the difference of their frames. With ``--profile``
one more quality restore at the longest length runs under
torch.profiler (slower, and left out of the steady state): the device's
busy time (the sum of its kernels' times) against that run's wall and
against the unprofiled run's. Prints the card's name and power limit, then one JSON line.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
FILM = {"deduplicate": True, "defect_repair": True, "grain_mode": "match"}


class PartClock:
    """Host ms and calls of wrapped functions, summed across threads."""

    def __init__(self):
        self.ms = collections.Counter()
        self.calls = collections.Counter()
        self._lock = threading.Lock()

    def wrap(self, owner, name: str, label: str) -> None:
        fn = getattr(owner, name)

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with self._lock:
                    self.ms[label] += (time.perf_counter() - t) * 1e3
                    self.calls[label] += 1

        setattr(owner, name, timed)

    def reset(self) -> None:
        self.ms.clear()
        self.calls.clear()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, nargs=2, default=(12, 36))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--presets", nargs="+", default=["default", "quality", "film"],
                    choices=["default", "quality", "film", "archive"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_presr_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from framewright_tpu_torch import restorer
    from framewright_tpu_torch.config import build_config
    from framewright_tpu_torch.io import y4m
    from framewright_tpu_torch.processors import film, noise_profiler, super_resolution
    from framewright_tpu_torch.processors import faces, interpolation
    from framewright_tpu_torch.processors import temporal_attention, temporal_denoise
    from framewright_tpu_torch.quality import validators
    from framewright_tpu_torch.restorer import VideoRestorer

    clock = PartClock()
    from framewright_tpu_torch.processors import format as fmt

    clock.wrap(y4m.Y4MReader, "read_frame", "producer: Y4M decode")
    clock.wrap(fmt.InterlaceDetector, "analyze", "main: interlace probe (60-frame decode)")
    clock.wrap(temporal_denoise, "frame_pair_scores", "producer: scene score")
    clock.wrap(noise_profiler.NoiseProfiler, "analyze_frames", "producer: noise profile")
    clock.wrap(temporal_denoise.TemporalDenoiser, "upload", "producer: denoiser upload")
    clock.wrap(temporal_denoise.TemporalDenoiser, "denoise_window",
               "producer: denoise a centre (card, copy back)")
    clock.wrap(temporal_attention.CrossFrameAttention, "_filter",
               "producer: attention a frame (card, copy back)")
    clock.wrap(film.DefectRepairer, "_emit", "producer: defect repair a frame")
    clock.wrap(VideoRestorer, "_stage_dedup", "main: dedup pass (decode and hash)")
    clock.wrap(super_resolution.SuperResolution, "dispatch", "main: SR dispatch (enqueue)")
    clock.wrap(super_resolution.SuperResolution, "materialize",
               "main: SR materialize (wait, copy back)")
    clock.wrap(validators.QualityValidator, "observe", "main: gate pair observe")
    clock.wrap(validators.QualityValidator, "validate", "main: gate scoring")
    clock.wrap(restorer._PostSRGrain, "__call__", "main: grain (post_fx)")
    clock.wrap(faces.FaceRestorer, "restore_frame", "main: face restore a frame")
    clock.wrap(faces.FaceDetector, "detect", "main: skin detector a frame")
    clock.wrap(faces.RetinaFaceDetector, "detect", "main: RetinaFace a frame (card, NMS)")
    clock.wrap(faces.FaceRestorer, "_enhance_crop", "main: face crop (resize, model, resize)")
    clock.wrap(interpolation.FrameInterpolator, "_mid",
               "interpolate: IFNet step (upload, card, copy back)")
    clock.wrap(interpolation, "frame_pair_scores", "interpolate: scene score a pair")
    clock.wrap(y4m.Y4MWriter, "write_yuv_frame", "writer: Y4M write 4:2:0 planes")
    clock.wrap(y4m.Y4MWriter, "write_frame", "writer: Y4M encode RGB and write")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = {"card": torch.cuda.get_device_name(0), "runs": {}}
    with tempfile.TemporaryDirectory(prefix="fw_presr_") as tmp:
        tmp = Path(tmp)
        (tmp / "nw").mkdir()
        presets = ["" if p == "default" else p for p in args.presets]
        runs = [(presets[0], 4, False)]                     # warm-up
        runs += [(p, n, False) for n in args.frames for p in presets]
        if args.profile and "quality" in presets:
            runs.append(("quality", max(args.frames), True))
        if "archive" in presets:
            chip_smoke.write_archive_weights(tmp / "aw")
        for preset, n, profile in runs:
            kind = preset if preset in ("film", "archive") else "cut"
            src = tmp / f"{kind}{n}.y4m"
            h, w = (540, 960) if kind == "archive" else (1080, 1920)
            if not src.exists():
                frames = (chip_smoke.film_clip(n, h, w, seed=47) if kind == "film"
                          else chip_smoke.archive_clip(n, h, w, seed=61) if kind == "archive"
                          else chip_smoke.clip_with_cut(n, n // 2, h, w, seed=41))
                with y4m.Y4MWriter(src, w, h, fps=24) as wr:
                    for f in frames:
                        wr.write_frame(f)
            label = f"{preset or 'default'} {n}" + (" profiled" if profile else "")
            cfg = build_config("" if preset == "film" else preset, {
                "project_dir": tmp / label.replace(" ", "_"),
                "weights_dir": tmp / ("aw" if kind == "archive" else "nw"),
                "checkpoint_enabled": False, **(FILM if preset == "film" else {})})
            prof = (torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                if profile else contextlib.nullcontext())
            clock.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            with prof:
                res = VideoRestorer(cfg).restore_video(src, tmp / f"{label}.y4m")
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
            run = {"frames": res.frames_out, "wall_s": wall, "batches": res.batches,
                   "parts_ms": dict(clock.ms), "calls": dict(clock.calls),
                   "enqueue_ms_per_dispatch": (clock.ms["main: SR dispatch (enqueue)"]
                                               / max(1, clock.calls["main: SR dispatch (enqueue)"])),
                   "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                   "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
                   "pre_sr": res.pre_sr.get("denoise", {}).get("method"),
                   "host_codec": res.pre_sr.get("host_codec"),
                   "duplicates": res.dedup.duplicates if res.dedup else None,
                   "stage_seconds": {st["name"]: st["duration_s"]
                                     for st in res.stage_summary["stages"]},
                   "faces_restored": res.faces_restored, "interpolation": res.interpolation}
            if profile:
                busy = sum(getattr(e, "self_device_time_total", 0)
                           for e in prof.key_averages()) / 1e3
                run["device_busy_ms"] = busy
                run["device_busy_share"] = busy / (wall * 1e3)
                # the same device work against the wall of the same restore
                # unprofiled (the profiler slows the host)
                run["device_busy_share_unprofiled"] = busy / (
                    out["runs"][f"{preset} {n}"]["wall_s"] * 1e3)
            out["runs"][label] = run
        n1, n2 = args.frames
        out["steady_ms_per_frame"] = {
            p: 1e3 * (out["runs"][f"{p} {n2}"]["wall_s"] - out["runs"][f"{p} {n1}"]["wall_s"])
            / (n2 - n1) for p in args.presets}
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
