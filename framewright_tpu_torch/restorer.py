"""Restore a Y4M clip: decode -> super-resolution -> encode, with the
work the JAX default ``Config()`` does on every restore.

The port of the ``framewright_tpu.restorer.VideoRestorer`` path that a
default ``restore`` takes, as stage methods with the JAX names run in
order (the JAX package runs them under its DAG engine, which is not
ported): ``_stage_probe``; ``_stage_checkpoint`` (the source's checkpoint,
discarded when the config changed); ``_stage_enhance`` (``PrefetchRing``,
one batch in flight on the card, ``WriterDrain``; the YUV-direct writer
path whenever the output is 4:2:0 Y4M with even sides, for either model
family, else uint8 RGB; resume, checkpoint progress, the runtime budget,
bicubic copies of a batch that failed with a ``TransientError`` under
``continue_on_error``, and the quality gate's per-frame scores from the
SR pass); ``_stage_validate``
(the gate); ``_stage_finalize`` (the checkpoint removed). The QA report
is written to ``project_dir / "qa_report.<fmt>"``.

Resume cuts the output to R = min(the checkpoint's count, the whole
frames in the file), rounded down to a whole batch, and restarts the
input at frame R. The JAX
restorer appends after min(checkpoint, frames counted), which duplicates
the frames written after the last checkpoint save and counts a frame cut
short by a kill as whole (ROADMAP.md, "JAX faults the port must not
copy").
A resumed run's quality report and ``errors`` cover the frames from R
on, which the report and ``RestoreResult.resumed_from`` state (the JAX
restorer starts a fresh validator on resume too, and says nothing).

Only a ``TransientError`` (``HBMError``: the card ran out of memory
after the plan's downshifts) becomes bicubic copies. A kernel that fails
to build or launch, or any other fault of the model path, ends the
restore: the JAX restorer copies on any exception but ``StageError``,
which would hide a broken kernel behind CPU copies and exit 0.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from framewright_tpu_torch.config import Config
from framewright_tpu_torch.engine.checkpoint import CheckpointManager
from framewright_tpu_torch.errors import (
    FatalError,
    InputError,
    TransientError,
    ValidationError,
)
from framewright_tpu_torch.io.ring import PrefetchRing, WriterDrain
from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter, rgb_to_yuv420
from framewright_tpu_torch.processors.super_resolution import (
    SRConfig,
    SuperResolution,
)
from framewright_tpu_torch.quality.validators import QualityReport, QualityValidator

logger = logging.getLogger(__name__)

_ENHANCE = "enhance"


@dataclass
class RestoreResult:
    output_path: Path
    frames_in: int
    frames_out: int
    duration_s: float
    batches: int = 0          # device dispatches
    batch_size: int = 0       # frames per dispatch (the last may hold fewer)
    quality: Optional[QualityReport] = None
    errors: int = 0           # frames written as bicubic copies
    resumed_from: int = 0     # first frame this run wrote; quality and
                              # errors cover the frames from it on
    stage_summary: Dict = field(default_factory=dict)

    @property
    def fps(self) -> float:
        return self.frames_out / self.duration_s if self.duration_s > 0 else 0.0


def build_sr_config(cfg: Config) -> SRConfig:
    return SRConfig(
        model_name=cfg.sr_model,
        compute_dtype=cfg.compute_dtype,
        batch_size=cfg.batch_size,
        hbm_utilization=cfg.hbm_utilization,
        weights_dir=str(cfg.weights_dir) if cfg.weights_dir else None,
        device="cuda" if cfg.device_platform == "auto" else cfg.device_platform,
    )


class VideoRestorer:
    def __init__(self, config: Optional[Config] = None,
                 progress_callback: Optional[Callable[[int, int], None]] = None):
        self.config = config or Config()
        self.progress_callback = progress_callback
        self.checkpoints = CheckpointManager(self.config.checkpoint_dir,
                                             self.config.checkpoint_interval)
        self.sr: Optional[SuperResolution] = None

    def _resolve_output(self, source: Path) -> Path:
        if self.config.output_path is not None:
            return self.config.output_path
        return self.config.project_dir / (source.stem + "_restored.y4m")

    def restore_video(self, source, output=None) -> RestoreResult:
        cfg = self.config
        source = Path(source)
        if not source.exists():
            raise InputError(f"source not found: {source}")
        if source.suffix.lower() != ".y4m":
            raise InputError(f"the port reads .y4m only, got {source.name}")
        out_path = Path(output) if output else self._resolve_output(source)
        if out_path.suffix.lower() != ".y4m":
            raise InputError(f"the port writes .y4m only, got {out_path.name}")
        t0 = time.time()
        data: Dict = {"source": source, "output": out_path}
        stages: List[Dict] = []

        def run(name: str, fn) -> None:
            t = time.time()
            try:
                data.update(fn(data))
            except BaseException:
                stages.append({"name": name, "status": "failed",
                               "duration_s": time.time() - t})
                raise
            stages.append({"name": name, "status": "completed",
                           "duration_s": time.time() - t})

        run("probe", self._stage_probe)
        if cfg.checkpoint_enabled:
            run("checkpoint", self._stage_checkpoint)
        run(_ENHANCE, self._stage_enhance)
        try:
            if cfg.validate_output:
                run("validate", self._stage_validate)
        finally:
            # the output is complete: a rerun must not resume into it
            run("finalize", self._stage_finalize)
        result = RestoreResult(
            out_path, data["frames_in"], data["frames_out"], time.time() - t0,
            data["batches"], data["batch_size"], data.get("quality_report"),
            data["frame_errors"], data["resumed_from"], {"stages": stages})
        if cfg.quality_report_format != "none" and result.quality is not None:
            try:
                from framewright_tpu_torch.reports import build_qa_report

                rp = cfg.project_dir / ("qa_report." + cfg.quality_report_format)
                build_qa_report(result, str(source)).save(rp)
                logger.info("QA report -> %s", rp)
            except Exception:  # noqa: BLE001 - reporting never fails a job
                logger.exception("QA report generation failed")
        return result

    # -- stages ----------------------------------------------------------
    def _stage_probe(self, data: Dict) -> Dict:
        with Y4MReader(data["source"]) as probe:
            total = probe.count_frames()
            h, w, fps = probe.height, probe.width, probe.header.fps
        if w <= 0 or total <= 0:
            raise InputError(f"empty or unreadable video: {data['source']}")
        if self.config.max_frames:
            total = min(total, self.config.max_frames)
        return {"frames_in": total, "height": h, "width": w, "fps": fps}

    def _stage_checkpoint(self, data: Dict) -> Dict:
        ck = self.checkpoints.start(data["source"], self.config.get_hash(),
                                    total_frames=data["frames_in"])
        return {"checkpoint": ck}

    def _stage_enhance(self, data: Dict) -> Dict:
        cfg = self.config
        total, h, w = data["frames_in"], data["height"], data["width"]
        out_path = data["output"]
        checkpointed = "checkpoint" in data
        resume_from = (self.checkpoints.resume_point(_ENHANCE)
                       if checkpointed and cfg.resume else 0)
        sr = self.sr = SuperResolution(build_sr_config(cfg))
        written = frame_errors = batch_size = 0
        budget_hit = False
        with contextlib.ExitStack() as stack:    # unwinds in reverse order
            if checkpointed:
                @stack.callback
                def _save_progress():
                    self.checkpoints.frames_completed(_ENHANCE, written)
                    self.checkpoints.force_save()
            stack.callback(sr.teardown)
            sr.setup(h, w)
            oh, ow = sr.output_size(h, w)
            batch_size = max(1, min(sr.plan.batch, total))
            if resume_from:
                # cut the output to R = min(checkpoint, whole frames in it),
                # rounded down to a whole batch: every frame then runs in
                # the batch it had in a straight run, so the output is the
                # straight run's (the CPU's plain convolutions may round a
                # frame differently in another batch)
                on_disk = 0
                if out_path.is_file():
                    with Y4MReader(out_path) as r:
                        on_disk = r.count_frames()
                keep = min(resume_from, on_disk) // batch_size * batch_size
                writer = Y4MWriter(out_path, ow, oh, fps=data["fps"], append=True,
                                   keep_frames=keep)
                resume_from = writer.frames_written
                logger.info("resuming enhance at frame %d", resume_from)
            else:
                writer = Y4MWriter(out_path, ow, oh, fps=data["fps"])
            stack.enter_context(writer)
            written = resume_from
            validator = (QualityValidator(cfg.min_psnr, cfg.min_ssim, min_vmaf=cfg.min_vmaf,
                                          first_frame=resume_from)
                         if cfg.validate_output else None)
            reader = stack.enter_context(Y4MReader(data["source"]))
            yuv_direct = (writer.header.colorspace.startswith("420")
                          and oh % 2 == 0 and ow % 2 == 0)
            if yuv_direct:
                sr.config.yuv_full_range = writer.full_range
                sr.set_output_color("yuv420")
                if validator is not None:
                    # the gate's scores ride in the SR pass: a few floats
                    # a frame instead of RGB frames on the host
                    sr.enable_device_stats()
                drain = WriterDrain(lambda planes: writer.write_yuv_frame(*planes),
                                    depth=4)
            else:
                drain = WriterDrain(writer.write_frame, depth=4)
            stack.callback(drain.close)
            ring = PrefetchRing(itertools.islice(iter(reader), total), batch_size=batch_size,
                                skip_frames=resume_from, start_frame=resume_from)
            stack.callback(ring.close)

            def guarded(fn, frames: np.ndarray):
                """(fn(), True), or (the frames' bicubic copies, False) when
                fn raises a TransientError under continue_on_error."""
                nonlocal frame_errors
                try:
                    return fn(), True
                except TransientError:
                    if not cfg.continue_on_error:
                        raise
                    logger.exception("enhance batch failed; writing bicubic copies")
                    frame_errors += len(frames)
                    return self._upscale_fallback(frames, (oh, ow)), False

            def finish(handle, ok: bool, frames: np.ndarray) -> None:
                nonlocal written
                n = len(frames)
                out = handle                            # bicubic copies if not ok
                if ok:
                    out, ok = guarded(lambda: sr.materialize(handle), frames)
                if yuv_direct:
                    if ok:                              # (Y, U, V) planes
                        st = handle.get("stats_np")
                        if validator is not None and st is not None:
                            validator.observe_scores(st["psnr"], st["ssim"], st["luma"],
                                                     std=st["std"], finite=st["finite"])
                        out = [tuple(p[i] for p in out) for i in range(n)]
                    else:                               # bicubic copies in RGB
                        out = [rgb_to_yuv420(f, full_range=writer.full_range) for f in out]
                elif validator is not None and ok:
                    for i in range(n):
                        validator.observe(frames[i], out[i])
                drain.submit(out, n)
                written += n
                if checkpointed:
                    self.checkpoints.frames_completed(_ENHANCE, written)
                if self.progress_callback is not None:
                    self.progress_callback(written, total)

            deadline = (time.time() + cfg.max_runtime_minutes * 60.0
                        if cfg.max_runtime_minutes > 0 else None)
            # one batch in flight: batch N+1 is enqueued on the card before
            # batch N is copied back and handed to the writer
            pending = None
            for batch in ring:
                if deadline is not None and time.time() > deadline:
                    budget_hit = True
                    logger.warning("runtime budget (%.1f min) reached at frame %d; "
                                   "stopping: rerun to resume", cfg.max_runtime_minutes,
                                   written)
                    break
                frames = batch.frames[: batch.valid]
                handle, ok = guarded(lambda: sr.dispatch(frames), frames)
                if pending is not None:
                    finish(*pending)
                pending = (handle, ok, frames)
            if pending is not None:
                finish(*pending)
        if budget_hit:
            raise FatalError(f"runtime budget reached after {written} frames; "
                             "rerun the same command to resume")
        if checkpointed:
            self.checkpoints.stage_completed(_ENHANCE)
        return {"frames_out": written, "frame_errors": frame_errors,
                "resumed_from": resume_from,
                "validator": validator, "batches": sr.dispatches,
                "batch_size": batch_size}

    @staticmethod
    def _upscale_fallback(frames: np.ndarray, out_hw) -> np.ndarray:
        """Bicubic copies of frames whose batch failed with a
        ``TransientError`` (``continue_on_error``): ``resize_bicubic(
        frames / 255)`` on the CPU, then clip and round half away from
        zero to uint8."""
        import torch

        from framewright_tpu_torch.models.layers import resize_bicubic

        y = resize_bicubic(torch.from_numpy(np.ascontiguousarray(frames)).float() / 255.0,
                           out_hw).numpy()
        return np.clip(y * 255.0 + 0.5, 0, 255).astype(np.uint8)

    def _stage_validate(self, data: Dict) -> Dict:
        validator: Optional[QualityValidator] = data.get("validator")
        if validator is None:
            return {}
        report = validator.validate()
        if not report.passed:
            logger.warning("quality gates failed: %s", report.to_dict())
            if not self.config.continue_on_error:
                raise ValidationError(f"quality gates failed: {report.to_dict()}",
                                      details=report.to_dict())
        return {"quality_report": report}

    def _stage_finalize(self, data: Dict) -> Dict:
        if "checkpoint" in data:
            self.checkpoints.complete()
        return {}
