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

In front of the ring, the pre-SR stream in the JAX order
(``framewright_tpu/restorer.py:477-635``): long-form drift correction
(``long_form``: the anchors from a second decode pass, each frame
corrected at its global index), deinterlacing (``deinterlace="auto"``
probes the first 60 frames with ``InterlaceDetector(sample_every=5)`` in
a third pass and engages yadif on an interlaced source), the temporal
denoiser (``denoise``) and temporal consistency (``temporal_consistency``:
cross-frame attention or the EMA flicker reducer). The ring's producer
thread runs it; the denoiser and the attention run on the restore's
device, in full f32 (``hw.full_f32`` is held for the whole enhance
stage), and the batch plan keeps their memory (``planner.pre_sr_bytes``)
off the SR batch. On a resume the ring discards the frames before the
resume point after the stream has made them, as the JAX ring does, so
the denoiser profiles the same head frames, cuts at the same scenes and
the enforcer's indices stay global.

Deduplication (``deduplicate``, ``_stage_dedup``): one decode pass of
the first ``frames_in`` frames hashes every frame (and tees the
long-form anchors off the same pass); the enhance stage then runs SR on
the unique frames of each ring batch only and repeats their outputs.
Film defect repair (``defect_repair``) runs in the pre-SR stream after
deinterlacing and before the denoiser, and post-SR grain (``grain_mode``)
on each output frame after the gate has observed it, with one seeded
generator for the run. A mapping or grain turns off the YUV-direct path:
the SR pass emits uint8 RGB, the gate scores sampled RGB pairs and the
writer encodes 4:2:0 on the host (the native codec). As in the JAX
restorer (``framewright_tpu/restorer.py:301-342, 470, 654-720, 823-895``).

The ring's producer thread runs the pre-SR stream on a CUDA stream of
its own (``hw.on_stream``), so its uploads and copies back wait for its
own work, not for the SR batch queued on the main thread's stream.

Resume cuts the output to R = min(the checkpoint's count, the whole
frames in the file), rounded down to a whole batch, and restarts the
input at frame R. With deduplication R moves back to a batch start that
is a unique frame, so no SR output is carried across it and the last
unique position is the mapping's at R - 1; with grain R moves back to a
point the checkpoint holds the generator's state and measured target
for (``carry``); R = 0 when there is none. The resumed output is the
straight run's byte for byte: the JAX restorer restarts its last unique
index and its generator on a resume (ROADMAP.md, "JAX faults"). The JAX
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
import dataclasses
import itertools
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from framewright_tpu_torch import planner
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.engine.checkpoint import CheckpointManager
from framewright_tpu_torch.engine.temporal import ColorConsistencyEnforcer, GlobalAnchors
from framewright_tpu_torch.errors import (
    FatalError,
    InputError,
    TransientError,
    ValidationError,
)
from framewright_tpu_torch.hw import full_f32, on_stream, side_stream
from framewright_tpu_torch.io.ring import PrefetchRing, WriterDrain
from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter, rgb_to_yuv420
from framewright_tpu_torch.processors.deduplication import (
    DedupConfig,
    DedupResult,
    FrameDeduplicator,
)
from framewright_tpu_torch.processors.film import (
    DefectRepairer,
    GrainManager,
    estimate_grain_level,
)
from framewright_tpu_torch.processors.format import InterlaceDetector, YadifDeinterlacer
from framewright_tpu_torch.processors.super_resolution import (
    SRConfig,
    SuperResolution,
)
from framewright_tpu_torch.processors.temporal_attention import CFAConfig, CrossFrameAttention
from framewright_tpu_torch.processors.temporal_denoise import (
    FlickerReducer,
    TemporalDenoiseConfig,
    TemporalDenoiser,
)
from framewright_tpu_torch.quality.validators import QualityReport, QualityValidator

logger = logging.getLogger(__name__)

_ENHANCE = "enhance"
# resume points whose carried state the checkpoint keeps (the newest): a
# killed run's file may lag its checkpoint by the writer's queue
_CARRY_POINTS = 16


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
    pre_sr: Dict = field(default_factory=dict)   # what the pre-SR stream did:
                                                 # long_form, deinterlace,
                                                 # defect_repair, denoise (the
                                                 # denoiser's result),
                                                 # temporal_consistency,
                                                 # host_codec
    dedup: Optional[DedupResult] = None
    post_sr: Dict = field(default_factory=dict)  # grain: mode and target

    @property
    def fps(self) -> float:
        return self.frames_out / self.duration_s if self.duration_s > 0 else 0.0


def _device(cfg: Config) -> str:
    return "cuda" if cfg.device_platform == "auto" else cfg.device_platform


def _denoise_method(cfg: Config) -> str:
    """The JAX restorer's mapping of ``denoise_model`` to the denoiser's
    method (``none`` becomes ``temporal`` there too)."""
    return (cfg.denoise_model if cfg.denoise_model in ("auto", "temporal", "nafnet",
                                                       "restormer", "bilateral")
            else "temporal")


def pre_sr_reserve(cfg: Config, height: int, width: int) -> int:
    """Card bytes the pre-SR stream of ``cfg`` may hold at its peak."""
    return planner.pre_sr_bytes(
        height, width, _denoise_method(cfg) if cfg.denoise else None,
        cfg.temporal_model if cfg.temporal_consistency else None,
        (cfg.temporal_window - 1) // 2)


def build_sr_config(cfg: Config, reserved_bytes: int = 0) -> SRConfig:
    return SRConfig(
        model_name=cfg.sr_model,
        compute_dtype=cfg.compute_dtype,
        batch_size=cfg.batch_size,
        hbm_utilization=cfg.hbm_utilization,
        weights_dir=str(cfg.weights_dir) if cfg.weights_dir else None,
        device=_device(cfg),
        reserved_bytes=reserved_bytes,
    )


class _PostSRGrain:
    """The restore's post-SR ``post_fx`` (``framewright_tpu/restorer.py:
    654-720``): ``GrainManager.process`` on each output frame, with the
    ``match`` target measured once from the first batch's unique frames
    when ``grain_target`` is 0. ``state``/``restore`` carry the generator
    and the target across a resume."""

    def __init__(self, gm: GrainManager, target: float):
        self.gm = gm
        self.target = target

    def state(self) -> Dict:
        return {"rng": self.gm.rng.bit_generator.state, "target": self.target}

    def restore(self, state: Dict) -> None:
        self.gm.rng.bit_generator.state = state["rng"]
        self.target = state["target"]

    def __call__(self, out: np.ndarray, src_frames: Optional[np.ndarray]) -> np.ndarray:
        tgt = self.target
        if tgt <= 0:
            if src_frames is not None and len(src_frames):
                tgt = max(0.05, float(np.mean([estimate_grain_level(f)
                                               for f in src_frames[:2]])))
                self.target = tgt
            else:
                tgt = 0.2
        return np.stack([self.gm.process(f, target_level=tgt) for f in out])


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
        if cfg.deduplicate:
            run("dedup", self._stage_dedup)
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
            data["frame_errors"], data["resumed_from"], {"stages": stages},
            data.get("pre_sr", {}), data.get("dedup_result"), data.get("post_sr", {}))
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

    def _stage_dedup(self, data: Dict) -> Dict:
        """One decode pass of the first ``frames_in`` frames: the dedup
        analysis, and the long-form anchors teed off the same frames."""
        cfg = self.config
        total = data["frames_in"]
        dedup = FrameDeduplicator(DedupConfig(similarity_threshold=cfg.dedup_similarity,
                                              hash_size=cfg.dedup_hash_size))
        out: Dict = {}
        with Y4MReader(data["source"]) as reader:
            frames = itertools.islice(iter(reader), total)
            if self._longform_active(total):
                anchors = GlobalAnchors(total_frames=total)

                def teed(it=frames, every=cfg.anchor_interval):
                    for i, f in enumerate(it):
                        if i % every == 0:
                            anchors.points.append(GlobalAnchors.measure(f, i))
                        yield f

                frames = teed()
                out["anchors"] = anchors
            out["dedup_result"] = dedup.analyze(frames, target_fps=float(data["fps"]))
        return out

    def _grain(self) -> Optional["_PostSRGrain"]:
        """The post-SR grain of the config (``grain_mode`` resolved as the
        JAX restorer does), or None."""
        cfg = self.config
        mode = cfg.grain_mode
        if mode == "auto":
            mode = "match" if cfg.grain_preserve else "off"
        elif mode == "preserve":
            mode = "match"
        if mode == "off":
            return None
        return _PostSRGrain(GrainManager(mode=mode, strength=cfg.grain_strength, seed=cfg.seed),
                            cfg.grain_target)

    def _resume_point(self, keep: int, batch: int, mapping: Optional[Dict[int, int]],
                      grain: Optional["_PostSRGrain"]) -> int:
        """The largest batch start <= ``keep`` a resume can start from
        with the straight run's bytes: a unique frame under a mapping, and
        one whose grain state the checkpoint carries under grain; else 0.
        Restores the grain state there."""
        carry = ({int(k): v for k, v in self.checkpoints.checkpoint.carry.items()}
                 if grain is not None else {})
        for r in range(keep - keep % batch, 0, -batch):
            if mapping is not None and mapping.get(r) == mapping[r - 1]:
                continue
            if grain is not None:
                if r not in carry:
                    continue
                grain.restore(carry[r])
            return r
        return 0

    def _stage_enhance(self, data: Dict) -> Dict:
        cfg = self.config
        total, h, w = data["frames_in"], data["height"], data["width"]
        out_path = data["output"]
        checkpointed = "checkpoint" in data
        resume_from = (self.checkpoints.resume_point(_ENHANCE)
                       if checkpointed and cfg.resume else 0)
        dedup: Optional[DedupResult] = data.get("dedup_result")
        mapping = dedup.frame_mapping if dedup is not None else None
        grain = self._grain()
        sr = self.sr = SuperResolution(build_sr_config(cfg, pre_sr_reserve(cfg, h, w)))
        written = frame_errors = batch_size = 0
        budget_hit = False
        pre_sr: Dict = {}
        with contextlib.ExitStack() as stack:    # unwinds in reverse order
            # f32 in full f32 in both threads (the pre-SR stream's convs run
            # in the ring's producer thread): TF32 off until the stage ends
            stack.enter_context(full_f32())
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
                # rounded down to a whole batch (and back to a unique frame
                # or a carried grain state): every frame then runs in the
                # batch it had in a straight run, so the output is the
                # straight run's (the CPU's plain convolutions may round a
                # frame differently in another batch)
                on_disk = 0
                if out_path.is_file():
                    with Y4MReader(out_path) as r:
                        on_disk = r.count_frames()
                keep = self._resume_point(min(resume_from, on_disk) // batch_size * batch_size,
                                          batch_size, mapping, grain)
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
            pre_sr["host_codec"] = {"decode": reader.codec, "encode": writer.codec}
            # a mapping repeats RGB outputs and grain changes them on the
            # host: both take the RGB path
            yuv_direct = (writer.header.colorspace.startswith("420")
                          and oh % 2 == 0 and ow % 2 == 0
                          and mapping is None and grain is None)
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
            # the pre-SR stream from frame 0, on a stream of its own on the
            # card: the ring drops the frames before the resume point after
            # the stream made them
            stream, finish_pre_sr = self._pre_sr_stream(
                data, itertools.islice(iter(reader), total), pre_sr)
            ring = PrefetchRing(on_stream(stream, side_stream(sr.device)),
                                batch_size=batch_size, skip_frames=resume_from,
                                start_frame=resume_from)
            stack.callback(ring.close)
            # the unique position of the last frame SR ran on, and its output
            last_unique = mapping[resume_from - 1] if mapping and resume_from else -1
            last_out: Optional[np.ndarray] = None
            carry: Dict[str, Dict] = {}

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

            def finish(handle, ok: bool, frames: np.ndarray, start: int, unique_sel: List[int],
                       work: np.ndarray) -> None:
                nonlocal written, last_out
                n = len(frames)
                out = handle                            # bicubic copies if not ok
                if handle is None:                      # every frame a duplicate
                    out = frames[:0]
                elif ok:
                    out, ok = guarded(lambda: sr.materialize(handle), work)
                if yuv_direct:
                    if ok:                              # (Y, U, V) planes
                        st = handle.get("stats_np")
                        if validator is not None and st is not None:
                            validator.observe_scores(st["psnr"], st["ssim"], st["luma"],
                                                     std=st["std"], finite=st["finite"])
                        out = [tuple(p[i] for p in out) for i in range(n)]
                    else:                               # bicubic copies in RGB
                        out = [rgb_to_yuv420(f, full_range=writer.full_range) for f in out]
                else:
                    if mapping is not None:
                        # the unique frames' outputs back at every position
                        outs, k = [], 0
                        for pos in range(n):
                            if k < len(unique_sel) and unique_sel[k] == pos:
                                last_out = out[k]
                                k += 1
                            outs.append(last_out)   # a resume starts at a unique frame
                        out = np.stack(outs)
                    if validator is not None and ok:
                        for i in range(n):
                            validator.observe(frames[i], out[i])
                    if grain is not None:
                        # after the gate: grain is an intended change
                        out = grain(out, work if len(work) else None)
                        nxt = start + n
                        if nxt < total and (mapping is None or mapping[nxt] > mapping[nxt - 1]):
                            carry[str(nxt)] = grain.state()
                            for key in list(carry)[:-_CARRY_POINTS]:
                                del carry[key]
                            if checkpointed:
                                self.checkpoints.checkpoint.carry = dict(carry)
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
                start = batch.start_frame
                if mapping is not None:
                    # SR on the frames of a unique position not seen yet
                    unique_sel = []
                    for pos in range(len(frames)):
                        u = mapping[start + pos]
                        if u > last_unique:
                            unique_sel.append(pos)
                            last_unique = u
                    work = frames[unique_sel]
                else:
                    unique_sel, work = list(range(len(frames))), frames
                handle, ok = (guarded(lambda: sr.dispatch(work), work) if len(work)
                              else (None, True))
                if pending is not None:
                    finish(*pending)
                pending = (handle, ok, frames, start, unique_sel, work)
            if pending is not None:
                finish(*pending)
        finish_pre_sr()
        if budget_hit:
            raise FatalError(f"runtime budget reached after {written} frames; "
                             "rerun the same command to resume")
        if checkpointed:
            self.checkpoints.stage_completed(_ENHANCE)
        post_sr = {} if grain is None else {"grain": {"mode": grain.gm.mode,
                                                      "target": grain.target}}
        return {"frames_out": written, "frame_errors": frame_errors,
                "resumed_from": resume_from, "pre_sr": pre_sr, "post_sr": post_sr,
                "validator": validator, "batches": sr.dispatches,
                "batch_size": batch_size}

    def _longform_active(self, nb_frames: int) -> bool:
        cfg = self.config
        if cfg.long_form == "on":
            return True
        if cfg.long_form == "off":
            return False
        return nb_frames >= cfg.long_form_threshold

    def _pre_sr_stream(self, data: Dict, frames: Iterator[np.ndarray], info: Dict):
        """The frames of the source from 0 through the pre-SR stages, in
        the JAX order (drift correction, deinterlacing, defect repair,
        denoising, temporal consistency) -> (stream, finish): ``finish()``
        adds the defect repairer's and the denoiser's results to ``info``
        once the stream has run."""
        cfg = self.config
        total = data["frames_in"]
        if self._longform_active(total):
            anchors = data.get("anchors")             # teed off the dedup pass
            if anchors is None:
                with Y4MReader(data["source"]) as ar:
                    anchors = GlobalAnchors.extract(itertools.islice(iter(ar), total),
                                                    sample_every=cfg.anchor_interval)
            info["long_form"] = {"anchors": len(anchors.points)}
            if anchors.points:
                enforcer = ColorConsistencyEnforcer(anchors, cfg.long_form_strength)
                frames = (enforcer.correct(f, i) for i, f in enumerate(frames))
                logger.info("long-form consistency on: %d anchors", len(anchors.points))
        deint = cfg.deinterlace
        if deint == "auto":
            # the head of the source probed for combing; yadif only on an
            # interlaced source
            with Y4MReader(data["source"]) as r:
                rep = InterlaceDetector(sample_every=5).analyze(itertools.islice(iter(r), 60))
            deint = "yadif" if rep.interlaced else "off"
            info["deinterlace"] = {"mode": deint, **dataclasses.asdict(rep)}
            if rep.interlaced:
                logger.info("interlaced source detected (combing %.2f, %s): yadif engaged",
                            rep.combing_score, rep.field_order)
        else:
            info["deinterlace"] = {"mode": deint}
        if deint in ("yadif", "bwdif"):
            frames = YadifDeinterlacer(mode=deint).process_stream(frames)
        repairer = None
        if cfg.defect_repair:
            repairer = DefectRepairer(scratch_threshold=cfg.defect_scratch_sensitivity,
                                      dust_threshold=cfg.defect_dust_sensitivity)
            frames = repairer.process_stream(frames)
        denoiser = None
        if cfg.denoise:
            denoiser = TemporalDenoiser(TemporalDenoiseConfig(
                radius=(cfg.temporal_window - 1) // 2, strength=cfg.denoise_strength,
                method=_denoise_method(cfg), scene_change_threshold=cfg.scene_threshold,
                flow_model=cfg.flow_model,
                weights_dir=str(cfg.weights_dir) if cfg.weights_dir else None,
                device=_device(cfg)))
            denoiser.setup(data["height"], data["width"])
            frames = denoiser.denoise_stream(frames)
        if cfg.temporal_consistency:
            info["temporal_consistency"] = cfg.temporal_model
            if cfg.temporal_model == "attention":
                frames = CrossFrameAttention(CFAConfig(radius=1),
                                             device=_device(cfg)).reduce_stream(frames)
            else:
                frames = FlickerReducer().reduce_stream(frames)

        def finish() -> None:
            if repairer is not None:
                info["defect_repair"] = dataclasses.asdict(repairer.report)
            if denoiser is not None:
                info["denoise"] = {"method": denoiser.config.method,
                                   **denoiser.result.to_dict()}

        return frames, finish

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
