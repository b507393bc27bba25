"""Restore a clip: decode -> super-resolution -> encode, with the work
the JAX default ``Config()`` does on every restore.

Sources and outputs are Y4M, PNG frame directories or, with ffmpeg on
``PATH``, any container it reads or writes (``io.video``: ``probe``,
``open_reader``, ``open_writer``; the output's format by its suffix, or
``output_format`` when the restore names no output).

The port of the ``framewright_tpu.restorer.VideoRestorer`` path that a
default ``restore`` takes, as stage methods with the JAX names run under
the DAG engine (``engine.pipeline``) with JAX's stages, dependencies and
flags, an ``EventBus`` and a ``HookManager`` (the caller's, or new ones),
inside a ``SafeguardLoop`` and ``KeepAwake``: ``_stage_probe`` (the probe
and ``safeguards.preflight_check``, whose blockers raise ``InputError``
before any card work); ``_stage_checkpoint`` (the source's checkpoint,
discarded when the config changed); ``_stage_dedup``; ``_stage_enhance``
(retried ``stage_max_retries`` times on a ``TransientError``; ``PrefetchRing``,
one batch in flight on the card, ``WriterDrain``; the YUV-direct writer
path whenever the output is 4:2:0 Y4M with even sides, for either model
family, else uint8 RGB; resume, checkpoint progress, the runtime budget,
bicubic copies of a batch that failed with a ``TransientError`` under
``continue_on_error``, and the quality gate's per-frame scores from the
SR pass; ``cancel``, ``pause`` and ``resume`` act between batches);
``_stage_interpolate``; ``_stage_validate`` (the gate, not critical, as in
JAX); ``_stage_finalize`` (the checkpoint removed). The QA report is
written to ``project_dir / "qa_report.<fmt>"``; ``RestoreResult.
stage_summary`` is the engine's summary. ``dry_run`` returns the plan
(the probe, the preflight, the stages that would run) and processes,
writes and checkpoints nothing. ``progress_callback`` receives a
``ProgressInfo`` (stage, frames done and total, fps, ETA, percent) after
each batch of the enhance stage and each frame of the interpolate stage,
as in JAX.

A failed stage raises its own error to the caller (the JAX engine wraps
it in ``StageError``; the stage summary records it). A failed gate under
``continue_on_error=False`` raises ``ValidationError`` after the
finalize stage: the JAX restorer's non-critical validate stage swallows
it (ROADMAP.md, "JAX faults the port must not copy"). A retried enhance
stage resumes from its checkpoint as a rerun of a killed run does: the
failed attempt's writer, ring, producer thread, writer thread and
staging buffers are shut down first (its ``ExitStack``), and the output
is cut back to the resume point, so the output equals a straight
run's.

After SR, in the JAX order (``framewright_tpu/restorer.py:344-355,
395-416, 454-466, 723-736, 840-848, 964-1021``): face restoration
(``face_restore``: ``processors/faces``, set up at the output size, on
each output frame after the mapping's repeats and before the gate, which
turns off the YUV-direct path) and frame interpolation
(``interpolation``: the enhance stage writes ``work_dir/enhanced.y4m``,
only the unique frames at the estimated source rate when dedup found a
lower cadence, and ``_stage_interpolate`` streams it through
``FrameInterpolator`` into the output at ``factor`` times that rate,
then deletes it unless ``keep_intermediates``). The face restorer and
the interpolator read ``weights_dir`` (the JAX restorer never passes its
own to the face restorer), and a restore that needs a checkpoint the
weights directory lacks (``rife-v4.6``, ``GFPGANv1.4``) raises
``InputError`` naming it before any compute.

In front of the ring, the pre-SR stream in the JAX order
(``framewright_tpu/restorer.py:477-670``): long-form drift correction
(``long_form``: the anchors from a second decode pass, each frame
corrected at its global index), deinterlacing (``deinterlace="auto"``
probes the first 60 frames with ``InterlaceDetector(sample_every=5)`` in
a third pass and engages yadif on an interlaced source), VHS repair
(``vhs_restore``), defect repair, gap filling (``fill_missing_frames``:
``processors/frame_generation.GapFiller`` inserts an IFNet midpoint
where a frame was dropped), stabilization (``stabilize``),
watermark or subtitle inpainting (``watermark_removal``,
``subtitle_removal``: LaMa from ``<weights_dir>/big-lama.npz`` or the
heat fill), colorization (``colorize``: ``processors/colorize``, DDColor
or ECCV16 keyframes from ``<weights_dir>/ddcolor.npz`` or ``eccv16.npz``,
or the palette, propagated along IFNet flow), QP removal
(``qp_removal``), the temporal denoiser
(``denoise``), temporal consistency (``temporal_consistency``:
cross-frame attention, the EMA flicker reducer or the latent low-pass)
and the scene-adaptive filter (``scene_adaptive``: its map from a
sampled decode pass). After SR, HDR output (``hdr_output``) runs last in
``_PostSR``; ``hdr10plus`` writes ``<output>.hdr10plus.json`` after the
enhance stage, its collector carried across a resume with grain's state.
``auto_enhance`` analyses the source first and applies
``recommend_settings``' overrides (never the geometry), as JAX does. The ring's producer
thread runs it; the denoiser and the attention run on the restore's
device, in full f32 (``hw.full_f32`` is held for the whole enhance
stage), and the batch plan keeps their memory (``planner.pre_sr_bytes``)
off the SR batch. On a resume the ring discards the frames before the
resume point after the stream has made them, as the JAX ring does, so
the denoiser profiles the same head frames, cuts at the same scenes and
the enforcer's indices stay global.

An inserted frame is a stream frame like any other for the checkpoint
(which counts stream positions; the stream runs again from frame 0 on a
resume, as in JAX), the gate and the writer. Three JAX faults are
repaired (ROADMAP.md, "JAX faults the port must not copy"): the progress
total grows by each inserted frame (JAX's stays the source count);
dedup's mapping and the scene-adaptive segments are read by each stream
frame's source frame (``_StreamMap``; JAX reads them by stream position,
so every frame after an insertion takes its neighbour's), an inserted
frame running the SR and taking the segment of the frame before it; a
resume under dedup starts at a source frame new to the mapping, found
from the inserted positions the checkpoint keeps.

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
frames in the file, or the frame directory's files from frame 1 without
a gap), rounded down to a whole batch, and restarts the input at frame
R; an ffmpeg output cannot be appended to, so a rerun writes it from
frame 0 (``resumed_from`` 0). With interpolation the enhance stage
resumes in its intermediate, except when duplicates are dropped (as the
JAX restorer, which skips resume then); a run killed in the interpolate
stage resumes there, the intermediate intact and the enhance stage not
run again (``stage_state`` in the checkpoint keeps what the stage needs,
and the enhance stage's gate report, errors and results, so the rerun
reports what a straight run does), at a whole step of pairs (the pair
batch kept in the checkpoint). With
deduplication R moves back to a batch start that is a unique frame, so
no SR output is carried across it and the last unique position is the
mapping's at R - 1; with grain R moves back to a
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

The SR processor (``build_sr``, the JAX restorer's choice): a video SR
row (BasicVSR, TVSR_x4) runs ``processors.video_sr`` in chunks of
``batch_size`` (8 by default) with the dedup mapping bypassed, and a
resume at a chunk start seeds its carry with the ``overlap`` frames before
it (teed off the pre-SR stream), so the output is a straight run's;
``sr_ensemble`` runs ``testing.EnsembleSR``; else ``SuperResolution``
with ``outscale`` and the enhancement cap, one a card behind
``parallel.distributor.ShardedSR`` when there are several local cards
(``--batch`` stays a dispatch's frames, split over them). The video SR, the ensemble and
``outscale`` take the RGB writer path, as in JAX. Each SR processor
plans beside the pre-SR and face reserves: the ensemble's members share
them, and a video SR window that does not fit beside them raises
``HBMError`` before its first frame. Guided enhancement
(``sr_prompt``, ``sr_style_preset``, ``reference_images_dir``) runs on
each output frame after the gate and before grain (``_PostSR``); the
checkpoint carries its generators with grain's.

Only a ``TransientError`` (``HBMError``: the card ran out of memory
after the plan's downshifts) becomes bicubic copies. A kernel that fails
to build or launch, or any other fault of the model path, ends the
restore: the JAX restorer copies on any exception but ``StageError``,
which would hide a broken kernel behind CPU copies and exit 0.
"""

from __future__ import annotations

import bisect
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
from framewright_tpu_torch.engine.pipeline import (
    Pipeline,
    PipelineBuilder,
    PipelineContext,
    StageStatus,
)
from framewright_tpu_torch.engine.temporal import ColorConsistencyEnforcer, GlobalAnchors
from framewright_tpu_torch.errors import (
    FatalError,
    InputError,
    StageError,
    TransientError,
    ValidationError,
)
from framewright_tpu_torch.events import EventBus, EventType, HookManager
from framewright_tpu_torch.hw import (
    device_info,
    full_f32,
    on_stream,
    resolve_device,
    side_stream,
)
from framewright_tpu_torch.io.png_seq import FrameDirWriter, whole_frames
from framewright_tpu_torch.io.ring import PrefetchRing, WriterDrain
from framewright_tpu_torch.io.video import is_frame_dir, open_reader, open_writer, probe
from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter, rgb_to_yuv420
from framewright_tpu_torch.models.registry import (
    VSR_FAMILIES,
    aux_path,
    default_weights_dir,
    get_model,
    load_aux,
)
from framewright_tpu_torch.processors.colorize import NET_METHODS as COLORIZE_NETS
from framewright_tpu_torch.processors.colorize import ColorizeConfig, Colorizer
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
from framewright_tpu_torch.processors.faces import FaceRestoreConfig, FaceRestorer
from framewright_tpu_torch.processors.format import InterlaceDetector, YadifDeinterlacer
from framewright_tpu_torch.processors.frame_generation import GapFiller
from framewright_tpu_torch.processors.interpolation import (
    FrameInterpolator,
    InterpolationConfig,
    interpolation_factor,
)
from framewright_tpu_torch.processors.guided import GuidedConfig, make_backend
from framewright_tpu_torch.processors.hdr import HDRConfig, HDRConverter
from framewright_tpu_torch.processors.inpaint import (
    InpaintConfig,
    SubtitleRemover,
    WatermarkRemover,
)
from framewright_tpu_torch.parallel.distributor import ShardedSR
from framewright_tpu_torch.parallel.mesh import frames_mesh
from framewright_tpu_torch.processors.latent_temporal import LatentTemporalSmoother
from framewright_tpu_torch.processors.qp_removal import QPArtifactRemover, QPRemovalConfig
from framewright_tpu_torch.processors.scene_intelligence import (
    SceneAdaptiveFilter,
    SceneIntelligence,
)
from framewright_tpu_torch.processors.stabilization import StabilizeConfig, VideoStabilizer
from framewright_tpu_torch.processors.vhs import VHSConfig, VHSProcessor
from framewright_tpu_torch.processors.super_resolution import (
    SRConfig,
    SuperResolution,
)
from framewright_tpu_torch.processors.video_sr import VideoSuperResolution, VSRConfig
from framewright_tpu_torch.testing import EnsembleSR
from framewright_tpu_torch.processors.temporal_attention import CFAConfig, CrossFrameAttention
from framewright_tpu_torch.processors.temporal_denoise import (
    FlickerReducer,
    RAFTFlow,
    TemporalDenoiseConfig,
    TemporalDenoiser,
)
from framewright_tpu_torch.quality.validators import QualityReport, QualityValidator
from framewright_tpu_torch.safeguards import KeepAwake, SafeguardLoop, preflight_check

logger = logging.getLogger(__name__)

_ENHANCE = "enhance"
_INTERPOLATE = "interpolate"
# the checkpoint's stage_state key of the gap filler's inserted positions
_GAP_FILL = "gap_fill"
# resume points whose carried state the checkpoint keeps (the newest): a
# killed run's file may lag its checkpoint by the writer's queue
_CARRY_POINTS = 16


@dataclass
class ProgressInfo:
    stage: str = ""
    frames_done: int = 0
    total_frames: int = 0
    fps: float = 0.0
    eta_s: float = 0.0
    percent: float = 0.0


class _EtaTracker:
    """Rolling-window throughput and ETA over the last ``window`` frames
    (the JAX restorer's)."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times: List[float] = []

    def tick(self, n: int = 1) -> None:
        now = time.time()
        self.times.extend([now] * n)
        if len(self.times) > self.window:
            self.times = self.times[-self.window:]

    @property
    def fps(self) -> float:
        if len(self.times) < 2:
            return 0.0
        dt = self.times[-1] - self.times[0]
        return (len(self.times) - 1) / dt if dt > 0 else 0.0

    def eta(self, remaining: int) -> float:
        f = self.fps
        return remaining / f if f > 0 else 0.0


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
    resumed_from: int = 0     # first frame the enhance stage wrote in the
                              # run that completed it; quality and errors
                              # cover the frames from it on
    stage_summary: Dict = field(default_factory=dict)   # Pipeline.summary(); a dry
                                                        # run: {"dry_run": plan}
    pre_sr: Dict = field(default_factory=dict)   # what the pre-SR stream did:
                                                 # long_form, deinterlace,
                                                 # defect_repair, denoise (the
                                                 # denoiser's result),
                                                 # temporal_consistency,
                                                 # host_codec
    dedup: Optional[DedupResult] = None
    post_sr: Dict = field(default_factory=dict)  # grain: mode and target
    output_fps: float = 0.0
    interpolation: Optional[Dict] = None  # frames in and out, factor, scene
                                          # skips, output fps, resumed_from
                                          # (the output frame it restarted at)
    faces_restored: Optional[int] = None  # faces pasted back (face_restore)

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


def raft_pairs(cfg: Config, height: int, width: int) -> int:
    """Pairs a step of the denoiser's RAFT alignment holds: as many of
    the 2r as half the free card memory fits (0: it aligns with IFNet, or
    does not align)."""
    if not raft_needed(cfg):
        return 0
    return planner.raft_pairs(height, width, _free_bytes(_device(cfg)), cfg.hbm_utilization,
                              max_pairs=max(1, cfg.temporal_window - 1))


def pre_sr_reserve(cfg: Config, height: int, width: int,
                   pairs: Optional[int] = None) -> int:
    """Card bytes the pre-SR stream of ``cfg`` may hold at its peak, with
    ``pairs`` RAFT pairs a step (``raft_pairs`` when None) and Restormer
    at the widths of the user's checkpoint."""
    method = _denoise_method(cfg) if cfg.denoise else None
    return planner.pre_sr_bytes(
        height, width, method,
        cfg.temporal_model if cfg.temporal_consistency else None,
        (cfg.temporal_window - 1) // 2,
        raft_pairs(cfg, height, width) if pairs is None else pairs,
        load_aux("restormer", cfg.weights_dir)[0].arch_config
        if method == "restormer" else None,
        stages=tuple(st for st, on in (
            ("qp", cfg.qp_removal), (_inpaint_method(cfg), _inpaints(cfg)),
            ("gapfill", cfg.fill_missing_frames), ("colorize", cfg.colorize),
            (cfg.colorize_model, cfg.colorize and cfg.colorize_model in COLORIZE_NETS)) if on))


def _inpaints(cfg: Config) -> bool:
    return cfg.watermark_removal or cfg.subtitle_removal


def _inpaint_method(cfg: Config) -> str:
    """The JAX restorer's mapping of ``inpaint_model`` (anything but
    ``diffusion`` runs LaMa) to the stage's method: ``lama`` or ``heat``
    (the ``diffusion`` fill)."""
    return "heat" if cfg.inpaint_model == "diffusion" else "lama"


def _free_bytes(device: str) -> Optional[int]:
    """Free card bytes, counting what PyTorch's allocator holds in its
    cache (None on the CPU)."""
    import torch

    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    return (device_info(dev).free_bytes + torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))


def face_reserve(cfg: Config, out_h: int, out_w: int) -> int:
    """Card bytes the face restorer of ``cfg`` holds beside the SR batch."""
    if not cfg.face_restore:
        return 0
    retina = aux_path("RetinaFace_mnet025", cfg.weights_dir) is not None
    return planner.face_bytes(cfg.face_model, out_h, out_w, retinaface=retina)


def required_weights(cfg: Config) -> List[str]:
    """The user checkpoints a restore with ``cfg`` reads and never draws."""
    names = []
    if cfg.denoise and cfg.denoise_model == "restormer":
        names.append("restormer")
    if raft_needed(cfg):
        names.append("raft-things")
    if cfg.interpolation:
        names.append(cfg.interpolation_model)
    if cfg.face_restore and cfg.face_model == "gfpgan":
        names.append("GFPGANv1.4")
    if cfg.face_restore and cfg.face_model == "codeformer":
        names.append("CodeFormer")
    if _inpaints(cfg) and _inpaint_method(cfg) == "lama":
        names.append("big-lama")
    if cfg.colorize and cfg.colorize_model in COLORIZE_NETS:
        names.append(cfg.colorize_model)
    return names


def raft_needed(cfg: Config) -> bool:
    """Whether the restore's denoiser aligns with RAFT."""
    return (cfg.denoise and cfg.flow_model == "raft"
            and _denoise_method(cfg) in ("auto", "temporal", "nafnet", "restormer"))


def output_size(cfg: Config, height: int, width: int):
    """The enhance stage's output size: ``outscale`` or the model's scale."""
    if cfg.outscale:
        return int(round(height * cfg.outscale)), int(round(width * cfg.outscale))
    scale = get_model(cfg.sr_model).scale
    return height * scale, width * scale


def build_sr(cfg: Config, reserved_bytes: int = 0):
    """The enhance stage's SR processor (the JAX restorer's choice,
    ``framewright_tpu/restorer.py:365-394``): a video SR row runs the
    chunked video SR (with ``weights_dir``, which the JAX restorer leaves
    out), ``sr_ensemble`` the ensemble, else ``SuperResolution``; each
    plans beside ``reserved_bytes``."""
    if get_model(cfg.sr_model).family in VSR_FAMILIES:
        return VideoSuperResolution(VSRConfig(
            model_name=cfg.sr_model, chunk=cfg.batch_size or 8,
            compute_dtype=cfg.compute_dtype,
            weights_dir=str(cfg.weights_dir) if cfg.weights_dir else None,
            device=_device(cfg), hbm_utilization=cfg.hbm_utilization,
            reserved_bytes=reserved_bytes))
    if cfg.ensemble_models():
        return EnsembleSR([cfg.sr_model] + cfg.ensemble_models(),
                          strategy=cfg.ensemble_strategy,
                          weights_dir=str(cfg.weights_dir) if cfg.weights_dir else None,
                          compute_dtype=cfg.compute_dtype, device=_device(cfg),
                          hbm_utilization=cfg.hbm_utilization, reserved_bytes=reserved_bytes)
    sr_cfg = build_sr_config(cfg, reserved_bytes)
    # the frames split over the local cards (JAX super_resolution.py:194-215);
    # JAX's restorer never maps sharding_strategy, the port honours "none".
    # The diffusion SR keeps one card (its noise is drawn per dispatch chunk).
    mesh = (None if cfg.sharding_strategy == "none"
            or get_model(cfg.sr_model).family == "diffusion"
            else frames_mesh(sr_cfg.device, cfg.mesh_shape))
    return SuperResolution(sr_cfg) if mesh is None else ShardedSR(sr_cfg, mesh)


def build_sr_config(cfg: Config, reserved_bytes: int = 0) -> SRConfig:
    return SRConfig(
        model_name=cfg.sr_model,
        compute_dtype=cfg.compute_dtype,
        tile_size=cfg.tile_size,
        tile_overlap=cfg.tile_overlap,
        batch_size=cfg.batch_size,
        hbm_utilization=cfg.hbm_utilization,
        weights_dir=str(cfg.weights_dir) if cfg.weights_dir else None,
        device=_device(cfg),
        reserved_bytes=reserved_bytes,
        outscale=cfg.outscale,
        enhancement_cap=cfg.max_enhancement_strength,
        diffusion_steps=cfg.diffusion_steps,
    )


def _tee_range(frames: Iterator[np.ndarray], lo: int, hi: int,
               into: List[np.ndarray]) -> Iterator[np.ndarray]:
    """``frames`` unchanged, frames lo .. hi - 1 also appended to ``into``."""
    for i, f in enumerate(frames):
        if lo <= i < hi:
            into.append(f)
        yield f


class _StreamMap:
    """Stream position -> (source index, inserted) when the gap filler
    inserts frames: from the filler while the stream runs, else from the
    inserted positions a checkpoint kept (a resume needs them before the
    stream has run again); an inserted frame's source index is that of the
    frame before it. Without a filler every position is its own source."""

    def __init__(self, inserted=()):
        self.filler: Optional[GapFiller] = None
        self._inserted = sorted(int(p) for p in inserted)

    def source_of(self, pos: int):
        f = self.filler
        if f is not None and pos < len(f.sources):
            return f.source_of(pos)
        n = bisect.bisect_left(self._inserted, pos)
        if n < len(self._inserted) and self._inserted[n] == pos:
            return pos - n - 1, True
        return pos - n, False

    def known(self, pos: int) -> bool:
        """Whether the stream has a frame at ``pos`` that the map knows."""
        return self.filler is None or pos < len(self.filler.sources)

    def inserted_positions(self) -> List[int]:
        return self._inserted if self.filler is None else self.filler.inserted_at


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


class _PostSR:
    """The restore's post-SR ``post_fx`` in JAX's order (``framewright_tpu/
    restorer.py:671-720``): guided enhancement (``style``), then grain,
    then the HDR expansion. ``state``/``restore`` carry both generators
    and the HDR10+ collector's frames across a resume."""

    def __init__(self, style, grain: Optional[_PostSRGrain],
                 hdr: Optional[HDRConverter] = None):
        self.style, self.grain, self.hdr = style, grain, hdr

    def state(self) -> Dict:
        col = self.hdr.collector if self.hdr is not None else None
        return {"style": self.style.rng_states() if self.style is not None else None,
                "grain": self.grain.state() if self.grain is not None else None,
                "hdr10plus": (None if col is None else
                              {"frames": [dict(f) for f in col.frames],
                               "last_avg": col._last_avg})}

    def restore(self, state: Dict) -> None:
        if self.style is not None:
            self.style.set_rng_states(state["style"])
        if self.grain is not None:
            self.grain.restore(state["grain"])
        if self.hdr is not None and self.hdr.collector is not None:
            col = self.hdr.collector
            col.frames = [dict(f) for f in state["hdr10plus"]["frames"]]
            col._last_avg = state["hdr10plus"]["last_avg"]

    def __call__(self, out: np.ndarray, src_frames: Optional[np.ndarray]) -> np.ndarray:
        if self.style is not None:
            out = np.stack([self.style.enhance(f) for f in out])
        if self.grain is not None:
            out = self.grain(out, src_frames)
        if self.hdr is not None:
            out = np.stack([self.hdr.expand_frame(f) for f in out])
        return out


class VideoRestorer:
    def __init__(self, config: Optional[Config] = None,
                 progress_callback: Optional[Callable[[ProgressInfo], None]] = None,
                 events: Optional[EventBus] = None, hooks: Optional[HookManager] = None):
        self.config = config or Config()
        self.progress_callback = progress_callback
        self.events = events or EventBus()
        self.hooks = hooks or HookManager()
        self.checkpoints = CheckpointManager(self.config.checkpoint_dir,
                                             self.config.checkpoint_interval)
        self.context: Optional[PipelineContext] = None
        self.sr: Optional[SuperResolution] = None
        self._raft_pairs = 0      # RAFT pairs a denoiser step (the enhance stage's plan)
        self.auto_enhance: Optional[Dict] = None   # the auto-enhance overrides and analysis
        self.gap_filler: Optional[GapFiller] = None   # the pre-SR stream's, when it inserts
        self.stage = ""           # the stage running (a progress callback may read it)
        if self.config.multihost:
            # the process group, before any work (JAX: jax.distributed)
            from framewright_tpu_torch.parallel.dcn import ensure_distributed

            ensure_distributed(backend="gloo" if self.config.device_platform == "cpu" else None)

    def _progress(self, stage: str, done: int, total: int, tracker: _EtaTracker) -> None:
        if self.progress_callback is None:
            return
        self.progress_callback(ProgressInfo(
            stage=stage, frames_done=done, total_frames=total,
            fps=round(tracker.fps, 2),
            eta_s=round(tracker.eta(max(total - done, 0)), 1),
            percent=round(100.0 * done / total, 1) if total else 0.0))

    def _resolve_output(self, source: Path) -> Path:
        """``output_path``, else ``<project_dir>/<stem>_restored`` with the
        source's suffix (``.y4m`` for a frame directory) or
        ``output_format``'s (``png``: a frame directory)."""
        cfg = self.config
        if cfg.output_path is not None:
            return cfg.output_path
        suffix = source.suffix if source.suffix else ".y4m"
        if cfg.output_format not in ("auto", ""):
            suffix = "." + cfg.output_format if cfg.output_format != "png" else ""
        return cfg.project_dir / (source.stem + "_restored" + suffix)

    def _missing_weights(self) -> List[str]:
        """The checkpoints the restore needs and the weights directory lacks."""
        wdir = Path(self.config.weights_dir or default_weights_dir())
        return [str(wdir / f"{n}.npz") for n in required_weights(self.config)
                if aux_path(n, wdir) is None]

    def _check_weights(self) -> None:
        """``InputError`` naming every checkpoint the restore needs and
        the weights directory lacks, before any compute."""
        missing = self._missing_weights()
        if missing:
            raise InputError(f"missing checkpoints: {', '.join(missing)} (the port reads "
                             "user weights only, in the JAX package's .npz layout)")

    def _build_pipeline(self, restored: List[str]) -> Pipeline:
        """The JAX restorer's stages, dependencies and flags
        (``framewright_tpu/restorer.py:164-186``)."""
        cfg = self.config
        return (PipelineBuilder("restore")
                .events(self.events)
                .hooks(self.hooks)
                .stage("probe", self._stage_probe)
                .stage("checkpoint", self._stage_checkpoint, depends_on=("probe",),
                       enabled=cfg.checkpoint_enabled)
                .stage("dedup", self._stage_dedup, depends_on=("probe",),
                       enabled=cfg.deduplicate)
                .stage(_ENHANCE, self._stage_enhance, depends_on=("probe",),
                       max_retries=cfg.stage_max_retries)
                .stage(_INTERPOLATE, self._stage_interpolate, depends_on=(_ENHANCE,),
                       enabled=cfg.interpolation)
                .stage("validate", self._stage_validate, depends_on=(_ENHANCE,),
                       enabled=cfg.validate_output, critical=False)
                .stage("finalize", self._stage_finalize, depends_on=(_ENHANCE,))
                .restore_completed(restored)
                .build())

    def restore_video(self, source, output=None) -> RestoreResult:
        cfg = self.config
        source = Path(source)
        if not source.exists():
            raise InputError(f"source not found: {source}")
        if cfg.auto_enhance:
            cfg = self.config = self._apply_auto_enhance(source)
        out_path = Path(output) if output else self._resolve_output(source)
        t0 = time.time()
        ctx = self.context = PipelineContext({"source": source, "output": out_path})
        restored: List[str] = []
        if not cfg.dry_run:
            self._check_weights()
            enhanced = self._enhanced_intermediate(source)
            if enhanced is not None:
                # a rerun of a run killed in the interpolate stage: the
                # intermediate is whole, dedup and enhance are not run again
                logger.info("enhance stage completed earlier: resuming at interpolation")
                ctx.update(enhanced)
                restored = [_ENHANCE] + (["dedup"] if cfg.deduplicate else [])
        pipeline = self._build_pipeline(restored)
        if cfg.dry_run:
            return self._dry_run(ctx, pipeline, out_path)
        guard = SafeguardLoop(cfg.project_dir, self.events)
        guard.start()
        try:
            with KeepAwake():
                pipeline.run(ctx)
        except StageError as exc:
            raise self._stage_exception(pipeline, exc)
        finally:
            guard.stop()
        # the gate's failure under continue_on_error=False, after finalize
        self._raise_failed_gate(pipeline)
        data = ctx.data
        result = RestoreResult(
            out_path, data["frames_in"], data["frames_out"], time.time() - t0,
            data["batches"], data["batch_size"], data.get("quality_report"),
            data["frame_errors"], data["resumed_from"], pipeline.summary(),
            data.get("pre_sr", {}), data.get("dedup_result"), data.get("post_sr", {}),
            data.get("output_fps", float(data["fps"])), data.get("interpolation_result"),
            data.get("faces_restored"))
        if cfg.quality_report_format != "none" and result.quality is not None:
            try:
                from framewright_tpu_torch.reports import build_qa_report

                rp = cfg.project_dir / ("qa_report." + cfg.quality_report_format)
                build_qa_report(result, str(source)).save(rp)
                logger.info("QA report -> %s", rp)
            except Exception:  # noqa: BLE001 - reporting never fails a job
                logger.exception("QA report generation failed")
        return result

    def _apply_auto_enhance(self, source: Path) -> Config:
        """The config with the stages the content analysis of the source
        recommends (JAX ``restorer.py:270-292``): ``recommend_settings``
        when ``auto_detect_content``, never the output's geometry
        (``scale_factor``, ``sr_model``), ``grain_preserve`` when the grain
        level passes 0.3. The checkpoint follows the new config's hash."""
        from framewright_tpu_torch.processors.analysis import ContentAnalyzer, recommend_settings

        cfg = self.config
        with open_reader(source) as r:
            rep = ContentAnalyzer().analyze(iter(r))
        rec = recommend_settings(rep) if cfg.auto_detect_content else {}
        rec.pop("scale_factor", None)
        rec.pop("sr_model", None)
        if rep.grain_level > 0.3:
            rec.setdefault("grain_preserve", True)
        logger.info("auto-enhance: %s (analysis: %s)", rec or "no changes", rep.to_dict())
        self.auto_enhance = {"overrides": dict(rec), "analysis": rep.to_dict()}
        return cfg.with_overrides(**rec) if rec else cfg

    @staticmethod
    def _stage_exception(pipeline: Pipeline, exc: StageError) -> BaseException:
        """The failed stage's own error (the engine's ``StageError`` when it
        has none)."""
        for s in pipeline.stages:
            if s.status is StageStatus.FAILED and s.exception is not None:
                return s.exception
        return exc

    @staticmethod
    def _raise_failed_gate(pipeline: Pipeline) -> None:
        for s in pipeline.stages:
            if s.name == "validate" and s.status is StageStatus.FAILED:
                raise s.exception

    def _dry_run(self, ctx: PipelineContext, pipeline: Pipeline, out_path: Path) -> RestoreResult:
        """The plan without processing (the probe and the preflight, which
        raises on a blocker): nothing is written, no checkpoint opened, no
        card memory taken."""
        cfg = self.config
        ctx.update(self._stage_probe(ctx.data))
        d = ctx.data
        scale = get_model(cfg.sr_model).scale
        plan = {
            "stages": [s.name for s in pipeline.stages if s.enabled],
            "input": f"{d['width']}x{d['height']}@{float(d['fps']):.2f} "
                     f"({d['frames_in']} frames)",
            "output": f"{d['width'] * scale}x{d['height'] * scale} -> {out_path}",
            "model": cfg.sr_model,
            "preflight": d["preflight"],
            "missing_weights": self._missing_weights(),
        }
        logger.info("dry run: %s", plan)
        return RestoreResult(out_path, d["frames_in"], 0, 0.0,
                             stage_summary={"dry_run": plan})

    def cancel(self) -> None:
        if self.context:
            self.context.cancel()

    def pause(self) -> None:
        if self.context:
            self.context.pause()

    def resume(self) -> None:
        if self.context:
            self.context.resume()

    # -- stages ----------------------------------------------------------
    def _stage_probe(self, data: Dict) -> Dict:
        self.stage = "probe"
        meta = probe(data["source"])
        total, h, w, fps = meta.nb_frames, meta.height, meta.width, meta.fps
        if w <= 0 or total <= 0:
            raise InputError(f"empty or unreadable video: {data['source']}")
        if self.config.max_frames:
            total = min(total, self.config.max_frames)
        # blockers stop the restore before any card work; warnings are
        # logged and kept for the report
        pf = preflight_check(self.config, data["source"],
                             meta=dataclasses.replace(meta, nb_frames=total))
        for warn in pf.warnings:
            logger.warning("preflight: %s", warn)
        if not pf.ok:
            raise InputError("preflight blocked: " + "; ".join(pf.blockers))
        return {"frames_in": total, "height": h, "width": w, "fps": fps,
                "preflight": pf.to_dict()}

    def _stage_checkpoint(self, data: Dict) -> Dict:
        self.stage = "checkpoint"
        ck = self.checkpoints.start(data["source"], self.config.get_hash(),
                                    total_frames=data["frames_in"])
        if ck.frames_done:
            self.events.emit(EventType.CHECKPOINT_RESTORED, stage=next(reversed(ck.frames_done)),
                             frames=dict(ck.frames_done))
        return {"checkpoint": ck}

    def _stage_dedup(self, data: Dict) -> Dict:
        """One decode pass of the first ``frames_in`` frames: the dedup
        analysis, and the long-form anchors teed off the same frames."""
        self.stage = "dedup"
        cfg = self.config
        total = data["frames_in"]
        dedup = FrameDeduplicator(DedupConfig(similarity_threshold=cfg.dedup_similarity,
                                              hash_size=cfg.dedup_hash_size))
        out: Dict = {}
        with open_reader(data["source"]) as reader:
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

    def _post_sr(self) -> Optional["_PostSR"]:
        """The post-SR work of the config, or None: guided enhancement
        (``sr_prompt``, ``sr_style_preset``, ``reference_images_dir``),
        grain (``grain_mode`` resolved as the JAX restorer does) and the
        HDR expansion (``hdr_output``)."""
        cfg = self.config
        mode = cfg.grain_mode
        if mode == "auto":
            mode = "match" if cfg.grain_preserve else "off"
        elif mode == "preserve":
            mode = "match"
        grain = None if mode == "off" else _PostSRGrain(
            GrainManager(mode=mode, strength=cfg.grain_strength, seed=cfg.seed),
            cfg.grain_target)
        style = None
        if cfg.sr_prompt or cfg.sr_style_preset or cfg.reference_images_dir:
            style = make_backend(
                GuidedConfig(prompt=cfg.sr_prompt, preset=cfg.sr_style_preset,
                             strength=(cfg.reference_strength if cfg.reference_images_dir
                                       else 0.8),
                             guidance_scale=cfg.guidance_scale, seed=cfg.seed,
                             device=_device(cfg),
                             weights_dir=str(cfg.weights_dir) if cfg.weights_dir else None),
                reference_dir=(str(cfg.reference_images_dir) if cfg.reference_images_dir
                               else None))
        hdr = None
        if cfg.hdr_output in ("hdr10", "hdr10plus", "hlg"):
            hdr = HDRConverter(HDRConfig(mode="expand", target=cfg.hdr_output,
                                         peak_nits=cfg.hdr_peak_nits,
                                         highlight_boost=cfg.hdr_highlight_boost))
        if grain is None and style is None and hdr is None:
            return None
        return _PostSR(style, grain, hdr)

    def _resume_point(self, keep: int, batch: int, mapping: Optional[Dict[int, int]],
                      post: Optional["_PostSR"], smap: _StreamMap) -> int:
        """The largest batch start <= ``keep`` a resume can start from
        with the straight run's bytes: under a mapping a source frame (not
        one the gap filler inserted) that is a unique frame, and one whose
        post-SR generators' state the checkpoint carries under grain or
        guided enhancement; else 0. Restores that state there."""
        carry = ({int(k): v for k, v in self.checkpoints.checkpoint.carry.items()}
                 if post is not None else {})
        for r in range(keep - keep % batch, 0, -batch):
            src, inserted = smap.source_of(r)
            if mapping is not None and (inserted or mapping.get(src) == mapping[src - 1]):
                continue
            if post is not None:
                if r not in carry:
                    continue
                post.restore(carry[r])
            return r
        return 0

    def _open_output(self, path: Path, ow: int, oh: int, fps, resume_from: int, unit: int,
                     resume_point: Callable[[int], int] = lambda keep: keep):
        """(writer, the frame the run starts at): ``path`` opened for the
        format of its suffix (``open_writer``); on a resume a Y4M file is
        cut to and a frame directory continued after R = ``resume_point``
        of its whole frames on disk (at most ``resume_from``) rounded down
        to ``unit``; an ffmpeg output is written anew (R = 0)."""
        on_disk = None
        if resume_from and is_frame_dir(path):
            on_disk = whole_frames(path)
        elif resume_from and path.suffix.lower() == ".y4m" and path.is_file():
            with Y4MReader(path) as r:
                on_disk = r.count_frames()
        elif resume_from and path.suffix.lower() != ".y4m":
            logger.info("%s cannot be appended to: writing it from frame 0", path.name)
        keep = resume_point(min(resume_from, on_disk) // unit * unit) if on_disk else 0
        if not keep:
            cfg = self.config
            return open_writer(path, ow, oh, fps=fps, codec=cfg.codec, crf=cfg.crf,
                               preset=cfg.encode_preset, pix_fmt=cfg.pixel_format), 0
        if is_frame_dir(path):
            return FrameDirWriter(path, fps=fps, start_index=keep + 1), keep
        writer = Y4MWriter(path, ow, oh, fps=fps, append=True, keep_frames=keep)
        return writer, writer.frames_written

    def _stage_enhance(self, data: Dict) -> Dict:
        self.stage = _ENHANCE
        cfg = self.config
        total, h, w = data["frames_in"], data["height"], data["width"]
        checkpointed = "checkpoint" in data
        dedup: Optional[DedupResult] = data.get("dedup_result")
        vsr = get_model(cfg.sr_model).family in VSR_FAMILIES
        # a recurrent video SR model sees every frame in order: the dedup
        # mapping is bypassed (JAX restorer.py:365-383)
        mapping = dedup.frame_mapping if dedup is not None and not vsr else None
        # interpolation after a lower cadence found by dedup: the duplicates
        # are dropped and the intermediate holds the unique frames at the
        # estimated source rate (the JAX restorer skips resume then)
        drop = bool(cfg.interpolation and dedup is not None and dedup.duplicates > 0
                    and not vsr
                    and 0 < dedup.estimated_source_fps < float(data["fps"]) - 1e-3)
        write_fps = dedup.estimated_source_fps if drop else data["fps"]
        out_path = cfg.work_dir / "enhanced.y4m" if cfg.interpolation else data["output"]
        resume_from = (self.checkpoints.resume_point(_ENHANCE)
                       if checkpointed and cfg.resume and not drop else 0)
        post = self._post_sr()
        self._raft_pairs = raft_pairs(cfg, h, w)
        reserve = (pre_sr_reserve(cfg, h, w, self._raft_pairs)
                   + face_reserve(cfg, *output_size(cfg, h, w)))
        sr = self.sr = build_sr(cfg, reserve)
        tracker = _EtaTracker()
        written = frame_errors = batch_size = 0
        budget_hit = False
        pre_sr: Dict = {"auto_enhance": self.auto_enhance} if self.auto_enhance else {}
        faces: Optional[FaceRestorer] = None
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
            batch_size = max(1, min(sr.plan.frames, total))
            if cfg.face_restore:
                faces = FaceRestorer(FaceRestoreConfig(
                    strength=cfg.face_strength, backend=cfg.face_model,
                    weights_dir=str(cfg.weights_dir) if cfg.weights_dir else None,
                    device=_device(cfg), fidelity_weight=cfg.face_fidelity))
                faces.setup(oh, ow)
                stack.callback(faces.teardown)
            # stream positions to source frames: from the checkpoint's inserted
            # positions until the stream runs again
            smap = _StreamMap(self.checkpoints.checkpoint.stage_state.get(_GAP_FILL, ())
                              if checkpointed and resume_from else ())
            # cut the output to R = min(checkpoint, whole frames in it),
            # rounded down to a whole batch (and back to a unique frame or a
            # carried grain state): every frame then runs in the batch it had
            # in a straight run, so the output is the straight run's (the
            # CPU's plain convolutions may round a frame differently in
            # another batch)
            writer, resume_from = self._open_output(
                out_path, ow, oh, write_fps, resume_from, batch_size,
                lambda keep: self._resume_point(keep, batch_size, mapping, post, smap))
            if resume_from:
                logger.info("resuming enhance at frame %d", resume_from)
            # the writer's own exit: an ffmpeg encode is killed, not
            # finalised, when the stage fails
            stack.enter_context(writer)
            written = resume_from
            validator = (QualityValidator(cfg.min_psnr, cfg.min_ssim, min_vmaf=cfg.min_vmaf,
                                          first_frame=resume_from, device=_device(cfg))
                         if cfg.validate_output else None)
            reader = stack.enter_context(open_reader(data["source"]))
            pre_sr["host_codec"] = {"decode": getattr(reader, "codec", type(reader).__name__),
                                    "encode": getattr(writer, "codec", type(writer).__name__)}
            # a mapping repeats RGB outputs, and grain and faces change them
            # on the host: each takes the RGB path; so does the VMAF gate,
            # which scores sampled RGB pairs
            yuv_direct = (hasattr(writer, "write_yuv_frame") and hasattr(sr, "set_output_color")
                          and not cfg.outscale
                          and writer.header.colorspace.startswith("420")
                          and oh % 2 == 0 and ow % 2 == 0
                          and mapping is None and post is None and faces is None
                          and (validator is None or cfg.min_vmaf <= 0))
            if yuv_direct:
                sr.set_output_color("yuv420", full_range=writer.full_range)
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
                data, itertools.islice(iter(reader), total), pre_sr, smap)
            context: List[np.ndarray] = []
            if vsr and resume_from:
                # the overlap frames before the resume point seed the
                # video SR's carry, as a straight run carries them
                stream = _tee_range(stream, max(0, resume_from - sr.config.overlap),
                                    resume_from, context)
            ring = PrefetchRing(on_stream(stream, side_stream(sr.device)),
                                batch_size=batch_size, skip_frames=resume_from,
                                start_frame=resume_from)
            stack.callback(ring.close)
            # the unique position of the last frame SR ran on, and its output
            # (a resume under a mapping starts at a source frame: the frame
            # before it in the source is the last SR ran on)
            last_unique = (mapping[smap.source_of(resume_from)[0] - 1]
                           if mapping and resume_from else -1)
            last_out: Optional[np.ndarray] = None
            carry: Dict[str, Dict] = {}

            def inserted_so_far() -> int:
                return self.gap_filler.report.frames_inserted if self.gap_filler else 0

            def resumable(pos: int) -> bool:
                """Whether stream frame ``pos`` is a source frame new to the
                mapping (a resume may start there)."""
                src, ins = smap.source_of(pos)
                return not ins and mapping[src] > mapping[src - 1]

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
                       work: np.ndarray, inserted: List[bool]) -> None:
                nonlocal written, last_out
                n = len(frames)
                nxt = start + n
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
                    if drop:                            # the unique frames only
                        frames, n = work, len(work)
                    elif mapping is not None:
                        # the unique frames' outputs back at every position (an
                        # inserted frame's is its own: it repeats no source frame)
                        outs, k = [], 0
                        for pos in range(n):
                            if k < len(unique_sel) and unique_sel[k] == pos:
                                k += 1
                                if inserted[pos]:
                                    outs.append(out[k - 1])
                                    continue
                                last_out = out[k - 1]
                            outs.append(last_out)   # a resume starts at a unique frame
                        out = np.stack(outs)
                    if faces is not None and n:
                        out = np.stack([faces.restore_frame(f) for f in out])
                    if validator is not None and ok:
                        for i in range(n):
                            validator.observe(frames[i], out[i])
                    if post is not None and n:
                        # after the gate: guided style and grain are intended changes
                        out = post(out, work if len(work) else None)
                        if smap.known(nxt) and nxt < total + inserted_so_far() and (
                                mapping is None or resumable(nxt)):
                            carry[str(nxt)] = post.state()
                            for key in list(carry)[:-_CARRY_POINTS]:
                                del carry[key]
                            if checkpointed:
                                self.checkpoints.checkpoint.carry = dict(carry)
                if n:
                    drain.submit(out, n)
                written += n
                tracker.tick(n)
                if checkpointed:
                    self.checkpoints.frames_completed(_ENHANCE, written)
                self.events.emit(EventType.FRAME_PROCESSED, frames=written)
                if checkpointed and self.gap_filler is not None:
                    self.checkpoints.checkpoint.stage_state[_GAP_FILL] = smap.inserted_positions()
                # the total grows by each frame the gap filler inserts
                self._progress(_ENHANCE, written, inserted_so_far()
                               + (dedup.unique_frames if drop else total), tracker)

            deadline = (time.time() + cfg.max_runtime_minutes * 60.0
                        if cfg.max_runtime_minutes > 0 else None)
            # one batch in flight: batch N+1 is enqueued on the card before
            # batch N is copied back and handed to the writer
            pending = None
            for batch in ring:
                self.context.checkpoint_wait()      # pause / cancel between batches
                if deadline is not None and time.time() > deadline:
                    budget_hit = True
                    logger.warning("runtime budget (%.1f min) reached at frame %d; "
                                   "stopping: rerun to resume", cfg.max_runtime_minutes,
                                   written)
                    break
                frames = batch.frames[: batch.valid]
                start = batch.start_frame
                if vsr and resume_from and start == resume_from:
                    sr.seed_context(context)
                inserted = [smap.source_of(start + pos)[1] for pos in range(len(frames))]
                if mapping is not None:
                    # SR on the frames of a unique source frame not seen yet,
                    # and on every frame the gap filler inserted
                    unique_sel = []
                    for pos in range(len(frames)):
                        if inserted[pos]:
                            unique_sel.append(pos)
                            continue
                        u = mapping[smap.source_of(start + pos)[0]]
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
                pending = (handle, ok, frames, start, unique_sel, work, inserted)
            if pending is not None:
                finish(*pending)
        finish_pre_sr()
        self._write_hdr10plus(post, out_path)
        if budget_hit:
            raise FatalError(f"runtime budget reached after {written} frames; "
                             "rerun the same command to resume")
        out = {"frames_out": written, "frame_errors": frame_errors,
               "resumed_from": resume_from, "pre_sr": pre_sr, "validator": validator,
               "batches": sr.dispatches, "batch_size": batch_size,
               "post_sr": self._post_sr_info(post),
               "faces_restored": faces.result.faces_restored if faces is not None else None}
        if cfg.interpolation:
            # the gate is scored here, so that the checkpoint keeps its
            # report and the errors with the intermediate: a rerun that
            # resumes at interpolation reports what a straight run does
            out.update(enhanced_path=str(out_path), out_size=[oh, ow],
                       enhanced_fps=float(write_fps), enhanced_frames=written,
                       validator=None,
                       quality_report=validator.validate() if validator is not None else None)
        if checkpointed:
            if cfg.interpolation:       # what the interpolate stage reads on a rerun
                st = {k: out[k] for k in ("enhanced_path", "out_size", "enhanced_fps",
                                          "enhanced_frames", "frame_errors", "resumed_from",
                                          "faces_restored", "pre_sr", "post_sr")}
                rep = out["quality_report"]
                st["quality_report"] = dataclasses.asdict(rep) if rep is not None else None
                # the dedup counts; the mapping, read by the enhance stage
                # only, is left out
                st["dedup_result"] = (None if dedup is None else dataclasses.asdict(
                    dataclasses.replace(dedup, unique_indices=[], frame_mapping={})))
                self.checkpoints.checkpoint.stage_state[_ENHANCE] = st
            self.checkpoints.stage_completed(_ENHANCE)
        return out

    @staticmethod
    def _write_hdr10plus(post: Optional[_PostSR], out_path: Path) -> None:
        """The HDR10+ (ST 2094-40) metadata sidecar beside the enhance
        stage's output, ``<output>.hdr10plus.json`` (JAX
        ``restorer.py:936-943``)."""
        col = post.hdr.collector if post is not None and post.hdr is not None else None
        if col is None or not col.frames:
            return
        sidecar = Path(str(out_path) + ".hdr10plus.json")
        sidecar.write_text(col.to_json())
        logger.info("HDR10+ metadata: %d scenes -> %s", len(col.scenes()), sidecar)

    def _post_sr_info(self, post: Optional[_PostSR]) -> Dict:
        """What the post-SR work did: grain's mode and target, the guided
        style vector."""
        info: Dict = {}
        if post is not None and post.grain is not None:
            info["grain"] = {"mode": post.grain.gm.mode, "target": post.grain.target}
        if post is not None and post.hdr is not None:
            col = post.hdr.collector
            info["hdr"] = {"target": post.hdr.config.target,
                           "peak_nits": post.hdr.config.peak_nits,
                           "scenes": len(col.scenes()) if col is not None else None}
        if post is not None and post.style is not None:
            cfg = self.config
            info["guided"] = {"prompt": cfg.sr_prompt, "preset": cfg.sr_style_preset,
                              "reference_dir": (str(cfg.reference_images_dir)
                                                if cfg.reference_images_dir else None)}
        return info

    def _enhanced_intermediate(self, source: Path) -> Optional[Dict]:
        """On a rerun whose checkpoint (read, not opened:
        ``CheckpointManager.peek``) says the enhance stage completed and
        whose intermediate is whole: what the interpolate stage reads, and
        the enhance stage's gate report, errors and resume point, for an
        enhance stage with nothing left to do; else None."""
        cfg = self.config
        if not (cfg.interpolation and cfg.resume and cfg.checkpoint_enabled):
            return None
        ck = self.checkpoints.peek(source, cfg.get_hash())
        st = ck.stage_state.get(_ENHANCE) if ck is not None else None
        if not st or _ENHANCE not in ck.completed_stages:
            return None
        path = Path(st["enhanced_path"])
        if path != cfg.work_dir / "enhanced.y4m" or not path.is_file():
            return None
        with Y4MReader(path) as r:
            if r.count_frames() != st["enhanced_frames"]:
                return None
        rep, dd = st["quality_report"], st["dedup_result"]
        return {**st, "frames_out": st["enhanced_frames"], "batches": 0, "batch_size": 0,
                "quality_report": QualityReport(**rep) if rep is not None else None,
                "dedup_result": DedupResult(**dd) if dd is not None else None}

    def _stage_interpolate(self, data: Dict) -> Dict:
        """Stream the intermediate through the interpolator into the
        output at ``factor`` times its rate; on a rerun, resume at a whole
        step of pairs (the checkpoint's pair batch)."""
        self.stage = _INTERPOLATE
        cfg = self.config
        src = Path(data["enhanced_path"])
        oh, ow = data["out_size"]
        src_fps = data["enhanced_fps"]
        factor = interpolation_factor(src_fps, cfg.target_fps)
        out_fps = src_fps * factor
        checkpointed = "checkpoint" in data
        state = (self.checkpoints.checkpoint.stage_state.get(_INTERPOLATE)
                 if checkpointed and cfg.resume else None)
        pairs = (state["pairs"] if state else
                 planner.interpolation_pairs(oh, ow, _free_bytes(_device(cfg)),
                                             cfg.hbm_utilization, max_pairs=4))
        if checkpointed:
            self.checkpoints.checkpoint.stage_state[_INTERPOLATE] = {"pairs": pairs}
        done = (self.checkpoints.resume_point(_INTERPOLATE)
                if checkpointed and cfg.resume else 0)
        writer, keep = self._open_output(data["output"], ow, oh, out_fps, done, factor * pairs)
        if keep:
            logger.info("resuming interpolation at output frame %d", keep)
        interp = FrameInterpolator(InterpolationConfig(
            model_name=cfg.interpolation_model, target_fps=cfg.target_fps,
            scene_change_threshold=cfg.scene_threshold,
            scene_change_skip=cfg.scene_change_skip, batch_pairs=pairs,
            weights_dir=str(cfg.weights_dir) if cfg.weights_dir else None,
            device=_device(cfg)))
        n = keep
        est_total = (data["enhanced_frames"] - 1) * factor + 1
        tracker = _EtaTracker()
        try:
            with writer, open_reader(src) as reader:
                interp.setup(oh, ow)
                frames = itertools.islice(iter(reader), keep // factor, None)
                for frame in interp.interpolate_to_fps(frames, src_fps):
                    writer.write_frame(frame)
                    n += 1
                    tracker.tick()
                    if checkpointed:
                        self.checkpoints.frames_completed(_INTERPOLATE, n)
                    self._progress(_INTERPOLATE, n, est_total, tracker)
        finally:
            interp.teardown()
            if checkpointed:
                self.checkpoints.force_save()
        if not cfg.keep_intermediates:
            src.unlink(missing_ok=True)
        if checkpointed:
            self.checkpoints.stage_completed(_INTERPOLATE)
        res = interp.result
        return {"frames_out": n, "output_fps": out_fps,
                "interpolation_result": {"frames_in": keep // factor + res.frames_in,
                                         "frames_out": n, "factor": factor,
                                         "scene_skips": res.scene_skips,
                                         "output_fps": out_fps, "pairs_per_step": pairs,
                                         "resumed_from": keep}}

    def _longform_active(self, nb_frames: int) -> bool:
        cfg = self.config
        if cfg.long_form == "on":
            return True
        if cfg.long_form == "off":
            return False
        return nb_frames >= cfg.long_form_threshold

    def _pre_sr_stream(self, data: Dict, frames: Iterator[np.ndarray], info: Dict,
                       smap: Optional[_StreamMap] = None):
        """The frames of the source from 0 through the pre-SR stages, in
        the JAX order (drift correction, deinterlacing, VHS repair, defect
        repair, gap filling, stabilization, watermark or subtitle
        inpainting, colorization, QP removal, denoising, temporal
        consistency, the scene-adaptive filter) -> (stream, finish):
        ``finish()`` adds the stages' results to ``info`` once the stream
        has run. The gap filler is ``self.gap_filler`` and ``smap``'s (a
        new map when None); the scene-adaptive filter reads each frame's
        segment by its source frame."""
        cfg = self.config
        total = data["frames_in"]
        if self._longform_active(total):
            anchors = data.get("anchors")             # teed off the dedup pass
            if anchors is None:
                with open_reader(data["source"]) as ar:
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
            with open_reader(data["source"]) as r:
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
        dev = _device(cfg)
        if cfg.vhs_restore:
            info["vhs"] = {"tracking": cfg.vhs_fix_tracking, "dropouts": cfg.vhs_fix_dropouts,
                           "chroma": cfg.vhs_fix_chroma, "dot_crawl": cfg.vhs_fix_dot_crawl}
            frames = VHSProcessor(VHSConfig(
                fix_tracking_lines=cfg.vhs_fix_tracking, fix_dropouts=cfg.vhs_fix_dropouts,
                reduce_chroma_bleed=cfg.vhs_fix_chroma, reduce_dot_crawl=cfg.vhs_fix_dot_crawl,
                tracking_threshold=cfg.vhs_tracking_threshold)).process_stream(frames)
        repairer = None
        if cfg.defect_repair:
            repairer = DefectRepairer(scratch_threshold=cfg.defect_scratch_sensitivity,
                                      dust_threshold=cfg.defect_dust_sensitivity)
            frames = repairer.process_stream(frames)
        smap = smap if smap is not None else _StreamMap()
        self.gap_filler = smap.filler = None
        if cfg.fill_missing_frames:
            self.gap_filler = smap.filler = GapFiller(
                jump_ratio=cfg.gap_jump_ratio, scene_change_threshold=cfg.scene_threshold,
                device=dev)
            self.gap_filler.setup(data["height"], data["width"])   # before any frame
            frames = self.gap_filler.process_stream(frames)
        stabilizer = None
        if cfg.stabilize:
            stabilizer = VideoStabilizer(StabilizeConfig(
                smoothing=cfg.stabilize_smoothing, crop_ratio=cfg.stabilize_crop,
                estimate_rotation=cfg.stabilize_rotation))
            frames = stabilizer.process_stream(frames)
        remover = None
        if _inpaints(cfg):
            cls = SubtitleRemover if cfg.subtitle_removal else WatermarkRemover
            remover = cls(InpaintConfig(
                method="diffusion" if _inpaint_method(cfg) == "heat" else "lama",
                auto_detect=cfg.watermark_auto_detect,
                custom_masks=list(cfg.watermark_regions),
                weights_dir=str(cfg.weights_dir) if cfg.weights_dir else None, device=dev))
            remover.setup()                   # LaMa's checkpoint, before any frame
            frames = remover.process_stream(frames)
        if cfg.colorize:
            colorizer = Colorizer(ColorizeConfig(
                method=cfg.colorize_model, scene_change_threshold=cfg.scene_threshold,
                saturation=cfg.colorize_saturation,
                keyframe_interval=cfg.colorize_keyframe_interval,
                weights_dir=str(cfg.weights_dir) if cfg.weights_dir else None, device=dev))
            colorizer.setup()                 # the checkpoint, before any frame
            info["colorize"] = {"method": cfg.colorize_model}
            frames = colorizer.colorize_stream(frames)
        if cfg.qp_removal:
            info["qp_removal"] = {"strength": cfg.qp_strength}
            frames = QPArtifactRemover(QPRemovalConfig(strength=cfg.qp_strength),
                                       device=dev).process_stream(frames)
        denoiser = None
        if cfg.denoise:
            denoiser = TemporalDenoiser(TemporalDenoiseConfig(
                radius=(cfg.temporal_window - 1) // 2, strength=cfg.denoise_strength,
                method=_denoise_method(cfg), scene_change_threshold=cfg.scene_threshold,
                flow_model=cfg.flow_model, flow_pairs=self._raft_pairs,
                weights_dir=str(cfg.weights_dir) if cfg.weights_dir else None,
                device=dev))
            denoiser.setup(data["height"], data["width"])
            frames = denoiser.denoise_stream(frames)
        if cfg.temporal_consistency:
            info["temporal_consistency"] = cfg.temporal_model
            if cfg.temporal_model == "attention":
                frames = CrossFrameAttention(CFAConfig(radius=1),
                                             device=dev).reduce_stream(frames)
            elif cfg.temporal_model == "latent":
                frames = LatentTemporalSmoother(device=dev).reduce_stream(frames)
            else:
                frames = FlickerReducer().reduce_stream(frames)
        adaptive = None
        if cfg.scene_adaptive:
            # one sampled decode pass over the source builds the content map
            si = SceneIntelligence(sample_every=24,
                                   weights_dir=str(cfg.weights_dir) if cfg.weights_dir else None,
                                   device=dev)
            with open_reader(data["source"]) as r:
                pmap = si.generate_processing_map(
                    si.analyze_video(itertools.islice(iter(r), total)))
            info["scene_adaptive"] = {"segments": len(pmap)}
            if pmap:
                adaptive = SceneAdaptiveFilter(pmap)
                frames = adaptive.process_stream(
                    frames, None if self.gap_filler is None else lambda p: smap.source_of(p)[0])
                logger.info("scene-adaptive map: %d segments", len(pmap))

        def finish() -> None:
            if repairer is not None:
                info["defect_repair"] = dataclasses.asdict(repairer.report)
            if self.gap_filler is not None:
                info["fill_missing_frames"] = dataclasses.asdict(self.gap_filler.report)
            if stabilizer is not None:
                res = stabilizer.result
                info["stabilize"] = {"frames": res.frames, "scene_cuts": res.scene_cuts,
                                     "mean_correction_px": res.mean_correction_px,
                                     "max_correction_px": res.max_correction_px}
            if remover is not None:
                mask = remover.mask
                info["inpaint"] = {"method": remover.config.method,
                                   "mask_fraction": float(mask.mean()) if mask is not None
                                   else 0.0}
            if adaptive is not None:
                info["scene_adaptive"]["frames_adjusted"] = adaptive.frames_adjusted
            if denoiser is not None:
                info["denoise"] = {"method": denoiser.config.method,
                                   **denoiser.result.to_dict()}
                if isinstance(denoiser.flow_net, RAFTFlow):
                    info["denoise"]["flow_pairs"] = denoiser.flow_net.pairs

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
        """Gate the validator's report (scored here, or by the enhance
        stage when interpolation follows it)."""
        self.stage = "validate"
        validator: Optional[QualityValidator] = data.get("validator")
        report = validator.validate() if validator is not None else data.get("quality_report")
        if report is None:
            return {}
        if report.passed:
            self.events.emit(EventType.QUALITY_CHECK_PASSED, **report.to_dict())
        else:
            self.events.emit(EventType.QUALITY_CHECK_FAILED, **report.to_dict())
            logger.warning("quality gates failed: %s", report.to_dict())
            if not self.config.continue_on_error:
                raise ValidationError(f"quality gates failed: {report.to_dict()}",
                                      details=report.to_dict())
        return {"quality_report": report}

    def _stage_finalize(self, data: Dict) -> Dict:
        self.stage = "finalize"
        if "checkpoint" in data:
            self.checkpoints.complete()
        return {}
