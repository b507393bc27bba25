"""The port of ``framewright_tpu.processors.analysis``: numpy on the host,
as in JAX, op for op. Every override ``recommend_settings`` returns names
a field of the port's ``Config``.

Content analysis: degradation detection, quality scoring, auto-plan.

Capability parity with the reference's analysis stack
(processors/analyzer.py:1649 ContentType/DegradationType/ProcessingPlan
driving --auto-enhance; processors/analysis/{content_analyzer:315,
degradation_detector:213, quality_scorer:480}; noise_profiler.py:137;
upscale_detector.py:132 source-resolution estimation;
credits_detector.py:104): sampled-frame statistics -> a recommended
Config delta.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Iterator, List, Optional

import numpy as np

from framewright_tpu_torch.processors.film import estimate_grain_level
from framewright_tpu_torch.processors.format import combing_score

logger = logging.getLogger(__name__)


class ContentType(Enum):
    LIVE_ACTION = "live_action"
    ANIMATION = "animation"
    MIXED = "mixed"
    BW_FILM = "bw_film"


class DegradationType(Enum):
    NOISE = "noise"
    BLUR = "blur"
    COMPRESSION = "compression"
    INTERLACING = "interlacing"
    FADING = "fading"
    FLICKER = "flicker"
    LOW_RESOLUTION = "low_resolution"


@dataclass
class FrameStats:
    sharpness: float = 0.0
    noise: float = 0.0
    blockiness: float = 0.0
    saturation: float = 0.0
    brightness: float = 0.0
    contrast: float = 0.0
    edge_density: float = 0.0
    combing: float = 0.0


def analyze_frame(frame: np.ndarray) -> FrameStats:
    f = frame.astype(np.float32)
    g = f.mean(-1)
    # sharpness: Laplacian variance
    lap = (4 * g - np.roll(g, 1, 0) - np.roll(g, -1, 0)
           - np.roll(g, 1, 1) - np.roll(g, -1, 1))
    # noise: high-freq residual in flat regions (low-gradient mask)
    gx = np.abs(np.diff(g, axis=1, prepend=g[:, :1]))
    gy = np.abs(np.diff(g, axis=0, prepend=g[:1]))
    flat = (gx + gy) < 10.0
    noise = float(lap[flat].std() / 40.0) if flat.sum() > 100 else 0.0
    # blockiness: energy at 8-pixel grid boundaries vs elsewhere
    col_d = np.abs(np.diff(g, axis=1)).mean(axis=0)
    grid = col_d[7::8].mean() if len(col_d) >= 8 else 0.0
    nongrid = np.delete(col_d, np.s_[7::8]).mean() if len(col_d) >= 9 else 1.0
    mx = f.max(-1)
    mn = f.min(-1)
    return FrameStats(
        sharpness=float(np.clip(lap.var() / 2000.0, 0, 10)),
        noise=float(np.clip(noise, 0, 1)),
        blockiness=float(np.clip(grid / (nongrid + 1e-3) - 1.0, 0, 5)),
        saturation=float(((mx - mn) / (mx + 1e-3)).mean()),
        brightness=float(g.mean() / 255.0),
        contrast=float(g.std() / 128.0),
        edge_density=float((gx + gy > 40).mean()),
        combing=combing_score(frame),
    )


@dataclass
class AnalysisReport:
    content_type: ContentType = ContentType.LIVE_ACTION
    degradations: List[DegradationType] = field(default_factory=list)
    stats: FrameStats = field(default_factory=FrameStats)
    grain_level: float = 0.0
    estimated_source_height: int = 0
    flicker_score: float = 0.0
    quality_score: float = 0.0          # 0-100
    frames_sampled: int = 0
    noise_profile: object = None        # processors.noise_profiler.NoiseProfile

    def to_dict(self) -> Dict:
        return {
            "content_type": self.content_type.value,
            "degradations": [d.value for d in self.degradations],
            "quality_score": round(self.quality_score, 1),
            "grain_level": round(self.grain_level, 3),
            "estimated_source_height": self.estimated_source_height,
            "flicker_score": round(self.flicker_score, 3),
            "frames_sampled": self.frames_sampled,
            "noise_profile": (self.noise_profile.to_dict()
                              if self.noise_profile is not None else None),
        }


class ContentAnalyzer:
    def __init__(self, sample_every: int = 10, max_samples: int = 30):
        self.sample_every = sample_every
        self.max_samples = max_samples

    def analyze(self, frames_iter: Iterator[np.ndarray],
                height: int = 0) -> AnalysisReport:
        rep = AnalysisReport()
        stats: List[FrameStats] = []
        lumas: List[float] = []
        grains: List[float] = []
        sample_frames: List[np.ndarray] = []
        consec: List[np.ndarray] = []   # consecutive head frames for the
        for i, f in enumerate(frames_iter):  # temporal noise estimate
            lumas.append(float(f.mean()))
            if len(consec) < 9:
                consec.append(f)
            if i % self.sample_every:
                continue
            if len(stats) >= self.max_samples:
                continue
            stats.append(analyze_frame(f))
            grains.append(estimate_grain_level(f))
            if len(sample_frames) < 5:
                sample_frames.append(f)
        if not stats:
            return rep
        rep.frames_sampled = len(stats)

        def mean(attr):
            return float(np.mean([getattr(s, attr) for s in stats]))

        agg = FrameStats(**{k: mean(k) for k in FrameStats().__dict__})
        rep.stats = agg
        rep.grain_level = float(np.mean(grains))

        # full noise decomposition (reference noise_profiler.py:137):
        # consecutive head frames give the temporal component, spread
        # samples the spatial ones
        from framewright_tpu_torch.processors.noise_profiler import NoiseProfiler

        rep.noise_profile = NoiseProfiler().analyze_frames(
            consec + sample_frames)

        # content type
        if agg.saturation < 0.08:
            rep.content_type = ContentType.BW_FILM
        elif agg.edge_density > 0.22 and agg.noise < 0.1:
            rep.content_type = ContentType.ANIMATION
        else:
            rep.content_type = ContentType.LIVE_ACTION

        # flicker: oscillation of global luma
        if len(lumas) > 4:
            diffs = np.abs(np.diff(lumas))
            rep.flicker_score = float(np.clip(diffs.mean() / 12.0, 0, 1))

        # upscale detection: effective resolution from frequency falloff
        if sample_frames:
            rep.estimated_source_height = estimate_source_height(sample_frames[0])

        degr = []
        if agg.noise > 0.25 or rep.grain_level > 0.4:
            degr.append(DegradationType.NOISE)
        if agg.sharpness < 0.15:
            degr.append(DegradationType.BLUR)
        if agg.blockiness > 0.5:
            degr.append(DegradationType.COMPRESSION)
        if agg.combing > 0.55:
            degr.append(DegradationType.INTERLACING)
        if rep.flicker_score > 0.4:
            degr.append(DegradationType.FLICKER)
        if agg.contrast < 0.3 and agg.saturation < 0.25 and rep.content_type != ContentType.BW_FILM:
            degr.append(DegradationType.FADING)
        if height and rep.estimated_source_height and \
                rep.estimated_source_height < 0.75 * height:
            degr.append(DegradationType.LOW_RESOLUTION)
        rep.degradations = degr

        # quality score 0-100
        penalty = (
            25 * min(agg.noise, 1.0) + 20 * min(agg.blockiness, 1.0)
            + 20 * max(0.0, 0.3 - agg.sharpness) / 0.3
            + 15 * rep.flicker_score + 10 * max(0.0, agg.combing - 0.5)
        )
        rep.quality_score = float(np.clip(100 - penalty, 0, 100))
        return rep


def estimate_source_height(frame: np.ndarray) -> int:
    """Estimate true content resolution from the radial frequency
    cutoff (reference upscale_detector.py: upscaled content lacks
    energy above the source Nyquist)."""
    g = frame.astype(np.float32).mean(-1)
    h = g.shape[0]
    spec = np.abs(np.fft.rfft(g - g.mean(), axis=0)[: h // 2])
    prof = spec.mean(axis=1)
    if prof.max() <= 0:
        return h
    # frequency below which 95% of spectral energy lives: native
    # content ~0.9+, k-times-upscaled content ~1/k
    energy = np.cumsum(prof ** 2)
    energy = energy / energy[-1]
    cutoff = float(np.searchsorted(energy, 0.95)) / (h / 2)
    est = int(h * min(1.0, cutoff * 1.1))
    # snap to common heights
    for std in (2160, 1440, 1080, 720, 576, 480, 360, 240):
        if abs(est - std) < 0.15 * std:
            return std
    return est


class CreditsDetector:
    """Detect credit/title segments: mostly-dark frames with high-contrast
    text edges (reference credits_detector.py:104)."""

    def __init__(self, dark_threshold: float = 60.0, edge_threshold: float = 0.02):
        self.dark_threshold = dark_threshold
        self.edge_threshold = edge_threshold

    def analyze(self, frames_iter: Iterator[np.ndarray]) -> List[tuple]:
        flags: List[bool] = []
        for f in frames_iter:
            g = f.astype(np.float32).mean(-1)
            dark = g.mean() < self.dark_threshold
            gx = np.abs(np.diff(g, axis=1)).mean()
            texty = gx > self.edge_threshold * 255
            flags.append(bool(dark and texty))
        # contiguous runs
        segs = []
        start = None
        for i, v in enumerate(flags):
            if v and start is None:
                start = i
            elif not v and start is not None:
                if i - start >= 8:
                    segs.append((start, i))
                start = None
        if start is not None and len(flags) - start >= 8:
            segs.append((start, len(flags)))
        return segs


def frame_quality_score(stats: FrameStats) -> float:
    """Composite per-frame quality score in [0, 100] (reference
    processors/frame_quality_scorer.py:108 FrameQualityScorer).

    Sharpness and contrast raise the score; noise, blockiness, and
    off-center exposure lower it. Deterministic arithmetic over
    FrameStats so batches can be scored from a single analysis pass.
    """
    score = 50.0
    score += 25.0 * min(stats.sharpness / 4.0, 1.0)
    score += 10.0 * min(stats.contrast / 0.5, 1.0)
    score -= 25.0 * min(stats.noise, 1.0)
    score -= 20.0 * min(stats.blockiness / 2.0, 1.0)
    # exposure: full marks near mid-gray, falling off toward crush/clip
    score -= 15.0 * min(abs(stats.brightness - 0.45) / 0.45, 1.0)
    return float(np.clip(score, 0.0, 100.0))


class FrameQualityScorer:
    """Score frames for QA triage: per-frame quality + worst-k lookup
    (reference frame_quality_scorer.py:108; feeds QA reports the same
    way the reference's scorer feeds its report pipeline)."""

    def __init__(self):
        self.scores: List[float] = []

    def score_frame(self, frame: np.ndarray) -> float:
        s = frame_quality_score(analyze_frame(frame))
        self.scores.append(s)
        return s

    def analyze(self, frames_iter: Iterator[np.ndarray]) -> List[float]:
        for f in frames_iter:
            self.score_frame(f)
        return self.scores

    def worst(self, k: int = 5) -> List[tuple]:
        """[(frame_index, score)] for the k lowest-scoring frames."""
        order = np.argsort(self.scores)[:k]
        return [(int(i), float(self.scores[i])) for i in order]

    def summary(self) -> Dict:
        if not self.scores:
            return {"frames": 0}
        arr = np.asarray(self.scores)
        return {"frames": len(arr), "mean": float(arr.mean()),
                "min": float(arr.min()), "max": float(arr.max()),
                "p5": float(np.percentile(arr, 5))}


def recommend_settings(report: AnalysisReport) -> Dict:
    """AnalysisReport -> Config overrides (the reference's
    ProcessingPlan / --auto-enhance entry, analyzer.py:190)."""
    rec: Dict = {}
    degr = set(report.degradations)
    prof = report.noise_profile
    if prof is not None and prof.recommended_denoiser != "none":
        # profiled denoiser choice + strength (reference noise_profiler
        # _determine_recommendations:542 feeding the ProcessingPlan)
        rec.update(prof.config_overrides())
    elif DegradationType.NOISE in degr:
        rec["denoise"] = True
        rec["denoise_strength"] = min(0.9, 0.4 + report.stats.noise)
    if DegradationType.INTERLACING in degr:
        rec["deinterlace"] = "yadif"
    if DegradationType.FLICKER in degr:
        rec["temporal_consistency"] = True
    if DegradationType.COMPRESSION in degr:
        rec["qp_removal"] = True
    if report.content_type == ContentType.ANIMATION:
        rec["sr_model"] = "realesr-animevideov3"
    elif report.content_type == ContentType.BW_FILM:
        rec["grain_preserve"] = True
    if DegradationType.LOW_RESOLUTION in degr:
        rec["scale_factor"] = 4
        rec["sr_model"] = rec.get("sr_model", "RealESRGAN_x4plus")
    return rec
