"""The port of ``framewright_tpu.processors.scene_intelligence``: numpy on
the host, as in JAX, op for op; faces come from the port's
``faces.make_detector`` (RetinaFace with its weights, else the
skin-chroma detector).

Per-scene content intelligence → adaptive processing settings.

The JAX package's rebuild of the reference's scene intelligence
(reference processors/scene_intelligence.py:170-744:
``SceneIntelligence.analyze_frame / analyze_video /
get_adaptive_settings / generate_processing_map`` and
``SceneAdaptiveProcessor:749``): classify each sampled frame's content
(face close-up / text-title / landscape / action / low-light), motion
level and degradation, and derive per-frame processing settings —
sharpening, noise reduction, temporal smoothing, face/text regional
care — that the restorer's stages can consume.

Design notes: frame statistics are pure vectorized numpy (cheap per
sampled frame, no OpenCV cascade dependency); face regions come from
processors/faces.make_detector (RetinaFace when weights exist, else
the luma-shape heuristic); text regions from gradient-density row
profiling (titles are horizontal high-contrast bands).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class SceneContent(Enum):
    FACE_CLOSEUP = "face_closeup"
    TEXT_TITLE = "text_title"
    LANDSCAPE = "landscape"
    ACTION = "action"
    GENERAL = "general"


class MotionLevel(Enum):
    STATIC = "static"
    LOW = "low"
    MODERATE = "moderate"
    HIGH = "high"
    EXTREME = "extreme"


class Lighting(Enum):
    LOW_LIGHT = "low_light"
    NORMAL = "normal"
    BRIGHT = "bright"
    HIGH_CONTRAST = "high_contrast"


@dataclass
class SceneAnalysis:
    """Per-frame analysis record (reference scene_intelligence.py:83)."""

    frame_number: int
    content: SceneContent = SceneContent.GENERAL
    motion: MotionLevel = MotionLevel.LOW
    lighting: Lighting = Lighting.NORMAL
    noise_level: float = 0.0          # 0-1
    blur_level: float = 0.0           # 0-1
    brightness: float = 0.5           # mean luma 0-1
    contrast: float = 0.0             # luma std 0-1
    faces: List[Tuple[int, int, int, int]] = field(default_factory=list)
    text_regions: List[Tuple[int, int, int, int]] = field(default_factory=list)
    is_scene_boundary: bool = False

    def to_dict(self) -> Dict:
        return {
            "frame": self.frame_number, "content": self.content.value,
            "motion": self.motion.value, "lighting": self.lighting.value,
            "noise": round(self.noise_level, 3),
            "blur": round(self.blur_level, 3),
            "brightness": round(self.brightness, 3),
            "faces": self.faces, "text_regions": self.text_regions,
            "scene_boundary": self.is_scene_boundary,
        }


@dataclass
class AdaptiveSettings:
    """Stage strengths derived from content
    (reference scene_intelligence.py:131-167)."""

    sharpening: float = 0.3
    noise_reduction: float = 0.3
    detail_enhancement: float = 0.2
    face_enhancement: float = 0.0
    temporal_smoothing: float = 0.5
    color_correction: float = 0.2
    text_sharpening: float = 0.0
    interpolation_quality: str = "normal"   # fast | normal | high
    apply_regional: bool = False
    face_regions: List[Tuple[int, int, int, int]] = field(default_factory=list)
    text_regions: List[Tuple[int, int, int, int]] = field(default_factory=list)

    def to_dict(self) -> Dict:
        return {
            "sharpening": round(self.sharpening, 3),
            "noise_reduction": round(self.noise_reduction, 3),
            "detail_enhancement": round(self.detail_enhancement, 3),
            "face_enhancement": round(self.face_enhancement, 3),
            "temporal_smoothing": round(self.temporal_smoothing, 3),
            "color_correction": round(self.color_correction, 3),
            "text_sharpening": round(self.text_sharpening, 3),
            "interpolation_quality": self.interpolation_quality,
            "apply_regional": self.apply_regional,
        }


# ---------------------------------------------------------------------------
# Frame statistics (vectorized, no deps)
# ---------------------------------------------------------------------------

def _luma(frame: np.ndarray) -> np.ndarray:
    f = frame.astype(np.float32)
    if f.ndim == 3:
        return 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    return f


def _noise_estimate(lum: np.ndarray) -> float:
    """Median absolute Laplacian in flat regions — robust noise sigma
    (immune to edges, unlike raw variance)."""
    lap = np.abs(4 * lum[1:-1, 1:-1] - lum[:-2, 1:-1] - lum[2:, 1:-1]
                 - lum[1:-1, :-2] - lum[1:-1, 2:])
    return float(np.clip(np.median(lap) / 32.0, 0.0, 1.0))


def _blur_estimate(lum: np.ndarray) -> float:
    """1 - normalized high-frequency energy (low gradients = blur)."""
    gx = np.abs(np.diff(lum, axis=1)).mean()
    gy = np.abs(np.diff(lum, axis=0)).mean()
    sharp = (gx + gy) / 2.0
    return float(np.clip(1.0 - sharp / 12.0, 0.0, 1.0))


def _text_regions(lum: np.ndarray,
                  max_regions: int = 4) -> List[Tuple[int, int, int, int]]:
    """Title/caption bands: rows whose horizontal-gradient density is
    far above the frame's median (text = dense vertical strokes)."""
    gx = np.abs(np.diff(lum, axis=1))
    strokes = (gx > 40.0).mean(axis=1)          # per-row stroke density
    med = float(np.median(strokes))
    hot = strokes > max(0.08, 4.0 * med)
    regions: List[Tuple[int, int, int, int]] = []
    h, w = lum.shape
    start = None
    for y, on in enumerate(hot.tolist() + [False]):
        if on and start is None:
            start = y
        elif not on and start is not None:
            if y - start >= max(4, h // 80):    # ignore 1-row speckle
                regions.append((0, start, w, y - start))
            start = None
    regions.sort(key=lambda r: -r[3])
    return regions[:max_regions]


# ---------------------------------------------------------------------------
# Scene intelligence
# ---------------------------------------------------------------------------

class SceneIntelligence:
    """Content-aware analysis → adaptive settings
    (reference scene_intelligence.py:170-744)."""

    def __init__(self, enable_faces: bool = True,
                 enable_text: bool = True,
                 sample_every: int = 12,
                 weights_dir: Optional[str] = None,
                 device: str = "cuda"):
        self.enable_faces = enable_faces
        self.enable_text = enable_text
        self.sample_every = max(1, sample_every)
        self._detector = None
        self._weights_dir = weights_dir
        self._device = device

    def _faces(self, frame: np.ndarray) -> List[Tuple[int, int, int, int]]:
        if not self.enable_faces:
            return []
        if self._detector is None:
            from framewright_tpu_torch.processors.faces import make_detector

            self._detector = make_detector(weights_dir=self._weights_dir,
                                           device=self._device)
        boxes = self._detector.detect(frame)
        return [(b.x0, b.y0, b.w, b.h) for b in boxes]

    # ------------------------------------------------------------------
    def analyze_frame(self, frame: np.ndarray, frame_number: int = 0,
                      prev_frame: Optional[np.ndarray] = None
                      ) -> SceneAnalysis:
        lum = _luma(frame)
        h, w = lum.shape
        brightness = float(lum.mean() / 255.0)
        contrast = float(lum.std() / 255.0)

        if brightness < 0.18:
            lighting = Lighting.LOW_LIGHT
        elif brightness > 0.75:
            lighting = Lighting.BRIGHT
        elif contrast > 0.30:
            lighting = Lighting.HIGH_CONTRAST
        else:
            lighting = Lighting.NORMAL

        motion = MotionLevel.LOW
        boundary = False
        if prev_frame is not None:
            diff = float(np.abs(_luma(prev_frame) - lum).mean())
            if diff < 0.6:
                motion = MotionLevel.STATIC
            elif diff < 3.0:
                motion = MotionLevel.LOW
            elif diff < 9.0:
                motion = MotionLevel.MODERATE
            elif diff < 25.0:
                motion = MotionLevel.HIGH
            else:
                motion = MotionLevel.EXTREME
                boundary = diff > 45.0

        faces = self._faces(frame)
        texts = _text_regions(lum) if self.enable_text else []

        face_area = sum(fw * fh for _, _, fw, fh in faces) / float(h * w)
        text_area = sum(tw * th for _, _, tw, th in texts) / float(h * w)
        if face_area > 0.08:
            content = SceneContent.FACE_CLOSEUP
        elif text_area > 0.10:
            content = SceneContent.TEXT_TITLE
        elif motion in (MotionLevel.HIGH, MotionLevel.EXTREME):
            content = SceneContent.ACTION
        elif contrast > 0.22 and not faces:
            content = SceneContent.LANDSCAPE
        else:
            content = SceneContent.GENERAL

        return SceneAnalysis(
            frame_number=frame_number, content=content, motion=motion,
            lighting=lighting, noise_level=_noise_estimate(lum),
            blur_level=_blur_estimate(lum), brightness=brightness,
            contrast=contrast, faces=faces, text_regions=texts,
            is_scene_boundary=boundary)

    def analyze_video(self, frames: Iterator[np.ndarray]
                      ) -> List[SceneAnalysis]:
        analyses = []
        prev = None
        for i, frame in enumerate(frames):
            if i % self.sample_every:
                continue
            analyses.append(self.analyze_frame(frame, i, prev))
            prev = frame
        return analyses

    # ------------------------------------------------------------------
    @staticmethod
    def get_adaptive_settings(analysis: SceneAnalysis,
                              base: Optional[Dict[str, float]] = None
                              ) -> AdaptiveSettings:
        """Settings tuned per content class (reference
        scene_intelligence.py:598-668 adaptation rules)."""
        s = AdaptiveSettings()
        if base:
            s.sharpening = base.get("sharpening", s.sharpening)
            s.noise_reduction = base.get("noise_reduction",
                                         s.noise_reduction)

        if analysis.content == SceneContent.FACE_CLOSEUP:
            s.face_enhancement = 0.4
            s.sharpening = min(s.sharpening, 0.25)
            s.noise_reduction = min(s.noise_reduction, 0.4)
            s.detail_enhancement = 0.3
            s.face_regions = list(analysis.faces)
            s.apply_regional = True
        elif analysis.content == SceneContent.TEXT_TITLE:
            s.text_sharpening = 0.4
            s.sharpening = 0.4
            s.noise_reduction = 0.2
            s.text_regions = list(analysis.text_regions)
            s.apply_regional = True
        elif analysis.content == SceneContent.LANDSCAPE:
            s.sharpening = min(s.sharpening * 1.2, 0.5)
            s.detail_enhancement = 0.4
            s.color_correction = 0.4
        elif analysis.content == SceneContent.ACTION:
            s.temporal_smoothing = 0.3
            s.interpolation_quality = "high"
            s.sharpening = 0.35

        if analysis.motion == MotionLevel.STATIC:
            s.temporal_smoothing = 0.8
            s.noise_reduction = min(1.0, s.noise_reduction * 1.2)
        elif analysis.motion == MotionLevel.EXTREME:
            s.temporal_smoothing = 0.2
            s.interpolation_quality = "fast"

        if analysis.lighting == Lighting.LOW_LIGHT:
            s.noise_reduction = min(1.0, s.noise_reduction * 1.3)
            s.sharpening *= 0.8

        if analysis.blur_level > 0.5:
            s.sharpening = min(1.0, s.sharpening * 1.2)
        if analysis.noise_level > 0.5:
            s.noise_reduction = min(1.0, s.noise_reduction * 1.2)
        return s

    def generate_processing_map(self, analyses: List[SceneAnalysis]
                                ) -> Dict[int, AdaptiveSettings]:
        return {a.frame_number: self.get_adaptive_settings(a)
                for a in analyses}

    @staticmethod
    def get_summary(analyses: List[SceneAnalysis]) -> Dict:
        if not analyses:
            return {}
        from collections import Counter

        contents = Counter(a.content.value for a in analyses)
        motions = Counter(a.motion.value for a in analyses)
        return {
            "frames_analyzed": len(analyses),
            "content_distribution": dict(contents),
            "motion_distribution": dict(motions),
            "mean_noise": round(float(np.mean(
                [a.noise_level for a in analyses])), 3),
            "mean_blur": round(float(np.mean(
                [a.blur_level for a in analyses])), 3),
            "scene_boundaries": [a.frame_number for a in analyses
                                 if a.is_scene_boundary],
            "faces_present_pct": round(100.0 * sum(
                1 for a in analyses if a.faces) / len(analyses), 1),
        }


# ---------------------------------------------------------------------------
# Streaming adaptive filter
# ---------------------------------------------------------------------------

def _blur3(f: np.ndarray) -> np.ndarray:
    """Separable 3x3 box blur (edge-replicated)."""
    p = np.pad(f, ((1, 1), (1, 1)) + ((0, 0),) * (f.ndim - 2), mode="edge")
    h = (p[:, :-2] + p[:, 1:-1] + p[:, 2:]) / 3.0
    return (h[:-2] + h[1:-1] + h[2:]) / 3.0


class SceneAdaptiveFilter:
    """Streaming filter driven by the adaptive-settings map
    (reference processors/scene_intelligence.py:749
    ``SceneAdaptiveProcessor``): applies content-aware sharpening and
    extra noise reduction as DELTAS beyond the pipeline's configured
    baseline, so static scenes / low light / blurry content get the
    boost the analysis asked for without double-processing everything.
    Runs pre-SR at source resolution (cheap, on the decode thread)."""

    def __init__(self, pmap: Dict[int, AdaptiveSettings],
                 base_sharpening: float = 0.3,
                 base_noise_reduction: float = 0.3):
        self.pmap = dict(sorted(pmap.items()))
        self.base_sharpening = base_sharpening
        self.base_nr = base_noise_reduction
        self._keys = np.asarray(list(self.pmap.keys()), np.int64)
        self.frames_adjusted = 0

    def _settings_for(self, idx: int) -> Optional[AdaptiveSettings]:
        if self._keys.size == 0:
            return None
        pos = int(np.searchsorted(self._keys, idx, side="right")) - 1
        return self.pmap[int(self._keys[max(pos, 0)])]

    def process_stream(self, frames: Iterator[np.ndarray],
                       source_index: Optional[Callable[[int], int]] = None
                       ) -> Iterator[np.ndarray]:
        """Each frame adjusted by the segment of its source frame:
        ``source_index(position)`` when frames were inserted upstream (JAX
        reads the stream's position, so its segments shift after an
        insertion), else its position."""
        for i, frame in enumerate(frames):
            s = self._settings_for(i if source_index is None else source_index(i))
            if s is None:
                yield frame
                continue
            ds = s.sharpening - self.base_sharpening
            dn = s.noise_reduction - self.base_nr
            if ds <= 0.01 and dn <= 0.01:
                yield frame
                continue
            f = frame.astype(np.float32)
            blur = _blur3(f)
            if dn > 0.01:
                f = f + min(dn, 0.5) * (blur - f)     # light extra NR
            if ds > 0.01:
                f = f + min(ds, 0.5) * (f - blur)     # unsharp mask
            self.frames_adjusted += 1
            yield np.clip(f, 0, 255).astype(frame.dtype)
