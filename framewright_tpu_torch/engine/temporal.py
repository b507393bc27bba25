"""Long-form drift correction: the port's copy of
``framewright_tpu.engine.temporal``'s ``AnchorPoint``, ``GlobalAnchors``
and ``ColorConsistencyEnforcer`` (numpy, on the host).

A decode pass samples colour statistics every ``anchor_interval``
frames; during the restore each frame's per-channel mean and std are
pulled toward the anchors interpolated at its (global) frame index."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List

import numpy as np

from framewright_tpu_torch.processors.film import estimate_grain_level


@dataclass
class AnchorPoint:
    frame_index: int
    mean_rgb: np.ndarray          # (3,)
    std_rgb: np.ndarray           # (3,)
    brightness: float
    contrast: float
    grain: float


@dataclass
class GlobalAnchors:
    points: List[AnchorPoint] = field(default_factory=list)
    total_frames: int = 0

    @classmethod
    def extract(cls, frames_iter: Iterator[np.ndarray],
                sample_every: int = 50) -> "GlobalAnchors":
        anchors = cls()
        i = 0
        for f in frames_iter:
            if i % sample_every == 0:
                anchors.points.append(cls.measure(f, i))
            i += 1
        anchors.total_frames = i
        return anchors

    @staticmethod
    def measure(frame: np.ndarray, index: int) -> AnchorPoint:
        """The anchor statistics of one frame."""
        ff = frame.astype(np.float32)
        return AnchorPoint(
            frame_index=index,
            mean_rgb=ff.mean(axis=(0, 1)),
            std_rgb=ff.std(axis=(0, 1)) + 1e-3,
            brightness=float(ff.mean()),
            contrast=float(ff.std()),
            grain=estimate_grain_level(frame),
        )

    def interpolate(self, frame_index: int) -> AnchorPoint:
        """Anchor statistics at any frame (linear in time, held at the
        first and last anchor)."""
        pts = self.points
        if not pts:
            raise ValueError("no anchors")
        if frame_index <= pts[0].frame_index:
            return pts[0]
        if frame_index >= pts[-1].frame_index:
            return pts[-1]
        for a, b in zip(pts, pts[1:]):
            if a.frame_index <= frame_index <= b.frame_index:
                t = (frame_index - a.frame_index) / max(b.frame_index - a.frame_index, 1)
                return AnchorPoint(
                    frame_index=frame_index,
                    mean_rgb=a.mean_rgb * (1 - t) + b.mean_rgb * t,
                    std_rgb=a.std_rgb * (1 - t) + b.std_rgb * t,
                    brightness=a.brightness * (1 - t) + b.brightness * t,
                    contrast=a.contrast * (1 - t) + b.contrast * t,
                    grain=a.grain * (1 - t) + b.grain * t,
                )
        return pts[-1]


class ColorConsistencyEnforcer:
    """Per-channel affine match of a frame's mean and std to the anchor
    at its index, blended with the frame by ``strength``."""

    def __init__(self, anchors: GlobalAnchors, strength: float = 0.5):
        self.anchors = anchors
        self.strength = strength

    def correct(self, frame: np.ndarray, frame_index: int) -> np.ndarray:
        a = self.anchors.interpolate(frame_index)
        f = frame.astype(np.float32)
        cur_mean = f.mean(axis=(0, 1))
        cur_std = f.std(axis=(0, 1)) + 1e-3
        gain = a.std_rgb / cur_std
        corrected = (f - cur_mean) * gain + a.mean_rgb
        out = f * (1 - self.strength) + corrected * self.strength
        return np.clip(out, 0, 255).astype(np.uint8)
