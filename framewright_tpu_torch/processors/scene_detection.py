"""Scene-change detection: the port's copy of
``framewright_tpu.processors.scene_detection`` (numpy, on the host):
``frame_pair_scores`` between consecutive frames, and ``SceneDetector``,
which cuts a stream into scenes (the ``analyze`` verb)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import numpy as np


@dataclass
class SceneConfig:
    threshold: float = 0.30       # combined-difference score in [0, 1]
    min_scene_len: int = 8        # frames
    hist_bins: int = 32


@dataclass
class SceneResult:
    boundaries: List[int] = field(default_factory=list)  # first frame of each scene
    scores: List[float] = field(default_factory=list)
    total_frames: int = 0

    def scene_ranges(self) -> List[tuple]:
        starts = [0] + self.boundaries
        ends = self.boundaries + [self.total_frames]
        return [(s, e) for s, e in zip(starts, ends) if e > s]


def _luma(frames: np.ndarray) -> np.ndarray:
    f = frames.astype(np.float32)
    return 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]


def _hist(lum: np.ndarray, bins: int) -> np.ndarray:
    # (B, H, W) -> (B, bins) normalized histograms
    b = lum.shape[0]
    q = np.clip((lum / 256.0 * bins).astype(np.int32), 0, bins - 1).reshape(b, -1)
    out = np.zeros((b, bins), np.float32)
    for i in range(b):
        out[i] = np.bincount(q[i], minlength=bins)
    return out / q.shape[1]


def frame_pair_scores(prev: np.ndarray, cur: np.ndarray, bins: int = 32) -> np.ndarray:
    """Change score in [0,1] between consecutive frames (B,H,W,3): mean
    abs luma delta blended with the histogram L1 distance."""
    lp, lc = _luma(prev), _luma(cur)
    luma_diff = np.abs(lc - lp).mean(axis=(1, 2)) / 255.0
    hist_diff = 0.5 * np.abs(_hist(lc, bins) - _hist(lp, bins)).sum(axis=1)
    return 0.5 * luma_diff * 4.0 + 0.5 * hist_diff  # luma term rescaled


class SceneDetector:
    """A boundary where a pair's score reaches the threshold at least
    ``min_scene_len`` frames after the last one; scored in batches."""

    def __init__(self, config: Optional[SceneConfig] = None):
        self.config = config or SceneConfig()

    def analyze(self, frames_iter: Iterator[np.ndarray], batch_size: int = 32) -> SceneResult:
        cfg = self.config
        result = SceneResult()
        prev: Optional[np.ndarray] = None
        last_boundary = idx = 0
        buf: List[np.ndarray] = []

        def flush(buf):
            nonlocal prev, last_boundary, idx
            batch = np.stack(buf)
            if prev is None:               # the first frame has no predecessor
                result.scores.append(0.0)
                scores = (frame_pair_scores(batch[:-1], batch[1:], cfg.hist_bins)
                          if len(batch) > 1 else np.zeros(0))
                offset = 1
            else:
                prevs = np.concatenate([prev[None], batch[:-1]], axis=0)
                scores = frame_pair_scores(prevs, batch, cfg.hist_bins)
                offset = 0
            for k, s in enumerate(scores):
                i = idx + offset + k
                result.scores.append(float(s))
                if s >= cfg.threshold and i - last_boundary >= cfg.min_scene_len:
                    result.boundaries.append(i)
                    last_boundary = i
            prev = batch[-1]
            idx += len(batch)

        for f in frames_iter:
            buf.append(f)
            if len(buf) == batch_size:
                flush(buf)
                buf = []
        if buf:
            flush(buf)
        result.total_frames = idx
        return result

    @staticmethod
    def is_scene_change(prev: np.ndarray, cur: np.ndarray, threshold: float = 0.30) -> bool:
        return float(frame_pair_scores(prev[None], cur[None])[0]) >= threshold
