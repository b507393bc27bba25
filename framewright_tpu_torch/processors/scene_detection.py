"""Scene-change scores between consecutive frames: the port's copy of
``framewright_tpu.processors.scene_detection``'s ``frame_pair_scores``
(numpy, on the host)."""

from __future__ import annotations

import numpy as np


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
