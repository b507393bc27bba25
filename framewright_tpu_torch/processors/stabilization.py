"""The port of ``framewright_tpu.processors.stabilization``: numpy on the
host, as in JAX, op for op.

Full-frame video stabilization (camera shake removal).

Fills the reference's VideoStabilizer slot
(processors/stabilization.py:537 — two-pass vidstab through ffmpeg:
pass 1 `vidstabdetect` writes a transforms file, pass 2
`vidstabtransform` smooths and warps; also
restoration/stabilization.py:962). This is an in-process, streaming
redesign — no subprocess, no transforms sidecar file:

1. **Global motion**: phase correlation between consecutive frames on
   downscaled, Hann-windowed luma. Four quadrant correlations give four
   local translations; a similarity transform (dx, dy, rotation, scale)
   is least-squares fitted to them, so camera roll is recovered without
   feature tracking. Subpixel precision via parabolic peak fit.
2. **Trajectory smoothing**: the cumulative camera path is smoothed
   with a centered moving average of radius ``smoothing``; the
   correction for frame i is (smoothed - actual) path.
3. **Streaming with lookahead**: frames are emitted ``smoothing``
   frames behind the read head, so a single pass suffices (the
   reference needs two full decode passes); memory is O(radius).
4. **Warp**: inverse-mapped bilinear affine warp with crop-zoom
   (``crop_ratio``) hiding the stabilization borders.

Scene cuts reset the trajectory (a cut is not camera motion).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)


@dataclass
class StabilizeConfig:
    smoothing: int = 15            # trajectory smoothing radius (frames)
    crop_ratio: float = 0.95       # retained frame fraction after zoom
    estimate_rotation: bool = True
    max_shift_fraction: float = 0.2   # reject implausible correlations
    analysis_size: int = 256       # max dim of the analysis luma
    scene_cut_threshold: float = 0.5  # correlation-quality cut detector


@dataclass
class StabilizeResult:
    frames: int = 0
    scene_cuts: int = 0
    mean_correction_px: float = 0.0
    max_correction_px: float = 0.0
    trajectory: List[Tuple[float, float, float]] = field(default_factory=list)


def _to_luma_small(frame: np.ndarray, max_dim: int) -> np.ndarray:
    """uint8 HxWx3 -> downscaled float luma via block mean."""
    f = frame.astype(np.float32)
    luma = f @ _LUMA if f.ndim == 3 else f
    h, w = luma.shape
    step = max(1, int(np.ceil(max(h, w) / max_dim)))
    if step > 1:
        hh, ww = (h // step) * step, (w // step) * step
        luma = luma[:hh, :ww].reshape(hh // step, step, ww // step, step)
        luma = luma.mean(axis=(1, 3))
    return luma


def _hann2d(shape: Tuple[int, int]) -> np.ndarray:
    wy = np.hanning(shape[0]).astype(np.float32)
    wx = np.hanning(shape[1]).astype(np.float32)
    return wy[:, None] * wx[None, :]


def phase_correlate(a: np.ndarray, b: np.ndarray) -> Tuple[float, float, float]:
    """Shift (dy, dx) such that b(x) ~= a(x - shift), plus peak response
    in [0, 1] (correlation quality). Subpixel by parabolic fit."""
    win = _hann2d(a.shape)
    fa = np.fft.rfft2((a - a.mean()) * win)
    fb = np.fft.rfft2((b - b.mean()) * win)
    cross = fb * np.conj(fa)
    denom = np.abs(cross)
    cross = cross / np.maximum(denom, 1e-9)
    corr = np.fft.irfft2(cross, s=a.shape)
    peak_flat = int(np.argmax(corr))
    py, px = np.unravel_index(peak_flat, corr.shape)
    peak = float(corr[py, px])

    def parabolic(cm, c0, cp):
        d = cm - 2 * c0 + cp
        return 0.0 if abs(d) < 1e-12 else float(np.clip(0.5 * (cm - cp) / d, -0.5, 0.5))

    h, w = corr.shape
    dy = py + parabolic(corr[(py - 1) % h, px], corr[py, px], corr[(py + 1) % h, px])
    dx = px + parabolic(corr[py, (px - 1) % w], corr[py, px], corr[py, (px + 1) % w])
    if dy > h / 2:
        dy -= h
    if dx > w / 2:
        dx -= w
    return dy, dx, peak


def estimate_motion(prev_luma: np.ndarray, cur_luma: np.ndarray,
                    rotation: bool = True,
                    max_shift_fraction: float = 0.2,
                    ) -> Tuple[float, float, float, float]:
    """Global motion prev -> cur: (dy, dx, theta, quality).

    Whole-frame phase correlation for translation; when ``rotation``,
    quadrant correlations are LS-fitted to a similarity transform
    (s_q = t + (A - I) c_q with A = [[a,-b],[b,a]]), giving roll.
    """
    h, w = cur_luma.shape
    dy, dx, q = phase_correlate(prev_luma, cur_luma)
    lim_y, lim_x = h * max_shift_fraction, w * max_shift_fraction
    if abs(dy) > lim_y or abs(dx) > lim_x:
        return 0.0, 0.0, 0.0, 0.0
    if not rotation:
        return dy, dx, 0.0, q

    h2, w2 = h // 2, w // 2
    quads = ((slice(0, h2), slice(0, w2)), (slice(0, h2), slice(w2, w)),
             (slice(h2, h), slice(0, w2)), (slice(h2, h), slice(w2, w)))
    centers = np.asarray([(-h2 / 2, -w2 / 2), (-h2 / 2, w2 / 2),
                          (h2 / 2, -w2 / 2), (h2 / 2, w2 / 2)], np.float32)
    rows, rhs = [], []
    for (sy, sx), c in zip(quads, centers):
        qdy, qdx, qq = phase_correlate(prev_luma[sy, sx], cur_luma[sy, sx])
        if qq <= 0.02 or abs(qdy) > lim_y or abs(qdx) > lim_x:
            continue
        cy, cx = float(c[0]), float(c[1])
        # shift = t + (A - I) c ; unknowns (ty, tx, a, b):
        #   qdy = ty + (a-1)*cy - b*cx
        #   qdx = tx + b*cy + (a-1)*cx
        rows.append([1.0, 0.0, cy, -cx])
        rhs.append(qdy + cy)
        rows.append([0.0, 1.0, cx, cy])
        rhs.append(qdx + cx)
    if len(rhs) >= 6:
        sol, *_ = np.linalg.lstsq(np.asarray(rows, np.float32),
                                  np.asarray(rhs, np.float32), rcond=None)
        ty, tx, a, b = (float(v) for v in sol)
        theta = float(np.arctan2(b, a))
        # sanity: reject wild fits, keep whole-frame translation
        if abs(theta) < 0.12:
            return ty, tx, theta, q
    return dy, dx, 0.0, q


def warp_frame(frame: np.ndarray, dy: float, dx: float, theta: float,
               zoom: float) -> np.ndarray:
    """Inverse-mapped bilinear similarity warp: rotate by ``theta``,
    translate by (dy, dx), zoom about the center; edge-clamped."""
    h, w = frame.shape[:2]
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yc, xc = yy - cy, xx - cx
    cos_t, sin_t = np.cos(-theta) / zoom, np.sin(-theta) / zoom
    sy = cos_t * yc - sin_t * xc + cy - dy
    sx = sin_t * yc + cos_t * xc + cx - dx
    sy = np.clip(sy, 0, h - 1)
    sx = np.clip(sx, 0, w - 1)
    y0 = np.floor(sy).astype(np.int32)
    x0 = np.floor(sx).astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (sy - y0)[..., None] if frame.ndim == 3 else (sy - y0)
    wx = (sx - x0)[..., None] if frame.ndim == 3 else (sx - x0)
    f = frame.astype(np.float32)
    top = f[y0, x0] * (1 - wx) + f[y0, x1] * wx
    bot = f[y1, x0] * (1 - wx) + f[y1, x1] * wx
    out = top * (1 - wy) + bot * wy
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


class VideoStabilizer:
    """Streaming one-pass stabilizer with lookahead smoothing
    (reference VideoStabilizer, processors/stabilization.py:537)."""

    def __init__(self, config: Optional[StabilizeConfig] = None):
        self.config = config or StabilizeConfig()
        self.result = StabilizeResult()

    # -- trajectory helpers -------------------------------------------------
    @staticmethod
    def _smooth(path: np.ndarray, idx: int, radius: int) -> np.ndarray:
        lo = max(0, idx - radius)
        hi = min(len(path), idx + radius + 1)
        return path[lo:hi].mean(axis=0)

    def process_stream(self, frames_iter: Iterator[np.ndarray]
                       ) -> Iterator[np.ndarray]:
        cfg = self.config
        radius = cfg.smoothing
        zoom = 1.0 / cfg.crop_ratio
        buf: List[np.ndarray] = []          # frames waiting for lookahead
        path: List[np.ndarray] = []         # cumulative (dy, dx, theta)
        prev_luma: Optional[np.ndarray] = None
        cum = np.zeros(3, np.float32)
        emitted = 0
        corrections: List[float] = []
        # luma downscale factor maps analysis shifts -> full-res pixels
        scale = 1.0

        def emit_ready(final: bool) -> Iterator[np.ndarray]:
            nonlocal emitted
            p = np.asarray(path, np.float32)
            while buf and (len(path) - emitted > radius or
                           (final and emitted < len(path))):
                i = emitted
                smoothed = self._smooth(p, i, radius)
                corr = smoothed - p[i]
                dy, dx = corr[0] * scale, corr[1] * scale
                theta = corr[2]
                corrections.append(float(np.hypot(dy, dx)))
                frame = buf.pop(0)
                if abs(dy) < 0.05 and abs(dx) < 0.05 and abs(theta) < 1e-4 \
                        and zoom == 1.0:
                    yield frame
                else:
                    yield warp_frame(frame, dy, dx, theta, zoom)
                emitted += 1

        for frame in frames_iter:
            luma = _to_luma_small(frame, cfg.analysis_size)
            if prev_luma is None:
                path.append(cum.copy())
                scale = frame.shape[0] / luma.shape[0]
            else:
                dy, dx, theta, q = estimate_motion(
                    prev_luma, luma, cfg.estimate_rotation,
                    cfg.max_shift_fraction)
                if q < cfg.scene_cut_threshold * 0.1:
                    # unreliable correlation = scene cut: reset path
                    self.result.scene_cuts += 1
                    for out in emit_ready(final=True):
                        yield out
                    path.clear()
                    emitted = 0
                    cum[:] = 0.0
                    path.append(cum.copy())
                else:
                    cum += np.asarray([dy, dx, theta], np.float32)
                    path.append(cum.copy())
            prev_luma = luma
            buf.append(frame)
            for out in emit_ready(final=False):
                yield out
        for out in emit_ready(final=True):
            yield out
        self.result.frames = len(corrections)
        if corrections:
            self.result.mean_correction_px = float(np.mean(corrections))
            self.result.max_correction_px = float(np.max(corrections))
        self.result.trajectory = [tuple(map(float, p)) for p in path]

    def stabilize(self, frames: List[np.ndarray]) -> List[np.ndarray]:
        return list(self.process_stream(iter(frames)))


def jitter_metric(frames: List[np.ndarray]) -> float:
    """Mean inter-frame displacement magnitude (px) — the quantity
    stabilization minimizes; used by tests and QA reports."""
    mags = []
    prev = None
    for f in frames:
        luma = _to_luma_small(f, 256)
        if prev is not None:
            dy, dx, _ = phase_correlate(prev, luma)
            mags.append(float(np.hypot(dy, dx)))
        prev = luma
    return float(np.mean(mags)) if mags else 0.0
