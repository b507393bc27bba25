"""Film restoration: the port's copy of ``framewright_tpu.processors.film``.

Stock detection (``FILM_STOCK_PROFILES``, ``FilmStockDetector``), grain
(``estimate_grain_level``, ``GrainManager``), defects (``DefectReport``,
``DefectRepairer``: vertical scratches and dust) and gate weave
(``GateWeaveStabilizer``). Everything but the gate weave's translation
is numpy on the host, as in the JAX package, so the frames are the JAX
ones byte for byte: ``np.median`` averages the two middle values of an
even window where ``torch.median`` takes the lower, and
``np.random.default_rng(seed).normal`` is the only source of JAX's grain.
The translation runs the port's ``ops.warp.flow_warp`` on the CPU, as
the JAX one runs ``framewright_tpu.ops.warp.flow_warp``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Film stock detection
# ---------------------------------------------------------------------------

# Era colour signatures: warmth (mean R / mean B) and saturation ranges.
FILM_STOCK_PROFILES: Dict[str, Dict] = {
    "kodachrome": {"warmth": (1.05, 1.45), "saturation": (0.35, 0.9), "era": "1935-2010",
                   "color_response": "saturated reds, deep blacks"},
    "ektachrome": {"warmth": (0.85, 1.05), "saturation": (0.3, 0.8), "era": "1946-2012",
                   "color_response": "cooler, blue-shifted"},
    "technicolor": {"warmth": (0.95, 1.35), "saturation": (0.5, 1.0), "era": "1922-1955",
                    "color_response": "vivid three-strip"},
    "eastmancolor": {"warmth": (1.0, 1.3), "saturation": (0.15, 0.45), "era": "1950-1990",
                     "color_response": "prone to fading toward magenta"},
    "black_and_white": {"warmth": (0.97, 1.03), "saturation": (0.0, 0.08), "era": "any",
                        "color_response": "monochrome"},
}


@dataclass
class FilmStockReport:
    stock: str = "unknown"
    confidence: float = 0.0
    warmth: float = 1.0
    saturation: float = 0.0
    grain_level: float = 0.0
    is_bw: bool = False
    faded: bool = False


class FilmStockDetector:
    def analyze(self, frames_iter: Iterator[np.ndarray],
                max_frames: int = 20) -> FilmStockReport:
        """The first ``max_frames`` frames' mean warmth, saturation, grain
        and fade -> the profile matching most of them."""
        warmths, sats, grains, fades = [], [], [], []
        for i, f in enumerate(frames_iter):
            if i >= max_frames:
                break
            ff = f.astype(np.float32)
            r, b = ff[..., 0], ff[..., 2]
            warmths.append((r.mean() + 1) / (b.mean() + 1))
            mx = ff.max(-1)
            mn = ff.min(-1)
            sats.append(float(((mx - mn) / (mx + 1e-3)).mean()))
            grains.append(estimate_grain_level(f))
            # fade: lifted blacks and a compressed range
            fades.append(float(np.percentile(ff, 2) > 28 and np.percentile(ff, 98) < 225))
        rep = FilmStockReport()
        if not warmths:
            return rep
        rep.warmth = float(np.mean(warmths))
        rep.saturation = float(np.mean(sats))
        rep.grain_level = float(np.mean(grains))
        rep.is_bw = rep.saturation < 0.08
        rep.faded = np.mean(fades) > 0.5
        best, best_score = "unknown", 0.0
        for name, prof in FILM_STOCK_PROFILES.items():
            w0, w1 = prof["warmth"]
            s0, s1 = prof["saturation"]
            score = float(w0 <= rep.warmth <= w1) + float(s0 <= rep.saturation <= s1)
            if score > best_score:
                best, best_score = name, score
        rep.stock = best
        rep.confidence = best_score / 2.0
        return rep


# ---------------------------------------------------------------------------
# Grain
# ---------------------------------------------------------------------------

def estimate_grain_level(frame: np.ndarray) -> float:
    """High-frequency residual energy: std of the 4-neighbour Laplacian
    residual of the grey frame (wrapping at the borders) / 40, in 0-1."""
    g = frame.astype(np.float32).mean(axis=-1)
    blur = (np.roll(g, 1, 0) + np.roll(g, -1, 0) + np.roll(g, 1, 1)
            + np.roll(g, -1, 1)) / 4.0
    return float(np.clip((g - blur).std() / 40.0, 0.0, 1.0))


class GrainManager:
    """preserve | remove | synthesize | match. ``rng`` is the one
    generator of the run (``default_rng(seed)``); a resumed restore sets
    its ``bit_generator.state`` to the straight run's at the resume point."""

    def __init__(self, mode: str = "preserve", strength: float = 0.3, seed: int = 0):
        self.mode = mode
        self.strength = strength
        self.rng = np.random.default_rng(seed)

    def extract_grain(self, frame: np.ndarray) -> np.ndarray:
        f = frame.astype(np.float32)
        blur = (np.roll(f, 1, 0) + np.roll(f, -1, 0) + np.roll(f, 1, 1)
                + np.roll(f, -1, 1)) / 4.0
        return f - blur

    def remove(self, frame: np.ndarray) -> np.ndarray:
        grain = self.extract_grain(frame)
        out = frame.astype(np.float32) - self.strength * grain
        return np.clip(out, 0, 255).astype(np.uint8)

    def synthesize(self, frame: np.ndarray) -> np.ndarray:
        """Gaussian grain, one draw a pixel, strongest in the midtones."""
        f = frame.astype(np.float32)
        noise = self.rng.normal(0.0, 12.0 * self.strength, f.shape[:2])
        luma = f.mean(-1) / 255.0
        response = 4.0 * luma * (1.0 - luma)
        out = f + (noise * response)[..., None]
        return np.clip(out, 0, 255).astype(np.uint8)

    def match(self, frame: np.ndarray, target_level: float) -> np.ndarray:
        cur = estimate_grain_level(frame)
        if cur > target_level + 0.05:
            self.strength = min(1.0, (cur - target_level) * 2)
            return self.remove(frame)
        if cur < target_level - 0.05:
            self.strength = min(1.0, (target_level - cur) * 2)
            return self.synthesize(frame)
        return frame

    def process(self, frame: np.ndarray, target_level: float = 0.2) -> np.ndarray:
        if self.mode == "remove":
            return self.remove(frame)
        if self.mode == "synthesize":
            return self.synthesize(frame)
        if self.mode == "match":
            return self.match(frame, target_level)
        return frame


# ---------------------------------------------------------------------------
# Defects: scratches and dust
# ---------------------------------------------------------------------------

@dataclass
class DefectReport:
    scratch_columns: List[int] = field(default_factory=list)
    dust_count: int = 0


class DefectRepairer:
    """Vertical scratches: columns of the first 8 frames' mean that stand
    out from their neighbours 2 columns away, replaced by the mean of
    those neighbours. Dust: pixels far from the median of their +-radius
    temporal window (5 frames in the middle of the clip, 3 or 4 at its
    ends), replaced by it. ``report`` counts what ``process_stream``
    repaired."""

    def __init__(self, scratch_threshold: float = 12.0, dust_threshold: float = 45.0):
        self.scratch_threshold = scratch_threshold
        self.dust_threshold = dust_threshold
        self.report = DefectReport()

    def detect_scratches(self, frames: List[np.ndarray]) -> List[int]:
        mean = np.stack([f.astype(np.float32).mean(-1) for f in frames]).mean(0)
        col = mean.mean(axis=0)
        neighbor = 0.5 * (np.roll(col, 2) + np.roll(col, -2))
        dev = col - neighbor
        cols = np.where(np.abs(dev) > self.scratch_threshold)[0]
        return [int(c) for c in cols if 2 <= c < len(col) - 2]

    def repair_scratch_columns(self, frame: np.ndarray, cols: List[int]) -> np.ndarray:
        out = frame.astype(np.float32)
        for c in cols:
            out[:, c] = 0.5 * (out[:, c - 2] + out[:, c + 2])
        return np.clip(out, 0, 255).astype(np.uint8)

    def repair_dust(self, window: List[np.ndarray], center: int) -> Tuple[np.ndarray, int]:
        """The centre with its pixels far from the temporal median set to it."""
        stack = np.stack([f.astype(np.float32) for f in window])
        med = np.median(stack, axis=0)
        cur = stack[center]
        diff = np.abs(cur - med).mean(-1)
        mask = diff > self.dust_threshold
        out = cur.copy()
        out[mask] = med[mask]
        return np.clip(out, 0, 255).astype(np.uint8), int(mask.sum())

    def process_stream(self, frames_iter: Iterator[np.ndarray],
                       radius: int = 2) -> Iterator[np.ndarray]:
        buf: List[np.ndarray] = []
        emitted = 0
        scratch_cols: Optional[List[int]] = None
        for f in frames_iter:
            buf.append(f)
            if scratch_cols is None and len(buf) >= 8:
                scratch_cols = self.report.scratch_columns = self.detect_scratches(buf[:8])
            while emitted + radius < len(buf):
                yield self._emit(buf, emitted, radius, scratch_cols or [])
                emitted += 1
        while emitted < len(buf):
            yield self._emit(buf, emitted, radius, scratch_cols or [])
            emitted += 1

    def _emit(self, buf, idx, radius, scratch_cols) -> np.ndarray:
        lo = max(0, idx - radius)
        hi = min(len(buf), idx + radius + 1)
        out, dust = self.repair_dust(buf[lo:hi], idx - lo)
        self.report.dust_count += dust
        if scratch_cols:
            out = self.repair_scratch_columns(out, scratch_cols)
        return out


# ---------------------------------------------------------------------------
# Gate weave (global translation jitter)
# ---------------------------------------------------------------------------

class GateWeaveStabilizer:
    """Frame-to-frame translation by phase correlation, a box-smoothed
    trajectory, and each frame moved by (smooth - raw), at most
    ``max_shift`` pixels."""

    def __init__(self, smooth_window: int = 15, max_shift: float = 8.0):
        self.smooth_window = smooth_window
        self.max_shift = max_shift

    @staticmethod
    def phase_shift(a: np.ndarray, b: np.ndarray) -> Tuple[float, float]:
        """(dy, dx) shift of b relative to a."""
        ga = a.astype(np.float32).mean(-1)
        gb = b.astype(np.float32).mean(-1)
        fa = np.fft.rfft2(ga)
        fb = np.fft.rfft2(gb)
        cross = fa * np.conj(fb)
        cross /= np.abs(cross) + 1e-9
        corr = np.fft.irfft2(cross, s=ga.shape)
        dy, dx = np.unravel_index(np.argmax(corr), corr.shape)
        h, w = ga.shape
        if dy > h // 2:
            dy -= h
        if dx > w // 2:
            dx -= w
        return float(dy), float(dx)

    def stabilize(self, frames: List[np.ndarray]) -> List[np.ndarray]:
        if len(frames) < 3:
            return list(frames)
        traj = [(0.0, 0.0)]                  # cumulative, against frame 0
        for i in range(1, len(frames)):
            dy, dx = self.phase_shift(frames[i - 1], frames[i])
            py, px = traj[-1]
            traj.append((py - dy, px - dx))
        traj_arr = np.asarray(traj)
        k = min(self.smooth_window, len(frames))
        kernel = np.ones(k) / k
        smooth = np.stack([np.convolve(traj_arr[:, 0], kernel, mode="same"),
                           np.convolve(traj_arr[:, 1], kernel, mode="same")], axis=1)
        out = []
        for f, raw, sm in zip(frames, traj_arr, smooth):
            dy, dx = np.clip(sm - raw, -self.max_shift, self.max_shift)
            out.append(_translate(f, dy, dx))
        return out


def _translate(frame: np.ndarray, dy: float, dx: float) -> np.ndarray:
    """Sub-pixel translation, bilinear with border padding, on the CPU in
    f32; clip(out * 255 + 0.5) truncated to uint8."""
    import torch

    from framewright_tpu_torch.ops.warp import flow_warp

    f = torch.from_numpy(np.ascontiguousarray(frame[None])).float() / 255.0
    flow = torch.tensor([-dx, -dy], dtype=torch.float32).expand(1, *frame.shape[:2], 2)
    out = flow_warp(f, flow)[0].numpy()
    return np.clip(out * 255.0 + 0.5, 0, 255).astype(np.uint8)
