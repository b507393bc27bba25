"""Interlace detection and deinterlacing: the port's copy of
``framewright_tpu.processors.format``'s ``combing_score``,
``InterlaceReport``, ``InterlaceDetector`` and ``YadifDeinterlacer``.

The same numpy code on the host, so the port's frames equal the JAX
package's exactly. The default restore probes the first 60 frames
(``InterlaceDetector(sample_every=5)``) and, on an interlaced source,
streams every frame through ``YadifDeinterlacer(mode="yadif")`` before
super-resolution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class InterlaceReport:
    interlaced: bool = False
    combing_score: float = 0.0
    field_order: str = "tff"       # tff | bff | progressive
    frames_sampled: int = 0


def combing_score(frame: np.ndarray) -> float:
    """Comb artifacts: the disagreement of a line with the mean of its
    two neighbours, relative to the vertical detail at 2-line scale."""
    g = frame.astype(np.float32).mean(axis=-1)
    inter = np.abs(g[1:-1] - 0.5 * (g[:-2] + g[2:])).mean()
    base = np.abs(g[2:] - g[:-2]).mean() + 1e-6
    return float(inter / base)


class InterlaceDetector:
    def __init__(self, threshold: float = 0.55, sample_every: int = 10):
        self.threshold = threshold
        self.sample_every = sample_every

    def analyze(self, frames_iter: Iterator[np.ndarray]) -> InterlaceReport:
        scores = []
        orders = []
        for i, f in enumerate(frames_iter):
            if i % self.sample_every:
                continue
            scores.append(combing_score(f))
            g = f.astype(np.float32).mean(axis=-1)
            top = np.abs(np.diff(g[0::2], axis=0)).mean()
            bot = np.abs(np.diff(g[1::2], axis=0)).mean()
            orders.append("tff" if top <= bot else "bff")
        rep = InterlaceReport(frames_sampled=len(scores))
        if scores:
            rep.combing_score = float(np.mean(scores))
            rep.interlaced = rep.combing_score > self.threshold
            rep.field_order = (max(set(orders), key=orders.count) if rep.interlaced
                               else "progressive")
        return rep


class YadifDeinterlacer:
    """Motion-adaptive edge-directed deinterlacer (the yadif algorithm in
    numpy, frame-rate mode).

    Per missing-field pixel: an edge-directed spatial prediction (the best
    of 5 directions by 3-tap SAD) clamped to ``(prev + next) / 2 +-
    motion``, motion being the largest of the three yadif temporal
    differences and the spatial interlacing check. ``bwdif`` averages the
    spatial prediction with a 4-tap cubic vertical one."""

    def __init__(self, field_order: str = "tff", mode: str = "yadif"):
        self.field_order = field_order
        self.mode = mode

    @staticmethod
    def _edge_directed(above: np.ndarray, below: np.ndarray) -> np.ndarray:
        """Best-direction spatial interpolation between the line above
        and below. above/below: (R, W, C) float32."""
        pad = 4
        a = np.pad(above, ((0, 0), (pad, pad), (0, 0)), mode="edge")
        b = np.pad(below, ((0, 0), (pad, pad), (0, 0)), mode="edge")
        al_full = a.mean(axis=-1)
        bl_full = b.mean(axis=-1)
        w = above.shape[1]

        def at(arr, d):
            return arr[:, pad + d:pad + d + w]

        def pred_score(d):
            pred = 0.5 * (at(a, d) + at(b, -d))
            score = sum(np.abs(at(al_full, d + k) - at(bl_full, -d + k))
                        for k in (-1, 0, 1))
            return pred, score

        best_pred, best_score = pred_score(0)
        # try +-1; +-2 only where +-1 already beat vertical
        for sign in (-1, 1):
            p1, s1 = pred_score(sign)
            m1 = s1 < best_score
            best_pred = np.where(m1[..., None], p1, best_pred)
            best_score = np.where(m1, s1, best_score)
            p2, s2 = pred_score(2 * sign)
            m2 = m1 & (s2 < best_score)
            best_pred = np.where(m2[..., None], p2, best_pred)
            best_score = np.where(m2, s2, best_score)
        return best_pred

    def _rebuild(self, prev: np.ndarray, cur: np.ndarray, nxt: np.ndarray) -> np.ndarray:
        f = cur.astype(np.float32)
        fp = prev.astype(np.float32)
        fn = nxt.astype(np.float32)
        h = f.shape[0]
        keep = 0 if self.field_order == "tff" else 1
        miss = 1 - keep
        rows = np.arange(miss, h, 2)
        up = np.clip(rows - 1, 0, h - 1)
        dn = np.clip(rows + 1, 0, h - 1)

        above, below = f[up], f[dn]
        spatial = self._edge_directed(above, below)
        if self.mode == "bwdif":
            # wider vertical base (Catmull-Rom through 4 kept lines)
            up2 = np.clip(rows - 3, 0, h - 1)
            dn2 = np.clip(rows + 3, 0, h - 1)
            wide = (-f[up2] + 9.0 * above + 9.0 * below - f[dn2]) / 16.0
            spatial = 0.5 * (spatial + wide)

        d = 0.5 * (fp[rows] + fn[rows])
        td0 = 0.5 * np.abs(fp[rows] - fn[rows])
        td1 = 0.5 * (np.abs(fp[up] - above) + np.abs(fp[dn] - below))
        td2 = 0.5 * (np.abs(fn[up] - above) + np.abs(fn[dn] - below))
        motion = np.maximum(td0, np.maximum(td1, td2))
        # spatial interlacing check: widen the clamp window by the
        # vertical gradients of the temporal field (rows +-2)
        up2 = np.clip(rows - 2, 0, h - 1)
        dn2 = np.clip(rows + 2, 0, h - 1)
        bb = 0.5 * (fp[up2] + fn[up2])
        ff = 0.5 * (fp[dn2] + fn[dn2])
        mx = np.maximum(np.maximum(d - below, d - above),
                        np.minimum(bb - above, ff - below))
        mn = np.minimum(np.minimum(d - below, d - above),
                        np.maximum(bb - above, ff - below))
        motion = np.maximum(motion, np.maximum(mn, -mx))

        out = f.copy()
        out[rows] = np.clip(spatial, d - motion, d + motion)
        return np.clip(out, 0, 255).astype(cur.dtype)

    def process_stream(self, frames_iter: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        """Every frame once, rebuilt from its neighbours (the first frame
        is its own previous one, the last its own next one)."""
        prev = cur = None
        for nxt in frames_iter:
            if cur is not None:
                yield self._rebuild(prev if prev is not None else cur, cur, nxt)
            prev, cur = cur, nxt
        if cur is not None:
            yield self._rebuild(prev if prev is not None else cur, cur, cur)
