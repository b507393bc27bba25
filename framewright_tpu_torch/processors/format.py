"""Format and geometry processors: the port's copy of
``framewright_tpu.processors.format`` (``combing_score``,
``InterlaceReport``, ``InterlaceDetector``, ``Deinterlacer``,
``YadifDeinterlacer``, ``InverseTelecine``, ``TelecineResult``,
``LetterboxDetector``, ``LetterboxInfo``, ``AspectCorrector``).

The same numpy code on the host, so the port's frames equal the JAX
package's exactly; ``AspectCorrector`` resizes with the port's
``layers.resize_bicubic`` on the card (within 1e-5 of JAX's). The default
restore probes the first 60 frames (``InterlaceDetector(sample_every=5)``)
and, on an interlaced source, streams every frame through
``YadifDeinterlacer(mode="yadif")`` before super-resolution. The
telecine, letterbox and aspect tools are not restore stages, in JAX as in
the port (``Config.inverse_telecine``, ``crop_letterbox`` and
``aspect_correction`` map to nothing).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Union

import numpy as np
import torch


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


class Deinterlacer:
    """Bob/weave deinterlacer: keep the dominant field, interpolate the
    other (``skip``) or blend the interpolation with it (``blend``)."""

    def __init__(self, method: str = "blend", field_order: str = "tff"):
        self.method = method
        self.field_order = field_order

    def deinterlace(self, frame: np.ndarray) -> np.ndarray:
        f = frame.astype(np.float32)
        keep0 = 0 if self.field_order == "tff" else 1
        out = f.copy()
        interp = 0.5 * (np.roll(f, 1, axis=0) + np.roll(f, -1, axis=0))
        other = 1 - keep0
        if self.method == "skip":
            out[other::2] = interp[other::2]
        else:
            out[other::2] = 0.5 * (f[other::2] + interp[other::2])
        return np.clip(out, 0, 255).astype(np.uint8)

    def process_stream(self, frames_iter: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        for f in frames_iter:
            yield self.deinterlace(f)


@dataclass
class TelecineResult:
    pattern_found: bool = False
    frames_in: int = 0
    frames_out: int = 0


class InverseTelecine:
    """3:2 pulldown removal: in a 5-frame cadence one frame repeats its
    neighbour (dHash similarity); that position is dropped."""

    def __init__(self, similarity_threshold: float = 0.96):
        self.threshold = similarity_threshold

    def detect_cadence(self, frames: List[np.ndarray]) -> Optional[int]:
        """The cadence offset (which of each 5 frames is dropped), or None."""
        from framewright_tpu_torch.ops import dhash

        if len(frames) < 10:
            return None
        sims = dhash.consecutive_similarity(dhash.dhash_batch(np.stack(frames)))
        votes = np.zeros(5)
        for i in range(1, len(sims)):
            if sims[i] >= self.threshold:
                votes[i % 5] += 1
        if votes.max() >= max(2, 0.5 * (len(frames) // 5)):
            return int(votes.argmax())
        return None

    def process_stream(self, frames_iter: Iterator[np.ndarray],
                       result: Optional[TelecineResult] = None) -> Iterator[np.ndarray]:
        result = result or TelecineResult()
        buf = list(frames_iter)  # cadence detection needs lookahead
        result.frames_in = len(buf)
        offset = self.detect_cadence(buf[: min(len(buf), 60)])
        result.pattern_found = offset is not None
        for i, f in enumerate(buf):
            if offset is not None and i % 5 == offset:
                continue
            result.frames_out += 1
            yield f


@dataclass
class LetterboxInfo:
    top: int = 0
    bottom: int = 0
    left: int = 0
    right: int = 0

    @property
    def any(self) -> bool:
        return bool(self.top or self.bottom or self.left or self.right)

    def crop(self, frame: np.ndarray) -> np.ndarray:
        h, w = frame.shape[:2]
        return frame[self.top:h - self.bottom or h, self.left:w - self.right or w]


class LetterboxDetector:
    """Black bars: rows and columns whose mean luma, over the brightest of
    the sampled frames, stays below the threshold."""

    def __init__(self, luma_threshold: float = 24.0, sample_frames: int = 10):
        self.luma_threshold = luma_threshold
        self.sample_frames = sample_frames

    def detect(self, frames_iter: Iterator[np.ndarray]) -> LetterboxInfo:
        acc = None
        n = 0
        for f in frames_iter:
            g = f.astype(np.float32).mean(axis=-1)
            acc = g if acc is None else np.maximum(acc, g)
            n += 1
            if n >= self.sample_frames:
                break
        if acc is None:
            return LetterboxInfo()
        h, w = acc.shape
        row_dark = acc.mean(axis=1) < self.luma_threshold
        col_dark = acc.mean(axis=0) < self.luma_threshold

        def run_len(mask):
            k = 0
            for v in mask:
                if not v:
                    break
                k += 1
            return k

        info = LetterboxInfo(top=run_len(row_dark), bottom=run_len(row_dark[::-1]),
                             left=run_len(col_dark), right=run_len(col_dark[::-1]))
        # never crop more than 40% in any direction
        if info.top + info.bottom > 0.4 * h or info.left + info.right > 0.4 * w:
            return LetterboxInfo()
        # even sides for 4:2:0 encoders
        info.top -= info.top % 2
        info.bottom -= info.bottom % 2
        info.left -= info.left % 2
        info.right -= info.right % 2
        return info


class AspectCorrector:
    """Resize to a target display aspect ratio (the width, to an even
    number of pixels), bicubically on the card."""

    def __init__(self, target_dar: float, device: Union[str, torch.device, None] = "auto"):
        self.target_dar = target_dar
        self.device = device

    def correct(self, frame: np.ndarray) -> np.ndarray:
        from framewright_tpu_torch.hw import full_f32, resolve_device
        from framewright_tpu_torch.models.layers import resize_bicubic

        h, w = frame.shape[:2]
        if abs(w / h - self.target_dar) < 1e-3:
            return frame
        new_w = int(round(h * self.target_dar / 2)) * 2
        x = torch.from_numpy(np.ascontiguousarray(frame[None])).to(resolve_device(self.device))
        with full_f32():
            out = resize_bicubic(x.float() / 255.0, (h, new_w))
        return np.clip(out[0].cpu().numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
