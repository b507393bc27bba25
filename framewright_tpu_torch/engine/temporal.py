"""Long-form consistency: the port of ``framewright_tpu.engine.temporal``
(numpy, on the host).

A decode pass samples colour statistics every ``anchor_interval``
frames; during the restore each frame's per-channel mean and std are
pulled toward the anchors interpolated at its (global) frame index.
``ChunkedProcessor`` runs a stream in chunks with a trailing overlap and
cross-fades consecutive chunks' outputs over it;
``LongFormConsistencyManager`` drives both passes."""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional

import numpy as np

from framewright_tpu_torch.processors.film import estimate_grain_level

logger = logging.getLogger(__name__)


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


class ChunkedProcessor:
    """A stream processed in chunks of ``chunk_size`` frames, each handed
    to ``process_chunk`` with the ``overlap`` frames after it (the same
    count back); the overlap's outputs of consecutive chunks are
    cross-faded, weight (i + 1) / (overlap + 1) on the later chunk."""

    def __init__(self, process_chunk: Callable[[List[np.ndarray]], List[np.ndarray]],
                 chunk_size: int = 50, overlap: int = 4):
        if not overlap < chunk_size:
            raise ValueError(f"overlap {overlap} must be below chunk_size {chunk_size}")
        self.process_chunk = process_chunk
        self.chunk_size = chunk_size
        self.overlap = overlap

    @staticmethod
    def _blend(prev_tail: List[np.ndarray], new_head: List[np.ndarray]) -> List[np.ndarray]:
        n = len(prev_tail)
        out = []
        for i, (a, b) in enumerate(zip(prev_tail, new_head)):
            w = (i + 1) / (n + 1)
            out.append(np.clip(a.astype(np.float32) * (1 - w) + b.astype(np.float32) * w,
                               0, 255).astype(np.uint8))
        return out

    def process_stream(self, frames_iter: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        cs, ov = self.chunk_size, self.overlap
        buf: List[np.ndarray] = []
        tail_out: List[np.ndarray] = []       # the last chunk's processed overlap
        first = True
        while True:
            target = cs + ov
            ended = False
            while len(buf) < target:
                nxt = next(frames_iter, None)
                if nxt is None:
                    ended = True
                    break
                buf.append(nxt)
            if not buf:
                return
            processed = self.process_chunk(list(buf[:target]))
            if first:
                head = processed[:cs]
                first = False
            else:
                head = self._blend(tail_out, processed[:ov]) + processed[ov:cs]
            yield from head
            if ended:
                yield from processed[cs:]
                return
            tail_out = processed[cs:cs + ov]
            buf = buf[cs:]


class LongFormConsistencyManager:
    """Two passes: ``analyze`` samples the anchors over the whole stream,
    ``process_stream`` runs it chunked and pulls each output frame toward
    the anchors at its index."""

    def __init__(self, chunk_size: int = 50, overlap: int = 4, anchor_every: int = 50,
                 color_strength: float = 0.5):
        self.chunk_size = chunk_size
        self.overlap = overlap
        self.anchor_every = anchor_every
        self.color_strength = color_strength
        self.anchors: Optional[GlobalAnchors] = None

    def analyze(self, frames_iter: Iterator[np.ndarray]) -> GlobalAnchors:
        self.anchors = GlobalAnchors.extract(frames_iter, self.anchor_every)
        logger.info("extracted %d global anchors over %d frames",
                    len(self.anchors.points), self.anchors.total_frames)
        return self.anchors

    def process_stream(self, frames_iter: Iterator[np.ndarray],
                       process_chunk) -> Iterator[np.ndarray]:
        if self.anchors is None:
            raise ValueError("call analyze() first (two-pass design)")
        enforcer = ColorConsistencyEnforcer(self.anchors, self.color_strength)
        chunker = ChunkedProcessor(process_chunk, self.chunk_size, self.overlap)
        for i, frame in enumerate(chunker.process_stream(frames_iter)):
            yield enforcer.correct(frame, i)
