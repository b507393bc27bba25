"""Missing-frame detection, gap filling and sequence extension: the port
of ``framewright_tpu.processors.frame_generation``.

``GapFiller`` streams: when the scene score of prev -> cur exceeds
``jump_ratio`` times the previous step's (and stays below the scene-cut
threshold), a frame was dropped, and the IFNet midpoint of the pair
(``interpolate_padded`` at t = 0.5, on the card in f32) is inserted
before cur; after a fill the step counts half. The net is the JAX gap
filler's draw, ``ifnet.init(PRNGKey(5))`` at ``ALIGN_ARCH``, read from
``models/weights/gapfill_ifnet_key5.npz``. ``detect_gaps`` is the
whole-list detector. The filler records each yielded frame's source index
(an inserted frame: the index of the frame before it) and the positions it
inserted at (``source_of``), so the restore can map dedup and the
scene-adaptive segments by source frame.

``FrameExtender`` extends a clip by constant-velocity extrapolation: the
boundary flow (``FlowEstimator``, with its consistency confidence) is
estimated once, then the boundary frame is warped again and again, each
step blended with the unwarped frame by the confidence and the flow
damped.
"""

from __future__ import annotations

import bisect
import logging
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from framewright_tpu_torch.hw import full_f32, resolve_device
from framewright_tpu_torch.processors.base import to_float, to_uint8
from framewright_tpu_torch.processors.scene_detection import frame_pair_scores

logger = logging.getLogger(__name__)


@dataclass
class GapReport:
    gaps: List[int] = field(default_factory=list)   # index of frame AFTER the gap
    frames_inserted: int = 0


class GapFiller:
    """Detect single-frame drops and insert synthesized frames: in smooth
    motion the frame-to-frame difference is roughly constant, and a
    dropped frame shows as one difference ~2x its neighbours (and not a
    scene cut)."""

    def __init__(self, jump_ratio: float = 1.8, scene_change_threshold: float = 0.30,
                 device: str = "cuda"):
        self.jump_ratio = jump_ratio
        self.scene_threshold = scene_change_threshold
        self.device = resolve_device(device)
        self.net = None
        self.report = GapReport()
        self.sources: List[int] = []       # each yielded frame's source index
        self.inserted_at: List[int] = []   # the positions of the inserted frames

    def setup(self, height: int = 0, width: int = 0) -> None:
        """Load the synthesis net onto the device (once)."""
        if self.net is None:
            from framewright_tpu_torch.models import registry

            self.net = registry.load_align_ifnet(self.device, registry.GAPFILL_IFNET_NPZ)

    def source_of(self, pos: int) -> Tuple[int, bool]:
        """(source index, inserted) of the ``pos``-th frame yielded."""
        i = bisect.bisect_left(self.inserted_at, pos)
        return self.sources[pos], i < len(self.inserted_at) and self.inserted_at[i] == pos

    def _synth(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        def up(f):
            return to_float(torch.from_numpy(np.ascontiguousarray(f)).to(self.device))[None]

        with torch.no_grad(), full_f32():
            out = self.net.interpolate_padded(up(a), up(b), 0.5)
            return to_uint8(out[0]).cpu().numpy()

    def detect_gaps(self, frames: List[np.ndarray]) -> List[int]:
        """Indices i where a frame seems missing between i-1 and i."""
        if len(frames) < 4:
            return []
        diffs = [float(frame_pair_scores(frames[i][None], frames[i + 1][None])[0])
                 for i in range(len(frames) - 1)]
        gaps = []
        for i in range(1, len(diffs) - 1):
            d = diffs[i]
            neighbors = (diffs[i - 1] + diffs[i + 1]) / 2.0
            if neighbors < 1e-4:
                continue
            if d > self.jump_ratio * neighbors and d < self.scene_threshold \
                    and diffs[i - 1] > 1e-4:
                gaps.append(i + 1)
        return gaps

    def process_stream(self, frames_iter: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        """Streaming gap fill: when the step prev -> cur is over
        ``jump_ratio`` times the previous step (and below the scene-cut
        threshold), the midpoint is inserted before cur."""
        prev: Optional[np.ndarray] = None
        prev_diff: Optional[float] = None
        idx = 0
        for frame in frames_iter:
            self.setup()
            if prev is not None:
                d = float(frame_pair_scores(prev[None], frame[None])[0])
                if (prev_diff is not None and prev_diff > 1e-4
                        and d > self.jump_ratio * prev_diff and d < self.scene_threshold):
                    self.report.gaps.append(idx)
                    self.report.frames_inserted += 1
                    self.inserted_at.append(len(self.sources))
                    self.sources.append(idx - 1)
                    yield self._synth(prev, frame)
                    d = d / 2.0           # after filling, the effective step halves
                prev_diff = d
            self.sources.append(idx)
            yield frame
            prev = frame
            idx += 1


class FrameExtender:
    """Extend a clip forward or backward by motion extrapolation: the
    boundary flow estimated once, then the boundary frame warped again
    and again, blended toward a static hold by the flow's consistency
    confidence (occlusions smear instead of tearing), the flow damped
    each step."""

    def __init__(self, estimator=None, damping: float = 0.92, flow_backend: str = "ifnet",
                 device: str = "cuda"):
        from framewright_tpu_torch.processors.flow import FlowEstimator

        self.estimator = estimator or FlowEstimator(backend=flow_backend, device=device)
        self.damping = float(damping)

    def _extrapolate(self, anchor: np.ndarray, prev: np.ndarray,
                     count: int) -> List[np.ndarray]:
        """Frames continuing past ``anchor``, where ``prev`` is the frame
        one step before it (in extension direction)."""
        if count <= 0:
            return []
        fld = self.estimator.estimate(anchor, prev)
        flow = fld.flow.copy()
        conf = fld.confidence[..., None]
        out: List[np.ndarray] = []
        cur = anchor
        for _ in range(count):
            warped = self.estimator.warp_frame(cur, flow)
            blended = (warped.astype(np.float32) * conf
                       + cur.astype(np.float32) * (1.0 - conf))
            cur = (np.clip(blended + 0.5, 0, 255).astype(np.uint8)
                   if anchor.dtype == np.uint8 else blended.astype(anchor.dtype))
            out.append(cur)
            flow *= self.damping
        return out

    def extend_forward(self, frames: List[np.ndarray], count: int) -> List[np.ndarray]:
        """Continuation frames after ``frames[-1]``."""
        if len(frames) < 2:
            return [frames[-1].copy() for _ in range(count)] if frames else []
        return self._extrapolate(frames[-1], frames[-2], count)

    def extend_backward(self, frames: List[np.ndarray], count: int) -> List[np.ndarray]:
        """Frames before ``frames[0]``, in playback order (earliest first)."""
        if len(frames) < 2:
            return [frames[0].copy() for _ in range(count)] if frames else []
        return self._extrapolate(frames[0], frames[1], count)[::-1]
