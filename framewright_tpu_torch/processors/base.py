"""The processor protocol and frame conversions: the port of
``framewright_tpu.processors.base``.

``FrameProcessor`` is JAX's base class of per-batch transforms ((B, H, W,
3) uint8 in, the same out, possibly resized) with its ``process_video``
stream; ``ProcessorResult`` its result envelope, ``require_shape`` and
``Timer`` its helpers. ``to_float`` and ``to_uint8`` convert on tensors,
so the pre-SR stream converts on the card: ``x / 255`` in f32 is an IEEE
division, the same numbers on the card as the JAX package's on the host."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator

import numpy as np
import torch

from framewright_tpu_torch.errors import StageError


@dataclass
class ProcessorResult:
    """A processor's run: frames, seconds, metrics and errors."""

    name: str
    frames_processed: int = 0
    duration_s: float = 0.0
    metrics: Dict[str, Any] = field(default_factory=dict)
    errors: int = 0

    @property
    def fps(self) -> float:
        return self.frames_processed / self.duration_s if self.duration_s > 0 else 0.0


class FrameProcessor:
    """A per-batch frame transform: subclasses implement ``process_batch``
    and may override ``setup``, ``output_size`` and ``teardown``."""

    name: str = "base"
    scale: int = 1           # the factor applied to the frame's sides
    fps_factor: float = 1.0  # the frame-rate multiplier (interpolators)

    def setup(self, height: int, width: int) -> None:
        """Called once with the input's size before the first batch."""

    def process_batch(self, frames: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 -> (B, H * scale, W * scale, 3) uint8."""
        raise NotImplementedError

    def output_size(self, height: int, width: int):
        return height * self.scale, width * self.scale

    def teardown(self) -> None:
        pass

    def process_video(self, frames_iter: Iterator[np.ndarray],
                      batch_size: int = 8) -> Iterator[np.ndarray]:
        """Frames through this processor in batches of ``batch_size`` (the
        last may be short); ``setup`` on the first frame, ``teardown`` at
        the end."""
        buf: list = []
        started = False
        for f in frames_iter:
            if not started:
                self.setup(f.shape[0], f.shape[1])
                started = True
            buf.append(f)
            if len(buf) == batch_size:
                yield from self.process_batch(np.stack(buf))
                buf = []
        if buf:
            yield from self.process_batch(np.stack(buf))
        self.teardown()


def require_shape(frames: np.ndarray, stage: str) -> None:
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise StageError(f"expected (B, H, W, 3) frames, got {frames.shape}", stage=stage)


class Timer:
    """``with Timer() as t: ...`` leaves the block's seconds in ``t.dt``."""

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.dt = time.time() - self.t0


def to_float(frames: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1]; other dtypes -> float32."""
    if frames.dtype == torch.uint8:
        return frames.float() / 255.0
    return frames.float()


def to_uint8(frames: torch.Tensor) -> torch.Tensor:
    """float in [0, 1] -> uint8: clip(x * 255 + 0.5, 0, 255), truncated
    (round half away from zero on the clipped range)."""
    return torch.clamp(frames.float() * 255.0 + 0.5, 0, 255).to(torch.uint8)
