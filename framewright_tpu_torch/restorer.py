"""Restore a Y4M clip: decode -> super-resolution -> encode.

The port of the ``framewright_tpu.restorer.VideoRestorer`` path that a
default ``restore`` takes: probe, the enhance stage with ``PrefetchRing``
and ``WriterDrain``, one batch in flight on the card, and the
YUV-direct writer path (the SR stage emits 4:2:0 planes straight into a
4:2:0 Y4M writer whenever the output's width and height are even, for
either model family; any other writer gets uint8 RGB). Checkpoint/resume,
dedup and the other stages are not ported yet.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import InputError
from framewright_tpu_torch.io.ring import PrefetchRing, WriterDrain
from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
from framewright_tpu_torch.processors.super_resolution import (
    SRConfig,
    SuperResolution,
)

logger = logging.getLogger(__name__)


@dataclass
class RestoreResult:
    output_path: Path
    frames_in: int
    frames_out: int
    duration_s: float
    batches: int = 0          # device dispatches
    batch_size: int = 0       # frames per dispatch (the last may hold fewer)

    @property
    def fps(self) -> float:
        return self.frames_out / self.duration_s if self.duration_s > 0 else 0.0


def build_sr_config(cfg: Config) -> SRConfig:
    return SRConfig(
        model_name=cfg.sr_model,
        compute_dtype=cfg.compute_dtype,
        batch_size=cfg.batch_size,
        hbm_utilization=cfg.hbm_utilization,
        weights_dir=str(cfg.weights_dir) if cfg.weights_dir else None,
        device="cuda" if cfg.device_platform == "auto" else cfg.device_platform,
    )


class VideoRestorer:
    def __init__(self, config: Optional[Config] = None,
                 progress_callback: Optional[Callable[[int, int], None]] = None):
        self.config = config or Config()
        self.progress_callback = progress_callback
        self.sr: Optional[SuperResolution] = None

    def _resolve_output(self, source: Path) -> Path:
        if self.config.output_path is not None:
            return self.config.output_path
        return self.config.project_dir / (source.stem + "_restored.y4m")

    def restore_video(self, source, output=None) -> RestoreResult:
        cfg = self.config
        source = Path(source)
        if not source.exists():
            raise InputError(f"source not found: {source}")
        if source.suffix.lower() != ".y4m":
            raise InputError(f"the port reads .y4m only, got {source.name}")
        out_path = Path(output) if output else self._resolve_output(source)
        if out_path.suffix.lower() != ".y4m":
            raise InputError(f"the port writes .y4m only, got {out_path.name}")
        t0 = time.time()

        # probe
        with Y4MReader(source) as probe:
            total = probe.count_frames()
            h, w, fps = probe.height, probe.width, probe.header.fps
        if cfg.max_frames:
            total = min(total, cfg.max_frames)

        # enhance
        sr = self.sr = SuperResolution(build_sr_config(cfg))
        batch_size = written = 0
        with contextlib.ExitStack() as stack:    # unwinds in reverse order
            stack.callback(sr.teardown)
            sr.setup(h, w)
            oh, ow = sr.output_size(h, w)
            writer = stack.enter_context(Y4MWriter(out_path, ow, oh, fps=fps))
            reader = stack.enter_context(Y4MReader(source))
            yuv_direct = (writer.header.colorspace.startswith("420")
                          and oh % 2 == 0 and ow % 2 == 0)
            if yuv_direct:
                sr.config.yuv_full_range = writer.full_range
                sr.set_output_color("yuv420")
                drain = WriterDrain(lambda planes: writer.write_yuv_frame(*planes),
                                    depth=4)
            else:
                drain = WriterDrain(writer.write_frame, depth=4)
            stack.callback(drain.close)
            batch_size = max(1, min(sr.plan.batch, total))
            ring = PrefetchRing(itertools.islice(iter(reader), total),
                                batch_size=batch_size)
            stack.callback(ring.close)

            def finish(handle, n):
                nonlocal written
                out = sr.materialize(handle)
                if yuv_direct:
                    drain.submit([tuple(p[i] for p in out) for i in range(n)], n)
                else:
                    drain.submit(out, n)
                written += n
                if self.progress_callback is not None:
                    self.progress_callback(written, total)

            # one batch in flight: batch N+1 is enqueued on the card before
            # batch N is copied back and handed to the writer
            pending = None
            for batch in ring:
                handle = sr.dispatch(batch.frames[: batch.valid])
                if pending is not None:
                    finish(*pending)
                pending = (handle, batch.valid)
            if pending is not None:
                finish(*pending)
        return RestoreResult(out_path, total, written, time.time() - t0,
                             sr.dispatches, batch_size)
