"""Streaming chunked restore for long videos: the port of
``framewright_tpu/streaming.py``.

The clip is cut into time chunks (``parallel.distributor.
make_scene_chunks``, ``Config.scene_chunk_frames`` frames, snapped to the
given scene boundaries); each chunk is restored as a segment of its own
with the checkpoint, the quality gate, deduplication and interpolation
off (as in JAX), ``on_chunk_ready(index, path)`` fires, and the segments
are concatenated. A Y4M source's chunks and the segments are copied frame
byte for byte (JAX decodes each to RGB and encodes it again, which moves
4:2:0 chroma by a few LSB; the port's output equals the straight
restore). A rerun skips every segment
that is complete. The port
counts a segment's whole frames only (``Y4MReader.count_frames``), so a
segment cut short is restored again, where JAX's reader counts a frame
cut short as whole and takes the segment as done.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import InputError
from framewright_tpu_torch.io.video import open_reader, probe
from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter, concat_y4m
from framewright_tpu_torch.parallel.distributor import FrameChunk, make_scene_chunks

logger = logging.getLogger(__name__)


@dataclass
class StreamingResult:
    output_path: Path
    chunks: int = 0
    frames_out: int = 0
    duration_s: float = 0.0
    chunk_paths: List[Path] = field(default_factory=list)
    restored: List[int] = field(default_factory=list)   # chunks restored by this run


class StreamingRestorer:
    """Chunked end-to-end restore with per-chunk callbacks and resume."""

    def __init__(self, config: Config,
                 on_chunk_ready: Optional[Callable[[int, Path], None]] = None,
                 chunk_frames: int = 0):
        self.config = config
        self.on_chunk_ready = on_chunk_ready
        self.chunk_frames = chunk_frames or config.scene_chunk_frames

    def restore_video_streaming(self, source, output=None,
                                scene_boundaries: Optional[List[int]] = None) -> StreamingResult:
        from framewright_tpu_torch.restorer import VideoRestorer

        cfg = self.config
        source = Path(source)
        if not source.exists():
            raise InputError(f"source not found: {source}")
        meta = probe(source)
        out_path = Path(output) if output else cfg.project_dir / (source.stem + "_restored.y4m")
        seg_dir = cfg.work_dir / "segments"
        seg_dir.mkdir(parents=True, exist_ok=True)
        chunks = make_scene_chunks(meta.nb_frames, self.chunk_frames, scene_boundaries)
        t0 = time.time()
        result = StreamingResult(output_path=out_path, chunks=len(chunks))
        chunk_cfg = cfg.with_overrides(checkpoint_enabled=False, validate_output=False,
                                       deduplicate=False, interpolation=False)
        for chunk in chunks:
            seg_out = seg_dir / f"seg_{chunk.index:05d}.y4m"
            if seg_out.exists() and self._segment_complete(seg_out, chunk):
                logger.info("chunk %d already done; skipping", chunk.index)
                result.chunk_paths.append(seg_out)
                continue
            seg_in = seg_dir / f"in_{chunk.index:05d}.y4m"
            self._extract_range(source, seg_in, chunk, meta.fps)
            VideoRestorer(chunk_cfg).restore_video(seg_in, output=seg_out)
            seg_in.unlink(missing_ok=True)
            result.chunk_paths.append(seg_out)
            result.restored.append(chunk.index)
            if self.on_chunk_ready:
                self.on_chunk_ready(chunk.index, seg_out)
            logger.info("chunk %d/%d done", chunk.index + 1, len(chunks))

        if result.chunk_paths:
            out_path.parent.mkdir(parents=True, exist_ok=True)
            result.frames_out = concat_y4m(result.chunk_paths, out_path, fps=meta.fps)
        if not cfg.keep_intermediates:
            for seg in result.chunk_paths:
                seg.unlink(missing_ok=True)
        result.duration_s = time.time() - t0
        return result

    def _extract_range(self, source: Path, dst: Path, chunk: FrameChunk, fps: float) -> None:
        """The chunk's frames as a Y4M segment input: a Y4M source's frame
        bytes copied (JAX decodes and encodes them again), any other
        source's frames encoded."""
        if source.suffix.lower() == ".y4m":
            concat_y4m([source], dst, fps=fps, start=chunk.start, end=chunk.end)
            return
        with open_reader(source) as r, Y4MWriter(dst, r.width, r.height, fps=fps) as w:
            for i, frame in enumerate(r):
                if i >= chunk.end:
                    break
                if i >= chunk.start:
                    w.write_frame(frame)

    @staticmethod
    def _segment_complete(seg: Path, chunk: FrameChunk) -> bool:
        """Whether the segment holds the chunk's frames, every one whole."""
        try:
            with Y4MReader(seg) as r:
                return r.count_frames() == chunk.n_frames
        except Exception:  # noqa: BLE001 - an unreadable segment is redone
            return False
