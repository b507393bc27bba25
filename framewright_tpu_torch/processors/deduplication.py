"""Duplicate-frame detection: the port's copy of
``framewright_tpu.processors.deduplication`` (numpy, on the host).

Each frame is dHashed (``ops.dhash``, the numpy hash: the native one
averages in double and may flip a bit on a tie, and at the default 0.98
with 64 bits one bit decides) and compared with the last unique frame;
a similarity at or above ``similarity_threshold`` marks a duplicate. The
result maps every frame to its unique position, so the restore runs SR on
the unique frames only and repeats their outputs, and estimates the
source's true cadence (18 fps film padded to 24: 0.75 of the frames are
unique).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np

from framewright_tpu_torch.ops import dhash

logger = logging.getLogger(__name__)


@dataclass
class DedupConfig:
    similarity_threshold: float = 0.98
    hash_size: int = 8
    min_run_length: int = 1     # only collapse runs of >= N duplicates


@dataclass
class DedupResult:
    total_frames: int = 0
    unique_frames: int = 0
    duplicates: int = 0
    unique_indices: List[int] = field(default_factory=list)
    frame_mapping: Dict[int, int] = field(default_factory=dict)  # frame -> unique position
    estimated_source_fps: float = 0.0
    target_fps: float = 0.0

    @property
    def dedup_ratio(self) -> float:
        return self.duplicates / self.total_frames if self.total_frames else 0.0


class FrameDeduplicator:
    def __init__(self, config: Optional[DedupConfig] = None):
        self.config = config or DedupConfig()

    def analyze(self, frames_iter: Iterator[np.ndarray],
                target_fps: float = 25.0, batch_size: int = 64) -> DedupResult:
        """Every frame of the stream, hashed in batches, marked unique or
        a duplicate of the last unique frame."""
        cfg = self.config
        result = DedupResult(target_fps=target_fps)
        last_unique_hash: Optional[np.ndarray] = None
        idx = 0
        unique_pos = -1
        buf: List[np.ndarray] = []

        def flush(buf):
            nonlocal idx, last_unique_hash, unique_pos
            hashes = dhash.dhash_batch(np.stack(buf), cfg.hash_size)
            for h in hashes:
                if last_unique_hash is None:
                    is_dup = False
                else:
                    sim = float(dhash.hamming_similarity(h[None], last_unique_hash[None])[0])
                    is_dup = sim >= cfg.similarity_threshold
                if is_dup:
                    result.duplicates += 1
                else:
                    last_unique_hash = h
                    unique_pos += 1
                    result.unique_indices.append(idx)
                result.frame_mapping[idx] = unique_pos
                idx += 1

        for frame in frames_iter:
            buf.append(frame)
            if len(buf) == batch_size:
                flush(buf)
                buf = []
        if buf:
            flush(buf)

        result.total_frames = idx
        result.unique_frames = len(result.unique_indices)
        if result.total_frames:
            result.estimated_source_fps = round(
                target_fps * result.unique_frames / result.total_frames, 2)
        logger.info("dedup: %d/%d unique (est. source %.2f fps)", result.unique_frames,
                    result.total_frames, result.estimated_source_fps)
        return result

    @staticmethod
    def reconstruct_order(result: DedupResult) -> List[int]:
        """The unique position of each frame, in frame order."""
        return [result.frame_mapping[i] for i in range(result.total_frames)]
