"""Checkpoint and resume, keyed by the config's hash and the source's
content: the port's copy of ``framewright_tpu.engine.checkpoint``.

A checkpoint is one JSON file per source, named after a SHA-256 of the
source's first 10 MB, so the same clip resumes wherever it lies. It
holds the config hash (a changed config discards it), the stages
completed and, per stage, the count of output frames handed to the
writer. It is saved atomically (a temporary file, then a rename) every
``interval`` frames, on ``force_save`` and when a stage completes, and
removed by ``complete`` when the job is done.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from framewright_tpu_torch.errors import CheckpointError

logger = logging.getLogger(__name__)

_HASH_BYTES = 10 * 1024 * 1024


def video_content_hash(path: Path) -> str:
    """SHA-256 of the file's first 10 MB (32 hex digits)."""
    h = hashlib.sha256()
    try:
        with open(path, "rb") as f:
            h.update(f.read(_HASH_BYTES))
    except OSError as exc:
        raise CheckpointError(f"cannot hash {path}: {exc}") from exc
    return h.hexdigest()[:32]


@dataclass
class PipelineCheckpoint:
    config_hash: str = ""
    video_hash: str = ""
    source: str = ""
    total_frames: int = 0
    completed_stages: List[str] = field(default_factory=list)
    frames_done: Dict[str, int] = field(default_factory=dict)  # stage -> contiguous count
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "PipelineCheckpoint":
        d = json.loads(text)
        known = set(cls.__dataclass_fields__)  # type: ignore[attr-defined]
        return cls(**{k: v for k, v in d.items() if k in known})


class CheckpointManager:
    """Atomic JSON checkpoint store keyed by (config hash, video hash)."""

    def __init__(self, checkpoint_dir: Path, interval: int = 50):
        self.dir = Path(checkpoint_dir)
        self.interval = max(1, interval)
        self._ckpt: Optional[PipelineCheckpoint] = None
        self._since_save = 0

    def path(self, video_hash: str) -> Path:
        return self.dir / f"ckpt_{video_hash}.json"

    def start(self, source: Path, config_hash: str,
              total_frames: int = 0) -> PipelineCheckpoint:
        """Load the source's checkpoint if its config hash matches, else
        discard it and start a fresh one."""
        vhash = video_content_hash(source)
        path = self.path(vhash)
        if path.exists():
            try:
                ckpt = PipelineCheckpoint.from_json(path.read_text())
                if ckpt.config_hash == config_hash:
                    logger.info("resuming from checkpoint %s (stages=%s, frames=%s)",
                                path.name, ckpt.completed_stages, ckpt.frames_done)
                    self._ckpt = ckpt
                    return ckpt
                logger.info("config changed; discarding checkpoint %s", path.name)
                path.unlink()
            except (json.JSONDecodeError, TypeError, OSError):
                logger.warning("corrupt checkpoint %s; starting fresh", path.name)
        self._ckpt = PipelineCheckpoint(config_hash=config_hash, video_hash=vhash,
                                        source=str(source), total_frames=total_frames)
        return self._ckpt

    @property
    def checkpoint(self) -> PipelineCheckpoint:
        if self._ckpt is None:
            raise CheckpointError("CheckpointManager.start() not called")
        return self._ckpt

    def stage_completed(self, stage: str) -> None:
        ck = self.checkpoint
        if stage not in ck.completed_stages:
            ck.completed_stages.append(stage)
        self.save()

    def frames_completed(self, stage: str, contiguous_count: int) -> None:
        """Record progress; saves once ``interval`` frames have been
        recorded since the last save."""
        ck = self.checkpoint
        prev = ck.frames_done.get(stage, 0)
        ck.frames_done[stage] = max(prev, contiguous_count)
        self._since_save += ck.frames_done[stage] - prev
        if self._since_save >= self.interval:
            self.save()

    def resume_point(self, stage: str) -> int:
        return self.checkpoint.frames_done.get(stage, 0)

    def save(self) -> None:
        ck = self.checkpoint
        ck.updated_at = time.time()
        path = self.path(ck.video_hash)
        tmp = path.with_suffix(".tmp")
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            tmp.write_text(ck.to_json())
            os.replace(tmp, path)
        except OSError as exc:
            raise CheckpointError(f"checkpoint save failed: {exc}") from exc
        self._since_save = 0

    def complete(self) -> None:
        """The job is done: remove the checkpoint file."""
        if self._ckpt is not None:
            self.path(self._ckpt.video_hash).unlink(missing_ok=True)

    def force_save(self) -> None:
        """Save from a cleanup path: a failure is logged, not raised."""
        try:
            self.save()
        except CheckpointError:
            logger.exception("force_save failed")
