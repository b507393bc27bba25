"""Checkpoint and resume, keyed by the config's hash and the source's
content: the port's copy of ``framewright_tpu.engine.checkpoint``.

A checkpoint is one JSON file per source, named after a SHA-256 of the
source's first 10 MB (of a frame directory: its frames' names and sizes,
then their first 10 MB in order; the JAX hash cannot open a directory),
so the same clip resumes wherever it lies. It
holds the config hash (a changed config discards it), the stages
completed, per stage, the count of output frames handed to the writer,
and the state a resume carries across its resume point (``carry``: the
post-SR grain generator's state and measured target at recent points a
resume may start from), and what a stage reads when a rerun resumes after
or inside it (``stage_state``: the enhance stage's intermediate, its
size, rate and frames; the interpolate stage's pair batch, so a resume
steps through the same pairs). It is saved atomically (a temporary file, then
a rename) every ``interval`` frames, on ``force_save`` and when a stage
completes, and removed by ``complete`` when the job is done.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from framewright_tpu_torch.errors import CheckpointError

logger = logging.getLogger(__name__)

_HASH_BYTES = 10 * 1024 * 1024


def video_content_hash(path: Path) -> str:
    """SHA-256 of the file's first 10 MB (32 hex digits); of a frame
    directory, of its frames' names and sizes, then their first 10 MB."""
    h = hashlib.sha256()
    try:
        if Path(path).is_dir():
            from framewright_tpu_torch.io.png_seq import list_frames

            frames = list_frames(Path(path))
            for p in frames:
                h.update(f"{p.name}:{p.stat().st_size};".encode())
            left = _HASH_BYTES
            for p in frames:
                if left <= 0:
                    break
                with open(p, "rb") as f:
                    chunk = f.read(left)
                h.update(chunk)
                left -= len(chunk)
        else:
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
    current_stage: str = ""                                    # the stage started last
    frames_done: Dict[str, int] = field(default_factory=dict)  # stage -> contiguous count
    carry: Dict[str, Any] = field(default_factory=dict)        # str(frame) -> state there
    stage_state: Dict[str, Any] = field(default_factory=dict)  # stage -> what a rerun reads
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

    def peek(self, source: Path, config_hash: str) -> Optional[PipelineCheckpoint]:
        """The source's checkpoint if its config hash matches, else None;
        nothing is opened, changed or removed (``start`` does that)."""
        path = self.path(video_content_hash(source))
        try:
            ckpt = PipelineCheckpoint.from_json(path.read_text())
        except (json.JSONDecodeError, TypeError, OSError):
            return None
        return ckpt if ckpt.config_hash == config_hash else None

    @property
    def checkpoint(self) -> PipelineCheckpoint:
        if self._ckpt is None:
            raise CheckpointError("CheckpointManager.start() not called")
        return self._ckpt

    def stage_started(self, stage: str) -> None:
        self.checkpoint.current_stage = stage
        self.save()

    def is_stage_complete(self, stage: str) -> bool:
        return stage in self.checkpoint.completed_stages

    def stage_completed(self, stage: str) -> None:
        ck = self.checkpoint
        if stage not in ck.completed_stages:
            ck.completed_stages.append(stage)
        ck.current_stage = ""
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
