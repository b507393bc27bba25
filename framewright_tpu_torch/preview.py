"""Preview rendering (the port of ``framewright_tpu.preview``): a
segment cache, a render queue and the preview server. A preview renders
a frame range of the source through the port's ``VideoRestorer`` on the
card (the server's ``device`` for a config on ``auto``), so it runs the
real pipeline on a few seconds of video.

The segment is the source's frames cut out as a Y4M: a Y4M source's frame
bytes are copied (``io.y4m.concat_y4m``), where JAX decodes them to RGB
and encodes them again, which moves 4:2:0 chroma (ROADMAP "JAX faults the
port must not copy"); so a segment's restore equals those frames of the
whole clip's restore. Other sources are decoded and encoded as in JAX.
"""

from __future__ import annotations

import hashlib
import heapq
import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Segment cache
# ---------------------------------------------------------------------------

class SegmentCache:
    """Size-bounded LRU cache of rendered preview segments (``*.y4m`` in
    ``cache_dir``, found again on reload)."""

    def __init__(self, cache_dir: Path, max_size_mb: int = 500):
        self.cache_dir = Path(cache_dir)
        self.max_size_mb = max_size_mb
        self._lock = threading.RLock()
        self._entries: Dict[str, Tuple[Path, float]] = {}
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        for f in self.cache_dir.glob("*.y4m"):
            self._entries[f.stem] = (f, f.stat().st_mtime)

    @staticmethod
    def make_key(start: int, n_frames: int, config_hash: str) -> str:
        data = f"{start}_{n_frames}_{config_hash}"
        return hashlib.sha256(data.encode()).hexdigest()[:16]

    def get(self, start: int, n_frames: int,
            config_hash: str) -> Optional[Path]:
        key = self.make_key(start, n_frames, config_hash)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            path, _ = entry
            if not path.exists():
                del self._entries[key]
                return None
            self._entries[key] = (path, time.time())
            return path

    def put_file(self, start: int, n_frames: int, config_hash: str,
                 source: Path) -> Path:
        key = self.make_key(start, n_frames, config_hash)
        dst = self.cache_dir / f"{key}.y4m"
        with self._lock:
            self._evict_if_needed(source.stat().st_size)
            source.replace(dst)
            self._entries[key] = (dst, time.time())
        return dst

    def size_bytes(self) -> int:
        with self._lock:
            return sum(p.stat().st_size for p, _ in self._entries.values()
                       if p.exists())

    def _evict_if_needed(self, needed: int) -> None:
        budget = self.max_size_mb * 1024 * 1024
        while self._entries and self.size_bytes() + needed > budget:
            key = min(self._entries, key=lambda k: self._entries[k][1])
            path, _ = self._entries.pop(key)
            path.unlink(missing_ok=True)

    def clear(self) -> None:
        with self._lock:
            for path, _ in self._entries.values():
                path.unlink(missing_ok=True)
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# ---------------------------------------------------------------------------
# Render queue
# ---------------------------------------------------------------------------

@dataclass(order=True)
class _QueueItem:
    priority: int
    seq: int
    task: "RenderTask" = field(compare=False)


@dataclass
class RenderTask:
    """One queued preview render."""

    task_id: str
    start: int
    n_frames: int
    config_hash: str
    status: str = "queued"        # queued | rendering | done | failed | cancelled
    progress: float = 0.0
    output: Optional[Path] = None
    error: str = ""


class RenderQueue:
    """Priority render queue with one worker thread; a render's failure
    is reported on its task."""

    def __init__(self, render_fn: Callable[[RenderTask], Path],
                 cache: SegmentCache):
        self._render_fn = render_fn
        self._cache = cache
        self._heap: List[_QueueItem] = []
        self._tasks: Dict[str, RenderTask] = {}
        self._lock = threading.Condition()
        self._seq = itertools.count()
        self._callbacks: List[Callable[[RenderTask], None]] = []
        self._worker: Optional[threading.Thread] = None
        self._stop = False

    def start(self) -> None:
        if self._worker is not None:
            return
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def stop(self) -> None:
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=10)
            self._worker = None

    def submit(self, start: int, n_frames: int, config_hash: str,
               priority: int = 0) -> RenderTask:
        cached = self._cache.get(start, n_frames, config_hash)
        task_id = SegmentCache.make_key(start, n_frames, config_hash)
        task = RenderTask(task_id=task_id, start=start, n_frames=n_frames,
                          config_hash=config_hash)
        if cached is not None:
            task.status = "done"
            task.progress = 1.0
            task.output = cached
            self._tasks[task_id] = task
            return task
        with self._lock:
            if task_id in self._tasks and \
                    self._tasks[task_id].status in ("queued", "rendering"):
                return self._tasks[task_id]
            self._tasks[task_id] = task
            heapq.heappush(self._heap,
                           _QueueItem(-priority, next(self._seq), task))
            self._lock.notify()
        return task

    def get_task(self, task_id: str) -> Optional[RenderTask]:
        return self._tasks.get(task_id)

    def cancel(self, task_id: str) -> bool:
        with self._lock:
            task = self._tasks.get(task_id)
            if task is None or task.status != "queued":
                return False
            task.status = "cancelled"
            return True

    def on_progress(self, cb: Callable[[RenderTask], None]) -> None:
        self._callbacks.append(cb)

    def active_count(self) -> int:
        with self._lock:
            return sum(1 for t in self._tasks.values()
                       if t.status in ("queued", "rendering"))

    # ------------------------------------------------------------------
    def _notify(self, task: RenderTask) -> None:
        for cb in self._callbacks:
            try:
                cb(task)
            except Exception:  # noqa: BLE001 — observer must not kill worker
                logger.exception("preview progress callback failed")

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._heap and not self._stop:
                    self._lock.wait(timeout=1.0)
                if self._stop:
                    return
                item = heapq.heappop(self._heap)
            task = item.task
            if task.status == "cancelled":
                continue
            task.status = "rendering"
            self._notify(task)
            try:
                out = self._render_fn(task)
                task.output = self._cache.put_file(
                    task.start, task.n_frames, task.config_hash, out)
                task.status = "done"
                task.progress = 1.0
            except Exception as exc:  # noqa: BLE001 — reported on the task
                task.status = "failed"
                task.error = str(exc)
                logger.warning("preview render failed: %s", exc)
            self._notify(task)


# ---------------------------------------------------------------------------
# Preview server
# ---------------------------------------------------------------------------

class PreviewServer:
    """Render small segments of ``source`` under one or more configs
    (the REST API exposes it through ``/api/preview``). ``device``
    (``auto``: the card, ``DeviceError`` without one) renders every
    segment whose config leaves the device on ``auto``."""

    def __init__(self, source: Path, work_dir: Path, cache_mb: int = 500,
                 device: str = "auto"):
        from framewright_tpu_torch.config import Config
        from framewright_tpu_torch.hw import resolve_device

        self.device = resolve_device(device).type
        self.source = Path(source)
        self.work_dir = Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.cache = SegmentCache(self.work_dir / "cache", cache_mb)
        self.queue = RenderQueue(self._render, self.cache)
        self._configs: Dict[str, Config] = {}
        self._started = time.time()

    def start(self) -> None:
        self.queue.start()

    def stop(self) -> None:
        self.queue.stop()

    def render_segment(self, start: int, n_frames: int, config,
                       priority: int = 5) -> RenderTask:
        """Queue a preview of frames [start, start + n) under ``config``."""
        chash = config.get_hash()[:12]
        self._configs[chash] = config
        return self.queue.submit(start, n_frames, chash, priority)

    def compare_settings(self, start: int, n_frames: int, configs) -> Dict[str, RenderTask]:
        """The same segment under several configs (an A/B preview)."""
        return {cfg.get_hash()[:12]: self.render_segment(start, n_frames, cfg)
                for cfg in configs}

    def status(self) -> Dict:
        return {
            "running": self.queue._worker is not None,
            "active_renders": self.queue.active_count(),
            "cached_segments": len(self.cache),
            "cache_size_mb": round(self.cache.size_bytes() / 2**20, 2),
            "uptime_seconds": round(time.time() - self._started, 1),
        }

    def _cut(self, seg: Path, start: int, n_frames: int) -> None:
        from framewright_tpu_torch.io.video import open_reader
        from framewright_tpu_torch.io.y4m import Y4MWriter, concat_y4m

        if self.source.suffix.lower() == ".y4m":
            concat_y4m([self.source], seg, start=start, end=start + n_frames)
            return
        with open_reader(self.source) as r, \
                Y4MWriter(seg, r.width, r.height, fps=getattr(r, "fps", 25.0)) as w:
            for i, frame in enumerate(r):
                if i >= start + n_frames:
                    break
                if i >= start:
                    w.write_frame(frame)

    def _render(self, task: RenderTask) -> Path:
        from framewright_tpu_torch.restorer import VideoRestorer

        cfg = self._configs[task.config_hash]
        seg = self.work_dir / f"seg_{task.task_id}.y4m"
        self._cut(seg, task.start, task.n_frames)
        task.progress = 0.2
        out = self.work_dir / f"out_{task.task_id}.y4m"
        proj = cfg.with_overrides(
            project_dir=self.work_dir / f"proj_{task.task_id}",
            checkpoint_enabled=False, resume=False,
            device_platform=(self.device if cfg.device_platform == "auto"
                             else cfg.device_platform))
        VideoRestorer(proj).restore_video(seg, out)
        seg.unlink(missing_ok=True)
        task.progress = 1.0
        return out
