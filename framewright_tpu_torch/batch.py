"""Batch processing: the job queue, the watch folder and time-window
scheduling (the port's ``framewright_tpu/batch.py``, over the port's
``persistence.JobStore``). The default process runs the port's restore
of each job's config."""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

from framewright_tpu_torch.config import Config
from framewright_tpu_torch.persistence import JobRecord, JobStore

logger = logging.getLogger(__name__)

VIDEO_SUFFIXES = (".y4m", ".mp4", ".mkv", ".avi", ".mov", ".webm", ".mpg", ".ts")


class _JobLogBuffer(logging.Handler):
    """Per-job ring buffer of log lines: attached to the package's logger
    for the duration of a job."""

    def __init__(self, maxlen: int = 400):
        super().__init__(level=logging.INFO)
        self.maxlen = maxlen
        self.lines: List[str] = []
        self.setFormatter(logging.Formatter("%(asctime)s %(levelname).1s "
                                            "%(name)s: %(message)s",
                                            datefmt="%H:%M:%S"))

    def emit(self, record):
        try:
            self.lines.append(self.format(record))
            if len(self.lines) > self.maxlen:
                del self.lines[: len(self.lines) - self.maxlen]
        except Exception:  # noqa: BLE001 — logging must never raise
            pass


class BatchQueueProcessor:
    """Drains pending jobs from the store through a process function
    (default: the port's ``VideoRestorer.restore_video`` with the job's
    config, on the card unless that config asks for the CPU)."""

    def __init__(self, store: JobStore,
                 process_fn: Optional[Callable[[JobRecord], None]] = None):
        self.store = store
        self.process_fn = process_fn or self._default_process
        self._stop = threading.Event()
        self.job_logs: Dict[str, List[str]] = {}
        self._log_keep = 20       # completed-job logs kept in memory

    def job_log(self, job_id: str) -> Optional[List[str]]:
        return self.job_logs.get(job_id)

    def _default_process(self, job: JobRecord) -> None:
        from framewright_tpu_torch.restorer import VideoRestorer

        cfg = Config.from_dict(job.config) if job.config else Config()

        last = {"t": 0.0}

        def on_progress(info) -> None:
            # live per-stage progress for dashboards (throttled writes)
            now = time.time()
            if now - last["t"] < 0.5 and info.frames_done < info.total_frames:
                return
            last["t"] = now
            try:
                self.store.update_progress(
                    job.job_id, info.frames_done, stage=info.stage,
                    total_frames=info.total_frames or None)
            except Exception:  # noqa: BLE001 — progress is best-effort
                logger.debug("progress write failed", exc_info=True)

        VideoRestorer(cfg, progress_callback=on_progress).restore_video(
            job.source, output=job.output or None)

    def submit(self, source: str, output: str = "",
               config: Optional[Config] = None) -> str:
        return self.store.create_job(
            source, output,
            config=config.to_dict() if config else {},
            config_hash=config.get_hash() if config else "",
        )

    def process_next(self) -> Optional[str]:
        pending = self.store.list_jobs("pending")
        if not pending:
            return None
        job = pending[0]
        self.store.set_state(job.job_id, "running")
        buf = _JobLogBuffer()
        self.job_logs[job.job_id] = buf.lines
        if len(self.job_logs) > self._log_keep:
            self.job_logs.pop(next(iter(self.job_logs)))
        pkg_logger = logging.getLogger("framewright_tpu_torch")
        pkg_logger.addHandler(buf)
        old_level = pkg_logger.level
        if pkg_logger.getEffectiveLevel() > logging.INFO:
            pkg_logger.setLevel(logging.INFO)  # records must reach the
            #                                    buffer even when the app
            #                                    runs at WARNING
        try:
            self.process_fn(job)
            self.store.set_state(job.job_id, "completed")
        except Exception as exc:  # noqa: BLE001
            logger.exception("job %s failed", job.job_id)
            self.store.set_state(job.job_id, "failed", error=str(exc))
        finally:
            pkg_logger.removeHandler(buf)
            pkg_logger.setLevel(old_level)
        return job.job_id

    def run_until_empty(self) -> int:
        n = 0
        while not self._stop.is_set() and self.process_next() is not None:
            n += 1
        return n

    def resume_crashed(self) -> int:
        """Requeue jobs left 'running' by a crashed process."""
        n = 0
        for job in self.store.resumable_jobs():
            self.store.set_state(job.job_id, "pending")
            n += 1
        return n

    def stop(self) -> None:
        self._stop.set()


class WatchFolder:
    """Watch a directory for new videos and enqueue them: a file is
    enqueued once its size is the same on two polls."""

    def __init__(self, watch_dir: Path, queue: BatchQueueProcessor,
                 config: Optional[Config] = None, poll_s: float = 2.0,
                 output_dir: Optional[Path] = None):
        self.watch_dir = Path(watch_dir)
        self.queue = queue
        self.config = config
        self.poll_s = poll_s
        self.output_dir = Path(output_dir) if output_dir else self.watch_dir / "restored"
        self._seen: Dict[Path, int] = {}
        self._enqueued: set = set()
        self._stop = threading.Event()

    def scan_once(self) -> List[str]:
        """One poll cycle; returns job ids enqueued this cycle."""
        new_jobs = []
        if not self.watch_dir.is_dir():
            return new_jobs
        for p in sorted(self.watch_dir.iterdir()):
            if p.suffix.lower() not in VIDEO_SUFFIXES or p in self._enqueued:
                continue
            size = p.stat().st_size
            if self._seen.get(p) == size and size > 0:
                out = self.output_dir / (p.stem + "_restored" + p.suffix)
                jid = self.queue.submit(str(p), str(out), self.config)
                new_jobs.append(jid)
                self._enqueued.add(p)
            self._seen[p] = size
        return new_jobs

    def run(self, max_cycles: Optional[int] = None) -> None:
        cycles = 0
        while not self._stop.is_set():
            self.scan_once()
            self.queue.run_until_empty()
            cycles += 1
            if max_cycles is not None and cycles >= max_cycles:
                return
            self._stop.wait(self.poll_s)

    def stop(self) -> None:
        self._stop.set()


@dataclass
class ScheduledJob:
    """Time-window scheduling: process only between start_hour and
    end_hour (e.g. overnight)."""

    source: str
    output: str = ""
    start_hour: int = 0
    end_hour: int = 24

    def runnable_now(self, now: Optional[time.struct_time] = None) -> bool:
        h = (now or time.localtime()).tm_hour
        if self.start_hour <= self.end_hour:
            return self.start_hour <= h < self.end_hour
        return h >= self.start_hour or h < self.end_hour  # wraps midnight


class BatchScheduler:
    def __init__(self, queue: BatchQueueProcessor):
        self.queue = queue
        self.scheduled: List[ScheduledJob] = []

    def add(self, job: ScheduledJob) -> None:
        self.scheduled.append(job)

    def tick(self, now: Optional[time.struct_time] = None) -> List[str]:
        """Enqueue scheduled jobs whose window is open."""
        out = []
        rest = []
        for j in self.scheduled:
            if j.runnable_now(now):
                out.append(self.queue.submit(j.source, j.output))
            else:
                rest.append(j)
        self.scheduled = rest
        return out
