"""Priority job scheduler with a worker thread (the port's
``framewright_tpu/engine/scheduler.py``): higher priority first, FIFO
within a priority; submit, cancel, pause, resume, a retry budget, the
job store for persistence and the event bus for JOB_STARTED, COMPLETED
and FAILED. The default process restores a job with the port's
``VideoRestorer`` (on the card unless its config asks for the CPU).

``wait_idle`` waits on the scheduler's condition, which the worker
notifies after each job, instead of polling the store.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from framewright_tpu_torch.events import EventBus, EventType
from framewright_tpu_torch.persistence import JobRecord, JobStore

logger = logging.getLogger(__name__)


@dataclass(order=True)
class _QueueEntry:
    sort_key: tuple
    job_id: str = field(compare=False)


class JobScheduler:
    """Single-worker priority scheduler."""

    def __init__(self, store: JobStore,
                 process_fn: Optional[Callable[[JobRecord], None]] = None,
                 events: Optional[EventBus] = None, max_retries: int = 1):
        self.store = store
        self.events = events or EventBus()
        self.max_retries = max_retries
        self._counter = itertools.count()
        self._heap: List[_QueueEntry] = []
        self._priorities: Dict[str, int] = {}
        self._retries: Dict[str, int] = {}
        self._cancelled: set = set()
        self._running: Optional[str] = None
        self._paused = threading.Event()
        self._stop = threading.Event()
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._process_fn = process_fn or self._default_process
        self.stats = {"completed": 0, "failed": 0, "cancelled": 0, "retried": 0}

    @staticmethod
    def _default_process(job: JobRecord) -> None:
        from framewright_tpu_torch.config import Config
        from framewright_tpu_torch.restorer import VideoRestorer

        cfg = Config.from_dict(job.config) if job.config else Config()
        VideoRestorer(cfg).restore_video(job.source, output=job.output or None)

    # ------------------------------------------------------------------
    def submit(self, source: str, output: str = "", config: Optional[dict] = None,
               priority: int = 50) -> str:
        jid = self.store.create_job(source, output, config=config or {})
        with self._cv:
            self._priorities[jid] = priority
            heapq.heappush(self._heap, _QueueEntry((-priority, next(self._counter)), jid))
            self._cv.notify_all()
        return jid

    def cancel(self, job_id: str) -> None:
        with self._cv:
            self._cancelled.add(job_id)
            self.stats["cancelled"] += 1
        self.store.set_state(job_id, "cancelled")

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()
        with self._cv:
            self._cv.notify_all()

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._worker_loop, daemon=True,
                                        name="fw-scheduler")
        self._thread.start()

    def stop(self, wait: bool = True, timeout: float = 10.0) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if wait and self._thread:
            self._thread.join(timeout=timeout)

    def _next_job(self) -> Optional[str]:
        """The next job not cancelled, once the queue has one and the
        scheduler is not paused; None when stopped."""
        with self._cv:
            while not self._stop.is_set():
                if not self._paused.is_set():
                    while self._heap:
                        entry = heapq.heappop(self._heap)
                        if entry.job_id not in self._cancelled:
                            self._running = entry.job_id
                            return entry.job_id
                self._cv.wait()
            return None

    def _worker_loop(self) -> None:
        while True:
            jid = self._next_job()
            if jid is None:
                return
            try:
                self._run(jid)
            finally:
                with self._cv:
                    self._running = None
                    self._cv.notify_all()

    def _run(self, jid: str) -> None:
        job = self.store.get_job(jid)
        if job is None:
            return
        self.store.set_state(jid, "running")
        self.events.emit(EventType.JOB_STARTED, job_id=jid)
        try:
            self._process_fn(job)
        except Exception as exc:  # noqa: BLE001 - the job's failure is recorded
            retries = self._retries.get(jid, 0)
            if retries < self.max_retries:
                self._retries[jid] = retries + 1
                with self._cv:
                    self.stats["retried"] += 1
                    heapq.heappush(self._heap, _QueueEntry(
                        (-self._priorities.get(jid, 50), next(self._counter)), jid))
                self.store.set_state(jid, "pending")
            else:
                logger.exception("job %s failed", jid)
                self.store.set_state(jid, "failed", error=str(exc))
                with self._cv:
                    self.stats["failed"] += 1
                self.events.emit(EventType.JOB_FAILED, job_id=jid, error=str(exc))
            return
        self.store.set_state(jid, "completed")
        with self._cv:
            self.stats["completed"] += 1
        self.events.emit(EventType.JOB_COMPLETED, job_id=jid)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until the queue is empty and no job runs (True), or
        ``timeout`` seconds pass (False)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._heap or self._running is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return True
