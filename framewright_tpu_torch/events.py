"""The event bus and the hook points around a restore's stages: the
port's copy of ``framewright_tpu.events``.

``EventType`` names the lifecycle, stage, progress, resource and quality
events (the values are the JAX package's, so a subscriber written for
one package reads the other's); ``EventBus`` is a synchronous pub-sub
bus with per-type or catch-all subscribers, an optional predicate and a
bounded history; ``HookManager`` runs registered hooks in priority
order at each ``HookPoint`` on a context dict they may change. A
subscriber or hook that raises is logged and skipped: it cannot stop the
restore. Subscribers run on the emitting thread.

``HBM_PRESSURE`` keeps the JAX name: on the card it is emitted for the
card's memory (``safeguards.DeviceMemoryMonitor``).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


class EventType(Enum):
    # Lifecycle
    JOB_STARTED = "job_started"
    JOB_COMPLETED = "job_completed"
    JOB_FAILED = "job_failed"
    JOB_CANCELLED = "job_cancelled"
    JOB_PAUSED = "job_paused"
    JOB_RESUMED = "job_resumed"
    # Stages
    STAGE_STARTED = "stage_started"
    STAGE_COMPLETED = "stage_completed"
    STAGE_FAILED = "stage_failed"
    STAGE_SKIPPED = "stage_skipped"
    STAGE_RETRYING = "stage_retrying"
    # Progress
    PROGRESS = "progress"
    FRAME_PROCESSED = "frame_processed"
    CHUNK_COMPLETED = "chunk_completed"
    CHECKPOINT_SAVED = "checkpoint_saved"
    CHECKPOINT_RESTORED = "checkpoint_restored"
    # Resources
    HBM_PRESSURE = "hbm_pressure"
    HOST_MEMORY_LOW = "host_memory_low"
    DISK_SPACE_LOW = "disk_space_low"
    COMPILATION_STARTED = "compilation_started"
    COMPILATION_FINISHED = "compilation_finished"
    DEVICE_ERROR = "device_error"
    # Quality
    QUALITY_CHECK_PASSED = "quality_check_passed"
    QUALITY_CHECK_FAILED = "quality_check_failed"
    SCENE_DETECTED = "scene_detected"


@dataclass
class Event:
    type: EventType
    data: Dict[str, Any] = field(default_factory=dict)
    timestamp: float = field(default_factory=time.time)
    source: str = ""


Subscriber = Callable[[Event], None]


class EventBus:
    """Thread-safe synchronous pub-sub bus."""

    def __init__(self) -> None:
        self._subs: Dict[Optional[EventType], List[tuple]] = defaultdict(list)
        self._lock = threading.RLock()
        self._history: List[Event] = []
        self._history_limit = 1000

    def subscribe(
        self,
        handler: Subscriber,
        event_type: Optional[EventType] = None,
        predicate: Optional[Callable[[Event], bool]] = None,
    ) -> Callable[[], None]:
        """Register a handler; returns an unsubscribe callable.

        ``event_type=None`` subscribes to all events; ``predicate``
        optionally filters on payload.
        """
        entry = (handler, predicate)
        with self._lock:
            self._subs[event_type].append(entry)

        def unsubscribe() -> None:
            with self._lock:
                try:
                    self._subs[event_type].remove(entry)
                except ValueError:
                    pass

        return unsubscribe

    def emit(self, type_: EventType, source: str = "", **data: Any) -> Event:
        ev = Event(type=type_, data=data, source=source)
        with self._lock:
            self._history.append(ev)
            if len(self._history) > self._history_limit:
                self._history = self._history[-self._history_limit:]
            targets = list(self._subs[type_]) + list(self._subs[None])
        for handler, predicate in targets:
            try:
                if predicate is None or predicate(ev):
                    handler(ev)
            except Exception:  # noqa: BLE001 - subscriber isolation
                logger.exception("event subscriber failed for %s", type_)
        return ev

    def history(self, type_: Optional[EventType] = None) -> List[Event]:
        with self._lock:
            if type_ is None:
                return list(self._history)
            return [e for e in self._history if e.type is type_]

    def clear(self) -> None:
        with self._lock:
            self._history.clear()


# Global default bus (modules may also construct private buses).
_GLOBAL_BUS: Optional[EventBus] = None
_GLOBAL_LOCK = threading.Lock()


def get_event_bus() -> EventBus:
    global _GLOBAL_BUS
    with _GLOBAL_LOCK:
        if _GLOBAL_BUS is None:
            _GLOBAL_BUS = EventBus()
        return _GLOBAL_BUS


# ---------------------------------------------------------------------------
# Hook points (plugin pre/post interception around stages)
# ---------------------------------------------------------------------------

class HookPoint(Enum):
    PRE_PIPELINE = "pre_pipeline"
    POST_PIPELINE = "post_pipeline"
    PRE_STAGE = "pre_stage"
    POST_STAGE = "post_stage"
    PRE_FRAME_BATCH = "pre_frame_batch"
    POST_FRAME_BATCH = "post_frame_batch"
    ON_ERROR = "on_error"
    ON_CHECKPOINT = "on_checkpoint"


class HookManager:
    """Ordered hook registry. Hooks may change the context dict they
    receive; an exception in a hook is logged, not raised."""

    def __init__(self) -> None:
        self._hooks: Dict[HookPoint, List[tuple]] = defaultdict(list)
        self._lock = threading.RLock()

    def register(
        self, point: HookPoint, fn: Callable[[Dict[str, Any]], None], priority: int = 50
    ) -> None:
        with self._lock:
            self._hooks[point].append((priority, fn))
            self._hooks[point].sort(key=lambda t: t[0])

    def fire(self, point: HookPoint, context: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            hooks = list(self._hooks[point])
        for _, fn in hooks:
            try:
                fn(context)
            except Exception:  # noqa: BLE001
                logger.exception("hook failed at %s", point)
        return context

    def count(self, point: Optional[HookPoint] = None) -> int:
        with self._lock:
            if point is not None:
                return len(self._hooks[point])
            return sum(len(v) for v in self._hooks.values())
