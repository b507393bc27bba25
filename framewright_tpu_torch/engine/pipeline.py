"""The stage-DAG engine a restore runs under: the port's copy of
``framewright_tpu.engine.pipeline``.

Named stages with dependencies run in a deterministic topological order
(Kahn, declaration order breaking ties); a cycle, an unknown dependency
or a duplicate name raises ``StageError`` when the pipeline is built. A
stage may be disabled (skipped), restored as completed by a resumed run
(``restore_completed``: skipped, reported completed), retried on a
``TransientError`` up to ``max_retries`` times with exponential
back-off (``retry_delay * 2**attempt``), bounded by ``timeout_s`` (the
stage runs in a thread; ``StageError`` when it outlives the limit), and
critical (its failure raises ``StageError`` from the error) or not (its
dependents are skipped). ``PipelineContext`` carries the stages' shared
dict and the cooperative cancel and pause (``checkpoint_wait`` between
units of work). Each step emits its ``EventType`` on the bus and fires
its ``HookPoint``.

Errors are classified by ``errors.classify_error``: only a
``TransientError`` (a device out-of-memory among them) is retried. The
JAX engine classifies by the error's text, so a message that merely
mentions a timeout or a connection is retried there.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Sequence

from framewright_tpu_torch.errors import (
    CancelledError,
    FramewrightError,
    StageError,
    TransientError,
    classify_error,
)
from framewright_tpu_torch.events import EventBus, EventType, HookManager, HookPoint

logger = logging.getLogger(__name__)


class StageStatus(Enum):
    PENDING = "pending"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    SKIPPED = "skipped"
    CANCELLED = "cancelled"


@dataclass
class Stage:
    """A named unit of work. ``fn(context) -> dict | None``; returned
    dict merges into the shared context."""

    name: str
    fn: Callable[[Dict[str, Any]], Optional[Dict[str, Any]]]
    depends_on: Sequence[str] = ()
    enabled: bool = True
    max_retries: int = 0
    retry_delay: float = 1.0
    timeout_s: float = 0.0          # 0 = no timeout
    critical: bool = True           # failure aborts pipeline if True

    status: StageStatus = field(default=StageStatus.PENDING, init=False)
    duration_s: float = field(default=0.0, init=False)
    error: Optional[str] = field(default=None, init=False)
    attempts: int = field(default=0, init=False)
    exception: Optional[BaseException] = field(default=None, init=False)  # the
                                    # last attempt's own error, as raised


class PipelineContext:
    """Shared state + cooperative pause/cancel control."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self.data: Dict[str, Any] = dict(data or {})
        self._cancel = threading.Event()
        self._pause = threading.Event()
        self._lock = threading.RLock()

    def cancel(self) -> None:
        self._cancel.set()

    def pause(self) -> None:
        self._pause.set()

    def resume(self) -> None:
        self._pause.clear()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    @property
    def paused(self) -> bool:
        return self._pause.is_set()

    def checkpoint_wait(self) -> None:
        """Call between units of work: blocks while paused, raises
        ``CancelledError`` when cancelled."""
        if self._cancel.is_set():
            raise CancelledError("pipeline cancelled")
        while self._pause.is_set():
            if self._cancel.is_set():
                raise CancelledError("pipeline cancelled")
            time.sleep(0.05)

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self.data.get(key, default)

    def update(self, d: Dict[str, Any]) -> None:
        with self._lock:
            self.data.update(d)


class Pipeline:
    def __init__(
        self,
        stages: Sequence[Stage],
        events: Optional[EventBus] = None,
        hooks: Optional[HookManager] = None,
        name: str = "pipeline",
        completed_stages: Optional[Sequence[str]] = None,
    ):
        self.name = name
        self.stages = list(stages)
        self.events = events or EventBus()
        self.hooks = hooks or HookManager()
        self._by_name = {s.name: s for s in self.stages}
        if len(self._by_name) != len(self.stages):
            raise StageError("duplicate stage names")
        self._completed_restore = set(completed_stages or ())
        self.validate()

    # ------------------------------------------------------------------
    def validate(self) -> None:
        for s in self.stages:
            for dep in s.depends_on:
                if dep not in self._by_name:
                    raise StageError(
                        f"stage {s.name!r} depends on unknown {dep!r}", stage=s.name
                    )
        self.execution_order()  # raises on cycles

    def execution_order(self) -> List[str]:
        """Deterministic topological order (Kahn; declaration order as
        tiebreak)."""
        indeg = {s.name: 0 for s in self.stages}
        dependents: Dict[str, List[str]] = {s.name: [] for s in self.stages}
        for s in self.stages:
            for dep in s.depends_on:
                indeg[s.name] += 1
                dependents[dep].append(s.name)
        order: List[str] = []
        ready = [s.name for s in self.stages if indeg[s.name] == 0]
        while ready:
            n = ready.pop(0)
            order.append(n)
            for m in dependents[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(self.stages):
            cyc = [n for n, d in indeg.items() if d > 0]
            raise StageError(f"dependency cycle involving {cyc}")
        return order

    # ------------------------------------------------------------------
    def run(self, context: Optional[PipelineContext] = None) -> PipelineContext:
        ctx = context or PipelineContext()
        self.events.emit(EventType.JOB_STARTED, source=self.name)
        self.hooks.fire(HookPoint.PRE_PIPELINE, ctx.data)
        try:
            for name in self.execution_order():
                stage = self._by_name[name]
                ctx.checkpoint_wait()
                self._run_stage(stage, ctx)
            self.events.emit(EventType.JOB_COMPLETED, source=self.name)
        except CancelledError:
            self.events.emit(EventType.JOB_CANCELLED, source=self.name)
            for s in self.stages:
                if s.status is StageStatus.PENDING:
                    s.status = StageStatus.CANCELLED
            raise
        except FramewrightError as exc:
            self.events.emit(EventType.JOB_FAILED, source=self.name, error=str(exc))
            raise
        finally:
            self.hooks.fire(HookPoint.POST_PIPELINE, ctx.data)
        return ctx

    def _deps_ok(self, stage: Stage) -> bool:
        return all(
            self._by_name[d].status in (StageStatus.COMPLETED, StageStatus.SKIPPED)
            for d in stage.depends_on
        )

    def _run_stage(self, stage: Stage, ctx: PipelineContext) -> None:
        if not stage.enabled or stage.name in self._completed_restore:
            stage.status = (
                StageStatus.COMPLETED
                if stage.name in self._completed_restore
                else StageStatus.SKIPPED
            )
            self.events.emit(EventType.STAGE_SKIPPED, source=self.name,
                             stage=stage.name, restored=stage.name in self._completed_restore)
            return
        if not self._deps_ok(stage):
            stage.status = StageStatus.SKIPPED
            self.events.emit(EventType.STAGE_SKIPPED, source=self.name,
                             stage=stage.name, reason="dependency_failed")
            return

        self.events.emit(EventType.STAGE_STARTED, source=self.name, stage=stage.name)
        self.hooks.fire(HookPoint.PRE_STAGE, {"stage": stage.name, **ctx.data})
        stage.status = StageStatus.RUNNING
        t0 = time.time()
        last_err: Optional[BaseException] = None
        for attempt in range(stage.max_retries + 1):
            stage.attempts = attempt + 1
            try:
                ctx.checkpoint_wait()
                out = self._call_with_timeout(stage, ctx)
                if out:
                    ctx.update(out)
                stage.status = StageStatus.COMPLETED
                stage.duration_s = time.time() - t0
                self.events.emit(
                    EventType.STAGE_COMPLETED, source=self.name,
                    stage=stage.name, duration_s=stage.duration_s,
                )
                self.hooks.fire(HookPoint.POST_STAGE, {"stage": stage.name, **ctx.data})
                return
            except CancelledError:
                stage.status = StageStatus.CANCELLED
                raise
            except Exception as exc:  # noqa: BLE001
                err = classify_error(exc)
                last_err = err
                stage.exception = exc
                self.hooks.fire(HookPoint.ON_ERROR,
                                {"stage": stage.name, "error": err, **ctx.data})
                if isinstance(err, TransientError) and attempt < stage.max_retries:
                    self.events.emit(EventType.STAGE_RETRYING, source=self.name,
                                     stage=stage.name, attempt=attempt + 1)
                    time.sleep(stage.retry_delay * (2 ** attempt))
                    continue
                break
        stage.status = StageStatus.FAILED
        stage.duration_s = time.time() - t0
        stage.error = str(last_err)
        self.events.emit(EventType.STAGE_FAILED, source=self.name,
                         stage=stage.name, error=str(last_err))
        if stage.critical:
            raise StageError(
                f"stage {stage.name!r} failed: {last_err}", stage=stage.name
            ) from last_err

    def _call_with_timeout(self, stage: Stage, ctx: PipelineContext):
        if stage.timeout_s <= 0:
            return stage.fn(ctx.data)
        result: Dict[str, Any] = {}
        error: List[BaseException] = []

        def target():
            try:
                result["out"] = stage.fn(ctx.data)
            except BaseException as exc:  # noqa: BLE001
                error.append(exc)

        th = threading.Thread(target=target, daemon=True)
        th.start()
        th.join(stage.timeout_s)
        if th.is_alive():
            raise StageError(
                f"stage {stage.name!r} timed out after {stage.timeout_s}s",
                stage=stage.name,
            )
        if error:
            raise error[0]
        return result.get("out")

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "stages": [
                {
                    "name": s.name,
                    "status": s.status.value,
                    "duration_s": round(s.duration_s, 3),
                    "attempts": s.attempts,
                    "error": s.error,
                }
                for s in self.stages
            ],
        }

    def completed_stage_names(self) -> List[str]:
        return [s.name for s in self.stages if s.status is StageStatus.COMPLETED]


class PipelineBuilder:
    """Fluent builder of a ``Pipeline``."""

    def __init__(self, name: str = "pipeline"):
        self._name = name
        self._stages: List[Stage] = []
        self._events: Optional[EventBus] = None
        self._hooks: Optional[HookManager] = None
        self._restore: List[str] = []

    def stage(self, name: str, fn: Callable, depends_on: Sequence[str] = (),
              enabled: bool = True, max_retries: int = 0,
              timeout_s: float = 0.0, critical: bool = True,
              retry_delay: float = 1.0) -> "PipelineBuilder":
        self._stages.append(Stage(
            name=name, fn=fn, depends_on=tuple(depends_on), enabled=enabled,
            max_retries=max_retries, timeout_s=timeout_s, critical=critical,
            retry_delay=retry_delay,
        ))
        return self

    def events(self, bus: EventBus) -> "PipelineBuilder":
        self._events = bus
        return self

    def hooks(self, hm: HookManager) -> "PipelineBuilder":
        self._hooks = hm
        return self

    def restore_completed(self, names: Sequence[str]) -> "PipelineBuilder":
        self._restore = list(names)
        return self

    def build(self) -> Pipeline:
        return Pipeline(self._stages, events=self._events, hooks=self._hooks,
                        name=self._name, completed_stages=self._restore)
