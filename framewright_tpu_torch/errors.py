"""Errors the port raises (``framewright_tpu.errors``' taxonomy and its
retry machinery: a ``TransientError`` may succeed on a retry or with
fewer resources, a ``FatalError`` will not; ``RetryPolicy`` retries the
transient ones with JAX's backoff, ``ErrorReport`` counts a run's).

A device out-of-memory is ``torch.cuda.OutOfMemoryError`` and nothing
else: the SR processor catches that type to downshift its plan, and
``classify_error`` maps it to ``HBMError``. No rule maps error text to
an error class (the JAX ``classify_error`` does, so that any message
with "http 500" in it becomes a compile error): anything that is not a
``FramewrightError`` or a device out-of-memory is fatal.
"""

from __future__ import annotations

import functools
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class FramewrightError(Exception):
    """Base class for all errors of the port."""

    def __init__(self, message: str = "", *, details: Optional[dict] = None):
        super().__init__(message)
        self.message = message
        self.details = details or {}

    def to_dict(self) -> dict:
        return {"type": type(self).__name__, "message": self.message,
                "details": self.details}


class TransientError(FramewrightError):
    """Recoverable: a retry, possibly with fewer resources, may succeed."""


class FatalError(FramewrightError):
    """Unrecoverable: abort the stage or the job."""


class ConfigError(FatalError):
    """Invalid configuration value or combination."""


class InputError(FatalError):
    """Bad user input (missing file, unsupported format)."""


class MediaFormatError(InputError):
    """Could not parse a media container or frame."""


class DependencyError(FatalError):
    """A required optional dependency (the ffmpeg binary, Pillow) is missing."""


class DeviceError(FramewrightError):
    """The requested device is missing or unusable."""


class HBMError(TransientError, DeviceError):
    """Device memory exhausted even at the smallest plan."""


class CompilationError(FatalError, DeviceError):
    """A kernel or a program failed to build for the device."""


class DeviceUnavailableError(FatalError, DeviceError):
    """No usable accelerator, and no CPU run was asked for."""


class ModelError(FatalError):
    """Model weights missing or corrupt, or an architecture mismatch."""


class StageError(FramewrightError):
    """A pipeline stage failed."""

    def __init__(self, message: str = "", *, stage: str = "", **kw):
        super().__init__(message, **kw)
        self.stage = stage
        self.details.setdefault("stage", stage)


class CheckpointError(TransientError):
    """Checkpoint read or write failure."""


class ValidationError(FramewrightError):
    """The output failed the quality gates (PSNR/SSIM below thresholds,
    or a frame failed an integrity check)."""


class DiskSpaceError(TransientError):
    """Not enough free disk for the output or the intermediates."""


class CancelledError(FramewrightError):
    """The job was cancelled by the user."""


def classify_error(exc: BaseException) -> FramewrightError:
    """``exc`` in the port's taxonomy: a ``FramewrightError`` as it is, a
    device out-of-memory as ``HBMError`` (transient: a retry with less
    memory may succeed), anything else as a fatal ``FatalError`` naming
    its type."""
    if isinstance(exc, FramewrightError):
        return exc
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return HBMError(str(exc), details={"original_type": type(exc).__name__})
    return FatalError(str(exc), details={"original_type": type(exc).__name__})


class ShardingError(FatalError):
    """A device mesh or a batch split that the devices cannot hold."""


def is_transient(exc: BaseException) -> bool:
    return isinstance(classify_error(exc), TransientError)


@dataclass
class RetryPolicy:
    """Exponential backoff with jitter over the transient errors (JAX's
    contract): attempt k waits ``min(base * backoff**k, max_delay)``
    times a uniform factor in ``1 +- jitter``; ``on_retry(attempt, err)``
    runs before each wait."""

    max_attempts: int = 3
    base_delay: float = 0.5
    max_delay: float = 30.0
    backoff: float = 2.0
    jitter: float = 0.1
    retry_on: tuple = (TransientError,)
    on_retry: Optional[Callable[[int, BaseException], None]] = None

    def delay_for(self, attempt: int) -> float:
        d = min(self.base_delay * (self.backoff ** attempt), self.max_delay)
        return d * (1.0 + random.uniform(-self.jitter, self.jitter))

    def run(self, fn: Callable, *args, **kwargs):
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except Exception as exc:  # noqa: BLE001 - classified, then raised or retried
                err = classify_error(exc)
                if not isinstance(err, self.retry_on) or attempt == self.max_attempts - 1:
                    raise err from exc
                if self.on_retry is not None:
                    self.on_retry(attempt, err)
                delay = self.delay_for(attempt)
                logger.warning("transient error (attempt %d/%d), retrying in %.2fs: %s",
                               attempt + 1, self.max_attempts, delay, err)
                time.sleep(delay)
        raise ValueError(f"max_attempts must be at least 1, got {self.max_attempts}")


def with_retry(policy: Optional[RetryPolicy] = None):
    """Decorator form of :class:`RetryPolicy`."""
    pol = policy or RetryPolicy()

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return pol.run(fn, *args, **kwargs)

        return wrapper

    return deco


@dataclass
class ErrorReport:
    """A run's errors for its end-of-job report, each classified."""

    errors: list = field(default_factory=list)

    def record(self, exc: BaseException, *, stage: str = "", frame: Optional[int] = None):
        err = classify_error(exc)
        self.errors.append({"stage": stage, "frame": frame, "type": type(err).__name__,
                            "message": err.message,
                            "transient": isinstance(err, TransientError)})

    @property
    def count(self) -> int:
        return len(self.errors)

    def summary(self) -> dict:
        by_type: dict = {}
        for e in self.errors:
            by_type[e["type"]] = by_type.get(e["type"], 0) + 1
        return {"total": self.count, "by_type": by_type}
