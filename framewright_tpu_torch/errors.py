"""Errors the port raises (a subset of ``framewright_tpu.errors``, with
its hierarchy: a ``TransientError`` may succeed on a retry or with fewer
resources, a ``FatalError`` will not).

A device out-of-memory is ``torch.cuda.OutOfMemoryError`` and nothing
else: the SR processor catches that type to downshift its plan, and
``classify_error`` maps it to ``HBMError``. No rule maps error text to
an error class (the JAX ``classify_error`` does, so that any message
with "http 500" in it becomes a compile error): anything that is not a
``FramewrightError`` or a device out-of-memory is fatal.
"""

from __future__ import annotations

from typing import Optional


class FramewrightError(Exception):
    """Base class for all errors of the port."""

    def __init__(self, message: str = "", *, details: Optional[dict] = None):
        super().__init__(message)
        self.message = message
        self.details = details or {}


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
