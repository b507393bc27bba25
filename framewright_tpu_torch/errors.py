"""Errors the port raises (a subset of ``framewright_tpu.errors``, with
its hierarchy: a ``TransientError`` may succeed on a retry or with fewer
resources, a ``FatalError`` will not).

A device out-of-memory is ``torch.cuda.OutOfMemoryError`` and nothing
else: the SR processor catches that type to downshift its plan. No rule
maps error text to an error class.
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
