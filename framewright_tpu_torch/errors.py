"""Errors the port's restore path raises (a subset of
``framewright_tpu.errors``).

A device out-of-memory is ``torch.cuda.OutOfMemoryError`` and nothing
else: the SR processor catches that type to downshift its plan. No rule
maps error text to an error class.
"""



class FramewrightError(Exception):
    """Base class for all errors of the port."""


class ConfigError(FramewrightError):
    """Invalid configuration value or combination."""


class InputError(FramewrightError):
    """Bad user input (missing file, unsupported format)."""


class MediaFormatError(InputError):
    """Could not parse a media container or frame."""


class DeviceError(FramewrightError):
    """The requested device is missing or unusable."""


class HBMError(DeviceError):
    """Device memory exhausted even at the smallest plan."""
