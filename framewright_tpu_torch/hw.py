"""Device selection, the card's name and free memory, the f32 precision
of the card's library calls, and a CUDA stream of its own for work that
another thread queues.

The port runs on ``cuda`` unless the caller asks for ``cpu``. Asking
for ``cuda`` on a machine without a card raises; nothing falls back to
the CPU quietly.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional, TypeVar, Union

import torch

from framewright_tpu_torch.errors import DeviceError


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``auto``, None or ``cuda[:i]`` -> that CUDA device (raises without
    a card); ``cpu`` -> the CPU."""
    name = "cuda" if device in (None, "auto") else str(device)
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError("cuda was asked for but no CUDA device is "
                              "available (pass device='cpu' to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise DeviceError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


@dataclass(frozen=True)
class DeviceInfo:
    name: str
    free_bytes: Optional[int]  # None on the CPU


def device_info(device: torch.device) -> DeviceInfo:
    if device.type != "cuda":
        return DeviceInfo("cpu", None)
    free, _ = torch.cuda.mem_get_info(device)
    return DeviceInfo(torch.cuda.get_device_name(device), int(free))


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """f32 convolutions (cuDNN) and matrix products (cuBLAS) in full f32
    for the block, whatever the caller has set: PyTorch's default
    ``torch.backends.cudnn.allow_tf32 = True`` would round their f32
    operands to TF32. Both flags are restored after the block."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


T = TypeVar("T")


def side_stream(device: torch.device) -> Optional["torch.cuda.Stream"]:
    """A CUDA stream of its own on ``device`` that starts after the work
    queued so far on the current stream (weights uploaded there); None on
    the CPU."""
    if device.type != "cuda":
        return None
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream


def on_stream(items: Iterable[T], stream: Optional["torch.cuda.Stream"]) -> Iterator[T]:
    """``items`` iterated with ``stream`` current in the thread that
    iterates them (PyTorch's current stream is per thread), so their card
    work, uploads and copies back queue there and a copy back waits for
    that stream only. ``stream`` None: ``items`` as they are."""
    if stream is None:
        yield from items
        return
    with torch.cuda.stream(stream):
        yield from items
