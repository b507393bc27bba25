"""Device selection, the card's name and free memory, the f32 precision
of the card's library calls, a CUDA stream of its own for work that
another thread queues, and the hardware report and tier the presets key
off (JAX's ``HardwareTier``, ``HardwareInfo``, ``detect_hardware`` and
``check_hardware``, mapped to CUDA cards: the tiers are CPU_ONLY,
GPU_SINGLE, GPU_MULTI (several local cards) and GPU_MULTI_HOST (a process
group of several processes); the memory is a card's total; the status is
``ok`` on ``cuda``).

The port runs on ``cuda`` unless the caller asks for ``cpu``. Asking
for ``cuda`` on a machine without a card raises; nothing falls back to
the CPU quietly.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from dataclasses import dataclass, field
from enum import Enum
from typing import Iterable, Iterator, List, Optional, Sequence, TypeVar, Union

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


@contextlib.contextmanager
def deterministic() -> Iterator[List[str]]:
    """The block with cuDNN's deterministic algorithms and PyTorch's
    deterministic implementations (``use_deterministic_algorithms``,
    warning only), so training gives the same bytes every run. Yields a
    list that collects, once each, the ops that warned they have no
    deterministic implementation (and cuBLAS's when
    ``CUBLAS_WORKSPACE_CONFIG`` is unset). Every setting is restored
    after the block."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    ops: List[str] = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield ops
    finally:
        cudnn.deterministic, cudnn.benchmark = saved[0], saved[1]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
    for w in caught:
        msg = str(w.message)
        if "does not have a deterministic implementation" in msg:
            name = msg.split(" does not have")[0].strip()
        elif "CUBLAS_WORKSPACE_CONFIG" in msg:
            name = "cuBLAS (CUBLAS_WORKSPACE_CONFIG unset)"
        else:                                   # not ours: pass it on
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
            continue
        if name not in ops:
            ops.append(name)


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


class HardwareTier(Enum):
    CPU_ONLY = "cpu_only"
    GPU_SINGLE = "gpu_single"
    GPU_MULTI = "gpu_multi"
    GPU_MULTI_HOST = "gpu_multi_host"


@dataclass
class CardInfo:
    """One device of the report (JAX's per-device ``DeviceInfo``)."""
    index: int
    platform: str                  # cuda | cpu
    kind: str                      # the card's name
    memory_bytes: int              # the card's total
    memory_free_bytes: int

    @property
    def memory_gb(self) -> float:
        return self.memory_bytes / 2**30


@dataclass
class HardwareInfo:
    platform: str
    devices: List[CardInfo] = field(default_factory=list)
    num_processes: int = 1
    tier: HardwareTier = HardwareTier.CPU_ONLY

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    @property
    def memory_per_device(self) -> int:
        return self.devices[0].memory_bytes if self.devices else 0

    def summary(self) -> dict:
        return {
            "platform": self.platform,
            "num_devices": self.num_devices,
            "device_kind": self.devices[0].kind if self.devices else "none",
            "memory_gb_per_device": round(self.memory_per_device / 2**30, 1),
            "tier": self.tier.value,
            "num_processes": self.num_processes,
        }


def _host_memory_half() -> int:
    """Half the host's available memory (JAX's CPU figure), 8 GiB when the
    host does not say."""
    try:
        return int(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") * 0.5)
    except (ValueError, OSError):
        return 8 * 2**30


def detect_hardware(devices: Optional[Sequence[torch.device]] = None) -> HardwareInfo:
    """The local cards (every visible one unless ``devices`` is given; the
    CPU when there is none), the process group's size and the tier."""
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [torch.device("cpu")])
    infos: List[CardInfo] = []
    for i, d in enumerate(devices):
        if d.type == "cuda":
            free, total = torch.cuda.mem_get_info(d)
            infos.append(CardInfo(i, "cuda", torch.cuda.get_device_name(d), int(total),
                                  int(free)))
        else:
            half = _host_memory_half()
            infos.append(CardInfo(i, "cpu", "cpu", half, half))
    platform = infos[0].platform if infos else "cpu"
    dist = torch.distributed
    nproc = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if platform != "cuda":
        tier = HardwareTier.CPU_ONLY
    elif nproc > 1:
        tier = HardwareTier.GPU_MULTI_HOST
    elif len(infos) > 1:
        tier = HardwareTier.GPU_MULTI
    else:
        tier = HardwareTier.GPU_SINGLE
    return HardwareInfo(platform=platform, devices=infos, num_processes=nproc, tier=tier)


def check_hardware(info: Optional[HardwareInfo] = None) -> dict:
    """The ``check`` verb's report: the summary, recommendations and a
    status, ``ok`` on a card, ``degraded`` on the CPU."""
    info = info or detect_hardware()
    report = info.summary()
    recs = []
    if info.platform != "cuda":
        recs.append("No CUDA device detected: pipelines run on the CPU (slow).")
    if info.memory_per_device < 8 * 2**30:
        recs.append("Low device memory: the planner will tile aggressively.")
    report["recommendations"] = recs
    report["status"] = "ok" if info.platform == "cuda" else "degraded"
    return report
