"""Runtime safeguards of a restore: disk, host memory and card memory
monitors, the preflight check, the sleep inhibitor and the background
monitor loop. The port's copy of ``framewright_tpu.safeguards``.

``preflight_check`` runs in the restore's probe stage, before any card
work: a blocker (the source missing, less free disk than the output
needs, the card asked for and absent) stops the restore with
``InputError``; a warning (the CPU asked for, an SR model without
weights drawn at random, an output that will take more than half the
free disk) is logged and kept in the context. The JAX check lets
``allow_cpu_fallback`` turn a missing accelerator into a warning and a
CPU run; the port has no such fallback: a restore on ``cuda`` without a
card is a blocker, and one on ``cpu`` was asked for.

``DeviceMemoryMonitor`` samples the card's memory
(``torch.cuda.mem_get_info``) and emits ``HBM_PRESSURE`` above its
threshold, where the JAX ``HBMMonitor`` reads the TPU's memory stats.
``HostMemoryMonitor`` reads psutil when it is installed, else
``/proc/meminfo``.
"""

from __future__ import annotations

import logging
import shutil
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from framewright_tpu_torch.events import EventBus, EventType

logger = logging.getLogger(__name__)


@dataclass
class DiskStatus:
    free_gb: float
    total_gb: float
    ok: bool
    critical: bool


class DiskSpaceMonitor:
    """Free disk where the project lives, checked between batches by the
    monitor loop."""

    def __init__(self, path: Path, min_free_gb: float = 2.0,
                 critical_free_gb: float = 0.5,
                 events: Optional[EventBus] = None):
        self.path = Path(path)
        self.min_free_gb = min_free_gb
        self.critical_free_gb = critical_free_gb
        self.events = events

    def check(self) -> DiskStatus:
        usage = shutil.disk_usage(self.path if self.path.exists() else self.path.parent)
        free_gb = usage.free / 2**30
        status = DiskStatus(
            free_gb=round(free_gb, 2),
            total_gb=round(usage.total / 2**30, 2),
            ok=free_gb >= self.min_free_gb,
            critical=free_gb < self.critical_free_gb,
        )
        if not status.ok and self.events:
            self.events.emit(EventType.DISK_SPACE_LOW, free_gb=status.free_gb)
        return status

    def estimate_output_gb(self, width: int, height: int, frames: int,
                           container: str = "y4m") -> float:
        """The output's size: 1.5 bytes a pixel for 4:2:0 Y4M, 3 for PNG,
        0.15 for an encoded container."""
        px = width * height * frames
        per_px = {"y4m": 1.5, "png": 3.0, "mp4": 0.15}.get(container, 1.5)
        return px * per_px / 2**30


def _available_host_bytes() -> tuple:
    """(available bytes, percent used) of host memory."""
    try:
        import psutil
    except ImportError:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                info[key] = int(rest.split()[0]) * 1024
        total, avail = info["MemTotal"], info["MemAvailable"]
        return avail, round(100.0 * (total - avail) / total, 1)
    vm = psutil.virtual_memory()
    return vm.available, vm.percent


class HostMemoryMonitor:
    def __init__(self, min_free_gb: float = 1.0,
                 events: Optional[EventBus] = None):
        self.min_free_gb = min_free_gb
        self.events = events

    def check(self) -> Dict:
        avail, percent = _available_host_bytes()
        free_gb = avail / 2**30
        ok = free_gb >= self.min_free_gb
        if not ok and self.events:
            self.events.emit(EventType.HOST_MEMORY_LOW, free_gb=round(free_gb, 2))
        return {"free_gb": round(free_gb, 2), "percent": percent, "ok": ok}


class DeviceMemoryMonitor:
    """The card's memory in use over its total (``torch.cuda.mem_get_info``,
    which counts every process on the card); ``HBM_PRESSURE`` above
    ``threshold``."""

    def __init__(self, threshold: float = 0.92,
                 events: Optional[EventBus] = None, device=None):
        self.threshold = threshold
        self.events = events
        self.device = device
        self.samples: List[float] = []

    def check(self) -> Dict:
        import torch

        free, total = torch.cuda.mem_get_info(self.device)
        used = total - free
        util = used / total if total else 0.0
        self.samples.append(util)
        if len(self.samples) > 1000:
            self.samples = self.samples[-1000:]
        if util > self.threshold and self.events:
            self.events.emit(EventType.HBM_PRESSURE, utilization=round(util, 3))
        return {"utilization": round(util, 3),
                "used_gb": round(used / 2**30, 2),
                "limit_gb": round(total / 2**30, 2),
                "ok": util <= self.threshold}

    @property
    def peak(self) -> float:
        return max(self.samples) if self.samples else 0.0


@dataclass
class PreflightResult:
    ok: bool = True
    blockers: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)

    def to_dict(self) -> Dict:
        return {"ok": self.ok, "blockers": self.blockers, "warnings": self.warnings}


def _weights_found(name: str, weights_dir: Optional[Path]) -> bool:
    """Whether the registry resolves ``name`` to a checkpoint rather than
    a seeded random draw (``registry.load_weights``' order)."""
    from framewright_tpu_torch.models.registry import default_weights_dir, packaged_weights_dir

    wdir = Path(weights_dir) if weights_dir else default_weights_dir()
    return any(p.is_file() for p in (wdir / f"{name}.npz", packaged_weights_dir() / f"{name}.npz",
                                     wdir / f"{name}.pth"))


def preflight_check(config, source: Path, meta=None) -> PreflightResult:
    """Blockers and warnings of a restore with ``config`` on ``source``
    (``meta``: its probe, for the output's size), before any card work."""
    res = PreflightResult()
    source = Path(source)
    if not source.exists():
        res.blockers.append(f"source not found: {source}")
    mon = DiskSpaceMonitor(config.project_dir)
    try:
        status = mon.check()
        if meta is not None:
            need = mon.estimate_output_gb(
                meta.width * config.scale_factor,
                meta.height * config.scale_factor,
                meta.nb_frames,
                "y4m" if config.output_format in ("auto", "y4m") else "mp4",
            )
            if need > status.free_gb:
                res.blockers.append(
                    f"insufficient disk: need ~{need:.1f} GB, have {status.free_gb:.1f} GB")
            elif need > status.free_gb * 0.5:
                res.warnings.append(
                    f"output (~{need:.1f} GB) will use >50% of free disk")
        elif not status.ok:
            res.warnings.append(f"low disk: {status.free_gb:.1f} GB free")
    except OSError as exc:
        res.warnings.append(f"disk check failed: {exc}")
    # the device: the card unless the CPU was asked for, never a fallback
    import torch

    if config.device_platform == "cpu":
        res.warnings.append("running on CPU: expect low throughput")
    elif not torch.cuda.is_available():
        res.blockers.append(f"no CUDA device is available and device_platform="
                            f"{config.device_platform!r} runs on the card "
                            "(device_platform='cpu' runs on the CPU)")
    if config.sr_model != "none" and config.scale_factor > 1 \
            and not _weights_found(config.sr_model, config.weights_dir):
        res.warnings.append(
            f"no weights for {config.sr_model} in "
            f"{config.weights_dir or 'the default weights directory'}: seeded random "
            "init (output will not be enhanced)")
    res.ok = not res.blockers
    return res


class KeepAwake:
    """Keeps the system from sleeping for the scope of a long job: a
    ``systemd-inhibit`` (Linux) or ``caffeinate`` (macOS) child, stopped
    on exit; nothing when neither tool exists."""

    def __init__(self, why: str = "framewright restore in progress"):
        self.why = why
        self._proc = None

    def __enter__(self) -> "KeepAwake":
        import subprocess
        import sys

        inhibit = shutil.which("systemd-inhibit")
        caffeinate = shutil.which("caffeinate")
        if sys.platform.startswith("linux") and inhibit:
            cmd = [inhibit, "--what=sleep:idle",
                   f"--why={self.why}", "sleep", "infinity"]
        elif sys.platform == "darwin" and caffeinate:
            cmd = [caffeinate, "-i"]
        else:
            return self
        try:
            self._proc = subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        except OSError:
            self._proc = None
        return self

    def __exit__(self, *exc) -> None:
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=2)
            except Exception:  # noqa: BLE001
                self._proc.kill()
                self._proc.wait()
            self._proc = None


class SafeguardLoop:
    """A background thread that checks disk and host memory every
    ``interval_s`` and emits their pressure events."""

    def __init__(self, project_dir: Path, events: EventBus,
                 interval_s: float = 5.0):
        self.disk = DiskSpaceMonitor(project_dir, events=events)
        self.mem = HostMemoryMonitor(events=events)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fw-safeguards")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.disk.check()
                self.mem.check()
            except Exception:  # noqa: BLE001
                logger.exception("safeguard check failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
