"""The process group: the port of ``framewright_tpu/parallel/dcn.py``.

JAX brings up ``jax.distributed``; the port brings up
``torch.distributed.init_process_group`` (``nccl`` on the card, ``gloo``
on the CPU) with an explicit ``init_method="tcp://host:port"``, a world
size and a rank, from JAX's environment contract:

    FRAMEWRIGHT_COORDINATOR   host:port of process 0
    FRAMEWRIGHT_NUM_PROCESSES the world size
    FRAMEWRIGHT_PROCESS_ID    this process's rank

with JAX's validation. Where JAX auto-discovers a TPU pod, the port takes
torchrun's ``env://`` variables (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``). With neither, ``ensure_distributed`` does
nothing (a single process).
"""

from __future__ import annotations

import logging
import os
import socket
from dataclasses import dataclass
from typing import Mapping, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@dataclass
class DistributedSpec:
    coordinator: Optional[str] = None   # host:port of process 0
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "DistributedSpec":
        env = environ if environ is not None else os.environ
        num = env.get("FRAMEWRIGHT_NUM_PROCESSES")
        pid = env.get("FRAMEWRIGHT_PROCESS_ID")
        spec = cls(coordinator=env.get("FRAMEWRIGHT_COORDINATOR"),
                   num_processes=int(num) if num else None,
                   process_id=int(pid) if pid else None)
        spec.validate()
        return spec

    def validate(self) -> None:
        if self.coordinator is not None:
            host, _, port = self.coordinator.partition(":")
            if not host or not port.isdigit():
                raise ValueError(f"coordinator must be host:port, got {self.coordinator!r}")
        if (self.num_processes is None) != (self.process_id is None):
            raise ValueError("num_processes and process_id must be set together")
        if self.num_processes is not None:
            if not (0 <= (self.process_id or 0) < self.num_processes):
                raise ValueError(f"process_id {self.process_id} outside "
                                 f"[0, {self.num_processes})")

    @property
    def explicit(self) -> bool:
        return self.coordinator is not None or self.num_processes is not None

    @property
    def init_method(self) -> str:
        return f"tcp://{self.coordinator}"


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port free on ``host`` now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def ensure_distributed(spec: Optional[DistributedSpec] = None, force: bool = False,
                       backend: Optional[str] = None, environ=None) -> bool:
    """Bring the process group up once per process. Returns True when a
    group of more than one process is up after the call.

    - an explicit spec (or ``FRAMEWRIGHT_*``) -> a ``tcp://`` group
      (coordinator, world size and rank are all needed);
    - torchrun's variables -> an ``env://`` group;
    - ``force`` with neither -> a group of one on a free local port;
    - else nothing (False)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = environ if environ is not None else os.environ
    spec = spec or DistributedSpec.from_env(env)
    backend = backend or default_backend()
    if spec.explicit:
        if spec.coordinator is None or spec.num_processes is None:
            raise ValueError("a tcp:// process group needs the coordinator, "
                             "num_processes and process_id")
        world, rank, method = spec.num_processes, spec.process_id, spec.init_method
    elif all(k in env for k in _TORCHRUN):
        world, rank, method = int(env["WORLD_SIZE"]), int(env["RANK"]), "env://"
    elif force:
        world, rank, method = 1, 0, f"tcp://127.0.0.1:{free_port()}"
    else:
        return False
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=method, world_size=world, rank=rank)
    logger.info("process group up (%s): rank %d/%d via %s", backend, rank, world, method)
    return world > 1


def shutdown_distributed() -> None:
    """Destroy the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
