"""Device meshes and the frames split: the port of
``framewright_tpu/parallel/mesh.py``.

A mesh is a list of local torch devices on a ``frames`` axis (JAX's
``Mesh`` over its local devices): a batch's frames are split over them
in order, each device runs its part with a copy of the parameters, and
the parts are gathered in order. A second ``space`` axis splits each
frame's rows into bands (``parallel.bands``; the SR's ``"2d"`` split):
``shard_frames(..., spatial=True)`` gives each device its frames' band of
rows, as JAX's ``frame_sharding(mesh, spatial=True)`` places them.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from framewright_tpu_torch.errors import ShardingError

FRAME_AXIS = "frames"
SPACE_AXIS = "space"

DeviceLike = Union[str, torch.device]


def local_devices() -> List[torch.device]:
    """Every local card, or the CPU when there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def device_current(device: Optional[DeviceLike]) -> contextlib.AbstractContextManager:
    """``device`` current for the block (the kernels launch on the current
    device's stream); nothing on the CPU."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]     # row-major over ``shape``
    shape: Dict[str, int]                 # axis name -> size, JAX's ``Mesh.shape``

    @property
    def frame_devices(self) -> Tuple[torch.device, ...]:
        """The device of each position on the ``frames`` axis."""
        step = self.shape.get(SPACE_AXIS, 1)
        return self.devices[::step]


def build_mesh(mesh_shape: Tuple[int, ...] = (), devices: Optional[Sequence[DeviceLike]] = None,
               axis_names: Optional[Tuple[str, ...]] = None) -> Mesh:
    """() -> every device on the ``frames`` axis; (a,) -> a ``frames``
    mesh of size a; (a, b) -> ``frames`` x ``space``. ``devices`` defaults
    to the local cards; entries may repeat (``["cpu", "cpu"]``)."""
    devs = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    if not mesh_shape:
        mesh_shape = (len(devs),)
    n = int(np.prod(mesh_shape))
    if n > len(devs):
        raise ShardingError(f"mesh_shape {mesh_shape} needs {n} devices, have {len(devs)}")
    if axis_names is None:
        axis_names = (FRAME_AXIS, SPACE_AXIS)[: len(mesh_shape)]
    if len(axis_names) != len(mesh_shape):
        raise ShardingError("axis_names length must match mesh_shape")
    return Mesh(tuple(devs[:n]), dict(zip(axis_names, (int(d) for d in mesh_shape))))


def frames_mesh(device: Optional[DeviceLike], mesh_shape: Tuple[int, ...] = ()) -> Optional[Mesh]:
    """The mesh that a processor on ``device`` splits its frames over: the
    local devices of that device's type (every local card for ``cuda`` or
    ``auto``), shaped by ``mesh_shape``; None when there is one such
    device or the mesh's frames axis holds one (JAX splits only over more
    than one device)."""
    kind = torch.device("cuda" if device in (None, "auto") else device).type
    devs = [d for d in local_devices() if d.type == kind]
    if len(devs) < 2:
        return None
    mesh = build_mesh(tuple(mesh_shape), devs)
    return mesh if len(mesh.frame_devices) > 1 else None


def data_mesh(device: Optional[DeviceLike], mesh_shape: Tuple[int, ...] = ()) -> Optional[Mesh]:
    """The mesh of a data split (the denoiser's centres, the
    interpolator's pairs): every device of ``mesh_shape`` on one frames
    axis (() = every local device of ``device``'s type, JAX's
    ``build_mesh()``), so a restore shaped for some cards keeps every
    stage on them; None as for ``frames_mesh``."""
    return frames_mesh(device, (int(np.prod(mesh_shape)),) if mesh_shape else ())


def pad_batch_for_mesh(n: int, mesh: Mesh) -> int:
    """Round a batch size up to a multiple of the frames axis."""
    nf = mesh.shape[FRAME_AXIS]
    return -(-n // nf) * nf


def frame_split(n: int, mesh: Mesh) -> List[Tuple[int, int, int]]:
    """(position on the frames axis, start, end) of each non-empty
    contiguous part of n frames, the first parts one frame longer when n
    does not divide (no padding)."""
    nf = len(mesh.frame_devices)
    base, extra = divmod(n, nf)
    out, start = [], 0
    for i in range(nf):
        size = base + (i < extra)
        if size:
            out.append((i, start, start + size))
        start += size
    return out


def shard_frames(batch: np.ndarray, mesh: Mesh, spatial: bool = False) -> List[torch.Tensor]:
    """A host (B, H, W, C) batch as one equal part a frames-axis device,
    on that device. B must divide by the frames-axis size. ``spatial``:
    each part's rows also in equal bands over the ``space`` axis, one a
    device, in the mesh's row-major device order (H must divide by the
    ``space`` size)."""
    nf = mesh.shape[FRAME_AXIS]
    if batch.shape[0] % nf:
        raise ShardingError(f"batch size {batch.shape[0]} not divisible by frames axis {nf}")
    x = torch.from_numpy(np.ascontiguousarray(batch))
    if not spatial:
        return [x[a:b].to(mesh.frame_devices[i]) for i, a, b in frame_split(len(x), mesh)]
    ns = mesh.shape.get(SPACE_AXIS, 1)
    if batch.shape[1] % ns:
        raise ShardingError(f"height {batch.shape[1]} not divisible by space axis {ns}")
    rows = batch.shape[1] // ns
    return [x[a:b, j * rows:(j + 1) * rows].to(mesh.devices[i * ns + j])
            for i, a, b in frame_split(len(x), mesh) for j in range(ns)]
