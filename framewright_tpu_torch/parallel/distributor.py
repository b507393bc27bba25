"""Scene chunks and the frames split over the local cards: the port of
``framewright_tpu/parallel/distributor.py``.

``ChunkState``, ``FrameChunk``, ``make_scene_chunks`` and ``ChunkQueue``
are the JAX package's host code, copied (the farm's and the streaming
restore's unit of work). Both frame splits go through ``run_split``
(``mesh.frame_split``'s parts, each run with its device current, the
results in order): ``ShardedFrameProcessor`` runs a per-batch function
over a mesh (the batch padded to the mesh, the parameters copied to each
device once, the parts gathered in order), and ``ShardedSR`` runs the SR
processor, one a position of the frames axis, behind the processor's own
interface (the restore's split over the local cards, JAX
``super_resolution.py:194-217``); under ``SRConfig.sharding="2d"`` each
of those processors runs its frames on row bands over its ``space``
devices (``parallel.bands``). ``sr_mesh`` builds the mesh that
``sharding`` asks for and ``sharded_sr`` the processor over it.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.parallel.mesh import (
    FRAME_AXIS,
    SPACE_AXIS,
    Mesh,
    build_mesh,
    device_current,
    frame_split,
    pad_batch_for_mesh,
)
from framewright_tpu_torch.parallel import mesh as mesh_mod

logger = logging.getLogger(__name__)


class ChunkState(Enum):
    PENDING = "pending"
    ASSIGNED = "assigned"
    DONE = "done"
    FAILED = "failed"


@dataclass
class FrameChunk:
    index: int
    start: int                 # first frame (inclusive)
    end: int                   # last frame (exclusive)
    state: ChunkState = ChunkState.PENDING
    worker: str = ""
    attempts: int = 0

    @property
    def n_frames(self) -> int:
        return self.end - self.start


def make_scene_chunks(
    total_frames: int,
    chunk_frames: int = 100,
    scene_boundaries: Optional[Sequence[int]] = None,
) -> List[FrameChunk]:
    """Split [0, total) into ~chunk_frames units, snapping splits to the
    nearest scene boundary within half a chunk (scene-sharded recipe)."""
    bounds = sorted(b for b in (scene_boundaries or []) if 0 < b < total_frames)
    chunks: List[FrameChunk] = []
    start = 0
    idx = 0
    while start < total_frames:
        target = min(start + chunk_frames, total_frames)
        end = target
        if target < total_frames and bounds:
            near = [b for b in bounds
                    if abs(b - target) <= chunk_frames // 2 and b > start]
            if near:
                end = min(near, key=lambda b: abs(b - target))
        chunks.append(FrameChunk(idx, start, end))
        start = end
        idx += 1
    return chunks


class ChunkQueue:
    """In-memory chunk state tracker with straggler re-dispatch."""

    def __init__(self, chunks: Sequence[FrameChunk], max_attempts: int = 3):
        self.chunks = list(chunks)
        self.max_attempts = max_attempts

    def next_pending(self, worker: str = "") -> Optional[FrameChunk]:
        for c in self.chunks:
            if c.state is ChunkState.PENDING:
                c.state = ChunkState.ASSIGNED
                c.worker = worker
                c.attempts += 1
                return c
        return None

    def complete(self, index: int) -> None:
        self.chunks[index].state = ChunkState.DONE

    def fail(self, index: int) -> None:
        c = self.chunks[index]
        c.state = (ChunkState.PENDING if c.attempts < self.max_attempts
                   else ChunkState.FAILED)

    def requeue_stale(self, assigned_before: Dict[int, float],
                      timeout_s: float) -> int:
        """Re-dispatch chunks whose worker went quiet (the reference's
        stale-node cleanup, distributed/discovery.py:335)."""
        now = time.time()
        n = 0
        for c in self.chunks:
            t = assigned_before.get(c.index)
            if c.state is ChunkState.ASSIGNED and t and now - t > timeout_s:
                c.state = ChunkState.PENDING
                n += 1
        return n

    @property
    def done(self) -> bool:
        return all(c.state is ChunkState.DONE for c in self.chunks)

    @property
    def progress(self) -> float:
        done = sum(c.n_frames for c in self.chunks if c.state is ChunkState.DONE)
        total = sum(c.n_frames for c in self.chunks)
        return done / total if total else 1.0


def _to_device(tree: Any, device: torch.device) -> Any:
    """A parameter tree (dicts, lists, tuples of tensors or arrays) on
    ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def run_split(n: int, mesh: Mesh, fn: Callable[[int, int, int], Any]) -> List[Any]:
    """``fn(position, start, end)`` for each non-empty part of n frames
    (``frame_split``), with that position's device current; the results
    in frame order. ``fn`` enqueues its part's work without waiting for
    it, so the devices run their parts together."""
    out = []
    for i, a, b in frame_split(n, mesh):
        with device_current(mesh.frame_devices[i]):
            out.append(fn(i, a, b))
    return out


class ShardedFrameProcessor:
    """Runs ``fn(params, x)`` data-parallel over the mesh's frames axis.

    fn: (params, (B, H, W, C) tensor) -> (B, H', W', C) tensor on x's
    device. Batches are padded to a multiple of the frames axis with their
    last frame; the parameters are copied to each device once."""

    def __init__(self, fn: Callable, params, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else build_mesh()
        self.n_shards = self.mesh.shape[FRAME_AXIS]
        self.fn = fn
        self._params = {}
        for d in self.mesh.frame_devices:
            if d not in self._params:
                self._params[d] = _to_device(params, d)

    def process(self, batch: np.ndarray) -> np.ndarray:
        n = batch.shape[0]
        n_pad = pad_batch_for_mesh(n, self.mesh)
        if n_pad != n:
            pad = np.broadcast_to(batch[-1:], (n_pad - n,) + batch.shape[1:])
            batch = np.concatenate([batch, pad], axis=0)
        x = torch.from_numpy(np.ascontiguousarray(batch))
        devs = self.mesh.frame_devices
        outs = run_split(n_pad, self.mesh,
                         lambda i, a, b: self.fn(self._params[devs[i]], x[a:b].to(devs[i])))
        return torch.cat([y.cpu() for y in outs]).numpy()[:n]

    @staticmethod
    def estimate_speedup(n_devices: int) -> float:
        """Independent frames need no communication between devices:
        linear, less the host's feed (JAX's model)."""
        return n_devices * 0.98


SR_SHARDINGS = ("auto", "data", "2d", "none")
# the families with a band path under "2d" (their kernels run on bands)
BAND_FAMILIES = ("rrdb", "srvgg")


def sr_mesh(config, mesh_shape: Sequence[int] = ()) -> Optional[Mesh]:
    """The mesh ``config.sharding`` asks for over the local devices of
    ``config.device``'s kind, or None for one device: "none" never splits;
    "auto" and "data" split frames over ``mesh_shape`` (() = every such
    device) when its frames axis holds more than one; "2d" builds JAX's
    ``(nd // 2, 2)`` frames x space mesh over nd devices (nd the product of
    ``mesh_shape``, or every such device; a two-axis ``mesh_shape`` as it
    is) when nd is even, else it splits frames (JAX
    ``super_resolution.py:199-206``)."""
    if config.sharding not in SR_SHARDINGS:
        raise ConfigError(f"SR sharding must be one of {SR_SHARDINGS}, got {config.sharding!r}")
    if config.sharding == "none":
        return None
    kind = torch.device("cuda" if config.device in (None, "auto") else config.device).type
    devs = [d for d in mesh_mod.local_devices() if d.type == kind]
    if len(devs) < 2:
        return None
    shape = tuple(mesh_shape)
    if config.sharding == "2d":
        if len(shape) < 2:
            nd = int(np.prod(shape)) if shape else len(devs)
            shape = (nd // 2, 2) if nd % 2 == 0 else (nd,)
        mesh = build_mesh(shape, devs)
        return mesh if len(mesh.devices) > 1 else None
    fd = build_mesh(shape, devs).frame_devices      # a space axis idles, as before
    return build_mesh((len(fd),), fd) if len(fd) > 1 else None


def sharded_sr(config, mesh_shape: Sequence[int] = ()):
    """The SR processor ``config.sharding`` asks for: ``ShardedSR`` over
    ``sr_mesh``, or the one-device ``SuperResolution``."""
    from framewright_tpu_torch.processors.super_resolution import SuperResolution

    mesh = sr_mesh(config, mesh_shape)
    return SuperResolution(config) if mesh is None else ShardedSR(config, mesh)


class ShardedSR:
    """The SR processor with each dispatch's frames split over a mesh's
    frames axis: one ``SuperResolution`` a position (its weights, plan and
    staging buffers; its part runs through the same kernels on that
    device's stream, the device current for the launches), the parts
    gathered in order. With a ``space`` axis of more than one, each
    position's processor holds that position's devices and runs its frames
    on row bands over them; ``setup`` splits frames over every device
    instead when the height is odd (JAX's rule) or the family has no band
    path (HAT), with one log line. It has the processor's interface, and
    state reaches the members only through it (``set_output_color``,
    ``enable_device_stats``). ``batch_size`` stays the dispatch's frames,
    as JAX's is: each member plans for its share, rounded up. int8 static
    scales are calibrated once for every member, on the first batch. The
    diffusion SR's noise is drawn once a dispatch for each chunk layout the
    members' plans give (one, as each member plans as one card does; a
    member downshifted after an OOM has its own), as one card with that
    plan draws it (``super_resolution.dispatch_noise``), and each member
    samples its frames from their rows of its plan's draw
    (``SuperResolution.dispatch(noise=...)``), so the split's bytes are the
    one-card restore's."""

    name = "super_resolution"

    def __init__(self, config, mesh: Mesh):
        self.config = config
        self.dispatches = 0
        self._build_members(mesh)

    def _build_members(self, mesh: Mesh) -> None:
        from framewright_tpu_torch.models.registry import get_model
        from framewright_tpu_torch.processors.super_resolution import SuperResolution

        self.mesh = mesh
        ns = mesh.shape.get(SPACE_AXIS, 1)
        n = len(mesh.frame_devices)
        share = -(-self.config.batch_size // n) if self.config.batch_size else 0
        # the diffusion SR: each member plans as one card does, so that the
        # members share the one-card chunks whose noise a dispatch draws
        self._draws = get_model(self.config.model_name).family == "diffusion"
        if self._draws:
            share = self.config.batch_size
        self.members = [SuperResolution(dataclasses.replace(self.config, device=str(d),
                                                            batch_size=share),
                                        space_devices=mesh.devices[i * ns:(i + 1) * ns]
                                        if ns > 1 else None)
                        for i, d in enumerate(mesh.frame_devices)]

    @property
    def spatial(self) -> bool:
        """Whether the members run row bands (a ``space`` axis over one)."""
        return self.mesh.shape.get(SPACE_AXIS, 1) > 1

    @property
    def device(self) -> Optional[torch.device]:
        """The first member's device (the restore's pre-SR stream runs
        there)."""
        return self.members[0].device

    def setup(self, height: int, width: int) -> None:
        if self.spatial:
            from framewright_tpu_torch.models.registry import get_model

            family = get_model(self.config.model_name).family
            why = ("an odd height" if height % 2 else
                   None if family in BAND_FAMILIES else f"no band path for the {family} family")
            if why:
                logger.info("SR 2d: %s; frames split over all %d devices", why,
                            len(self.mesh.devices))
                self._build_members(build_mesh((len(self.mesh.devices),), self.mesh.devices))
        for sub in self.members:
            with device_current(sub.config.device):
                sub.setup(height, width)
        logger.info("SR split over %s: %s", self.mesh.shape,
                    [str(d) for d in self.mesh.devices])

    @property
    def plan(self):
        """A dispatch's plan: the first member's, with the frames of all
        (capped at ``batch_size``); its byte counts are one member's."""
        p = self.members[0].plan
        frames = p.frames * len(self.members)
        if self.config.batch_size:
            frames = min(frames, self.config.batch_size)
        return (dataclasses.replace(p, frame_batch=frames) if p.tiled
                else dataclasses.replace(p, batch=frames))

    def set_output_color(self, color: str, full_range: Optional[bool] = None) -> None:
        for sub in self.members:
            sub.set_output_color(color, full_range)

    def enable_device_stats(self) -> None:
        for sub in self.members:
            with device_current(sub.device):
                sub.enable_device_stats()

    def output_size(self, height: int, width: int):
        return self.members[0].output_size(height, width)

    def dispatch(self, frames: np.ndarray) -> dict:
        from framewright_tpu_torch.processors.super_resolution import (
            check_frames,
            dispatch_noise,
        )

        x = check_frames(self.name, frames)
        for sub in self.members:
            if sub._int8_calibrate:       # the same scales on every member
                with device_current(sub.device):
                    sub._calibrate_int8(x)
        self.dispatches += 1
        draws: dict = {}          # the dispatch's one-card draws, one a chunk layout

        def rows(a, b):
            def of(plan, device):
                key = (plan.tiled, plan.tile_size, plan.overlap, plan.batch)
                if key not in draws:
                    draws[key] = dispatch_noise(plan, len(x), x.shape[1], x.shape[2], device)
                z, per = draws[key]
                return z[a * per:b * per].to(device)
            return of

        def part(i, a, b):
            sub = self.members[i]
            return sub, sub.dispatch(x[a:b], noise=rows(a, b) if self._draws else None)

        parts = run_split(len(x), self.mesh, part)
        draws.clear()             # a retry after an OOM draws for its new plan
        return {"parts": parts}

    def materialize(self, handle: dict):
        outs, stats = [], []
        for sub, h in handle["parts"]:
            with device_current(sub.device):
                outs.append(sub.materialize(h))
            if "stats_np" in h:
                stats.append(h["stats_np"])
        if len(outs) == 1:                # one part: no gather copy
            if stats:
                handle["stats_np"] = stats[0]
            return outs[0]
        if stats:
            handle["stats_np"] = {k: np.concatenate([s[k] for s in stats]) for k in stats[0]}
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate([o[k] for o in outs]) for k in range(len(outs[0])))
        return np.concatenate(outs)

    def teardown(self) -> None:
        for sub in self.members:
            with device_current(sub.device):
                sub.teardown()
