"""Scene chunks and the frames split over the local cards: the port of
``framewright_tpu/parallel/distributor.py``.

``ChunkState``, ``FrameChunk``, ``make_scene_chunks`` and ``ChunkQueue``
are the JAX package's host code, copied (the farm's and the streaming
restore's unit of work). Both frame splits go through ``run_split``
(``mesh.frame_split``'s parts, each run with its device current, the
results in order): ``ShardedFrameProcessor`` runs a per-batch function
over a mesh (the batch padded to the mesh, the parameters copied to each
device once, the parts gathered in order), and ``ShardedSR`` runs the SR
processor, one a card, behind the processor's own interface (the
restore's frame split over the local cards, JAX
``super_resolution.py:194-215``).
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

from framewright_tpu_torch.parallel.mesh import (
    FRAME_AXIS,
    Mesh,
    build_mesh,
    device_current,
    frame_split,
    pad_batch_for_mesh,
)

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


class ShardedSR:
    """The SR processor with each dispatch's frames split over a mesh's
    devices: one ``SuperResolution`` a device (its weights, plan and
    staging buffers; its part runs through the same kernels on that
    device's stream, the device current for the launches), the parts
    gathered in order. It has the processor's interface, and state reaches
    the members only through it (``set_output_color``,
    ``enable_device_stats``). ``batch_size`` stays the dispatch's frames,
    as JAX's is: each member plans for its share, rounded up. int8 static
    scales are calibrated once for every member, on the first batch."""

    name = "super_resolution"

    def __init__(self, config, mesh: Mesh):
        from framewright_tpu_torch.processors.super_resolution import SuperResolution

        self.config = config
        self.mesh = mesh
        n = len(mesh.frame_devices)
        share = -(-config.batch_size // n) if config.batch_size else 0
        self.members = [SuperResolution(dataclasses.replace(config, device=str(d),
                                                            batch_size=share))
                        for d in mesh.frame_devices]
        self.dispatches = 0

    @property
    def device(self) -> Optional[torch.device]:
        """The first member's device (the restore's pre-SR stream runs
        there)."""
        return self.members[0].device

    def setup(self, height: int, width: int) -> None:
        for sub in self.members:
            with device_current(sub.config.device):
                sub.setup(height, width)
        logger.info("SR frames split over %d devices: %s", len(self.members),
                    [str(d) for d in self.mesh.frame_devices])

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
        from framewright_tpu_torch.processors.super_resolution import check_frames

        x = check_frames(self.name, frames)
        for sub in self.members:
            if sub._int8_calibrate:       # the same scales on every member
                with device_current(sub.device):
                    sub._calibrate_int8(x)
        self.dispatches += 1
        parts = run_split(len(x), self.mesh,
                          lambda i, a, b: (self.members[i], self.members[i].dispatch(x[a:b])))
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
