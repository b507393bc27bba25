"""Frame interpolation (RIFE-class) with scene-change gating: the port of
``framewright_tpu.processors.interpolation``.

The frame rate rises by a power of 2 (``interpolation_factor``: 2x the
source when no target is set). Between each pair of source frames the
interpolator inserts ``factor - 1`` frames at times ``i / factor``, all
from the source pair, in batches of ``batch_pairs`` pairs; across a
scene cut (``frame_pair_scores`` of the pair at or above the threshold)
it repeats the left frame instead. The model is the port's
``models/ifnet.IFNet`` at the published ``IFNetConfig()`` through
``interpolate_padded``, on the card in full f32, with the user's
weights, ``<weights_dir>/rife-v4.6.npz`` (``InputError`` without them:
the JAX interpolator draws ``ifnet.init(PRNGKey(0))``, ROADMAP.md "JAX
faults the port must not copy").

``sharding="data"`` (JAX ``interpolation.py:113-132``) with more than one
local device of the interpolator's kind, or of ``mesh_shape``
(``parallel.mesh.data_mesh``):
each device holds its own f32 IFNet, ``batch_pairs`` is rounded up to a
multiple of the devices, and each batch of pairs is split over them with
``parallel.distributor.run_split`` (each part enqueued with its device
current, the midpoints gathered in order). Pairs are independent, so the
midpoints are those of the unsplit interpolator.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.hw import full_f32, resolve_device
from framewright_tpu_torch.parallel.distributor import run_split
from framewright_tpu_torch.parallel.mesh import Mesh, data_mesh
from framewright_tpu_torch.processors.base import to_float, to_uint8
from framewright_tpu_torch.processors.scene_detection import frame_pair_scores

logger = logging.getLogger(__name__)


@dataclass
class InterpolationConfig:
    model_name: str = "rife-v4.6"
    target_fps: float = 0.0           # 0 = double the source fps
    scene_change_threshold: float = 0.30
    scene_change_skip: bool = True
    batch_pairs: int = 4              # frame pairs a device step (at most)
    weights_dir: Optional[str] = None
    device: str = "cuda"
    sharding: str = "none"            # none | data: split each pair batch over the devices
    mesh_shape: Tuple[int, ...] = ()  # the data split's cards (parallel.mesh.data_mesh)


@dataclass
class InterpolationResult:
    frames_in: int = 0
    frames_out: int = 0
    factor: int = 1
    scene_skips: int = 0
    output_fps: float = 0.0


def interpolation_factor(source_fps: float, target_fps: float) -> int:
    """Power-of-2 multiplier reaching >= target; a target of 0 -> 2x."""
    if target_fps <= 0 or source_fps <= 0:
        return 2
    if target_fps <= source_fps:
        return 1
    return 2 ** math.ceil(math.log2(target_fps / source_fps))


class FrameInterpolator:
    def __init__(self, config: Optional[InterpolationConfig] = None):
        self.config = config or InterpolationConfig()
        self.device: Optional[torch.device] = None
        self.result = InterpolationResult()
        self._mesh: Optional[Mesh] = None
        self._models: dict = {}           # device -> IFNet, one a mesh device

    def setup(self, height: int, width: int) -> None:
        """Load the model's weights (``InputError`` when they are missing)
        onto the device, or onto each device of the mesh with
        ``sharding="data"``."""
        from framewright_tpu_torch.models.ifnet import IFNet
        from framewright_tpu_torch.models.registry import load_aux

        cfg = self.config
        if cfg.sharding not in ("none", "data"):
            raise ConfigError(f"interpolation sharding must be none|data, got {cfg.sharding!r}")
        self.device = resolve_device(cfg.device)
        spec, sd, src = load_aux(cfg.model_name, cfg.weights_dir)
        self._mesh = data_mesh(self.device.type, cfg.mesh_shape) if cfg.sharding == "data" else None
        devices = self._mesh.frame_devices if self._mesh is not None else (self.device,)
        self._models = {}
        for d in devices:
            if d not in self._models:
                self._models[d] = IFNet.from_state_dict(spec.arch_config, sd, d)
        if self._mesh is not None:
            # pair batches fill the mesh (JAX interpolation.py:129-131)
            nf = len(self._mesh.frame_devices)
            cfg.batch_pairs = -(-cfg.batch_pairs // nf) * nf
            logger.info("interpolation split over %d devices: %s", nf,
                        [str(d) for d in self._mesh.frame_devices])
        logger.info("interpolation: %s from %s, %d pairs a step", cfg.model_name, src,
                    cfg.batch_pairs)

    def teardown(self) -> None:
        self._models = {}

    def _mid(self, a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
        """The frames at time ``t`` between uint8 pairs (n, H, W, 3), each
        part of the pairs on its mesh device with ``sharding="data"``."""
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)

        def part(dev, lo: int, hi: int) -> torch.Tensor:
            at = to_float(torch.from_numpy(a[lo:hi]).to(dev))
            bt = to_float(torch.from_numpy(b[lo:hi]).to(dev))
            return to_uint8(self._models[dev].interpolate_padded(at, bt, t))

        with torch.no_grad(), full_f32():
            if self._mesh is None:
                return part(self.device, 0, len(a)).cpu().numpy()
            devs = self._mesh.frame_devices
            outs = run_split(len(a), self._mesh, lambda i, lo, hi: part(devs[i], lo, hi))
            return np.concatenate([o.cpu().numpy() for o in outs])

    def interpolate_stream(self, frames_iter: Iterator[np.ndarray], factor: int,
                           result: Optional[InterpolationResult] = None
                           ) -> Iterator[np.ndarray]:
        """Each source frame, then its ``factor - 1`` synthesized
        successors (times i / factor toward the next frame), or the frame
        repeated across a scene cut; the last frame passes through."""
        cfg = self.config
        result = result if result is not None else InterpolationResult()
        prev: Optional[np.ndarray] = None
        buf_a: List[np.ndarray] = []
        buf_b: List[np.ndarray] = []
        gated: List[bool] = []

        def flush() -> List[np.ndarray]:
            nonlocal buf_a, buf_b, gated
            if not buf_a:
                return []
            a, b = np.stack(buf_a), np.stack(buf_b)
            need = [i for i, g in enumerate(gated) if not g]
            synth: dict = {i: [] for i in need}
            if need:
                for t in (i / factor for i in range(1, factor)):
                    mids = self._mid(a[need], b[need], t)
                    for j, i in enumerate(need):
                        synth[i].append(mids[j])
            emitted: List[np.ndarray] = []
            for i in range(len(buf_a)):
                emitted.append(buf_a[i])
                if gated[i]:            # scene cut: hold the left frame
                    emitted.extend([buf_a[i]] * (factor - 1))
                    result.scene_skips += 1
                else:
                    emitted.extend(synth[i])
            buf_a, buf_b, gated = [], [], []
            return emitted

        for frame in frames_iter:
            result.frames_in += 1
            if prev is not None:
                cut = False
                if cfg.scene_change_skip:
                    score = float(frame_pair_scores(prev[None], frame[None])[0])
                    cut = score >= cfg.scene_change_threshold
                buf_a.append(prev)
                buf_b.append(frame)
                gated.append(cut)
                if len(buf_a) >= cfg.batch_pairs:
                    for f in flush():
                        result.frames_out += 1
                        yield f
            prev = frame
        for f in flush():
            result.frames_out += 1
            yield f
        if prev is not None:
            result.frames_out += 1
            yield prev

    def interpolate_to_fps(self, frames_iter: Iterator[np.ndarray],
                           source_fps: float) -> Iterator[np.ndarray]:
        factor = interpolation_factor(source_fps, self.config.target_fps)
        self.result = InterpolationResult(factor=factor, output_fps=source_fps * factor)
        if factor == 1:
            for f in frames_iter:
                self.result.frames_in += 1
                self.result.frames_out += 1
                yield f
            return
        yield from self.interpolate_stream(frames_iter, factor, self.result)
