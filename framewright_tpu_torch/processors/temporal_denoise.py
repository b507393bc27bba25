"""Motion-compensated temporal denoising: the port of
``framewright_tpu.processors.temporal_denoise`` (``TemporalDenoiser``,
``FlickerReducer``).

A sliding window of 2r + 1 frames, cut at scene changes: the 2r
neighbour slots are aligned to the centre by the alignment IFNet's flow
(centre -> neighbour) and ``flow_warp``, then blended with photometric
weights exp(-d / s2), d the mean squared colour difference and s2 =
max(2 sigma^2, 2 x the median d over the real neighbours); slots past a
short window's end hold the centre under a zero weight. ``nafnet`` runs
``FW_nafnet_dn`` on the blend; ``bilateral`` a 3x3 edge-preserving filter
of the centre alone. The result is blended with the centre by
``strength`` (``chroma_only`` restores the centre's BT.601 luma) and
rounded to uint8. ``auto`` profiles the first max(8, 2r + 1) frames with
``NoiseProfiler`` and picks ``none``, ``temporal``, ``nafnet`` or
``bilateral`` and the strength.

On the card: each uint8 frame is uploaded once and the window stays
there; the blend, the flow net and NAFNet run in f32 (TF32 off: the
restorer holds ``hw.full_f32`` for the whole restore) on a batch of
``batch`` centres a step (JAX's ``cfg.batch or nf``: one centre without
a mesh), and the denoised frames come back to the host as uint8.
``sharding="data"`` (JAX ``temporal_denoise.py:147-168, 219-260``) with
more than one local device of the denoiser's kind, or of ``mesh_shape``
(``parallel.mesh.data_mesh``): each device holds its own nets, a step's
centres are padded to the mesh with the last one, as JAX pads them, and
split over it with ``parallel.distributor.run_split``, each device
holding its centres' full windows; the frames come back in order. The scene-change score
(``frame_pair_scores``) and the profile stay numpy on the host.
``restormer`` runs Restormer (``models.restormer``, at the widths of
``<weights_dir>/restormer.npz``: JAX's ``RestormerConfig()`` once
weighted) on the blend, as ``nafnet`` runs NAFNet. ``flow_model="raft"``
aligns with RAFT (``RAFTConfig(iters=8)``, ``<weights_dir>/raft-
things.npz`` or princeton-vl's ``.pth``) instead of the alignment IFNet;
its correlation volume grows with the square of the pixels, so a step
runs at most ``flow_pairs`` of its (centre, neighbour) pairs on a device
(``planner.raft_pairs`` of the free card memory when 0). The JAX
denoiser's random NAFNet when ``FW_nafnet_dn`` is missing, and its random
Restormer (``init(PRNGKey(2), dim=8)``) when ``restormer.npz`` is, are
not copied: a missing checkpoint raises ``InputError`` naming the file.
"""

from __future__ import annotations

import functools
import itertools
import logging
from dataclasses import asdict, dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.hw import resolve_device
from framewright_tpu_torch.ops.warp import flow_warp
from framewright_tpu_torch.parallel.distributor import run_split
from framewright_tpu_torch.parallel.mesh import Mesh, data_mesh, pad_batch_for_mesh
from framewright_tpu_torch.processors.base import to_float, to_uint8
from framewright_tpu_torch.processors.scene_detection import frame_pair_scores

logger = logging.getLogger(__name__)

METHODS = ("auto", "temporal", "nafnet", "restormer", "bilateral", "none")
# the methods that align the window before blending it
_ALIGNED = ("temporal", "nafnet", "restormer")
_BT601 = (0.299, 0.587, 0.114)


@dataclass
class TemporalDenoiseConfig:
    radius: int = 3                 # window = 2r+1
    strength: float = 0.5           # blend of denoised vs original
    method: str = "temporal"        # auto | temporal | nafnet | restormer | bilateral | none
    flow_model: str = "ifnet"       # the alignment flow net: ifnet | raft
    flow_pairs: int = 0             # raft: pairs a step (0: from the free card memory)
    similarity_sigma: float = 0.08  # photometric rejection width ([0,1] units)
    scene_change_threshold: float = 0.30
    chroma_only: bool = False       # denoise chroma, keep luma
    weights_dir: Optional[str] = None   # FW_nafnet_dn.npz (else packaged), restormer.npz,
                                        # raft-things.npz here
    device: str = "cuda"            # cuda | cpu
    batch: int = 0                  # centres a device step (0: one a mesh device)
    sharding: str = "none"          # none | data: split each step's centres over the devices
    mesh_shape: Tuple[int, ...] = ()  # the data split's cards (parallel.mesh.data_mesh)


@dataclass
class TemporalDenoiseResult:
    frames: int = 0
    scene_resets: int = 0
    profile: Optional[dict] = None  # NoiseProfile.to_dict() in auto mode

    def to_dict(self) -> dict:
        return asdict(self)


def check_method(method: str, flow_model: str = "ifnet") -> None:
    """``ConfigError`` for a method or flow net the port does not know."""
    if method not in METHODS:
        raise ConfigError(f"denoise method must be one of {METHODS}, got {method!r}")
    if flow_model not in ("ifnet", "raft"):
        raise ConfigError(f"flow_model must be ifnet|raft, got {flow_model!r}")


class RAFTFlow:
    """RAFT as the denoiser's flow net: ``estimate_flow`` on at most
    ``pairs`` pairs at a time."""

    def __init__(self, params, pairs: int):
        from framewright_tpu_torch.models.raft import RAFTConfig

        self.params, self.pairs, self.cfg = params, max(1, pairs), RAFTConfig(iters=8)

    def estimate_flow(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        from framewright_tpu_torch.models.raft import estimate_flow

        return torch.cat([estimate_flow(self.params, a[i:i + self.pairs],
                                        b[i:i + self.pairs], self.cfg)
                          for i in range(0, len(a), self.pairs)])


def nanmedian(v: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of finite values: the linear-interpolated middle
    of the sorted values, low x 0.5 + high x 0.5 for an even count (not
    ``torch.nanmedian``, which returns the lower one), 0-d f32."""
    s = torch.sort(v.reshape(-1)).values
    n = s.numel()
    lo, hi = s[(n - 1) // 2], s[n // 2]
    return lo if n % 2 else lo * 0.5 + hi * 0.5


class TemporalDenoiser:
    """Streaming sliding-window denoiser (``denoise_stream``)."""

    def __init__(self, config: Optional[TemporalDenoiseConfig] = None):
        self.config = config or TemporalDenoiseConfig()
        check_method(self.config.method, self.config.flow_model)
        self.device = resolve_device(self.config.device)
        self.flow_net = None
        self.refiner = None       # nafnet | restormer: NHWC f32 in [0, 1] -> the same
        self._dims = (0, 0)
        self.result = TemporalDenoiseResult()
        if self.config.sharding not in ("none", "data"):
            raise ConfigError(f"denoise sharding must be none|data, got "
                              f"{self.config.sharding!r}")
        self._mesh: Optional[Mesh] = (data_mesh(self.device.type, self.config.mesh_shape)
                                      if self.config.sharding == "data" else None)
        nf = len(self._mesh.frame_devices) if self._mesh is not None else 1
        self._batch = self.config.batch or nf
        self._nets: dict = {}     # device -> (flow net, refiner) of a mesh device

    def setup(self, height: int = 0, width: int = 0) -> None:
        """Load the nets the method runs (``auto``: after its profile),
        onto each device of the mesh with ``sharding="data"``."""
        cfg = self.config
        self._dims = (height, width)
        if cfg.method in ("auto", "none"):
            return
        if self.flow_net is None and self.refiner is None:
            self.flow_net, self.refiner = self._load_nets(self.device, height, width)
        self._nets = {self.device: (self.flow_net, self.refiner)}
        if self._mesh is not None:
            for d in self._mesh.frame_devices:
                if d not in self._nets:
                    self._nets[d] = self._load_nets(d, height, width)
            logger.info("temporal denoise split over %d devices, %d centres a step",
                        len(self._mesh.frame_devices), self._batch)

    def _load_nets(self, dev: torch.device, height: int, width: int):
        """-> (flow net, refiner) of the method on ``dev`` (None where the
        method runs none)."""
        cfg = self.config
        from framewright_tpu_torch.models import registry, restormer
        from framewright_tpu_torch.models.layers import tree_to_torch
        from framewright_tpu_torch.models.nafnet import NAFNet

        flow_net = refiner = None
        if cfg.method in _ALIGNED and cfg.radius > 0:
            if cfg.flow_model == "raft":
                _, tree, src = registry.load_aux("raft-things", cfg.weights_dir)
                pairs = cfg.flow_pairs or self._raft_pairs(height, width)
                flow_net = RAFTFlow(tree_to_torch(tree, dev), pairs)
                logger.info("denoise RAFT: %s, %d pairs a step", src, pairs)
            else:
                flow_net = registry.load_align_ifnet(dev)
        if cfg.method == "nafnet":
            spec, sd, src = registry.load_weights("FW_nafnet_dn", cfg.weights_dir,
                                                  allow_random=False)
            refiner = NAFNet.from_state_dict(spec.arch_config, sd, dev).apply_padded
            logger.info("denoise NAFNet: %s", src)
        if cfg.method == "restormer":
            spec, tree, src = registry.load_aux("restormer", cfg.weights_dir)
            refiner = functools.partial(restormer.apply_padded, tree_to_torch(tree, dev),
                                        cfg=spec.arch_config)
            logger.info("denoise Restormer %s: %s", spec.arch_config, src)
        return flow_net, refiner

    def _raft_pairs(self, height: int, width: int) -> int:
        from framewright_tpu_torch import planner
        from framewright_tpu_torch.hw import device_info

        free = device_info(self.device).free_bytes if self.device.type == "cuda" else None
        return planner.raft_pairs(height or 64, width or 64, free,
                                  max_pairs=2 * self.config.radius)

    # -- the device step ------------------------------------------------------
    def upload(self, frame: np.ndarray) -> torch.Tensor:
        """A uint8 (H, W, 3) frame on the denoiser's device."""
        return torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)

    def _slots(self, window: List[torch.Tensor], center_idx: int):
        """-> centre (H,W,3) f32, neighbours (2r,H,W,3) f32 (short windows
        padded with the centre), real neighbour count."""
        k = 2 * self.config.radius
        c = to_float(window[center_idx])
        nb = [f for i, f in enumerate(window) if i != center_idx]
        n_real = len(nb)
        nbs = to_float(torch.stack(nb)) if nb else c.new_zeros((0,) + c.shape)
        if n_real < k:
            nbs = torch.cat([nbs, c.expand(k - n_real, *c.shape)])
        return c, nbs, n_real

    def align(self, c: torch.Tensor, nbs: torch.Tensor, flow_net=None) -> torch.Tensor:
        """The neighbours warped onto the centre by the flow centre ->
        neighbour (the JAX ``estimate_flow(c_rep, neighbors)``), with
        ``flow_net`` (default: the denoiser's)."""
        flow_net = flow_net or self.flow_net
        return flow_warp(nbs, flow_net.estimate_flow(c.expand_as(nbs), nbs))

    def blend(self, c: torch.Tensor, warped: torch.Tensor, n_real: int) -> torch.Tensor:
        """Photometric blend of the warped slots into the centre; slots
        from ``n_real`` on weigh nothing."""
        sigma2 = 2.0 * self.config.similarity_sigma ** 2
        diff = ((warped - c) ** 2).mean(-1, keepdim=True)
        # the median over the real neighbours' values: the noise floor
        floor = nanmedian(diff[:n_real]) if n_real else diff.new_zeros(())
        s2 = torch.clamp(2.0 * floor, min=sigma2)
        m = torch.zeros(len(warped), device=warped.device)
        m[:n_real] = 1.0
        wgt = torch.exp(-diff / s2) * m[:, None, None, None]
        return (c + (warped * wgt).sum(0)) / (1.0 + wgt.sum(0))

    @staticmethod
    def bilateral(x: torch.Tensor) -> torch.Tensor:
        """3x3 edge-preserving filter of x (B,H,W,3); the shifts wrap
        around the frame (``jnp.roll``)."""
        acc = torch.zeros_like(x)
        wacc = torch.zeros_like(x[..., :1])
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                sh = torch.roll(x, (dy, dx), dims=(1, 2))
                d2 = ((sh - x) ** 2).mean(-1, keepdim=True)
                w = torch.exp(-d2 / 0.01) * float(np.float32(np.exp(-(dy * dy + dx * dx) / 2.0)))
                acc = acc + sh * w
                wacc = wacc + w
        return acc / wacc

    def denoise_window(self, window: List[torch.Tensor], center_idx: int) -> np.ndarray:
        """One centre: uint8 device frames -> the denoised uint8 frame on
        the host."""
        return self._denoise_batch([(window, center_idx)])[0]

    def _step(self, windows: List[Tuple[List[torch.Tensor], int]],
              dev: torch.device) -> torch.Tensor:
        """A batch of centres on ``dev`` (each window's frames moved there)
        -> their denoised uint8 frames (n, H, W, 3) on ``dev``: each
        centre's 2r neighbours aligned by the flow net in one call and
        blended (the planner's pre-SR row holds one centre's window), then
        the refiner on the batch."""
        cfg = self.config
        flow_net, refiner = self._nets.get(dev, (self.flow_net, self.refiner))
        cs, outs = [], []
        for w, ci in windows:
            c, nbs, n_real = self._slots([f.to(dev) for f in w], ci)
            cs.append(c)
            aligned = cfg.method in _ALIGNED and len(nbs)
            outs.append(self.blend(c, self.align(c, nbs, flow_net), n_real) if aligned else c)
            del nbs
        c, out = torch.stack(cs), torch.stack(outs)
        del cs, outs
        if cfg.method in ("nafnet", "restormer"):
            out = refiner(out)
        elif cfg.method == "bilateral":
            out = self.bilateral(c)
        blended = cfg.strength * out + (1.0 - cfg.strength) * c
        if cfg.chroma_only:
            # keep the centre's luma: the luma delta added to every channel
            w = torch.tensor(_BT601, dtype=torch.float32, device=c.device)
            blended = blended + ((c - blended) * w).sum(-1, keepdim=True)
        return to_uint8(blended.clamp(0.0, 1.0))

    def _denoise_batch(self, windows: List[Tuple[List[torch.Tensor], int]]
                       ) -> List[np.ndarray]:
        """A step's centres -> their denoised uint8 frames on the host, in
        order: on the denoiser's device, or padded to the mesh with the
        last centre and split over it."""
        if not windows:
            return []
        n = len(windows)
        if self._mesh is None:
            return list(self._step(windows, self.device).cpu().numpy())
        padded = windows + [windows[-1]] * (pad_batch_for_mesh(n, self._mesh) - n)
        devs = self._mesh.frame_devices
        outs = run_split(len(padded), self._mesh,
                         lambda i, a, b: self._step(padded[a:b], devs[i]))
        return list(np.concatenate([o.cpu().numpy() for o in outs])[:n])

    # -- the stream ---------------------------------------------------------------
    def _auto_configure(self, head: List[np.ndarray]) -> None:
        """Profile the head frames; set method, strength, rejection width
        and chroma_only from the profile, then load the method's nets."""
        from framewright_tpu_torch.processors.noise_profiler import NoiseProfiler

        cfg = self.config
        prof = NoiseProfiler(sample_frames=len(head)).analyze_frames(head)
        cfg.method = prof.recommended_denoiser
        if cfg.method != "none":
            cfg.strength = max(0.1, prof.recommended_strength)
            cfg.similarity_sigma = max(cfg.similarity_sigma, prof.similarity_sigma)
            cfg.chroma_only = prof.chroma_only
        self.result.profile = prof.to_dict()
        logger.info("auto denoise: %s strength=%.2f (noise %s, sigma %.2f)",
                    cfg.method, cfg.strength, prof.dominant_type.value,
                    prof.characteristics.luma_sigma)
        self.setup(*self._dims)

    def denoise_stream(self, frames_iter: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        """Every frame once, denoised with its window; a look-ahead of r
        frames, windows cut at scene changes."""
        cfg = self.config
        if cfg.method == "auto":
            head = list(itertools.islice(frames_iter, max(8, 2 * cfg.radius + 1)))
            self._auto_configure(head)
            frames_iter = itertools.chain(head, frames_iter)
        if cfg.method == "none":
            for frame in frames_iter:
                self.result.frames += 1
                yield frame
            return
        r = cfg.radius
        buf: List[Tuple[np.ndarray, torch.Tensor]] = []   # (host, device) frames
        out_idx = 0
        pending: List[Tuple[List[torch.Tensor], int]] = []   # queued (window, centre)

        def queue(center_pos: int) -> None:
            lo = max(0, center_pos - r)
            hi = min(len(buf), center_pos + r + 1)
            self.result.frames += 1
            pending.append(([f for _, f in buf[lo:hi]], center_pos - lo))

        def flush(final: bool) -> List[np.ndarray]:
            """Steps of ``batch`` queued centres (at the end, the rest too)."""
            nonlocal pending
            done: List[np.ndarray] = []
            while len(pending) >= self._batch or (final and pending):
                step, pending = pending[:self._batch], pending[self._batch:]
                done += self._denoise_batch(step)
            return done

        prev: Optional[np.ndarray] = None
        for frame in frames_iter:
            if prev is not None:
                score = float(frame_pair_scores(prev[None], frame[None])[0])
                if score >= cfg.scene_change_threshold:
                    # every frame before the cut, then a fresh window
                    while out_idx < len(buf):
                        queue(out_idx)
                        out_idx += 1
                    self.result.scene_resets += 1
                    buf, out_idx = [], 0
            buf.append((frame, self.upload(frame)))
            prev = frame
            # frames whose forward context is complete
            while out_idx + r < len(buf):
                queue(out_idx)
                out_idx += 1
                if out_idx > r:              # drop frames no window needs
                    buf = buf[out_idx - r:]
                    out_idx = r
            yield from flush(False)
        while out_idx < len(buf):
            queue(out_idx)
            out_idx += 1
        yield from flush(True)


class FlickerReducer:
    """Global-luma temporal smoothing (numpy, on the host): each frame's
    mean scaled toward the mean over a centred window of ``window``
    frames, by ``strength``."""

    def __init__(self, window: int = 9, strength: float = 0.8):
        self.window = window
        self.strength = strength

    def reduce_stream(self, frames_iter: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        hist: List[float] = []
        buf: List[np.ndarray] = []
        half = self.window // 2
        for frame in frames_iter:
            buf.append(frame)
            hist.append(float(frame.astype(np.float32).mean()))
            if len(buf) > half:
                yield self._correct(buf, hist, len(buf) - half - 1)
            if len(buf) > self.window:
                buf.pop(0)
                hist.pop(0)
        start = max(0, len(buf) - half)
        for i in range(start, len(buf)):
            yield self._correct(buf, hist, i)

    def _correct(self, buf, hist, idx) -> np.ndarray:
        target = float(np.mean(hist))
        cur = hist[idx]
        if cur < 1e-3:
            return buf[idx]
        gain = 1.0 + self.strength * (target / cur - 1.0)
        out = buf[idx].astype(np.float32) * gain
        return np.clip(out, 0, 255).astype(np.uint8)
