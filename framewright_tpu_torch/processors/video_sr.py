"""Chunked recurrent video super-resolution: the port of
``framewright_tpu.processors.video_sr`` (``VSRConfig``,
``VideoSuperResolution``) for the registry's ``vsr`` rows (BasicVSR,
TVSR_x4).

Each ``dispatch`` of n <= ``chunk`` frames runs the model over a window
of ``overlap`` carried context frames, the n new frames and, for a short
batch, copies of its last frame up to ``chunk + overlap``; it returns the
outputs of the new frames only. The first window's context is copies of
the first frame; after each batch the carry is the last ``overlap``
source frames of the window. Frames are padded (edge, bottom and right)
to multiples of 32 for SpyNet's pyramid and the output cropped back; the
window runs as u8 / 255 in the compute dtype (bf16, or float32; int8 runs
bf16 as in JAX), the output clipped in f32 and rounded half up to uint8,
as JAX's ``run``. A batch larger than ``chunk`` runs in slices.

Resume (``seed_context``): the restorer resumes at a chunk start R and
seeds the carry with the ``overlap`` source frames before R (padded on
the left with the first frame when R < overlap), which is what a
straight run carries there, so the resumed output equals the straight
run's byte for byte. The JAX processor starts a resumed run's carry from
copies of the first resumed frame, so its output after a resume differs
(ROADMAP.md, "JAX faults the port must not copy"); so does its restorer,
which builds ``VSRConfig`` without ``weights_dir`` (the port passes it).

``sharding="spatial"`` (JAX's; the restorer maps ``sharding_strategy``
"auto" and "spatial" to it) splits each window's rows into bands over the
cards of ``mesh_shape`` (``parallel.mesh.data_mesh``; JAX's splits over
every local device), one a card, each computing its own rows of the
one-card result (``vsr.apply(bands=)``: SpyNet once on the whole frames,
the carry gathered whole before each warp, the trunk's halo exchanged
after its head and every block; ``tvsr.apply(bands=)``: bands on window
rows, half a window of rows from each neighbour, cyclic, before each
shifted block). With one card nothing is split; a height that does not
divide by the cards (JAX's rule), or a TVSR window with fewer rows of
attention windows than cards, is not split either, with a warning, and
runs on the first card. The plan is the first card's: its bands' share of
the window, one working set and what is gathered whole there
(``planner.vsr_bytes(band_rows=...)``).

No kernel of its own: the model's forward is plain PyTorch
(``models.vsr``, ``models.tvsr``: the registry's ``TREE_MODULES`` of the
row's family), as it is XLA in JAX. ``plan`` holds the frames a dispatch
takes (``frames``) and ``planner.vsr_bytes`` (``est_bytes``); ``setup``
raises ``HBMError`` when that window does not fit the free memory times
``hbm_utilization`` less ``reserved_bytes`` (the pre-SR and face
reserves). The chunk is not lowered to fit: the output depends on it,
and a resume must find the straight run's chunks.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch import planner
from framewright_tpu_torch.errors import ConfigError, HBMError, InputError
from framewright_tpu_torch.hw import device_info, full_f32, resolve_device

logger = logging.getLogger(__name__)

_PAD_MULT = 32  # SpyNet's 6-level pyramid
_SHARDINGS = ("none", "spatial")


@dataclass
class VSRConfig:
    model_name: str = "BasicVSR"
    chunk: int = 8                 # new frames a device step
    overlap: int = 2               # carried context frames
    compute_dtype: str = "bfloat16"
    weights_dir: Optional[str] = None
    device: str = "cuda"           # cuda | cpu
    hbm_utilization: float = 0.85
    reserved_bytes: int = 0        # card memory kept off the window's budget
    sharding: str = "none"         # none | spatial: the window's rows in bands
    #                                over the cards of ``mesh_shape``
    mesh_shape: Tuple[int, ...] = ()   # () = every local card


@dataclass(frozen=True)
class VSRPlan:
    frames: int                    # frames a dispatch takes (the chunk)
    est_bytes: int                 # planned peak card bytes of a window (the
    #                                first card's, under the spatial split)


class VideoSuperResolution:
    """Stateful chunked VSR: ``setup(h, w)`` once, then ``dispatch`` /
    ``materialize`` (or ``process_batch``) on consecutive batches in
    order."""

    name = "video_sr"

    def __init__(self, config: Optional[VSRConfig] = None):
        self.config = config or VSRConfig()
        self.scale = 4
        self.device: Optional[torch.device] = None
        self.dispatches = 0
        self.weights_source = ""
        self.plan: Optional[VSRPlan] = None
        self._tail: Optional[np.ndarray] = None
        self._params = None
        self.bands = None                  # parallel.bands.Bands of the spatial split
        self._band_params: list = []       # the tree on each band's device

    def setup(self, height: int, width: int) -> None:
        from framewright_tpu_torch.models.layers import tree_to_torch
        from framewright_tpu_torch.models.registry import (
            TREE_MODULES,
            VSR_FAMILIES,
            get_model,
            load_params,
        )

        cfg = self.config
        if get_model(cfg.model_name).family not in VSR_FAMILIES:
            raise ConfigError(f"{cfg.model_name} is not a video SR model")
        if cfg.chunk < 1 or cfg.overlap < 0:
            raise ConfigError("chunk must be >= 1 and overlap >= 0")
        if cfg.sharding not in _SHARDINGS:
            raise ConfigError(f"VSR sharding must be one of {_SHARDINGS}, got {cfg.sharding!r}")
        spec, tree, self.weights_source = load_params(cfg.model_name, cfg.weights_dir)
        self.scale = spec.scale
        self._dtype = torch.float32 if cfg.compute_dtype == "float32" else torch.bfloat16
        module = TREE_MODULES[spec.family]
        self._fn = module.apply
        self._arch = spec.arch_config
        self._h, self._w = height, width
        self._ph, self._pw = -height % _PAD_MULT, -width % _PAD_MULT
        self._win = cfg.chunk + cfg.overlap
        self._tail = None
        self.bands = self._split(height, spec, module)
        band_devs = self.bands.devices if self.bands is not None else ()
        self.device = band_devs[0] if band_devs else resolve_device(cfg.device)
        on = {d: tree_to_torch(tree, d, self._dtype)
              for d in dict.fromkeys((self.device,) + band_devs)}
        self._params = on[self.device]
        self._band_params = [on[d] for d in band_devs]
        dt = "float32" if cfg.compute_dtype == "float32" else "bfloat16"
        if self.bands is None:
            est = planner.vsr_bytes(height, width, self._win, spec.family, dt)
        else:
            est = planner.vsr_bytes(height, width, self._win, spec.family, dt,
                                    band_rows=self.bands.rows,
                                    bands_here=self.bands.devices.count(self.device))
        self.plan = VSRPlan(cfg.chunk, est)
        budget = (planner.budget_bytes(device_info(self.device).free_bytes, cfg.hbm_utilization)
                  - cfg.reserved_bytes)
        if self.plan.est_bytes > budget:
            raise HBMError(f"a VSR window of {self._win} frames of {width}x{height} needs "
                           f"~{self.plan.est_bytes / 2**30:.1f} GiB, {budget / 2**30:.1f} GiB "
                           "available beside the pre-SR and face reserves; lower "
                           "--batch (chunk) or the input resolution")
        logger.info("VSR %s (%s) on %s: window %d (+%d overlap), %dx%d -> %dx%d, plan %.2f GB",
                    cfg.model_name, self.weights_source, self.device, self._win, cfg.overlap,
                    width, height, width * self.scale, height * self.scale,
                    self.plan.est_bytes / 1e9)

    def _split(self, height: int, spec, module):
        """The row bands of the spatial split over the cards of
        ``mesh_shape`` (``parallel.mesh.data_mesh``), or None: one card, a
        height that does not divide by the number of cards (JAX's rule), or
        a TVSR window with fewer rows of attention windows than cards
        (its bands are cut on them) skips the split, the last two with a
        warning; the window then runs on the first card."""
        from framewright_tpu_torch.parallel import mesh as mesh_mod
        from framewright_tpu_torch.parallel.bands import Bands

        cfg = self.config
        if cfg.sharding != "spatial":
            return None
        mesh = mesh_mod.data_mesh(cfg.device, cfg.mesh_shape)
        if mesh is None:
            return None
        devs = list(mesh.frame_devices)
        hp = height + self._ph
        if height % len(devs):
            logger.warning("VSR spatial sharding skipped: height %d not divisible by %d "
                           "devices", height, len(devs))
            return None
        if spec.family == "tvsr":
            win = self._arch.window
            if hp // win < len(devs):
                logger.warning("VSR spatial sharding skipped: %d rows of %d-row windows "
                               "cannot make %d bands", hp // win, win, len(devs))
                return None
            bands = Bands.split(hp, devs, 0, align=win)
        else:
            bands = Bands.split(hp, devs, module.BAND_HALO)
        logger.info("VSR height-split over %d devices: rows %s (halo %d) on %s", len(devs),
                    list(bands.cuts), bands.halo, [str(d) for d in devs])
        return bands

    def output_size(self, height: int, width: int):
        return height * self.scale, width * self.scale

    def seed_context(self, before: List[np.ndarray]) -> None:
        """The carry of a run resumed at frame R: ``before`` holds the
        source frames max(0, R - overlap) .. R - 1 (R > 0), padded on the
        left with the first of them to ``overlap`` frames."""
        ov = self.config.overlap
        if not before:
            raise InputError("a resumed VSR run needs the frames before its resume point")
        frames = [before[0]] * (ov - len(before)) + list(before[-ov:] if ov else [])
        self._tail = np.stack(frames) if frames else np.zeros((0,) + before[0].shape, np.uint8)

    def reset_context(self) -> None:
        """Drop the carry: the next window starts from copies of its first
        frame, as a run's first window does."""
        self._tail = None

    def _run(self, window: np.ndarray) -> torch.Tensor:
        """uint8 (T, H, W, 3) -> uint8 (T, sH, sW, 3) on the device."""
        x = torch.from_numpy(window).to(self.device, non_blocking=False)
        x = x.to(self._dtype) / 255.0
        if self._ph or self._pw:
            x = F.pad(x.permute(0, 3, 1, 2).float(), (0, self._pw, 0, self._ph),
                      mode="replicate").to(self._dtype).permute(0, 2, 3, 1)
        with full_f32(), torch.no_grad():
            params = self._params if self.bands is None else self._band_params
            y = self._fn(params, x[None], self._arch, bands=self.bands)[0]
        y = y[:, : self._h * self.scale, : self._w * self.scale]
        return torch.floor(y.float().clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)

    def dispatch(self, frames: np.ndarray) -> dict:
        """Build the window, update the carry, run the model (on the card
        its work is queued; ``materialize`` copies the result back)."""
        if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8:
            raise InputError(f"{self.name}: expected uint8 (B, H, W, 3), got "
                             f"{frames.shape} {frames.dtype}")
        n, ov = len(frames), self.config.overlap
        if n > self.config.chunk:
            c = self.config.chunk
            return {"parts": [self.dispatch(frames[i:i + c]) for i in range(0, n, c)]}
        self.dispatches += 1
        if self._tail is None:             # the first window: copies of frame 0
            self._tail = np.repeat(frames[:1], ov, axis=0)
        window = np.concatenate([self._tail, frames], axis=0)
        if len(window) < self._win:
            window = np.concatenate(
                [window, np.repeat(window[-1:], self._win - len(window), axis=0)], axis=0)
        real = window[: ov + n]
        self._tail = real[len(real) - ov:] if ov else real[:0]
        try:
            y, exc = self._run(np.ascontiguousarray(window))[ov:ov + n], None
        except torch.cuda.OutOfMemoryError as e:     # surfaced at materialize
            y, exc = None, e
        return {"y": y, "exc": exc}

    def materialize(self, handle: dict) -> np.ndarray:
        if "parts" in handle:
            return np.concatenate([self.materialize(h) for h in handle["parts"]], axis=0)
        if handle["exc"] is not None:
            raise HBMError(f"VSR window {self._win}x{self._w}x{self._h} does not fit the "
                           "card; lower --batch (chunk) or the input resolution"
                           ) from handle["exc"]
        return handle["y"].cpu().numpy()

    def process_batch(self, frames: np.ndarray) -> np.ndarray:
        return self.materialize(self.dispatch(frames))

    def teardown(self) -> None:
        self._params = None
        self._band_params = []
        self._tail = None
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
