"""Watermark, logo and subtitle removal by mask inpainting: the port of
``framewright_tpu.processors.inpaint``.

The mask (host, numpy, as in JAX): over the first ``detect_frames``
frames, pixels whose luma barely changes over time and whose edge energy
is high (an overlay persists while the content moves), restricted to the
bottom third for subtitles, dropped when it covers over a fifth of the
frame, dilated ``dilate`` times; plus the ``custom_masks`` rectangles
(x0, y0, x1, y1). The fill, on the card in f32: ``lama`` runs the LaMa
FFC network (``models.lama``) from ``<weights_dir>/big-lama.npz``, its
widths read from the checkpoint (``config_from_params``); without that
file ``setup`` raises ``InputError`` naming it (JAX draws
``lama.init(PRNGKey(3))`` instead). ``diffusion`` is JAX's classical heat
fill: 64 iterations of the 4-neighbour mean (wrapped at the borders)
inside the hole. Both outputs are clipped and rounded half up to uint8
on the host, as JAX's ``to_uint8``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from framewright_tpu_torch.errors import InputError
from framewright_tpu_torch.hw import resolve_device

logger = logging.getLogger(__name__)

LAMA_NPZ = "big-lama.npz"


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(x, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)


@dataclass
class InpaintConfig:
    method: str = "lama"          # lama | diffusion (classical fill)
    auto_detect: bool = True
    detect_frames: int = 30
    static_threshold: float = 6.0   # max temporal std for "static"
    edge_threshold: float = 18.0    # min edge energy for overlay-ish
    dilate: int = 3
    custom_masks: List[Tuple[int, int, int, int]] = field(default_factory=list)
    subtitle_band: bool = False     # restrict auto-detect to bottom third
    weights_dir: Optional[str] = None
    device: str = "cuda"


class WatermarkRemover:
    def __init__(self, config: Optional[InpaintConfig] = None):
        self.config = config or InpaintConfig()
        self.device = resolve_device(self.config.device)
        self._mask: Optional[np.ndarray] = None
        self._params = None
        self._arch = None

    # ------------------------------------------------------------------
    def detect_mask(self, frames: List[np.ndarray]) -> np.ndarray:
        """Static-overlay mask: per-pixel temporal std low AND spatial
        edge energy high (logos/subtitles persist while content moves)."""
        cfg = self.config
        stack = np.stack([f.astype(np.float32).mean(-1) for f in frames])
        tstd = stack.std(axis=0)
        mean = stack.mean(axis=0)
        gx = np.abs(np.diff(mean, axis=1, prepend=mean[:, :1]))
        gy = np.abs(np.diff(mean, axis=0, prepend=mean[:1]))
        edges = gx + gy
        mask = (tstd < cfg.static_threshold) & (edges > cfg.edge_threshold)
        if cfg.subtitle_band:
            h = mask.shape[0]
            band = np.zeros_like(mask)
            band[int(h * 2 / 3):] = True
            mask &= band
        # reject if "overlay" covers most of the frame (static scene)
        if mask.mean() > 0.2:
            return np.zeros_like(mask, dtype=bool)
        for _ in range(cfg.dilate):
            mask = (mask | np.roll(mask, 1, 0) | np.roll(mask, -1, 0)
                    | np.roll(mask, 1, 1) | np.roll(mask, -1, 1))
        return mask

    def _build_mask(self, frames: List[np.ndarray]) -> np.ndarray:
        h, w = frames[0].shape[:2]
        mask = np.zeros((h, w), bool)
        if self.config.auto_detect and len(frames) >= 3:
            mask |= self.detect_mask(frames)
        for (x0, y0, x1, y1) in self.config.custom_masks:
            mask[y0:y1, x0:x1] = True
        return mask

    # ------------------------------------------------------------------
    def setup(self, height: int = 0, width: int = 0) -> None:
        """``lama``: the checkpoint, read before any compute (raises
        ``InputError`` naming ``<weights_dir>/big-lama.npz`` when it is
        missing)."""
        if self.config.method != "lama" or self._params is not None:
            return
        from framewright_tpu_torch.models import lama
        from framewright_tpu_torch.models.layers import tree_to_torch
        from framewright_tpu_torch.models.registry import _read_checkpoint, default_weights_dir

        npz = Path(self.config.weights_dir or default_weights_dir()) / LAMA_NPZ
        if not npz.is_file():
            raise InputError(f"inpainting with LaMa needs {npz} (the JAX package's .npz "
                             "layout; the port never draws it at random)")
        params = _read_checkpoint(npz)
        self._arch = lama.config_from_params(params)
        self._params = tree_to_torch(params, self.device, torch.float32)

    def diffusion_fill(self, frame: np.ndarray, mask: np.ndarray,
                       iters: int = 64) -> np.ndarray:
        """Heat diffusion inside the hole: each iteration sets the hole to
        the mean of its 4 neighbours (wrapped), on the card in f32."""
        f = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device).float() / 255.0
        m = torch.from_numpy(mask[..., None].astype(np.float32)).to(self.device)
        keep = f * (1 - m)
        x = keep
        for _ in range(iters):
            avg = (torch.roll(x, 1, 0) + torch.roll(x, -1, 0)
                   + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)) / 4.0
            x = keep + avg * m
        return _to_uint8(x.clamp(0, 1).cpu().numpy())

    def lama_fill(self, frame: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """LaMa on one frame, on the card in f32."""
        from framewright_tpu_torch.models import lama

        img = torch.from_numpy(frame[None].astype(np.float32) / 255.0).to(self.device)
        m = torch.from_numpy(mask[None, ..., None].astype(np.float32)).to(self.device)
        with torch.no_grad():
            out = lama.apply_padded(self._params, img, m, self._arch)
        return _to_uint8(out[0].cpu().numpy())

    def inpaint_frame(self, frame: np.ndarray, mask: np.ndarray) -> np.ndarray:
        if not mask.any():
            return frame
        if self.config.method == "lama":
            return self.lama_fill(frame, mask)
        return self.diffusion_fill(frame, mask)

    # ------------------------------------------------------------------
    def process_stream(self, frames_iter: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        cfg = self.config
        buf: List[np.ndarray] = []
        started = False
        for f in frames_iter:
            if not started:
                buf.append(f)
                if len(buf) >= cfg.detect_frames:
                    self._begin(buf)
                    started = True
                    for bf in buf:
                        yield self.inpaint_frame(bf, self._mask)
                    buf = []
                continue
            yield self.inpaint_frame(f, self._mask)
        if not started and buf:
            self._begin(buf)
            for bf in buf:
                yield self.inpaint_frame(bf, self._mask)

    @property
    def mask(self) -> Optional[np.ndarray]:
        return self._mask

    def _begin(self, frames: List[np.ndarray]) -> None:
        self.setup(frames[0].shape[0], frames[0].shape[1])
        self._mask = self._build_mask(frames)
        logger.info("inpaint mask covers %.2f%% of frame", 100.0 * self._mask.mean())


class SubtitleRemover(WatermarkRemover):
    """Burnt-in subtitle removal: auto-detect restricted to the bottom
    band, with a looser static threshold (subtitles change with dialog)."""

    def __init__(self, config: Optional[InpaintConfig] = None):
        cfg = config or InpaintConfig()
        cfg.subtitle_band = True
        cfg.static_threshold = max(cfg.static_threshold, 20.0)
        super().__init__(cfg)
