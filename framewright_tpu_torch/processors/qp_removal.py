"""QP / codec artifact removal (deblocking and deringing): the port of
``framewright_tpu.processors.qp_removal``.

The blockiness probe (the luma gradient energy on the 8-pixel codec grid
against off it) runs on the host in numpy, as in JAX; it sets the DCT
threshold when ``strength`` is 0, per batch of frames from its first
frame. The filter runs on the card in f32: for each of ``shifts`` shifted
copies of the 8x8 block grid, the forward DCT of every block (two matrix
products), soft-thresholding of the AC coefficients, the inverse DCT, and
the mean over the shifts; then clip(y + 0.5) truncated to uint8. Frames
are edge-padded to multiples of 8 on the host and cropped back. JAX
computes the filter in XLA, outside any Pallas kernel; here it is plain
``torch.einsum``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from framewright_tpu_torch.hw import resolve_device

logger = logging.getLogger(__name__)


@dataclass
class QPRemovalConfig:
    strength: float = 0.0          # 0 = auto from blockiness
    shifts: int = 4                # shifted grids averaged (1..4)
    luma_only: bool = False        # filter Y only (fastest)
    auto_gain: float = 12.0        # blockiness -> threshold scaling


def _dct_matrix(n: int = 8) -> np.ndarray:
    k = np.arange(n)
    m = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    m[0] *= np.sqrt(0.5)
    return m.astype(np.float32)


_DCT8 = _dct_matrix(8)
_SHIFTS = ((0, 0), (4, 4), (0, 4), (4, 0))


def estimate_blockiness(frame: np.ndarray) -> float:
    """Gradient energy on the 8-px codec grid vs off-grid (>= ~1.15
    means visible blocking). Frame: HxWx3 or HxW uint8."""
    f = frame.astype(np.float32)
    luma = f @ np.asarray([0.299, 0.587, 0.114], np.float32) if f.ndim == 3 else f
    gx = np.abs(np.diff(luma, axis=1))
    gy = np.abs(np.diff(luma, axis=0))
    h, w = luma.shape
    on_x = gx[:, 7::8].mean() if w > 8 else 0.0
    on_y = gy[7::8, :].mean() if h > 8 else 0.0
    mask_x = np.ones(gx.shape[1], bool)
    mask_x[7::8] = False
    mask_y = np.ones(gy.shape[0], bool)
    mask_y[7::8] = False
    off = (gx[:, mask_x].mean() + gy[mask_y, :].mean()) / 2.0 + 1e-6
    return float((on_x + on_y) / 2.0 / off)


def _one_shift(x: torch.Tensor, thr: float, dct: torch.Tensor, sy: int, sx: int
               ) -> torch.Tensor:
    """One shifted grid: x (N, H, W, C) f32, H and W multiples of 8."""
    n, h, w, c = x.shape
    xr = torch.roll(x, (-sy, -sx), dims=(1, 2))
    b = xr.reshape(n, h // 8, 8, w // 8, 8, c).permute(0, 1, 3, 5, 2, 4)
    coef = torch.einsum("ij,...jk,lk->...il", dct, b, dct)
    dc = coef[..., :1, :1].clone()
    coef = torch.sign(coef) * torch.clamp(coef.abs() - thr, min=0.0)
    coef[..., :1, :1] = dc
    blk = torch.einsum("ji,...jk,kl->...il", dct, coef, dct)
    out = blk.permute(0, 1, 4, 2, 5, 3).reshape(n, h, w, c)
    return torch.roll(out, (sy, sx), dims=(1, 2))


def dct_filter(x_u8: torch.Tensor, thr: float, shifts: int) -> torch.Tensor:
    """uint8 (N, H, W, C) on any device, H and W multiples of 8 -> the
    filtered uint8 frames: the mean over the first ``shifts`` (1-4) grids
    of ``_SHIFTS``."""
    x = x_u8.float()
    dct = torch.from_numpy(_DCT8).to(x.device)
    n = max(1, min(shifts, 4))
    acc = torch.zeros_like(x)
    for sy, sx in _SHIFTS[:n]:
        acc = acc + _one_shift(x, thr, dct, sy, sx)
    y = acc / float(n)
    return torch.clamp(y + 0.5, 0.0, 255.0).to(torch.uint8)


class QPArtifactRemover:
    """Deblocking/deringing processor (reference
    qp_artifact_removal.py:181): ``process_batch`` filters on the card;
    ``process_stream`` filters batches of 8 frames, each at the strength
    its first frame's blockiness gives."""

    def __init__(self, config: Optional[QPRemovalConfig] = None, device: str = "cuda"):
        self.config = config or QPRemovalConfig()
        self.device = resolve_device(device)

    def _threshold(self, sample: np.ndarray) -> float:
        if self.config.strength > 0:
            return self.config.strength
        block = estimate_blockiness(sample)
        if block < 1.05:
            return 0.0     # grid invisible: don't touch the frame
        # calibrated on synthetic DCT-quantized frames (PSNR-optimal
        # thresholds: q12->~2, q24->~3, q40->~5): small thresholds win,
        # large ones eat real texture
        return float(np.clip(1.5 + (block - 1.02) * self.config.auto_gain,
                             1.0, 8.0))

    def process_batch(self, frames: np.ndarray,
                      threshold: Optional[float] = None) -> np.ndarray:
        """frames: (N, H, W, C) uint8 -> filtered uint8."""
        thr = self._threshold(frames[0]) if threshold is None else threshold
        if thr <= 0.0:
            return frames
        n, h, w, c = frames.shape
        ph, pw = (-h) % 8, (-w) % 8
        x = np.pad(frames, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
        y = dct_filter(torch.from_numpy(x).to(self.device), float(thr), self.config.shifts)
        return y.cpu().numpy()[:, :h, :w]

    def process_stream(self, frames_iter: Iterator[np.ndarray],
                       batch: int = 8) -> Iterator[np.ndarray]:
        buf = []
        for f in frames_iter:
            buf.append(f)
            if len(buf) == batch:
                yield from self.process_batch(np.stack(buf))
                buf.clear()
        if buf:
            yield from self.process_batch(np.stack(buf))
