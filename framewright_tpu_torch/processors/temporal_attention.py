"""Cross-frame patch attention for temporal consistency: the port of
``framewright_tpu.processors.temporal_attention`` (``CFAConfig``,
``CrossFrameAttention``), on the card in f32.

Each frame is filtered with its edge-clamped +-radius window. Frames are
compared as 8x8 patches: for every patch of the centre, the candidates
are the same patch in each neighbour under a 3x3 grid of shifts of 4
pixels (``torch.roll``, wrapping). The distance is mean-free (the
variance of the mean colour difference over the patch), so a patch
whose brightness flickers still matches; the weights are a softmax of
-d / (2 sigma^2) over the self patch (distance 0, first) and the
candidates, and the output, clip(out + 0.5, 0, 255), is truncated to
uint8. Frames are edge-padded to multiples of 8 and cropped back; each
uint8 frame is uploaded once and its filtered copy returned to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np
import torch

from framewright_tpu_torch.hw import resolve_device


@dataclass
class CFAConfig:
    radius: int = 1                 # temporal neighbours each side
    patch: int = 8                  # patch size (fixed grid)
    search_step: int = 4            # offset grid step (px)
    search_range: int = 1           # offsets in [-r..r] * step per axis
    sigma: float = 6.0              # attention bandwidth (intensity units)
    strength: float = 1.0           # 0..1 blend with the input


class CrossFrameAttention:
    """Streaming cross-frame attention flicker and noise suppressor."""

    def __init__(self, config: Optional[CFAConfig] = None, device: str = "cuda"):
        self.config = config or CFAConfig()
        self.device = resolve_device(device)
        c = self.config
        self._offsets = [(dy * c.search_step, dx * c.search_step)
                         for dy in range(-c.search_range, c.search_range + 1)
                         for dx in range(-c.search_range, c.search_range + 1)]

    def _patch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """(H, W) -> the mean of each p x p patch, (H/p, W/p)."""
        p = self.config.patch
        h, w = x.shape
        return x.reshape(h // p, p, w // p, p).mean(dim=(1, 3))

    def run(self, win_u8: torch.Tensor) -> torch.Tensor:
        """(T, H, W, C) uint8 on the device, sides multiples of the patch
        -> the filtered centre, (H, W, C) uint8."""
        cfg = self.config
        p = cfg.patch
        win = win_u8.float()
        t = win.shape[0]
        center = win[t // 2]
        cands, dists = [], []
        for n in range(t):
            if n == t // 2:
                continue
            for dy, dx in self._offsets:
                shifted = torch.roll(win[n], (dy, dx), dims=(0, 1))
                # mean-free structural distance: a per-patch DC shift
                # (flicker) does not count
                diff = (shifted - center).mean(-1)
                m = self._patch_mean(diff)
                dists.append(self._patch_mean(diff ** 2) - m ** 2)
                cands.append(shifted)
        d = torch.stack(dists)                               # (K, H/p, W/p)
        v = torch.stack(cands)                               # (K, H, W, C)
        d_all = torch.cat([torch.zeros_like(d[:1]), d])      # self first
        wgt = torch.softmax(-d_all / (2.0 * cfg.sigma ** 2), dim=0)
        wfull = wgt.repeat_interleave(p, 1).repeat_interleave(p, 2)[..., None]
        out = wfull[0] * center + (wfull[1:] * v).sum(0)
        out = center + cfg.strength * (out - center)
        return torch.clamp(out + 0.5, 0, 255).to(torch.uint8)

    def _filter(self, frames: List[torch.Tensor]) -> np.ndarray:
        """A window of uint8 (H, W, C) device frames -> the filtered centre
        on the host: edge-padded to multiples of the patch, cropped back."""
        p = self.config.patch
        h, w = frames[0].shape[:2]
        x = torch.stack(frames)
        hp, wp = -(-h // p) * p, -(-w // p) * p
        if (hp, wp) != (h, w):
            rows = torch.arange(hp, device=x.device).clamp_(max=h - 1)
            cols = torch.arange(wp, device=x.device).clamp_(max=w - 1)
            x = x[:, rows][:, :, cols]
        return self.run(x)[:h, :w].cpu().numpy()

    def process_window(self, window: np.ndarray) -> np.ndarray:
        """window: (2r+1, H, W, C) uint8 -> the centre frame filtered."""
        return self._filter(list(torch.from_numpy(np.ascontiguousarray(window))
                                 .to(self.device)))

    def process_stream(self, frames_iter: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        """``reduce_stream`` under ``FlickerReducer``'s name (JAX's alias)."""
        return self.reduce_stream(frames_iter)

    def reduce_stream(self, frames_iter: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        """Every frame once, filtered with its edge-clamped +-radius window;
        2r + 1 frames held on the device."""
        r = self.config.radius
        win = 2 * r + 1
        buf: List[torch.Tensor] = []
        base = 0          # global index of buf[0]
        emitted = 0

        def emit(i: int, latest: int) -> np.ndarray:
            return self._filter([buf[min(max(j, 0), latest) - base]
                                 for j in range(i - r, i + r + 1)])

        for f in frames_iter:
            buf.append(torch.from_numpy(np.ascontiguousarray(f)).to(self.device))
            if len(buf) > win:
                buf.pop(0)
                base += 1
            latest = base + len(buf) - 1
            while emitted + r <= latest:
                yield emit(emitted, latest)
                emitted += 1
        latest = base + len(buf) - 1
        while buf and emitted <= latest:
            yield emit(emitted, latest)
            emitted += 1
