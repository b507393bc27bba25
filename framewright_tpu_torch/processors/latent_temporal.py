"""Temporal-VAE-class consistency, latent-space temporal smoothing: the
port of ``framewright_tpu.processors.latent_temporal``.

Per chunk of T frames, on the card in f32: the frames F (T, D) in [0, 1]
centred on their mean; the Gram matrix G = F F^T (T x T) and its
``eigh`` (temporal modes U, energies lam, clipped at 0); the latent
trajectories U * sqrt(lam) low-passed over time (a moving average of
radius ``smooth_radius``, edge-padded) and blended by ``strength``, except
within the radius of a scene cut (an adjacent-frame distance above
``cut_sigma`` times their median); the reconstruction from the basis
V^T = U^T F / sqrt(lam), plus the mean, clipped, times 255, plus 0.5,
truncated to uint8. A tail chunk shorter than T is edge-padded to T.
The stream (host, as in JAX): chunks overlap by ``overlap`` frames and
crossfade across them. The reconstruction is invariant to the sign and
the rotation within degenerate eigenvalues of U, which are not the same
on the card and in LAPACK.
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
class LatentTemporalConfig:
    chunk: int = 16              # frames per latent chunk (T)
    overlap: int = 4             # crossfaded frames between chunks
    strength: float = 0.6        # blend of the smoothed reconstruction
    smooth_radius: int = 2       # temporal low-pass half-width
    cut_sigma: float = 4.0       # adjacent-distance spike = scene cut


def smooth_chunk(frames_u8: torch.Tensor, cfg: LatentTemporalConfig) -> torch.Tensor:
    """uint8 (T, H, W, C) on any device -> the smoothed uint8 chunk."""
    r = cfg.smooth_radius
    t = frames_u8.shape[0]
    dev = frames_u8.device
    f = frames_u8.reshape(t, -1).float() / 255.0
    mu = f.mean(dim=0, keepdim=True)
    fc = f - mu
    g = fc @ fc.T                                    # (T, T)
    lam, u = torch.linalg.eigh(g)                    # ascending
    lam = torch.clamp(lam, min=0.0)
    s = torch.sqrt(lam + 1e-12)
    vt = (u.T @ fc) / s[:, None]                     # (T, D)
    el = u * s[None, :]                              # latent trajectories

    # scene-cut gate: a spike in the adjacent-frame distance
    d = torch.sqrt(torch.sum((fc[1:] - fc[:-1]) ** 2, dim=1))
    ds = torch.sort(d).values
    m = len(ds)
    med = (ds[(m - 1) // 2] + ds[m // 2]) / 2.0 + 1e-6
    cut = d > cfg.cut_sigma * med                    # (T-1,)
    cut_near = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), cut])
    ones = torch.ones((1, 1, 2 * r + 1), device=dev)
    near = torch.nn.functional.conv1d(cut_near.float()[None, None], ones, padding=r)[0, 0] > 0

    # temporal low-pass per component (columns of el), edge-padded
    pad = torch.cat([el[:1].expand(r, -1), el, el[-1:].expand(r, -1)])
    kernel = torch.full((1, 1, 2 * r + 1), 1.0 / (2 * r + 1), device=dev)
    sm = torch.nn.functional.conv1d(pad.T[:, None], kernel)[:, 0].T
    w = cfg.strength * (1.0 - near.float()[:, None])
    el2 = el * (1 - w) + sm * w
    f2 = el2 @ vt + mu
    out = torch.clamp(f2, 0.0, 1.0) * 255.0 + 0.5
    return out.to(torch.uint8).reshape(frames_u8.shape)


class LatentTemporalSmoother:
    """Streaming chunked latent-space temporal smoother."""

    def __init__(self, config: Optional[LatentTemporalConfig] = None, device: str = "cuda"):
        self.config = config or LatentTemporalConfig()
        self.device = resolve_device(device)

    def _run(self, frames: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        return smooth_chunk(x, self.config).cpu().numpy()

    def process_chunk(self, frames: np.ndarray) -> np.ndarray:
        t = frames.shape[0]
        want = self.config.chunk
        if t < 3:
            return frames
        if t < want:  # edge-pad the tail chunk to the static shape
            padded = np.concatenate(
                [frames, np.repeat(frames[-1:], want - t, axis=0)])
            return self._run(padded)[:t]
        return self._run(frames)

    def reduce_stream(self, frames_iter: Iterator[np.ndarray]
                      ) -> Iterator[np.ndarray]:
        cfg = self.config
        step = cfg.chunk - cfg.overlap
        assert step > 0, "overlap must be smaller than chunk"
        buf: list = []
        prev_tail: Optional[np.ndarray] = None  # smoothed overlap frames

        def flush(frames, final):
            nonlocal prev_tail
            out = np.array(self.process_chunk(np.stack(frames)))
            if prev_tail is not None:
                n = min(len(prev_tail), len(out))
                a = np.linspace(0.0, 1.0, n + 2)[1:-1, None, None, None]
                out[:n] = (prev_tail[:n] * (1 - a)
                           + out[:n].astype(np.float32) * a).astype(np.uint8)
            emit_n = len(out) if final else len(out) - cfg.overlap
            for i in range(emit_n):
                yield out[i]
            prev_tail = None if final else out[emit_n:].astype(np.float32)

        for f in frames_iter:
            buf.append(f)
            if len(buf) == cfg.chunk:
                yield from flush(buf, final=False)
                buf = buf[step:]
        if buf and (len(buf) > cfg.overlap or prev_tail is None):
            yield from flush(buf, final=True)
        elif prev_tail is not None:
            # stream ended exactly on a chunk boundary: the held
            # overlap frames are the only ones not yet emitted
            for i in range(len(buf)):
                yield prev_tail[i].astype(np.uint8)

    process_stream = reduce_stream
