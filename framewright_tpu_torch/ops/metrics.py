"""Quality metrics: PSNR and SSIM (the port of
``framewright_tpu.ops.metrics``), on NHWC tensors in f32.

SSIM is Wang et al.'s: an 11x11 Gaussian window with sigma 1.5, VALID
borders, C1 = (0.01 max)^2 and C2 = (0.03 max)^2, computed per channel
and averaged. The JAX package filters with the 2D window at
``Precision.HIGHEST``; here the window's two 1D factors filter rows,
then columns, in f32 with TF32 off, one frame and one channel at a time
so the maps of a 4K frame stay a few plane sizes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.hw import full_f32

_WINDOW, _SIGMA = 11, 1.5


@functools.lru_cache(maxsize=8)
def _gaussian_1d(dev: torch.device) -> torch.Tensor:
    """The 1D factor of the JAX package's 2D window (outer(g, g) / its
    sum equals outer(g / sum(g), g / sum(g))), on ``dev``, built once:
    an upload from pageable memory per frame would wait for the work
    queued on the stream, the SR batch the stats follow."""
    ax = np.arange(_WINDOW, dtype=np.float64) - (_WINDOW - 1) / 2.0
    g = np.exp(-0.5 * (ax / _SIGMA) ** 2)
    return torch.from_numpy((g / g.sum()).astype(np.float32)).to(dev)


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """PSNR in dB over all values of two tensors of the same shape."""
    mse = (a.float() - b.float()).pow_(2).mean()
    return 10.0 * torch.log10((max_val * max_val) / mse.clamp_min(1e-12))


def psnr_per_frame(a: torch.Tensor, b: torch.Tensor,
                   max_val: float = 1.0) -> torch.Tensor:
    """(N, H, W, C) pairs -> (N,) PSNR in dB."""
    mse = (a.float() - b.float()).pow_(2).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10((max_val * max_val) / mse.clamp_min(1e-12))


def _ssim_plane(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                c1: float, c2: float) -> torch.Tensor:
    """Mean SSIM of two (H, W) f32 planes."""
    q = torch.empty((5, 1) + a.shape, dtype=torch.float32, device=a.device)
    q[0, 0], q[1, 0] = a, b
    torch.mul(a, a, out=q[2, 0])
    torch.mul(b, b, out=q[3, 0])
    torch.mul(a, b, out=q[4, 0])
    q = F.conv2d(q, g.view(1, 1, 1, -1))
    q = F.conv2d(q, g.view(1, 1, -1, 1))[:, 0]
    mu_a, mu_b, e_aa, e_bb, e_ab = q
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    num = (2 * mu_ab + c1) * (2 * (e_ab - mu_ab) + c2)
    den = (mu_aa + mu_bb + c1) * ((e_aa - mu_aa) + (e_bb - mu_bb) + c2)
    return (num / den).mean()


def ssim_per_frame(a: torch.Tensor, b: torch.Tensor,
                   max_val: float = 1.0) -> torch.Tensor:
    """(N, H, W, C) pairs -> (N,) mean SSIM over the channels' maps."""
    n, h, w, c = a.shape
    if h < _WINDOW or w < _WINDOW:
        raise ValueError(f"SSIM needs frames of at least {_WINDOW}x{_WINDOW}, "
                         f"got {h}x{w}")
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    g = _gaussian_1d(a.device)
    out = torch.empty(n, dtype=torch.float32, device=a.device)
    with full_f32():
        for i in range(n):
            per_channel = [_ssim_plane(a[i, ..., k].float(), b[i, ..., k].float(), g, c1, c2)
                           for k in range(c)]
            out[i] = torch.stack(per_channel).mean()
    return out


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM of (H, W, C) or (N, H, W, C) images."""
    if a.dim() == 3:
        a, b = a[None], b[None]
    return ssim_per_frame(a, b, max_val).mean()
