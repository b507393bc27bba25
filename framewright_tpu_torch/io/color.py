"""Colourspace conversion between planar YUV and interleaved RGB: the
port's copy of ``framewright_tpu.io.color``.

``yuv420_to_rgb`` and ``rgb_to_yuv420`` are the JAX module's numpy
float math (BT.601, limited range unless ``full_range``); the Y4M codec
(``io.y4m``) decodes and encodes 4:2:0 at even sizes with the native
integer arithmetic instead, as the JAX reader and writer do.
``yuv_to_rgb`` and ``rgb_to_yuv`` are the tensor versions of
``yuv_to_rgb_jax`` and ``rgb_to_yuv_jax``: 4:4:4 float frames on any
device.
"""

from __future__ import annotations

import numpy as np
import torch

from framewright_tpu_torch.io.y4m import _yuv_to_rgb_float

# BT.601 limited-range constants
_KR, _KG, _KB = 0.299, 0.587, 0.114

def yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                  full_range: bool = False) -> np.ndarray:
    """Planar YUV (uint8) -> RGB uint8 (H, W, 3), BT.601, in float32
    (the Y4M reader's decode of chroma that is not 4:2:0 at even sizes)."""
    return _yuv_to_rgb_float(y, u, v, full_range)


def rgb_to_yuv420(rgb: np.ndarray, full_range: bool = False):
    """RGB uint8 (H, W, 3) -> planar YUV420 uint8 (y, u, v), BT.601, in
    float32 with 2x2 box-mean chroma. H and W must be even."""
    h, w = rgb.shape[:2]
    rf = rgb[..., 0].astype(np.float32)
    gf = rgb[..., 1].astype(np.float32)
    bf = rgb[..., 2].astype(np.float32)
    yf = _KR * rf + _KG * gf + _KB * bf
    uf = (bf - yf) / (2.0 * (1.0 - _KB))
    vf = (rf - yf) / (2.0 * (1.0 - _KR))
    if not full_range:
        yf = yf * (219.0 / 255.0) + 16.0
        uf = uf * (224.0 / 255.0)
        vf = vf * (224.0 / 255.0)
    yy = np.clip(yf + 0.5, 0, 255).astype(np.uint8)
    uf = uf.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    vf = vf.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    u = np.clip(uf + 128.5, 0, 255).astype(np.uint8)
    v = np.clip(vf + 128.5, 0, 255).astype(np.uint8)
    return yy, u, v


def yuv_to_rgb(yuv: torch.Tensor, full_range: bool = False) -> torch.Tensor:
    """(..., H, W, 3) float YUV in [0, 255] -> float RGB in [0, 1]."""
    y = yuv[..., 0]
    u = yuv[..., 1] - 128.0
    v = yuv[..., 2] - 128.0
    if not full_range:
        y = (y - 16.0) * (255.0 / 219.0)
        u = u * (255.0 / 224.0)
        v = v * (255.0 / 224.0)
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return (torch.stack([r, g, b], dim=-1) / 255.0).clamp(0.0, 1.0)


def rgb_to_yuv(rgb: torch.Tensor, full_range: bool = False) -> torch.Tensor:
    """(..., H, W, 3) float RGB in [0, 1] -> float YUV in [0, 255] (4:4:4)."""
    rgb = rgb * 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = _KR * r + _KG * g + _KB * b
    u = (b - y) / (2.0 * (1.0 - _KB))
    v = (r - y) / (2.0 * (1.0 - _KR))
    if not full_range:
        y = y * (219.0 / 255.0) + 16.0
        u = u * (224.0 / 255.0)
        v = v * (224.0 / 255.0)
    return torch.stack([y, u + 128.0, v + 128.0], dim=-1)
