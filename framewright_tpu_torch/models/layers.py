"""Building blocks on NHWC tensors, with the JAX package's semantics
(``framewright_tpu.models.layers``): NHWC activations at the public
functions, OIHW weights inside, f32 accumulation in every conv."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def conv_init(rng: np.random.Generator, k: int, c_in: int, c_out: int,
              gain: float = 1.0) -> Dict[str, np.ndarray]:
    """Seeded Kaiming-uniform init (torch Conv2d's default) in HWIO
    layout, with the bounds of ``framewright_tpu.models.layers.conv_init``."""
    bound = gain * np.sqrt(1.0 / (k * k * c_in)) * np.sqrt(3.0)
    w = rng.uniform(-bound, bound, (k, k, c_in, c_out)).astype(np.float32)
    b = rng.uniform(-bound, bound, (c_out,)).astype(np.float32)
    return {"w": w, "b": b}


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv, NHWC in and out, OIHW weights. Like the JAX
    ``conv2d``: weights cast to the activation dtype, products summed in
    f32, bias added in f32, one rounding to the activation dtype."""
    xf = x.permute(0, 3, 1, 2).float()
    wf = w.to(x.dtype).float()
    y = F.conv2d(xf, wf, padding=w.shape[-1] // 2) + b.float().view(1, -1, 1, 1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def mul_weak(x: torch.Tensor, s: float) -> torch.Tensor:
    """x * s with JAX's weakly typed Python scalar: against a bf16 operand
    the scalar is bf16(s) and the product rounds to bf16."""
    if x.dtype == torch.bfloat16:
        return x * torch.tensor(s, dtype=x.dtype)
    return x * s


def lrelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, mul_weak(x, slope))


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, H*r, W*r, C) -> (N, H, W, C*r*r), torch channel order
    (channel c*r*r + i*r + j holds offset (i, j))."""
    n, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    x = x.reshape(n, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, h, w, c * r * r)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of an NHWC tensor."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)
