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
    y = F.conv2d(xf, wf, padding=w.shape[-1] // 2)
    y += b.float().view(1, -1, 1, 1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def mul_weak(x: torch.Tensor, s: float) -> torch.Tensor:
    """x * s with JAX's weakly typed Python scalar: against a bf16 operand
    the scalar is bf16(s) and the product rounds to bf16."""
    if x.dtype == torch.bfloat16:
        return x * torch.tensor(s, dtype=x.dtype)
    return x * s


def lrelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, mul_weak(x, slope))


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Channel-wise PReLU of an NHWC tensor, as the JAX ``prelu``: alpha
    cast to x's dtype, so in bf16 the product rounds to bf16."""
    return torch.where(x >= 0, x, x * alpha.to(x.dtype))


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, H, W, C*r*r) -> (N, H*r, W*r, C), torch channel order
    (channel c*r*r + i*r + j lands at offset (i, j))."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, c // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, c // (r * r))


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


def out_epilogue(out: torch.Tensor, out_mode: str, full_range: bool):
    """The uint8 output contract on a float RGB image (B, H, W, 3):
    exactly ``framewright_tpu.models.rrdb._out_epilogue`` (rgb_u8:
    round half up of clip(out) * 255; yuv420_u8: BT.601 Y, U, V with 2x2
    chroma means, limited range unless ``full_range``). The RRDB tail
    kernel computes it in its store; the SRVGG path applies it here."""
    y = out.float().clamp(0.0, 1.0).mul_(255.0)
    if out_mode == "rgb_u8":
        return torch.floor(y + 0.5).to(torch.uint8)
    if out_mode != "yuv420_u8":
        raise ValueError(f"out_mode must be rgb_u8 or yuv420_u8, got {out_mode!r}")
    kr, kg, kb = 0.299, 0.587, 0.114
    r, g, b = y[..., 0], y[..., 1], y[..., 2]
    yy = kr * r + kg * g + kb * b
    uu = (b - yy) / (2.0 * (1.0 - kb))
    vv = (r - yy) / (2.0 * (1.0 - kr))
    if not full_range:
        yy = yy * (219.0 / 255.0) + 16.0
        uu = uu * (224.0 / 255.0)
        vv = vv * (224.0 / 255.0)
    n, hh, ww = yy.shape
    uu = uu.reshape(n, hh // 2, 2, ww // 2, 2).mean(dim=(2, 4))
    vv = vv.reshape(n, hh // 2, 2, ww // 2, 2).mean(dim=(2, 4))
    return (torch.floor(yy + 0.5).clamp(0, 255).to(torch.uint8),
            torch.floor(uu + 128.5).clamp(0, 255).to(torch.uint8),
            torch.floor(vv + 128.5).clamp(0, 255).to(torch.uint8))
