"""uint8 <-> float frame conversions: the port of
``framewright_tpu.processors.base.to_float`` and ``to_uint8`` on tensors,
so the pre-SR stream converts on the card. ``x / 255`` in f32 is an IEEE
division: the same numbers on the card as the JAX package's on the
host."""

from __future__ import annotations

import torch


def to_float(frames: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1]; other dtypes -> float32."""
    if frames.dtype == torch.uint8:
        return frames.float() / 255.0
    return frames.float()


def to_uint8(frames: torch.Tensor) -> torch.Tensor:
    """float in [0, 1] -> uint8: clip(x * 255 + 0.5, 0, 255), truncated
    (round half away from zero on the clipped range)."""
    return torch.clamp(frames.float() * 255.0 + 0.5, 0, 255).to(torch.uint8)
