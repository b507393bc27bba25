"""Backward warping by optical flow: the port of
``framewright_tpu.ops.warp`` (``grid_sample``, ``flow_warp``).

The JAX ``grid_sample`` gathers the two neighbours of each coordinate,
each clipped to the frame from the unclipped floor, so an out-of-frame
sample collapses to the border texel: that is torch's
``F.grid_sample(mode="bilinear", padding_mode="border")``, which the port
calls (``tests/test_torch_denoise.py`` holds the two together, out-of-frame
coordinates included). ``zeros`` multiplies the border result by the
bilinear in-bounds weight, as the JAX ``flow_warp`` does. Public
functions take NHWC tensors; ``flow_warp_nchw`` is the NCHW form the
flow net uses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = True) -> torch.Tensor:
    """Bilinear sample img (B,H,W,C) at grid (B,Ho,Wo,2) of normalized
    (x, y) coordinates in [-1, 1], border padding -> (B,Ho,Wo,C)."""
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid.to(img.dtype), mode="bilinear",
                        padding_mode="border", align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def flow_warp_nchw(img: torch.Tensor, flow: torch.Tensor,
                   padding_mode: str = "border", row0: int = 0) -> torch.Tensor:
    """img (B,C,H,W), flow (B,2,H,W) in pixels ((x, y) order):
    out(p) = img(p + flow(p)). ``row0``: flow holds the img rows row0 ..
    row0 + its height only (a band of the frame), and so does the output,
    each row computed as the whole frame's."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"padding_mode must be border or zeros, got {padding_mode!r}")
    _, _, h, w = img.shape
    fx = torch.arange(w, dtype=torch.float32, device=img.device) + flow[:, 0].float()
    fy = (torch.arange(row0, row0 + flow.shape[2], dtype=torch.float32,
                       device=img.device)[:, None] + flow[:, 1].float())
    # normalized to [-1, 1], align_corners=True
    grid = torch.stack([2.0 * fx / max(w - 1, 1) - 1.0, 2.0 * fy / max(h - 1, 1) - 1.0], -1)
    out = F.grid_sample(img, grid.to(img.dtype), mode="bilinear", padding_mode="border",
                        align_corners=True)
    if padding_mode == "zeros":
        # the border texel times the bilinear in-bounds weight: torch's
        # zeros padding, as the JAX flow_warp computes it
        mask = ((torch.minimum(fx + 1.0, w - fx)).clamp(0.0, 1.0)
                * (torch.minimum(fy + 1.0, h - fy)).clamp(0.0, 1.0))
        out = out * mask[:, None].to(out.dtype)
    return out


def flow_warp(img: torch.Tensor, flow: torch.Tensor,
              padding_mode: str = "border", row0: int = 0) -> torch.Tensor:
    """Backward-warp img (B,H,W,C) by flow (B,H,W,2) in pixels (``row0``:
    ``flow_warp_nchw``'s)."""
    out = flow_warp_nchw(img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), padding_mode,
                         row0)
    return out.permute(0, 2, 3, 1)
