"""K1: conv_body + bias + the head features' skip, its plain version.

Replaces ``framewright_tpu/ops/fused_tail3.py``: ``_cbody_kernel`` (via
``conv_body_skip_blocks``). The kernel is ``csrc/conv_body.cu``; its
note says what bounds it on the card and what the design does about it.
It reads the body output straight from the RDB workspace (channels 0:64
of a 192-channel NHWC tensor), so the body needs no copy between them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from framewright_tpu_torch.ops import _build, fused_rrdb

NF = 64


@dataclass
class ConvBodyWeights:
    w: torch.Tensor    # (64, 3, 3, 64) bf16, OHWI
    b: torch.Tensor    # (64,) f32
    wk: torch.Tensor   # fused_rrdb.wgmma_weights(w), for the kernel


def conv_body_weights(conv: torch.nn.Conv2d) -> ConvBodyWeights:
    w = conv.weight.detach().float().permute(0, 2, 3, 1).contiguous().to(torch.bfloat16)
    return ConvBodyWeights(w, conv.bias.detach().float().contiguous(),
                           fused_rrdb.wgmma_weights(w))


def _check(body: torch.Tensor, feat: torch.Tensor) -> None:
    if body.dtype != torch.bfloat16 or body.dim() != 4 or body.shape[-1] < NF \
            or body.shape[-1] % 8 or not body.is_contiguous():
        raise ValueError(f"conv_body_skip: body must be contiguous (B, H, W, C>=64)"
                         f" bf16, got {tuple(body.shape)} {body.dtype}")
    if feat.dtype != torch.bfloat16 or tuple(feat.shape) != (*body.shape[:3], NF) \
            or not feat.is_contiguous() or feat.device != body.device:
        raise ValueError(f"conv_body_skip: feat must be contiguous (B, H, W, 64) "
                         f"bf16 beside body, got {tuple(feat.shape)} {feat.dtype}")


def conv_body_skip_plain(body: torch.Tensor, feat: torch.Tensor,
                         wts: ConvBodyWeights) -> torch.Tensor:
    """bf16(conv(body[..., :64]) + b + feat), summed in f32."""
    acc = F.conv2d(body[..., :NF].permute(0, 3, 1, 2).float(),
                   wts.w.permute(0, 3, 1, 2).float(), padding=1)
    out = acc + wts.b.view(1, -1, 1, 1) + feat.permute(0, 3, 1, 2).float()
    return out.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


def conv_body_skip(body: torch.Tensor, feat: torch.Tensor,
                   wts: ConvBodyWeights) -> torch.Tensor:
    """``body`` (B, H, W, C) bf16 with the body output in channels 0:64,
    ``feat`` (B, H, W, 64) bf16 head output -> (B, H, W, 64) bf16. On a
    CPU tensor this runs the plain version; on a CUDA tensor it launches
    the kernel."""
    _check(body, feat)
    if body.device.type == "cpu":
        return conv_body_skip_plain(body, feat, wts)
    if body.device.type != "cuda":
        raise ValueError(f"conv_body_skip: unsupported device {body.device}")
    b, h, w, c = body.shape
    out = torch.empty(b, h, w, NF, dtype=torch.bfloat16, device=body.device)
    lib = _build.library()
    _build.check(lib.fw_conv_body_skip(
        body.data_ptr(), c, b, h, w, wts.wk.data_ptr(), wts.b.data_ptr(),
        feat.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(body.device).cuda_stream),
        "fw_conv_body_skip")
    conv_body_skip.launches += 1
    return out


conv_body_skip.launches = 0
