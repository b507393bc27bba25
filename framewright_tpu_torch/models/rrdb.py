"""RRDBNet (Real-ESRGAN generator) as a torch ``nn.Module``.

The port of ``framewright_tpu/models/rrdb.py``. Public functions keep
the JAX package's layout: NHWC input in [0, 1]; output (B, sH, sW, 3),
or uint8 planes Y (B, sH, sW), U and V (B, sH/2, sW/2).

  apply       plain PyTorch forward (counterpart of ``rrdb.apply``),
              computed in the input's dtype like the JAX conv2d
  apply_fast  the kernel path (counterpart of ``rrdb.apply_fast`` with
              the merge body and the tail3 kernels): conv_first in
              F.conv2d, then the RDB kernel 69 times (23 blocks), K1, K2
              with the output epilogue
  _out_epilogue  the exact uint8/YUV contract of ``rrdb._out_epilogue``

Parameter names follow the official basicsr state dict
(``conv_first``, ``body.{i}.rdb{1,2,3}.conv{1..5}``, ``conv_body``,
``conv_up1``, ``conv_up2``, ``conv_hr``, ``conv_last``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch import nn

from framewright_tpu_torch.models.layers import (
    conv2d,
    lrelu,
    pixel_unshuffle,
    upsample_nearest,
)


@dataclass(frozen=True)
class RRDBConfig:
    num_in_ch: int = 3
    num_out_ch: int = 3
    num_feat: int = 64
    num_block: int = 23
    num_grow_ch: int = 32
    scale: int = 4   # output = input * scale; the body runs at input / (4 / scale)


def _conv(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResidualDenseBlock(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.conv1 = _conv(nf, gc)
        self.conv2 = _conv(nf + gc, gc)
        self.conv3 = _conv(nf + 2 * gc, gc)
        self.conv4 = _conv(nf + 3 * gc, gc)
        self.conv5 = _conv(nf + 4 * gc, nf)

    def convs(self) -> List[nn.Conv2d]:
        return [self.conv1, self.conv2, self.conv3, self.conv4, self.conv5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for conv in self.convs()[:4]:
            feats.append(lrelu(conv2d(torch.cat(feats, -1), conv.weight, conv.bias)))
        x5 = conv2d(torch.cat(feats, -1), self.conv5.weight, self.conv5.bias)
        return x5 * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(nf, gc)
        self.rdb2 = ResidualDenseBlock(nf, gc)
        self.rdb3 = ResidualDenseBlock(nf, gc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.rdb3(self.rdb2(self.rdb1(x)))
        return out * 0.2 + x


@dataclass
class FastWeights:
    """The kernels' weight layouts, derived once from the module."""
    body: list     # [num_block][3] fused_rrdb.RDBWeights
    cbody: object  # fused_tail3.ConvBodyWeights
    tail: object   # fused_tail.TailWeights


class RRDBNet(nn.Module):
    def __init__(self, cfg: RRDBConfig = RRDBConfig()):
        super().__init__()
        self.cfg = cfg
        nf, gc = cfg.num_feat, cfg.num_grow_ch
        in_ch = cfg.num_in_ch * {2: 4, 1: 16}.get(cfg.scale, 1)
        self.conv_first = _conv(in_ch, nf)
        self.body = nn.ModuleList(RRDB(nf, gc) for _ in range(cfg.num_block))
        self.conv_body = _conv(nf, nf)
        self.conv_up1 = _conv(nf, nf)
        self.conv_up2 = _conv(nf, nf)
        self.conv_hr = _conv(nf, nf)
        self.conv_last = _conv(nf, cfg.num_out_ch)
        self._fast: Optional[FastWeights] = None

    @classmethod
    def from_state_dict(cls, cfg: RRDBConfig, sd: Dict[str, torch.Tensor],
                        device: torch.device) -> "RRDBNet":
        """Build on the meta device (no throwaway init), then take the
        state dict's tensors as parameters and move them to ``device``."""
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(sd, assign=True)
        return model.to(device).eval().requires_grad_(False)

    # -- plain path ------------------------------------------------------
    def _head(self, x: torch.Tensor) -> torch.Tensor:
        s = self.cfg.scale
        feat = pixel_unshuffle(x, 2) if s == 2 else (
            pixel_unshuffle(x, 4) if s == 1 else x)
        return conv2d(feat, self.conv_first.weight, self.conv_first.bias)

    def _tail(self, feat: torch.Tensor, body_out: torch.Tensor) -> torch.Tensor:
        feat = feat + conv2d(body_out.to(feat.dtype), self.conv_body.weight,
                             self.conv_body.bias)
        for conv in (self.conv_up1, self.conv_up2):
            feat = lrelu(conv2d(upsample_nearest(feat, 2), conv.weight, conv.bias))
        feat = lrelu(conv2d(feat, self.conv_hr.weight, self.conv_hr.bias))
        return conv2d(feat, self.conv_last.weight, self.conv_last.bias)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Plain forward. x: (B, H, W, C) in [0, 1], computed in x's
        dtype; H and W even for scale 2, multiples of 4 for scale 1.
        Named after ``rrdb.apply``, it shadows ``nn.Module.apply(fn)``,
        which the port never calls."""
        feat = self._head(x)
        body = feat
        for blk in self.body:
            body = blk(body)
        return self._tail(feat, body)

    # -- kernel path -----------------------------------------------------
    def fast_weights(self) -> FastWeights:
        """The kernels' weights (bf16, rounded once from the module's
        parameters), built on first use on the module's device."""
        if self._fast is None:
            from framewright_tpu_torch.ops import fused_rrdb, fused_tail, fused_tail3

            self._fast = FastWeights(
                body=[[fused_rrdb.rdb_weights(r.convs())
                       for r in (blk.rdb1, blk.rdb2, blk.rdb3)]
                      for blk in self.body],
                cbody=fused_tail3.conv_body_weights(self.conv_body),
                tail=fused_tail.tail_weights(self.conv_up1, self.conv_up2,
                                             self.conv_hr, self.conv_last))
        return self._fast

    def apply_fast(self, x: torch.Tensor, out_mode: str = "bf16",
                   full_range: bool = False):
        """Kernel forward in bf16. x: (B, H, W, 3) in [0, 1]. Output per
        ``out_mode`` (see ops/fused_tail.py): bf16 RGB, rgb_u8, or the
        yuv420_u8 planes."""
        from framewright_tpu_torch.ops import fused_rrdb, fused_tail, fused_tail3

        fw = self.fast_weights()
        feat = self._head(x.to(torch.bfloat16)).contiguous()
        ws = fused_rrdb.rrdb_body(feat, fw.body)
        skip = fused_tail3.conv_body_skip(ws, feat, fw.cbody)
        del ws, feat   # the tail's 4K intermediates may reuse this memory
        return fused_tail.fused_tail(skip, fw.tail, out_mode, full_range)


def _out_epilogue(out: torch.Tensor, out_mode: str, full_range: bool):
    """The uint8 output contract on a float RGB image (B, H, W, 3):
    exactly ``framewright_tpu.models.rrdb._out_epilogue``."""
    y = out.float().clamp(0.0, 1.0) * 255.0
    if out_mode == "rgb_u8":
        return torch.floor(y + 0.5).to(torch.uint8)
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
