"""IFNet (RIFE-class coarse-to-fine flow net): the port of
``framewright_tpu.models.ifnet`` as an ``nn.Module`` (NCHW inside, NHWC
at ``apply``, ``interpolate_padded`` and ``estimate_flow``), f32.

Each IFBlock: two stride-2 3x3 conv + PReLU downs padded (1, 1) as torch
RIFE pads them, a chain of 3x3 conv + PReLU with ONE residual skip
around the whole chain, then ``ConvTranspose2d(c, 24, 4, 2, 1)`` (as a
phase conv, ``ConvTranspose4x2``) and ``PixelShuffle(2)``: a 6-channel map at the block's input resolution
(flow img0 xy, flow img1 xy, mask logit, an unused channel). Block b
runs at 1 / scales[b] of the frame on the images and the timestep (b =
0), or on both images warped by the current flow, the timestep, the
mask and the flow scaled by 1 / scale (b > 0); its output is resized
back to the frame and its flow, times the scale, added to the flow.
State-dict names follow Practical-RIFE (``block0.conv0.0.0.weight``,
``block0.lastconv.0.weight``, ...).

The temporal denoiser aligns frames with ``estimate_flow`` on the
alignment arch (channels (96, 64), scales (4, 2), 4 chain convs) and the
weights ``weights/align_ifnet_key1.npz``, written by
``scripts/export_align_ifnet.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from framewright_tpu_torch.models.layers import resize_bilinear_nchw
from framewright_tpu_torch.ops.warp import flow_warp_nchw


@dataclass(frozen=True)
class IFNetConfig:
    channels: Tuple[int, ...] = (192, 128, 96, 64)
    scales: Tuple[int, ...] = (8, 4, 2, 1)
    num_res_convs: int = 8


# the temporal denoiser's alignment net (framewright_tpu temporal_denoise.py:99-104)
ALIGN_ARCH = IFNetConfig(channels=(96, 64), scales=(4, 2), num_res_convs=4)


def _conv_prelu(cin: int, cout: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, stride, 1), nn.PReLU(cout, 0.25))


# (3x3 tap index, transposed-kernel index) along one axis for each output
# parity of ConvTranspose2d(k=4, s=2, p=1): output row 2i reads input rows
# i (kernel row 1) and i - 1 (row 3); row 2i + 1 reads i (2) and i + 1 (0)
_PHASE_TAPS = {0: ((1, 1), (0, 3)), 1: ((1, 2), (2, 0))}


class ConvTranspose4x2(nn.Module):
    """``ConvTranspose2d(cin, cout, 4, 2, 1)`` (its weight (cin, cout, 4,
    4) and bias), computed as one 3x3 conv to the four output phases and a
    pixel shuffle. cuDNN runs a transposed conv as a convolution's
    backward-data pass, whose algorithms may sum in another order on each
    run; a forward conv sums in a fixed one, so a restore gives the same
    bytes every time (chip_smoke.py holds a resumed and a subprocess run
    to a straight one)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 4, 4))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cin, cout = self.weight.shape[:2]
        w3 = self.weight.new_zeros(cout, 2, 2, cin, 3, 3)
        for a, rows in _PHASE_TAPS.items():
            for b, cols in _PHASE_TAPS.items():
                for iy, ky in rows:
                    for ix, kx in cols:
                        w3[:, a, b, :, iy, ix] = self.weight[:, :, ky, kx].t()
        y = F.conv2d(x, w3.reshape(4 * cout, cin, 3, 3), self.bias.repeat_interleave(4),
                     padding=1)
        return F.pixel_shuffle(y, 2)


class IFBlock(nn.Module):
    def __init__(self, in_ch: int, c: int, num_res_convs: int):
        super().__init__()
        self.conv0 = nn.Sequential(_conv_prelu(in_ch, c // 2, 2), _conv_prelu(c // 2, c, 2))
        self.convblock = nn.Sequential(*[_conv_prelu(c, c) for _ in range(num_res_convs)])
        self.lastconv = nn.Sequential(ConvTranspose4x2(c, 24), nn.PixelShuffle(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv0(x)
        feat = self.convblock(feat) + feat
        return self.lastconv(feat)


class IFNet(nn.Module):
    def __init__(self, cfg: IFNetConfig = IFNetConfig()):
        super().__init__()
        self.cfg = cfg
        for b, c in enumerate(cfg.channels):
            self.add_module(f"block{b}", IFBlock(7 if b == 0 else 12, c, cfg.num_res_convs))

    def pyramid(self, img0: torch.Tensor, img1: torch.Tensor, timestep: float,
                final_warps: bool = True):
        """NCHW images -> (flow (B,4,H,W), mask, warped0, warped1); the
        last level's warps only when ``final_warps``."""
        b, _, h, w = img0.shape
        flow = img0.new_zeros(b, 4, h, w)
        mask = img0.new_zeros(b, 1, h, w)
        warped0, warped1 = img0, img1
        tmap = img0.new_full((b, 1, h, w), timestep)
        last = len(self.cfg.scales) - 1
        for bi, scale in enumerate(self.cfg.scales):
            if bi == 0:
                x = torch.cat([img0, img1, tmap], 1)
            else:
                x = torch.cat([warped0, warped1, tmap, mask, flow], 1)
            xs = resize_bilinear_nchw(x, (h // scale, w // scale))
            del x
            if bi > 0:
                # the flow channels at the pyramid level's scale
                xs = torch.cat([xs[:, :-4], xs[:, -4:] * (1.0 / scale)], 1)
            out = resize_bilinear_nchw(getattr(self, f"block{bi}")(xs), (h, w))
            flow = flow + out[:, :4] * scale
            mask = out[:, 4:5]
            del out
            if bi < last or final_warps:
                warped0 = flow_warp_nchw(img0, flow[:, 0:2])
                warped1 = flow_warp_nchw(img1, flow[:, 2:4])
        return flow, mask, warped0, warped1

    def _interpolate(self, i0: torch.Tensor, i1: torch.Tensor, timestep: float):
        _, mask, warped0, warped1 = self.pyramid(i0, i1, timestep)
        m = torch.sigmoid(mask)
        return (warped0 * m + warped1 * (1.0 - m)).clamp(0.0, 1.0)

    def apply(self, img0: torch.Tensor, img1: torch.Tensor,
              timestep: float = 0.5) -> torch.Tensor:
        """The frame at ``timestep`` between img0 and img1, (B,H,W,3) in
        [0, 1], sides multiples of 32."""
        out = self._interpolate(img0.permute(0, 3, 1, 2), img1.permute(0, 3, 1, 2), timestep)
        return out.permute(0, 2, 3, 1)

    @staticmethod
    def _pad32(*imgs: torch.Tensor):
        """NHWC -> NCHW, edge-padded at the bottom and right to multiples
        of 32."""
        h, w = imgs[0].shape[1:3]
        hp, wp = -(-h // 32) * 32, -(-w // 32) * 32
        out = [x.permute(0, 3, 1, 2) for x in imgs]
        if (hp, wp) != (h, w):
            out = [F.pad(x, (0, wp - w, 0, hp - h), mode="replicate") for x in out]
        return out

    def interpolate_padded(self, img0: torch.Tensor, img1: torch.Tensor,
                           timestep: float = 0.5) -> torch.Tensor:
        """``apply`` at any size: pad to multiples of 32, run, crop."""
        h, w = img0.shape[1:3]
        out = self._interpolate(*self._pad32(img0, img1), timestep)
        return out[:, :, :h, :w].permute(0, 2, 3, 1)

    def estimate_flow(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """Flow (B,H,W,2) in pixels on img0's grid sampling into img1
        (``flow_warp(img1, flow) ~ img0``): timestep 0, the pyramid's
        img1 flow (channels 2:4), edge-padded to multiples of 32 and
        cropped back."""
        h, w = img0.shape[1:3]
        i0, i1 = self._pad32(img0, img1)
        flow, _, _, _ = self.pyramid(i0, i1, 0.0, final_warps=False)
        return flow[:, 2:4, :h, :w].permute(0, 2, 3, 1)

    @classmethod
    def from_state_dict(cls, cfg: IFNetConfig, sd, device) -> "IFNet":
        net = cls(cfg)
        net.load_state_dict({k: v.float() for k, v in sd.items()})
        return net.to(device).eval().requires_grad_(False)
