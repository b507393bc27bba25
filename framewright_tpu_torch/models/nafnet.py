"""NAFNet (nonlinear-activation-free denoiser): the port of
``framewright_tpu.models.nafnet`` as an ``nn.Module`` (NCHW inside,
NHWC at ``apply_padded``), f32.

A U-net of NAFBlocks. A block: LayerNorm over channels (eps 1e-6) ->
1x1 conv to 2c -> depthwise 3x3 (groups 2c) -> SimpleGate (the two
channel halves multiplied) -> simplified channel attention (the global
mean, a 1x1 conv, times the map) -> 1x1 conv, added times a learned
``beta``; then LayerNorm -> 1x1 to 2c -> SimpleGate -> 1x1, added times
``gamma``. Downs are 2x2 stride-2 convs, ups 1x1 convs to 2c then
``pixel_shuffle(2)`` (bias-free in the official checkpoints, with a bias
in ``FW_nafnet_dn``: the JAX code adds one when the checkpoint has it),
and the input is added to the output.
State-dict names follow the official NAFNet (``intro``, ``encoders``,
``downs``, ``middle_blks``, ``ups.i.0``, ``decoders``, ``ending``;
``sca.1``, ``norm1.weight``). The temporal denoiser runs the
repository's trained ``FW_nafnet_dn`` (width 16, enc (1, 1, 2), middle
2, dec (1, 1, 1)).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class NAFNetConfig:
    width: int = 32
    in_ch: int = 3
    enc_blocks: Tuple[int, ...] = (2, 2, 4, 8)
    middle_blocks: int = 12
    dec_blocks: Tuple[int, ...] = (2, 2, 2, 2)


def _naf_block_jax_init(key, c: int) -> Dict:
    from framewright_tpu_torch.models.layers import jax_conv_init
    from framewright_tpu_torch.ops import jax_random

    ks = jax_random.split(key, 8)
    dw = ffn = 2 * c

    def norm():
        return {"gamma": np.ones((c,), np.float32), "beta": np.zeros((c,), np.float32)}

    return {
        "norm1": norm(),
        "conv1": jax_conv_init(ks[0], 1, c, dw),
        "conv2": jax_conv_init(ks[1], 3, 1, dw),          # depthwise: HWIO (3, 3, 1, dw)
        "conv3": jax_conv_init(ks[2], 1, dw // 2, c),
        "sca": jax_conv_init(ks[3], 1, dw // 2, dw // 2),
        "norm2": norm(),
        "conv4": jax_conv_init(ks[4], 1, c, ffn),
        "conv5": jax_conv_init(ks[5], 1, ffn // 2, c),
        "beta": np.zeros((1, 1, 1, c), np.float32),
        "gamma": np.zeros((1, 1, 1, c), np.float32),
    }


def jax_init(cfg: NAFNetConfig, seed: int = 0) -> Dict:
    """JAX's ``nafnet.init(PRNGKey(seed), cfg)``: the same tree (HWIO numpy
    f32) and draws."""
    from framewright_tpu_torch.models.layers import jax_conv_init
    from framewright_tpu_torch.ops import jax_random

    n_stages = len(cfg.enc_blocks)
    total = (4 + sum(cfg.enc_blocks) + cfg.middle_blocks + sum(cfg.dec_blocks)
             + 2 * n_stages)
    keys = iter(jax_random.split(seed, total + 4))
    c = cfg.width
    params: Dict = {"intro": jax_conv_init(next(keys), 3, cfg.in_ch, c),
                    "encoders": [], "downs": [], "decoders": [], "ups": []}
    ch = c
    for nb in cfg.enc_blocks:
        params["encoders"].append([_naf_block_jax_init(next(keys), ch) for _ in range(nb)])
        params["downs"].append(jax_conv_init(next(keys), 2, ch, 2 * ch))
        ch *= 2
    params["middles"] = [_naf_block_jax_init(next(keys), ch) for _ in range(cfg.middle_blocks)]
    for nb in cfg.dec_blocks:
        params["ups"].append(jax_conv_init(next(keys), 1, ch, 2 * ch))
        ch //= 2
        params["decoders"].append([_naf_block_jax_init(next(keys), ch) for _ in range(nb)])
    params["ending"] = jax_conv_init(next(keys), 3, c, cfg.in_ch)
    return params


class LayerNorm2d(nn.Module):
    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(1, keepdim=True)
        var = ((x - mu) ** 2).mean(1, keepdim=True)
        return ((x - mu) * torch.rsqrt(var + self.eps) * self.weight[:, None, None]
                + self.bias[:, None, None])


def _simple_gate(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=1)
    return a * b


class NAFBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        dw = 2 * c
        self.norm1 = LayerNorm2d(c)
        self.conv1 = nn.Conv2d(c, dw, 1)
        self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw)
        self.sca = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(c, c, 1))
        self.conv3 = nn.Conv2d(c, c, 1)
        self.norm2 = LayerNorm2d(c)
        self.conv4 = nn.Conv2d(c, 2 * c, 1)
        self.conv5 = nn.Conv2d(c, c, 1)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _simple_gate(self.conv2(self.conv1(self.norm1(x))))
        y = self.conv3(y * self.sca(y))
        x = x + y * self.beta
        y = self.conv5(_simple_gate(self.conv4(self.norm2(x))))
        return x + y * self.gamma


class NAFNet(nn.Module):
    def __init__(self, cfg: NAFNetConfig = NAFNetConfig(), ups_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        c = cfg.width
        self.intro = nn.Conv2d(cfg.in_ch, c, 3, padding=1)
        self.encoders, self.downs = nn.ModuleList(), nn.ModuleList()
        self.ups, self.decoders = nn.ModuleList(), nn.ModuleList()
        for nb in cfg.enc_blocks:
            self.encoders.append(nn.Sequential(*[NAFBlock(c) for _ in range(nb)]))
            self.downs.append(nn.Conv2d(c, 2 * c, 2, 2))
            c *= 2
        self.middle_blks = nn.Sequential(*[NAFBlock(c) for _ in range(cfg.middle_blocks)])
        for nb in cfg.dec_blocks:
            self.ups.append(nn.Sequential(nn.Conv2d(c, 2 * c, 1, bias=ups_bias),
                                          nn.PixelShuffle(2)))
            c //= 2
            self.decoders.append(nn.Sequential(*[NAFBlock(c) for _ in range(nb)]))
        self.ending = nn.Conv2d(cfg.width, cfg.in_ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW x in [0, 1], sides divisible by 2^len(enc_blocks)."""
        y = self.intro(x)
        skips = []
        for enc, down in zip(self.encoders, self.downs):
            y = enc(y)
            skips.append(y)
            y = down(y)
        y = self.middle_blks(y)
        for up, dec, skip in zip(self.ups, self.decoders, reversed(skips)):
            y = dec(up(y) + skip)
        return x + self.ending(y)

    def apply_padded(self, x: torch.Tensor) -> torch.Tensor:
        """Denoise NHWC x (B,H,W,C) at any size: reflect-padded at the
        bottom and right to multiples of 2^len(enc_blocks), then cropped."""
        div = 2 ** len(self.cfg.enc_blocks)
        h, w = x.shape[1:3]
        hp, wp = -(-h // div) * div, -(-w // div) * div
        xc = x.permute(0, 3, 1, 2)
        if (hp, wp) != (h, w):
            xc = F.pad(xc, (0, wp - w, 0, hp - h), mode="reflect")
        return self(xc)[:, :, :h, :w].permute(0, 2, 3, 1)

    @classmethod
    def from_state_dict(cls, cfg: NAFNetConfig, sd, device) -> "NAFNet":
        net = cls(cfg, ups_bias="ups.0.0.bias" in sd)
        net.load_state_dict({k: v.float() for k, v in sd.items()})
        return net.to(device).eval().requires_grad_(False)
