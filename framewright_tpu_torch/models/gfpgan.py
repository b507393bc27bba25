"""GFPGANv1Clean (the architecture of the released GFPGANv1.4): the
port of ``framewright_tpu.models.gfpgan`` as an ``nn.Module`` (NCHW
inside, NHWC at ``apply``), f32.

- a U-Net encoder over the face crop (``conv_body_first``, one
  ``conv_body_down`` ResBlock a halving, ``final_conv``) whose bottom
  gives the latent code (``final_linear``: one latent a decoder layer,
  or one shared latent refined by ``style_mlp`` when the code is
  ``num_style_feat`` wide), and a decoder side (``conv_body_up``) whose
  features give the SFT conditions (``condition_scale``,
  ``condition_shift``) at every resolution;
- a StyleGAN2 decoder (``stylegan_decoder``): modulated convs, the
  weight scaled per sample by the style and demodulated per output
  channel (``modulated_conv``: one grouped ``F.conv2d``, groups = the
  batch), the sqrt(2) gain on the conv output, bias and leaky ReLU 0.2;
  the CS-SFT on half the channels after each upsampling conv; ``to_rgb``
  with the bilinear 2x of the running skip.

Every 2x resize is ``layers.resize_bilinear``'s (the JAX resize;
``F.interpolate`` bilinear with half-pixel centres, no antialias). At
inference there is no noise (the JAX ``apply`` passes none). Parameter
names follow the JAX parameter tree (``conv_body_down.0.conv1.weight``,
``stylegan_decoder.style_convs.3.modulated_conv.weight`` as (out, in,
k, k), ``...modulation.weight`` as a ``Linear``'s); ``registry.
from_jax_params`` maps the JAX tree to them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from framewright_tpu_torch.models.layers import conv_init, resize_bilinear_nchw


@dataclass(frozen=True)
class GFPGANConfig:
    out_size: int = 512
    num_style_feat: int = 512
    channel_multiplier: int = 2
    num_mlp: int = 8
    narrow: float = 1.0
    sft_half: bool = True


def channels(cfg: GFPGANConfig) -> Dict[int, int]:
    n, cm = cfg.narrow, cfg.channel_multiplier
    return {
        4: int(512 * n), 8: int(512 * n), 16: int(512 * n), 32: int(512 * n),
        64: int(256 * cm * n), 128: int(128 * cm * n),
        256: int(64 * cm * n), 512: int(32 * cm * n), 1024: int(16 * cm * n),
    }


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def _half(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear_nchw(x, (x.shape[-2] // 2, x.shape[-1] // 2))


def _double(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear_nchw(x, (x.shape[-2] * 2, x.shape[-1] * 2))


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class _ResBlock(nn.Module):
    """basicsr's clean ResBlock, ``down`` (bilinear x0.5) or up (x2):
    conv1, lrelu, resize, conv2, lrelu, plus the 1x1 ``skip`` of the
    resized input; no sqrt(2) normalization."""

    def __init__(self, cin: int, cout: int, down: bool):
        super().__init__()
        self.down = down
        self.conv1 = _conv(cin, cin, 3)
        self.conv2 = _conv(cin, cout, 3)
        self.skip = _conv(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        resize = _half if self.down else _double
        y = _lrelu(self.conv1(x))
        y = _lrelu(self.conv2(resize(y)))
        return y + self.skip(resize(x))


class _Condition(nn.Module):
    def __init__(self, c: int, cout: int):
        super().__init__()
        self.c1 = _conv(c, c, 3)
        self.c2 = _conv(c, cout, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c2(_lrelu(self.c1(x)))


class ModulatedConv(nn.Module):
    """StyleGAN2's modulated conv: the weight scaled per sample and input
    channel by ``modulation(style)``, then (``demodulate``) by 1 /
    sqrt(sum of its squares + 1e-8) per output channel; one grouped
    conv over the batch."""

    def __init__(self, cin: int, cout: int, k: int, num_style: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.modulation = nn.Linear(num_style, cin)

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                demodulate: bool = True) -> torch.Tensor:
        b, cin, h, w = x.shape
        s = self.modulation(style)                             # (B, cin)
        wt = self.weight[None] * s[:, None, :, None, None]     # (B, cout, cin, k, k)
        if demodulate:
            wt = wt * torch.rsqrt(wt.square().sum((2, 3, 4)) + 1e-8)[:, :, None, None, None]
        cout, k = wt.shape[1], wt.shape[-1]
        y = F.conv2d(x.reshape(1, b * cin, h, w), wt.reshape(b * cout, cin, k, k),
                     padding=k // 2, groups=b)
        return y.view(b, cout, h, w)


class _StyleConv(nn.Module):
    def __init__(self, cin: int, cout: int, num_style: int, upsample: bool):
        super().__init__()
        self.upsample = upsample
        self.modulated_conv = ModulatedConv(cin, cout, 3, num_style)
        self.noise_weight = nn.Parameter(torch.zeros(()))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        if self.upsample:
            x = _double(x)
        # the sqrt(2) gain on the conv output only; no noise at inference
        y = self.modulated_conv(x, style) * math.sqrt(2.0)
        return _lrelu(y + self.bias.view(1, -1, 1, 1))


class _ToRGB(nn.Module):
    def __init__(self, cin: int, num_style: int):
        super().__init__()
        self.modulated_conv = ModulatedConv(cin, 3, 1, num_style)
        self.bias = nn.Parameter(torch.zeros(3))

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.modulated_conv(x, style, demodulate=False) + self.bias.view(1, -1, 1, 1)
        return y if skip is None else y + _double(skip)


class _Decoder(nn.Module):
    def __init__(self, cfg: GFPGANConfig):
        super().__init__()
        ch, nsf = channels(cfg), cfg.num_style_feat
        log_size = int(math.log2(cfg.out_size))
        self.constant_input = nn.Parameter(torch.zeros(1, ch[4], 4, 4))
        self.style_conv1 = _StyleConv(ch[4], ch[4], nsf, False)
        self.to_rgb1 = _ToRGB(ch[4], nsf)
        convs, rgbs, cin = [], [], ch[4]
        for i in range(3, log_size + 1):
            cout = ch[2 ** i]
            convs += [_StyleConv(cin, cout, nsf, True), _StyleConv(cout, cout, nsf, False)]
            rgbs.append(_ToRGB(cout, nsf))
            cin = cout
        self.style_convs = nn.ModuleList(convs)
        self.to_rgbs = nn.ModuleList(rgbs)


class GFPGAN(nn.Module):
    def __init__(self, cfg: GFPGANConfig = GFPGANConfig()):
        super().__init__()
        self.cfg = cfg
        ch, nsf = channels(cfg), cfg.num_style_feat
        log_size = int(math.log2(cfg.out_size))
        enc_res = [2 ** i for i in range(log_size, 2, -1)]          # out_size .. 8
        self.conv_body_first = _conv(3, ch[cfg.out_size], 1)
        self.conv_body_down = nn.ModuleList(_ResBlock(ch[r], ch[r // 2], True)
                                            for r in enc_res)
        self.final_conv = _conv(ch[4], ch[4], 3)
        self.final_linear = nn.Linear(ch[4] * 16, (log_size * 2 - 2) * nsf)
        self.style_mlp = nn.ModuleList(nn.Linear(nsf, nsf) for _ in range(cfg.num_mlp))
        up = list(reversed(enc_res))                                 # 8 .. out_size
        self.conv_body_up = nn.ModuleList(_ResBlock(ch[r // 2], ch[r], False) for r in up)
        sft = [ch[r] // 2 if cfg.sft_half else ch[r] for r in up]
        self.condition_scale = nn.ModuleList(_Condition(ch[r], s) for r, s in zip(up, sft))
        self.condition_shift = nn.ModuleList(_Condition(ch[r], s) for r, s in zip(up, sft))
        # in the released checkpoints; the clean forward does not read them
        self.toRGB = nn.ModuleList(_conv(ch[r], 3, 1) for r in up)
        self.stylegan_decoder = _Decoder(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, S, S) in [-1, 1] -> (B, 3, S, S), the raw RGB sum."""
        cfg = self.cfg
        b = x.shape[0]
        num_latent = int(math.log2(cfg.out_size)) * 2 - 2
        feat = _lrelu(self.conv_body_first(x))
        unet_skips: List[torch.Tensor] = []
        for blk in self.conv_body_down:
            feat = blk(feat)
            unet_skips.insert(0, feat)
        feat = _lrelu(self.final_conv(feat))
        code = self.final_linear(feat.reshape(b, -1))        # NCHW flattened, as torch
        conditions: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for i, blk in enumerate(self.conv_body_up):
            feat = blk(feat + unet_skips[i])
            conditions.append((self.condition_scale[i](feat), self.condition_shift[i](feat)))
        if code.shape[-1] == cfg.num_style_feat:
            style = code              # one latent, refined and shared by every layer
            for mlp in self.style_mlp:
                style = _lrelu(mlp(style))
            latent = style[:, None, :].expand(b, num_latent, cfg.num_style_feat)
        else:
            latent = code.reshape(b, num_latent, cfg.num_style_feat)
        sg = self.stylegan_decoder
        out = sg.constant_input.expand(b, -1, -1, -1)
        out = sg.style_conv1(out, latent[:, 0])
        skip = sg.to_rgb1(out, latent[:, 1])
        li = 1
        for i, to_rgb in enumerate(sg.to_rgbs):
            out = sg.style_convs[2 * i](out, latent[:, li])
            if i < len(conditions):
                scale, shift = conditions[i]
                if cfg.sft_half:      # the raw scale, on the second half
                    half = out.shape[1] // 2
                    out = torch.cat([out[:, :half], out[:, half:] * scale + shift], 1)
                else:
                    out = out * scale + shift
            out = sg.style_convs[2 * i + 1](out, latent[:, li + 1])
            skip = to_rgb(out, latent[:, li + 2], skip)
            li += 2
        return skip

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``gfpgan.apply``: (B, S, S, 3) in [-1, 1] -> the same shape."""
        return self(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    @classmethod
    def from_state_dict(cls, cfg: GFPGANConfig, sd: Dict[str, torch.Tensor],
                        device) -> "GFPGAN":
        with torch.device("meta"):
            net = cls(cfg)
        net.load_state_dict({k: v.float() for k, v in sd.items()}, assign=True)
        return net.to(device).eval().requires_grad_(False)


def config_from_params(params: Dict) -> GFPGANConfig:
    """The ``GFPGANConfig`` a JAX parameter tree was drawn or ported at,
    read from its shapes (the released checkpoint: ``GFPGANConfig()``;
    the JAX face restorer's 64-pixel stand-in: ``out_size=64,
    num_style_feat=64, channel_multiplier=1, num_mlp=2, narrow=0.25``)."""
    log_size = len(params["conv_body_down"]) + 2
    sg = params["stylegan_decoder"]
    narrow = np.asarray(sg["constant_input"]).shape[-1] / 512
    up = params["conv_body_up"]               # resolutions 8 .. out_size
    ch64 = np.asarray(up[3]["conv2"]["w"]).shape[-1]
    ch8 = np.asarray(up[0]["conv2"]["w"]).shape[-1]
    sft8 = np.asarray(params["condition_scale"][0]["c2"]["w"]).shape[-1]
    return GFPGANConfig(
        out_size=2 ** log_size,
        num_style_feat=np.asarray(sg["style_conv1"]["modulated_conv"]["modulation"]["w"]).shape[0],
        channel_multiplier=round(ch64 / (256 * narrow)), num_mlp=len(params["style_mlp"]),
        narrow=narrow, sft_half=sft8 != ch8)


def init_params(cfg: GFPGANConfig = GFPGANConfig(), seed: int = 0) -> Dict:
    """Seeded random parameters in the JAX module's tree (HWIO numpy
    arrays) at ``cfg``'s widths, drawn with numpy in the shapes and
    scales of ``gfpgan.init``. For smoke runs and benchmarks; a restore
    never draws a face model."""
    rng = np.random.default_rng(seed)
    ch, nsf = channels(cfg), cfg.num_style_feat
    log_size = int(math.log2(cfg.out_size))
    enc_res = [2 ** i for i in range(log_size, 2, -1)]

    def linear(din, dout):
        lim = 1.0 / math.sqrt(din)
        return {"w": rng.uniform(-lim, lim, (din, dout)).astype(np.float32),
                "b": rng.uniform(-lim, lim, (dout,)).astype(np.float32)}

    def modconv(cin, cout, k):
        return {"weight": (rng.standard_normal((k, k, cin, cout)) / math.sqrt(cin * k * k)
                           ).astype(np.float32), "modulation": linear(nsf, cin)}

    def style_conv(cin, cout):
        return {"modulated_conv": modconv(cin, cout, 3),
                "noise_weight": np.zeros((), np.float32), "bias": np.zeros((cout,), np.float32)}

    def to_rgb(cin):
        return {"modulated_conv": modconv(cin, 3, 1), "bias": np.zeros((3,), np.float32)}

    def res(cin, cout):
        return {"conv1": conv_init(rng, 3, cin, cin), "conv2": conv_init(rng, 3, cin, cout),
                "skip": conv_init(rng, 1, cin, cout)}

    up = list(reversed(enc_res))
    sft = [ch[r] // 2 if cfg.sft_half else ch[r] for r in up]
    p: Dict = {
        "conv_body_first": conv_init(rng, 1, 3, ch[cfg.out_size]),
        "conv_body_down": [res(ch[r], ch[r // 2]) for r in enc_res],
        "final_conv": conv_init(rng, 3, ch[4], ch[4]),
        "final_linear": linear(ch[4] * 16, (log_size * 2 - 2) * nsf),
        "style_mlp": [linear(nsf, nsf) for _ in range(cfg.num_mlp)],
        "conv_body_up": [res(ch[r // 2], ch[r]) for r in up],
        "condition_scale": [{"c1": conv_init(rng, 3, ch[r], ch[r]),
                             "c2": conv_init(rng, 3, ch[r], s)} for r, s in zip(up, sft)],
        "condition_shift": [{"c1": conv_init(rng, 3, ch[r], ch[r]),
                             "c2": conv_init(rng, 3, ch[r], s)} for r, s in zip(up, sft)],
        "toRGB": [conv_init(rng, 1, ch[r], 3) for r in up],
    }
    convs, rgbs, cin = [], [], ch[4]
    for i in range(3, log_size + 1):
        cout = ch[2 ** i]
        convs += [style_conv(cin, cout), style_conv(cout, cout)]
        rgbs.append(to_rgb(cout))
        cin = cout
    p["stylegan_decoder"] = {
        "constant_input": rng.standard_normal((1, 4, 4, ch[4])).astype(np.float32),
        "style_conv1": style_conv(ch[4], ch[4]), "to_rgb1": to_rgb(ch[4]),
        "style_convs": convs, "to_rgbs": rgbs}
    return p


def port_state_dict(sd) -> Dict:
    """basicsr's GFPGANv1Clean state dict (a released ``GFPGANv1.4.pth``)
    -> the JAX ``gfpgan`` tree (numpy, dtypes kept): the port's copy of
    ``framewright_tpu.models.torch_port.port_gfpgan``. A ResBlock skip
    without a bias gets zeros; the style MLP's Linears are read at any of
    the indices 0-31 (released files start at 1, after NormStyleCode)."""
    from framewright_tpu_torch.models.layers import np_leaf, port_conv

    def lin(prefix):
        return {"w": np_leaf(sd[prefix + ".weight"]).T, "b": np_leaf(sd[prefix + ".bias"])}

    def conv_nb(prefix):
        w = np_leaf(sd[prefix + ".weight"])
        return {"w": np.transpose(w, (2, 3, 1, 0)), "b": np.zeros(w.shape[0], w.dtype)}

    def modconv(prefix):
        w = np_leaf(sd[prefix + ".weight"])              # (1, cout, cin, k, k)
        return {"weight": np.transpose(w[0], (2, 3, 1, 0)),
                "modulation": lin(prefix + ".modulation")}

    def styleconv(prefix):
        return {"modulated_conv": modconv(prefix + ".modulated_conv"),
                "noise_weight": np_leaf(sd[prefix + ".weight"]).reshape(()),
                "bias": np_leaf(sd[prefix + ".bias"]).reshape(-1)}

    def torgb(prefix):
        return {"modulated_conv": modconv(prefix + ".modulated_conv"),
                "bias": np_leaf(sd[prefix + ".bias"]).reshape(-1)}

    def resblock(prefix):
        skip = (conv_nb(f"{prefix}.skip") if f"{prefix}.skip.bias" not in sd
                else port_conv(sd, f"{prefix}.skip"))
        return {"conv1": port_conv(sd, f"{prefix}.conv1"),
                "conv2": port_conv(sd, f"{prefix}.conv2"), "skip": skip}

    out: Dict = {"conv_body_first": port_conv(sd, "conv_body_first"),
                 "final_conv": port_conv(sd, "final_conv"), "final_linear": lin("final_linear"),
                 "conv_body_down": [], "conv_body_up": [], "condition_scale": [],
                 "condition_shift": [], "toRGB": [], "style_mlp": []}
    i = 0
    while f"conv_body_down.{i}.conv1.weight" in sd:
        out["conv_body_down"].append(resblock(f"conv_body_down.{i}"))
        i += 1
    i = 0
    while f"conv_body_up.{i}.conv1.weight" in sd:
        out["conv_body_up"].append(resblock(f"conv_body_up.{i}"))
        for kind in ("scale", "shift"):             # Sequential(conv, lrelu, conv)
            out[f"condition_{kind}"].append({"c1": port_conv(sd, f"condition_{kind}.{i}.0"),
                                             "c2": port_conv(sd, f"condition_{kind}.{i}.2")})
        out["toRGB"].append(port_conv(sd, f"toRGB.{i}"))
        i += 1
    out["style_mlp"] = [lin(f"stylegan_decoder.style_mlp.{i}") for i in range(32)
                        if f"stylegan_decoder.style_mlp.{i}.weight" in sd]
    sg = {"constant_input": np.transpose(
              np_leaf(sd["stylegan_decoder.constant_input.weight"]), (0, 2, 3, 1)),
          "style_conv1": styleconv("stylegan_decoder.style_conv1"),
          "to_rgb1": torgb("stylegan_decoder.to_rgb1"), "style_convs": [], "to_rgbs": []}
    i = 0
    while f"stylegan_decoder.style_convs.{i}.modulated_conv.weight" in sd:
        sg["style_convs"].append(styleconv(f"stylegan_decoder.style_convs.{i}"))
        i += 1
    i = 0
    while f"stylegan_decoder.to_rgbs.{i}.modulated_conv.weight" in sd:
        sg["to_rgbs"].append(torgb(f"stylegan_decoder.to_rgbs.{i}"))
        i += 1
    out["stylegan_decoder"] = sg
    return out
