"""Upstream-layout PyTorch references for ``models verify``.

The port's copy of the reference constructors that
``framewright_tpu/models/torch_ref.py`` holds a checkpoint against
(``build_rrdbnet``, ``build_srvgg``, ``build_hat``, ``build_nafnet``,
``build_restormer`` and ``build_lama``: independent statements of the
published Real-ESRGAN RRDBNet, SRVGGNetCompact, HAT, NAFNet, Restormer
and LaMa's FFCResNetGenerator, whose state-dict keys are the released
checkpoints'), with the inputs ``torch_ref.parity_check`` feeds them, and
``parity_check``: the same ``.pth`` loaded into the reference
(``strict=False``; a missing key raises) and, through
``registry.port_checkpoint``, into the port's own model, both forwards in
f32 with TF32 off (``hw.full_f32``) on one device, compared by PSNR (peak
1) and max |diff|. The port's forward is the plain f32 one: RRDB's and
SRVGG's ``apply`` (JAX's ``rrdb.apply`` and ``srvgg.apply``), HAT's
``hat.apply``, NAFNet's ``apply_padded`` and Restormer's
``restormer.apply_padded`` (at the widths of the ported tree) on the
ported checkpoint; LaMa's ``build_lama`` at the file's widths
(``lama.infer_arch``) against ``lama.apply_padded`` on JAX's masked frame.

``seeded_state_dict`` draws a checkpoint as the upstream projects
initialise their nets (basicsr's ``default_init_weights``: Kaiming-normal
scaled by 0.1 with zero biases in every RDB, PyTorch's default init for
the other convs and LaMa's transposed convs (its BatchNorms at their
identity statistics), PReLU 0.25; HAT's truncated normal (std 0.02) linears
and position-bias tables, unit LayerNorms; NAFNet's layer scales, zeros
upstream, drawn N(0, 0.01) as ``torch_ref.build_nafnet`` draws them, so
that its blocks are not the identity), from a seeded
``torch.Generator``, so that the outputs stay near [0, 1] as a trained
net's do and the 45 dB gate reads the port's error, not the output's
range.
"""

from __future__ import annotations

import dataclasses
import math
import re
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

PARITY_SIZE = (64, 96)      # torch_ref.parity_check's frame
PARITY_GATE_DB = 45.0       # framewright_tpu/cli.py's gate
# the port's family names -> JAX's registry's (the skip line names JAX's)
JAX_FAMILY = {"basicvsr": "vsr", "tvsr": "vsr", "codeformer": "face"}


def load_state_dict(path: Path) -> Dict[str, np.ndarray]:
    """A ``.pth`` as JAX's ``torch_port.load_state_dict`` reads it
    (``registry._torch_load``), every value a numpy array (floats f32)."""
    from framewright_tpu_torch.models.registry import _torch_load

    return {k: (v.detach().cpu().float().numpy() if v.is_floating_point()
                else v.detach().cpu().numpy()) if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in _torch_load(Path(path)).items()}


def infer_rrdb_blocks(sd: Mapping[str, Any]) -> int:
    idx = [int(m.group(1)) for k in sd for m in [re.match(r"body\.(\d+)\.rdb1", k)] if m]
    return max(idx) + 1 if idx else 0


def infer_srvgg_convs(sd: Mapping[str, Any]) -> int:
    idx = [int(m.group(1)) for k in sd for m in [re.match(r"body\.(\d+)\.weight", k)] if m]
    return (max(idx) - 2) // 2 if idx else 0


def build_rrdbnet(scale: int = 4, nb: int = 23):
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    class RDB(nn.Module):
        def __init__(self, nf=64, gc=32):
            super().__init__()
            self.conv1 = nn.Conv2d(nf, gc, 3, 1, 1)
            self.conv2 = nn.Conv2d(nf + gc, gc, 3, 1, 1)
            self.conv3 = nn.Conv2d(nf + 2 * gc, gc, 3, 1, 1)
            self.conv4 = nn.Conv2d(nf + 3 * gc, gc, 3, 1, 1)
            self.conv5 = nn.Conv2d(nf + 4 * gc, nf, 3, 1, 1)
            self.act = nn.LeakyReLU(0.2, inplace=False)

        def forward(self, x):
            x1 = self.act(self.conv1(x))
            x2 = self.act(self.conv2(torch.cat([x, x1], 1)))
            x3 = self.act(self.conv3(torch.cat([x, x1, x2], 1)))
            x4 = self.act(self.conv4(torch.cat([x, x1, x2, x3], 1)))
            x5 = self.conv5(torch.cat([x, x1, x2, x3, x4], 1))
            return x5 * 0.2 + x

    class RRDB(nn.Module):
        def __init__(self, nf=64, gc=32):
            super().__init__()
            self.rdb1, self.rdb2, self.rdb3 = RDB(nf, gc), RDB(nf, gc), RDB(nf, gc)

        def forward(self, x):
            return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x

    def pixel_unshuffle(x, s):
        b, c, hh, hw = x.size()
        h, w = hh // s, hw // s
        return (x.view(b, c, h, s, w, s).permute(0, 1, 3, 5, 2, 4)
                .reshape(b, c * s * s, h, w))

    class RRDBNet(nn.Module):
        def __init__(self, num_in_ch=3, num_out_ch=3, nf=64, gc=32):
            super().__init__()
            self.scale = scale
            in_ch = num_in_ch * (4 if scale == 2 else 16 if scale == 1 else 1)
            self.conv_first = nn.Conv2d(in_ch, nf, 3, 1, 1)
            self.body = nn.Sequential(*[RRDB(nf, gc) for _ in range(nb)])
            self.conv_body = nn.Conv2d(nf, nf, 3, 1, 1)
            self.conv_up1 = nn.Conv2d(nf, nf, 3, 1, 1)
            self.conv_up2 = nn.Conv2d(nf, nf, 3, 1, 1)
            self.conv_hr = nn.Conv2d(nf, nf, 3, 1, 1)
            self.conv_last = nn.Conv2d(nf, num_out_ch, 3, 1, 1)
            self.act = nn.LeakyReLU(0.2, inplace=False)

        def forward(self, x):
            if self.scale == 2:
                feat = pixel_unshuffle(x, 2)
            elif self.scale == 1:
                feat = pixel_unshuffle(x, 4)
            else:
                feat = x
            feat = self.conv_first(feat)
            feat = feat + self.conv_body(self.body(feat))
            feat = self.act(self.conv_up1(
                F.interpolate(feat, scale_factor=2, mode="nearest")))
            feat = self.act(self.conv_up2(
                F.interpolate(feat, scale_factor=2, mode="nearest")))
            return self.conv_last(self.act(self.conv_hr(feat)))

    # state_dict keys must match basicsr: body.N.rdbM.convK
    return RRDBNet()


def build_srvgg(num_conv: int = 32, upscale: int = 4):
    import torch.nn as nn
    import torch.nn.functional as F

    class SRVGG(nn.Module):
        def __init__(self, num_in_ch=3, num_out_ch=3, nf=64):
            super().__init__()
            self.upscale = upscale
            self.body = nn.ModuleList()
            self.body.append(nn.Conv2d(num_in_ch, nf, 3, 1, 1))
            self.body.append(nn.PReLU(num_parameters=nf))
            for _ in range(num_conv):
                self.body.append(nn.Conv2d(nf, nf, 3, 1, 1))
                self.body.append(nn.PReLU(num_parameters=nf))
            self.body.append(
                nn.Conv2d(nf, num_out_ch * upscale * upscale, 3, 1, 1))
            self.upsampler = nn.PixelShuffle(upscale)

        def forward(self, x):
            out = x
            for m in self.body:
                out = m(out)
            out = self.upsampler(out)
            return out + F.interpolate(
                x, scale_factor=self.upscale, mode="nearest")

    return SRVGG()


def build_hat(embed: int = 180, depths=(6,) * 6, heads: int = 6,
              window: int = 16, overlap: float = 0.5, mlp_ratio: float = 2.0,
              compress: int = 3, squeeze: int = 30, scale: int = 4,
              img_range: float = 1.0):
    """Official HAT (Chen et al., CVPR, 2023; XPixelGroup/HAT hat_arch.py;
    reference processors/hat_upscaler.py:120 loads these checkpoints):
    full model — conv_first, patch_embed LayerNorm, RHAG groups (HAB
    blocks + OCAB + conv), final norm, conv_after_body residual,
    pixelshuffle upsampler, rgb-mean/img_range wrapper. State-dict keys
    match the released HAT_SRx4.pth layout (the manifest)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    win = window
    kv_win = int(win * (1 + overlap))
    hidden = int(embed * mlp_ratio)
    head_dim = embed // heads

    def win_part(x, w):
        b, h, ww, c = x.shape
        x = x.view(b, h // w, w, ww // w, w, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)

    def win_merge(x, w, b, h, ww):
        c = x.shape[-1]
        x = x.view(b, h // w, ww // w, w, w, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, c)

    def rpi_sa():
        coords = torch.stack(torch.meshgrid(
            torch.arange(win), torch.arange(win), indexing="ij")).flatten(1)
        rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
        rel = rel + win - 1
        return rel[:, :, 0] * (2 * win - 1) + rel[:, :, 1]

    def rpi_oca():
        cq = torch.stack(torch.meshgrid(
            torch.arange(win), torch.arange(win), indexing="ij")).flatten(1)
        ck = torch.stack(torch.meshgrid(
            torch.arange(kv_win), torch.arange(kv_win),
            indexing="ij")).flatten(1)
        rel = (cq[:, :, None] - ck[:, None, :]).permute(1, 2, 0) + kv_win - 1
        return rel[:, :, 0] * (win + kv_win - 1) + rel[:, :, 1]

    class ChannelAttention(nn.Module):
        def __init__(self):
            super().__init__()
            self.attention = nn.Sequential(
                nn.AdaptiveAvgPool2d(1),
                nn.Conv2d(embed, embed // squeeze, 1), nn.ReLU(True),
                nn.Conv2d(embed // squeeze, embed, 1), nn.Sigmoid())

        def forward(self, x):
            return x * self.attention(x)

    class CAB(nn.Module):
        def __init__(self):
            super().__init__()
            self.cab = nn.Sequential(
                nn.Conv2d(embed, embed // compress, 3, 1, 1), nn.GELU(),
                nn.Conv2d(embed // compress, embed, 3, 1, 1),
                ChannelAttention())

        def forward(self, x):
            return self.cab(x)

    class WindowAttention(nn.Module):
        def __init__(self):
            super().__init__()
            self.qkv = nn.Linear(embed, embed * 3)
            self.proj = nn.Linear(embed, embed)
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros((2 * win - 1) ** 2, heads))

        def forward(self, x, rpi, mask=None):
            b_, n, c = x.shape
            qkv = self.qkv(x).reshape(b_, n, 3, heads, head_dim) \
                .permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
            q = q * head_dim ** -0.5
            attn = q @ k.transpose(-2, -1)
            bias = self.relative_position_bias_table[rpi.view(-1)] \
                .view(n, n, -1).permute(2, 0, 1)
            attn = attn + bias.unsqueeze(0)
            if mask is not None:
                nw = mask.shape[0]
                attn = attn.view(b_ // nw, nw, heads, n, n) \
                    + mask.unsqueeze(1).unsqueeze(0)
                attn = attn.view(-1, heads, n, n)
            attn = torch.softmax(attn, dim=-1)
            x = (attn @ v).transpose(1, 2).reshape(b_, n, c)
            return self.proj(x)

    class Mlp(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(embed, hidden)
            self.fc2 = nn.Linear(hidden, embed)

        def forward(self, x):
            return self.fc2(F.gelu(self.fc1(x)))

    class HAB(nn.Module):
        def __init__(self, shift):
            super().__init__()
            self.shift = shift
            self.norm1 = nn.LayerNorm(embed)
            self.attn = WindowAttention()
            self.conv_block = CAB()
            self.norm2 = nn.LayerNorm(embed)
            self.mlp = Mlp()

        def forward(self, x, x_size, rpi, mask):
            h, w = x_size
            b, _, c = x.shape
            shortcut = x
            x = self.norm1(x).view(b, h, w, c)
            conv_x = self.conv_block(x.permute(0, 3, 1, 2))
            conv_x = conv_x.permute(0, 2, 3, 1).reshape(b, h * w, c)
            if self.shift:
                sx = torch.roll(x, (-self.shift, -self.shift), dims=(1, 2))
                m = mask
            else:
                sx, m = x, None
            tok = win_part(sx, win)
            att = self.attn(tok, rpi, m)
            att = win_merge(att, win, b, h, w)
            if self.shift:
                att = torch.roll(att, (self.shift, self.shift), dims=(1, 2))
            att = att.reshape(b, h * w, c)
            x = shortcut + att + conv_x * 0.01
            return x + self.mlp(self.norm2(x))

    class OCAB(nn.Module):
        def __init__(self):
            super().__init__()
            self.norm1 = nn.LayerNorm(embed)
            self.qkv = nn.Linear(embed, embed * 3)
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros((win + kv_win - 1) ** 2, heads))
            self.proj = nn.Linear(embed, embed)
            self.norm2 = nn.LayerNorm(embed)
            self.mlp = Mlp()
            self.unfold = nn.Unfold(kernel_size=(kv_win, kv_win),
                                    stride=win, padding=(kv_win - win) // 2)

        def forward(self, x, x_size, rpi):
            h, w = x_size
            b, _, c = x.shape
            shortcut = x
            x = self.norm1(x).view(b, h, w, c)
            qkv = self.qkv(x).reshape(b, h, w, 3, c).permute(3, 0, 4, 1, 2)
            q = qkv[0].permute(0, 2, 3, 1)                 # (b, h, w, c)
            kv = torch.cat([qkv[1], qkv[2]], dim=1)        # (b, 2c, h, w)
            q_tok = win_part(q, win)                       # (nw*b, win², c)
            kv_tok = self.unfold(kv)                       # (b, 2c·kv², nW)
            kv_tok = kv_tok.view(
                b, 2 * c, kv_win * kv_win, -1).permute(0, 3, 2, 1)
            kv_tok = kv_tok.reshape(-1, kv_win * kv_win, 2 * c)
            k_tok, v_tok = kv_tok[:, :, :c], kv_tok[:, :, c:]

            b_, nq, _ = q_tok.shape
            qh = q_tok.reshape(b_, nq, heads, head_dim).permute(0, 2, 1, 3)
            kh = k_tok.reshape(b_, -1, heads, head_dim).permute(0, 2, 1, 3)
            vh = v_tok.reshape(b_, -1, heads, head_dim).permute(0, 2, 1, 3)
            qh = qh * head_dim ** -0.5
            attn = qh @ kh.transpose(-2, -1)
            bias = self.relative_position_bias_table[rpi.view(-1)] \
                .view(nq, kv_win * kv_win, -1).permute(2, 0, 1)
            attn = torch.softmax(attn + bias.unsqueeze(0), dim=-1)
            out = (attn @ vh).transpose(1, 2).reshape(b_, nq, c)
            out = win_merge(self.proj(out), win, b, h, w).reshape(b, h * w, c)
            x = shortcut + out
            return x + self.mlp(self.norm2(x))

    class AttenBlocks(nn.Module):
        def __init__(self, depth):
            super().__init__()
            self.blocks = nn.ModuleList(
                [HAB(0 if i % 2 == 0 else win // 2) for i in range(depth)])
            self.overlap_attn = OCAB()

        def forward(self, x, x_size, params):
            for blk in self.blocks:
                x = blk(x, x_size, params["rpi_sa"], params["attn_mask"])
            return self.overlap_attn(x, x_size, params["rpi_oca"])

    class RHAG(nn.Module):
        def __init__(self, depth):
            super().__init__()
            self.residual_group = AttenBlocks(depth)
            self.conv = nn.Conv2d(embed, embed, 3, 1, 1)

        def forward(self, x, x_size, params):
            h, w = x_size
            y = self.residual_group(x, x_size, params)
            b, _, c = y.shape
            y = y.transpose(1, 2).view(b, c, h, w)
            y = self.conv(y).flatten(2).transpose(1, 2)
            return y + x

    class HAT(nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer(
                "mean",
                torch.tensor([0.4488, 0.4371, 0.4040]).view(1, 3, 1, 1),
                persistent=False)
            self.conv_first = nn.Conv2d(3, embed, 3, 1, 1)
            self.patch_embed = nn.Module()
            self.patch_embed.norm = nn.LayerNorm(embed)
            self.layers = nn.ModuleList([RHAG(d) for d in depths])
            self.norm = nn.LayerNorm(embed)
            self.conv_after_body = nn.Conv2d(embed, embed, 3, 1, 1)
            self.conv_before_upsample = nn.Sequential(
                nn.Conv2d(embed, 64, 3, 1, 1), nn.LeakyReLU(inplace=True))
            ups = []
            for _ in range(scale // 2):
                ups += [nn.Conv2d(64, 256, 3, 1, 1), nn.PixelShuffle(2)]
            self.upsample = nn.Sequential(*ups)
            self.conv_last = nn.Conv2d(64, 3, 3, 1, 1)
            self.register_buffer("rpi_sa_buf", rpi_sa(), persistent=False)
            self.register_buffer("rpi_oca_buf", rpi_oca(), persistent=False)

        def calculate_mask(self, x_size):
            h, w = x_size
            shift = win // 2
            img = torch.zeros(1, h, w, 1)
            cnt = 0
            for hs in (slice(0, -win), slice(-win, -shift),
                       slice(-shift, None)):
                for ws in (slice(0, -win), slice(-win, -shift),
                           slice(-shift, None)):
                    img[:, hs, ws, :] = cnt
                    cnt += 1
            tok = win_part(img, win).view(-1, win * win)
            diff = tok.unsqueeze(1) - tok.unsqueeze(2)
            return diff.masked_fill(diff != 0, -100.0) \
                .masked_fill(diff == 0, 0.0)

        def forward(self, x):
            h0, w0 = x.shape[2:]
            x = (x - self.mean) * img_range
            ph, pw = (-h0) % win, (-w0) % win
            if ph or pw:
                x = F.pad(x, (0, pw, 0, ph), mode="reflect")
            h, w = x.shape[2:]
            params = {
                "attn_mask": self.calculate_mask((h, w)).to(x.device),
                "rpi_sa": self.rpi_sa_buf,
                "rpi_oca": self.rpi_oca_buf,
            }
            feat = self.conv_first(x)
            b, c = feat.shape[0], feat.shape[1]
            tok = self.patch_embed.norm(feat.flatten(2).transpose(1, 2))
            for layer in self.layers:
                tok = layer(tok, (h, w), params)
            tok = self.norm(tok)
            body = tok.transpose(1, 2).view(b, c, h, w)
            feat = feat + self.conv_after_body(body)
            y = self.conv_before_upsample(feat)
            y = self.conv_last(self.upsample(y))
            y = y / img_range + self.mean
            return y[:, :, : h0 * scale, : w0 * scale]

    return HAT()


def build_nafnet(width: int = 32, enc_blocks=(2, 2, 4, 8),
                 middle_blocks: int = 12, dec_blocks=(2, 2, 2, 2),
                 in_ch: int = 3):
    """Official NAFNet (megvii-research, ECCV22 "Simple Baselines")
    re-statement for full-model parity: LayerNorm2d NAFBlocks,
    conv2x2-stride2 downs, conv1x1+PixelShuffle ups with encoder skip
    adds, global input residual. State-dict keys mirror the official
    module names (intro/encoders/downs/middle_blks/ups/decoders/ending,
    sca as Sequential -> `sca.1`) so `torch_port.port_nafnet` doubles
    as the real-weight port. Ref capability slot: reference
    tap_denoise.py:156 (pretrained NAFNet backend)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    class LayerNorm2d(nn.Module):
        def __init__(self, c):
            super().__init__()
            self.weight = nn.Parameter(torch.ones(c))
            self.bias = nn.Parameter(torch.zeros(c))

        def forward(self, x):
            y = x.permute(0, 2, 3, 1)
            # official megvii LayerNorm2d (and nafnet._ln) use eps=1e-6
            y = F.layer_norm(y, y.shape[-1:], self.weight, self.bias,
                             eps=1e-6)
            return y.permute(0, 3, 1, 2)

    class NAFBlock(nn.Module):
        def __init__(self, c):
            super().__init__()
            dw = 2 * c
            ffn = 2 * c
            self.norm1 = LayerNorm2d(c)
            self.conv1 = nn.Conv2d(c, dw, 1)
            self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw)
            self.conv3 = nn.Conv2d(dw // 2, c, 1)
            self.sca = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                     nn.Conv2d(dw // 2, dw // 2, 1))
            self.norm2 = LayerNorm2d(c)
            self.conv4 = nn.Conv2d(c, ffn, 1)
            self.conv5 = nn.Conv2d(ffn // 2, c, 1)
            self.beta = nn.Parameter(torch.randn(1, c, 1, 1) * 0.1)
            self.gamma = nn.Parameter(torch.randn(1, c, 1, 1) * 0.1)

        @staticmethod
        def _sg(t):
            a, b = t.chunk(2, dim=1)
            return a * b

        def forward(self, x):
            y = self.conv2(self.conv1(self.norm1(x)))
            y = self._sg(y)
            y = y * self.sca(y)
            y = self.conv3(y)
            x = x + y * self.beta
            y = self.conv5(self._sg(self.conv4(self.norm2(x))))
            return x + y * self.gamma

    class NAFNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.intro = nn.Conv2d(in_ch, width, 3, padding=1)
            self.encoders = nn.ModuleList()
            self.downs = nn.ModuleList()
            ch = width
            for nb in enc_blocks:
                self.encoders.append(
                    nn.Sequential(*[NAFBlock(ch) for _ in range(nb)]))
                self.downs.append(nn.Conv2d(ch, 2 * ch, 2, stride=2))
                ch *= 2
            self.middle_blks = nn.Sequential(
                *[NAFBlock(ch) for _ in range(middle_blocks)])
            self.ups = nn.ModuleList()
            self.decoders = nn.ModuleList()
            for nb in dec_blocks:
                self.ups.append(nn.Sequential(
                    nn.Conv2d(ch, 2 * ch, 1, bias=False),
                    nn.PixelShuffle(2)))
                ch //= 2
                self.decoders.append(
                    nn.Sequential(*[NAFBlock(ch) for _ in range(nb)]))
            self.ending = nn.Conv2d(width, in_ch, 3, padding=1)

        def forward(self, x):
            inp = x
            y = self.intro(x)
            skips = []
            for enc, down in zip(self.encoders, self.downs):
                y = enc(y)
                skips.append(y)
                y = down(y)
            y = self.middle_blks(y)
            for up, dec, skip in zip(self.ups, self.decoders,
                                     reversed(skips)):
                y = up(y)
                y = y + skip
                y = dec(y)
            return inp + self.ending(y)

    return NAFNet()


def build_restormer(dim: int = 48, num_blocks=(4, 6, 6, 8),
                    heads=(1, 2, 4, 8), num_refinement: int = 4,
                    ffn_expansion: float = 2.66, in_ch: int = 3):
    """Official Restormer (swz30, CVPR22) re-statement for full-model
    parity: bias-free convs/LayerNorm, MDTA channel attention, GDFN,
    PixelUnshuffle downs / PixelShuffle ups, reduce_chan convs at
    levels 3/2 only, refinement at 2*dim. State-dict keys mirror the
    official module names so `torch_port.port_restormer` doubles as
    the real-weight port. Ref slot: reference tap_denoise.py:156."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    class _LNBody(nn.Module):
        def __init__(self, c):
            super().__init__()
            self.weight = nn.Parameter(torch.ones(c))

        def forward(self, x):  # x: (B, HW, C)
            sigma = x.var(-1, keepdim=True, unbiased=False)
            return x / torch.sqrt(sigma + 1e-5) * self.weight

    class LayerNorm(nn.Module):
        def __init__(self, c):
            super().__init__()
            self.body = _LNBody(c)

        def forward(self, x):  # (B, C, H, W)
            b, c, h, w = x.shape
            y = x.flatten(2).transpose(1, 2)        # to_3d
            y = self.body(y)
            return y.transpose(1, 2).reshape(b, c, h, w)

    class Attention(nn.Module):
        def __init__(self, c, nheads):
            super().__init__()
            self.num_heads = nheads
            self.temperature = nn.Parameter(torch.ones(nheads, 1, 1))
            self.qkv = nn.Conv2d(c, c * 3, 1, bias=False)
            self.qkv_dwconv = nn.Conv2d(c * 3, c * 3, 3, padding=1,
                                        groups=c * 3, bias=False)
            self.project_out = nn.Conv2d(c, c, 1, bias=False)

        def forward(self, x):
            b, c, h, w = x.shape
            qkv = self.qkv_dwconv(self.qkv(x))
            q, k, v = qkv.chunk(3, dim=1)
            hd = c // self.num_heads

            def rs(t):  # b (head c) h w -> b head c (h w)
                return t.reshape(b, self.num_heads, hd, h * w)

            q, k, v = rs(q), rs(k), rs(v)
            q = F.normalize(q, dim=-1)
            k = F.normalize(k, dim=-1)
            att = (q @ k.transpose(-2, -1)) * self.temperature
            att = att.softmax(dim=-1)
            out = (att @ v).reshape(b, c, h, w)
            return self.project_out(out)

    class FeedForward(nn.Module):
        def __init__(self, c, exp):
            super().__init__()
            hidden = int(c * exp)
            self.project_in = nn.Conv2d(c, hidden * 2, 1, bias=False)
            self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, padding=1,
                                    groups=hidden * 2, bias=False)
            self.project_out = nn.Conv2d(hidden, c, 1, bias=False)

        def forward(self, x):
            a, g = self.dwconv(self.project_in(x)).chunk(2, dim=1)
            return self.project_out(F.gelu(a) * g)

    class TransformerBlock(nn.Module):
        def __init__(self, c, nheads):
            super().__init__()
            self.norm1 = LayerNorm(c)
            self.attn = Attention(c, nheads)
            self.norm2 = LayerNorm(c)
            self.ffn = FeedForward(c, ffn_expansion)

        def forward(self, x):
            x = x + self.attn(self.norm1(x))
            return x + self.ffn(self.norm2(x))

    class _Body(nn.Module):
        """Official Downsample/Upsample wrap their Sequential in
        ``self.body`` — keys are down1_2.body.0.weight etc."""

        def __init__(self, *mods):
            super().__init__()
            self.body = nn.Sequential(*mods)

        def forward(self, x):
            return self.body(x)

    def down(c):
        return _Body(nn.Conv2d(c, c // 2, 3, padding=1, bias=False),
                     nn.PixelUnshuffle(2))

    def up(c):
        return _Body(nn.Conv2d(c, c * 2, 3, padding=1, bias=False),
                     nn.PixelShuffle(2))

    class PatchEmbed(nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = nn.Conv2d(in_ch, dim, 3, padding=1, bias=False)

        def forward(self, x):
            return self.proj(x)

    class Restormer(nn.Module):
        def __init__(self):
            super().__init__()
            d = dim
            self.patch_embed = PatchEmbed()
            self.encoder_level1 = nn.Sequential(
                *[TransformerBlock(d, heads[0]) for _ in range(num_blocks[0])])
            self.down1_2 = down(d)
            self.encoder_level2 = nn.Sequential(
                *[TransformerBlock(d * 2, heads[1]) for _ in range(num_blocks[1])])
            self.down2_3 = down(d * 2)
            self.encoder_level3 = nn.Sequential(
                *[TransformerBlock(d * 4, heads[2]) for _ in range(num_blocks[2])])
            self.down3_4 = down(d * 4)
            self.latent = nn.Sequential(
                *[TransformerBlock(d * 8, heads[3]) for _ in range(num_blocks[3])])
            self.up4_3 = up(d * 8)
            self.reduce_chan_level3 = nn.Conv2d(d * 8, d * 4, 1, bias=False)
            self.decoder_level3 = nn.Sequential(
                *[TransformerBlock(d * 4, heads[2]) for _ in range(num_blocks[2])])
            self.up3_2 = up(d * 4)
            self.reduce_chan_level2 = nn.Conv2d(d * 4, d * 2, 1, bias=False)
            self.decoder_level2 = nn.Sequential(
                *[TransformerBlock(d * 2, heads[1]) for _ in range(num_blocks[1])])
            self.up2_1 = up(d * 2)
            self.decoder_level1 = nn.Sequential(
                *[TransformerBlock(d * 2, heads[0]) for _ in range(num_blocks[0])])
            self.refinement = nn.Sequential(
                *[TransformerBlock(d * 2, heads[0]) for _ in range(num_refinement)])
            self.output = nn.Conv2d(d * 2, in_ch, 3, padding=1, bias=False)

        def forward(self, x):
            e1 = self.encoder_level1(self.patch_embed(x))
            e2 = self.encoder_level2(self.down1_2(e1))
            e3 = self.encoder_level3(self.down2_3(e2))
            lat = self.latent(self.down3_4(e3))
            d3 = self.decoder_level3(self.reduce_chan_level3(
                torch.cat([self.up4_3(lat), e3], 1)))
            d2 = self.decoder_level2(self.reduce_chan_level2(
                torch.cat([self.up3_2(d3), e2], 1)))
            d1 = self.decoder_level1(torch.cat([self.up2_1(d2), e1], 1))
            return x + self.output(self.refinement(d1))

    return Restormer()


def build_lama(ngf: int = 64, n_down: int = 3, n_blocks: int = 9,
               ratio: float = 0.5, in_ch: int = 4):
    """Official LaMa FFCResNetGenerator (saic-mdal, WACV22) re-statement
    for full-model parity: ReflectionPad 7x7 head/tail, FFC_BN_ACT
    downsamples (ratio 0, last one transitions to the resnet ratio),
    FFCResnetBlocks, ConvTranspose2d upsamples, sigmoid out. State-dict
    keys mirror the official ``model.{i}.*`` Sequential layout so
    ``models.lama.port_state_dict`` doubles as the real-weight port
    (enable_lfu=False, the big-lama setting)."""
    import torch
    import torch.nn as nn

    class FourierUnit(nn.Module):
        def __init__(self, c_in, c_out):
            super().__init__()
            self.conv_layer = nn.Conv2d(c_in * 2, c_out * 2, 1, bias=False)
            self.bn = nn.BatchNorm2d(c_out * 2)
            self.relu = nn.ReLU(inplace=False)

        def forward(self, x):
            b, c, h, w = x.shape
            f = torch.fft.rfftn(x.float(), dim=(-2, -1), norm="ortho")
            f = torch.stack((f.real, f.imag), dim=-1)       # (B,C,H,Wf,2)
            f = f.permute(0, 1, 4, 2, 3).reshape(b, -1, h, w // 2 + 1)
            f = self.relu(self.bn(self.conv_layer(f)))
            f = f.reshape(b, -1, 2, h, w // 2 + 1).permute(0, 1, 3, 4, 2)
            f = torch.complex(f[..., 0], f[..., 1])
            return torch.fft.irfftn(f, s=(h, w), dim=(-2, -1), norm="ortho")

    class SpectralTransform(nn.Module):
        def __init__(self, c_in, c_out):
            super().__init__()
            mid = c_out // 2
            self.conv1 = nn.Sequential(nn.Conv2d(c_in, mid, 1, bias=False),
                                       nn.BatchNorm2d(mid),
                                       nn.ReLU(inplace=False))
            self.fu = FourierUnit(mid, mid)
            self.conv2 = nn.Conv2d(mid, c_out, 1, bias=False)

        def forward(self, x):
            x = self.conv1(x)
            return self.conv2(x + self.fu(x))

    class FFC(nn.Module):
        def __init__(self, c_in, c_out, k, gin, gout, stride=1, pad=0):
            super().__init__()
            in_cg = int(c_in * gin)
            in_cl = c_in - in_cg
            out_cg = int(c_out * gout)
            out_cl = c_out - out_cg
            self.global_in_num = in_cg

            def conv(ci, co):
                if ci == 0 or co == 0:
                    return nn.Identity()
                return nn.Conv2d(ci, co, k, stride, pad, bias=False)

            self.convl2l = conv(in_cl, out_cl)
            self.convl2g = conv(in_cl, out_cg)
            self.convg2l = conv(in_cg, out_cl)
            self.convg2g = (SpectralTransform(in_cg, out_cg)
                            if in_cg and out_cg else nn.Identity())
            self.out_cl, self.out_cg = out_cl, out_cg

        def forward(self, x):
            x_l, x_g = x if isinstance(x, tuple) else (x, 0)
            out_l, out_g = 0, 0
            if self.out_cl:
                out_l = self.convl2l(x_l) + (
                    self.convg2l(x_g) if torch.is_tensor(x_g) else 0)
            if self.out_cg:
                out_g = (self.convl2g(x_l)
                         if not isinstance(self.convl2g, nn.Identity) else 0)
                if torch.is_tensor(x_g):
                    out_g = out_g + self.convg2g(x_g)
            return out_l, out_g

    class FFC_BN_ACT(nn.Module):
        def __init__(self, c_in, c_out, k, gin, gout, stride=1, pad=0):
            super().__init__()
            self.ffc = FFC(c_in, c_out, k, gin, gout, stride, pad)
            out_cg = int(c_out * gout)
            out_cl = c_out - out_cg
            self.bn_l = nn.BatchNorm2d(out_cl) if out_cl else nn.Identity()
            self.bn_g = nn.BatchNorm2d(out_cg) if out_cg else nn.Identity()
            self.act_l = nn.ReLU(inplace=False)
            self.act_g = nn.ReLU(inplace=False)

        def forward(self, x):
            xl, xg = self.ffc(x)
            if torch.is_tensor(xl):
                xl = self.act_l(self.bn_l(xl))
            if torch.is_tensor(xg):
                xg = self.act_g(self.bn_g(xg))
            return xl, xg

    class FFCResnetBlock(nn.Module):
        def __init__(self, c, gin):
            super().__init__()
            self.conv1 = FFC_BN_ACT(c, c, 3, gin, gin, pad=1)
            self.conv2 = FFC_BN_ACT(c, c, 3, gin, gin, pad=1)

        def forward(self, x):
            idl, idg = x
            xl, xg = self.conv2(self.conv1(x))
            return idl + xl, idg + xg

    class ConcatTupleLayer(nn.Module):
        def forward(self, x):
            xl, xg = x
            return torch.cat([xl, xg], dim=1)

    layers = [nn.ReflectionPad2d(3),
              FFC_BN_ACT(in_ch, ngf, 7, 0, 0)]
    ch = ngf
    for i in range(n_down):
        gout = ratio if i == n_down - 1 else 0
        layers.append(FFC_BN_ACT(ch, ch * 2, 3, 0, gout, stride=2, pad=1))
        ch *= 2
    for _ in range(n_blocks):
        layers.append(FFCResnetBlock(ch, ratio))
    layers.append(ConcatTupleLayer())
    for _ in range(n_down):
        layers += [nn.ConvTranspose2d(ch, ch // 2, 3, stride=2, padding=1,
                                      output_padding=1),
                   nn.BatchNorm2d(ch // 2), nn.ReLU(inplace=False)]
        ch //= 2
    layers += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, 3, 7), nn.Sigmoid()]

    class Generator(nn.Module):
        def __init__(self):
            super().__init__()
            self.model = nn.Sequential(*layers)

        def forward(self, x):
            return self.model(x)

    return Generator()


def reference(spec, sd: Mapping[str, Any]):
    """The upstream module for ``spec``'s family at the checkpoint's depth
    (RRDB blocks and SRVGG convs read from its keys, as
    ``torch_ref.parity_check`` reads them); ValueError for a family
    without one."""
    arch = spec.arch_config
    if spec.family == "rrdb":
        return build_rrdbnet(scale=arch.scale, nb=infer_rrdb_blocks(sd))
    if spec.family == "srvgg":
        return build_srvgg(num_conv=infer_srvgg_convs(sd), upscale=arch.scale)
    if spec.family == "hat":
        return build_hat(embed=arch.embed_dim, depths=arch.depths, heads=arch.num_heads,
                         window=arch.window, overlap=arch.overlap_ratio,
                         mlp_ratio=arch.mlp_ratio, squeeze=arch.cab_squeeze,
                         scale=arch.scale, img_range=arch.img_range)
    if spec.family == "nafnet":
        return build_nafnet(width=arch.width, enc_blocks=arch.enc_blocks,
                            middle_blocks=arch.middle_blocks, dec_blocks=arch.dec_blocks,
                            in_ch=arch.in_ch)
    if spec.family == "restormer":
        return build_restormer(dim=arch.dim, num_blocks=arch.num_blocks, heads=arch.heads,
                               num_refinement=arch.num_refinement,
                               ffn_expansion=arch.ffn_expansion, in_ch=arch.in_ch)
    if spec.family == "inpaint":          # the file's widths (the row's for a seeded draw)
        from framewright_tpu_torch.models.lama import infer_arch

        a = (infer_arch(sd) if sd else dict(ngf=arch.ngf, n_down=arch.n_down,
                                             n_blocks=arch.n_blocks, ratio=arch.global_ratio))
        return build_lama(ngf=a["ngf"], n_down=a["n_down"], n_blocks=a["n_blocks"],
                          ratio=a["ratio"], in_ch=arch.in_ch)
    raise ValueError(f"no torch reference for family "
                     f"{JAX_FAMILY.get(spec.family, spec.family)!r}")


@torch.no_grad()
def seeded_state_dict(spec, seed: int = 0, num_block: int = 0) -> Dict[str, torch.Tensor]:
    """A checkpoint for ``spec`` in the upstream layout, drawn as the
    upstream initialises its net (module docstring) from
    ``torch.Generator().manual_seed(seed)``; ``num_block`` (RRDB) other
    than the row's."""
    arch = spec.arch_config
    if spec.family == "rrdb":
        net = build_rrdbnet(scale=arch.scale, nb=num_block or arch.num_block)
    elif spec.family == "srvgg":
        net = build_srvgg(num_conv=arch.num_conv, upscale=arch.scale)
    else:
        net = reference(spec, {})
    g = torch.Generator().manual_seed(seed)
    for name, mod in net.named_modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            if re.search(r"rdb\d\.conv\d$", name):        # basicsr default_init_weights(.., 0.1)
                torch.nn.init.kaiming_normal_(mod.weight, generator=g)
                mod.weight.mul_(0.1)
                mod.bias.zero_()
            else:                                          # the module's own init
                torch.nn.init.kaiming_uniform_(mod.weight, a=math.sqrt(5), generator=g)
                if mod.bias is not None:
                    bound = 1.0 / math.sqrt(mod.weight[0].numel())
                    mod.bias.uniform_(-bound, bound, generator=g)
        elif isinstance(mod, torch.nn.Linear):             # HAT's _init_weights
            torch.nn.init.trunc_normal_(mod.weight, std=0.02, generator=g)
            mod.bias.zero_()
        elif isinstance(mod, torch.nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, torch.nn.PReLU):
            mod.weight.fill_(0.25)
        table = getattr(mod, "relative_position_bias_table", None)
        if isinstance(table, torch.nn.Parameter):
            torch.nn.init.trunc_normal_(table, std=0.02, generator=g)
        for scale in ("beta", "gamma"):   # NAFBlock's layer scales (upstream: zeros)
            p = getattr(mod, scale, None)
            if isinstance(p, torch.nn.Parameter) and p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return {k: v.clone() for k, v in net.state_dict().items()}


def _port_forward(spec, sd: Mapping[str, Any], tree, x: torch.Tensor) -> torch.Tensor:
    """The port's plain f32 forward on ``tree`` (``port_checkpoint``'s)."""
    from framewright_tpu_torch.models import hat, lama, registry, restormer
    from framewright_tpu_torch.models.layers import tree_to_torch
    from framewright_tpu_torch.models.nafnet import NAFNet
    from framewright_tpu_torch.models.rrdb import RRDBNet
    from framewright_tpu_torch.models.srvgg import SRVGGNet

    arch = spec.arch_config
    if spec.family == "hat":
        return hat.apply(tree_to_torch(tree, x.device, torch.float32), x, arch)
    if spec.family == "restormer":
        return restormer.apply_padded(tree_to_torch(tree, x.device, torch.float32), x,
                                      restormer.config_from_params(tree))
    if spec.family == "inpaint":
        return lama.apply_padded(tree_to_torch(tree, x.device, torch.float32), x,
                                 lama_mask(x), lama.config_from_params(tree))
    if spec.family == "nafnet":
        return NAFNet.from_state_dict(arch, registry.from_jax_params(tree, torch.float32),
                                      x.device).apply_padded(x)
    if spec.family == "rrdb":
        net, arch = RRDBNet, dataclasses.replace(arch, num_block=infer_rrdb_blocks(sd))
    else:
        net, arch = SRVGGNet, dataclasses.replace(arch, num_conv=infer_srvgg_convs(sd))
    model = net.from_state_dict(arch, registry.from_jax_params(tree, torch.float32), x.device)
    return model.apply(x)


def lama_mask(x: torch.Tensor) -> torch.Tensor:
    """``torch_ref.parity_check``'s inpainting mask for x (1, h, w, 3):
    ones on rows h/4 .. h/2 and columns w/4 .. w/2."""
    _, h, w, _ = x.shape
    m = x.new_zeros((1, h, w, 1))
    m[:, h // 4:h // 2, w // 4:w // 2] = 1.0
    return m


def parity_check(spec, sd: Mapping[str, Any], tree, device) -> Dict[str, Any]:
    """The reference and the port's forward on one seeded frame
    (``default_rng(0)``, 64x96, as ``torch_ref.parity_check``) ->
    {"psnr_db", "max_abs", "unexpected_keys"}; ValueError for a family
    without a reference or a checkpoint missing the reference's keys.
    Inpainting (JAX's branch): the reference takes the masked frame with
    the mask as a fourth channel, and its output is composited through the
    mask (``x (1 - m) + y m``), as ``lama.apply`` composites."""
    from framewright_tpu_torch.hw import full_f32

    tm = reference(spec, sd)
    own = tm.state_dict()
    bad = [k for k in sd if k in own and tuple(own[k].shape) != tuple(np.shape(sd[k]))]
    if bad:
        raise ValueError(f"torch reference shape mismatches: {bad[:5]}")
    missing, unexpected = tm.load_state_dict(
        {k: torch.as_tensor(v) for k, v in sd.items()}, strict=False)
    if missing:
        raise ValueError(f"torch reference missing keys: {missing[:5]}")
    h, w = PARITY_SIZE
    x = np.random.default_rng(0).random((1, h, w, 3), dtype=np.float32)
    xt = torch.from_numpy(x).to(device)
    with torch.no_grad(), full_f32():
        xr = xt
        if spec.family == "inpaint":
            m = lama_mask(xt)
            xr = torch.cat([xt * (1.0 - m), m], dim=-1)
        y_ref = tm.to(device).eval()(xr.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if spec.family == "inpaint":
            y_ref = xr[..., :3] + y_ref * m
        y_port = _port_forward(spec, sd, tree, xt)
    diff = y_port.double().cpu().numpy() - y_ref.double().cpu().numpy()
    mse = float(np.mean(diff ** 2))
    return {"psnr_db": 10 * np.log10(1.0 / max(mse, 1e-20)),
            "max_abs": float(np.abs(diff).max()), "unexpected_keys": list(unexpected)}
