"""ECCV16 colorization network (Zhang et al. 2016) and the Lab colour
maths: the port of ``framewright_tpu.models.colorizer_net``, functional
over the JAX package's parameter tree (``layers.tree_to_torch``), in f32.

Eight VGG-style blocks over the L channel: per block 3x3 convs with ReLU,
then BatchNorm (stored inference affine: gamma, beta, mean, var, eps
1e-5). The stride-2 convs pad k // 2 on both sides, as torch does (the
JAX module pads them explicitly); the stride-1 convs are XLA ``SAME``,
and blocks 5 and 6 dilate theirs by 2, so they pad 2. Then model8: the
``ConvTranspose2d(c512, c256, 4, 2, 1)`` up-conv (as the phase conv of
``models/ifnet.conv_transpose4x2``: cuDNN's transposed conv is a
backward-data pass whose sum order changes from run to run), two 3x3
convs, the 1x1 head to 313 bins, a softmax over the bins, the bias-free
1x1 projection to ab, times 110, and a bilinear resize to the input size.

``width_mult`` < 1 shrinks every channel count to max(8, int(c * m)) (the
JAX package's stand-in runs 0.125); ``config_from_params`` reads it from
a checkpoint's first conv. ``rgb_to_lab`` and ``lab_to_rgb`` are the JAX
module's D65 conversions, op for op in f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.models.ifnet import conv_transpose4x2
from framewright_tpu_torch.models.layers import conv_init, resize_bilinear_nchw

L_CENT = 50.0
L_NORM = 100.0
AB_NORM = 110.0

# (convs per block: (cin, cout, stride, dilation)), BN after each block
_BLOCKS: List[List[Tuple[int, int, int, int]]] = [
    [(1, 64, 1, 1), (64, 64, 2, 1)],
    [(64, 128, 1, 1), (128, 128, 2, 1)],
    [(128, 256, 1, 1), (256, 256, 1, 1), (256, 256, 2, 1)],
    [(256, 512, 1, 1), (512, 512, 1, 1), (512, 512, 1, 1)],
    [(512, 512, 1, 2), (512, 512, 1, 2), (512, 512, 1, 2)],
    [(512, 512, 1, 2), (512, 512, 1, 2), (512, 512, 1, 2)],
    [(512, 512, 1, 1), (512, 512, 1, 1), (512, 512, 1, 1)],
]


@dataclass(frozen=True)
class ECCV16Config:
    width_mult: float = 1.0      # < 1 shrinks all channels


def _scaled_blocks(cfg: ECCV16Config):
    m = cfg.width_mult

    def sc(c):
        return max(8, int(c * m)) if c > 1 else c

    return [[(sc(ci), sc(co), s, d) for (ci, co, s, d) in blk] for blk in _BLOCKS]


def config_from_params(params: Dict[str, Any]) -> ECCV16Config:
    """The width of a parameter tree: its first conv's outputs over 64."""
    return ECCV16Config(width_mult=int(np.shape(params["blocks"][0][0]["w"])[-1]) / 64.0)


def init_params(cfg: ECCV16Config = ECCV16Config(), seed: int = 0) -> Dict[str, Any]:
    """Seeded random parameters in the JAX ``colorizer_net.init`` shapes
    and scales (numpy; BN at its identity statistics), for a stand-in
    ``eccv16.npz``."""
    rng = np.random.default_rng(seed)
    blocks = _scaled_blocks(cfg)
    params: Dict[str, Any] = {"blocks": [], "bn": []}
    for blk in blocks:
        params["blocks"].append([conv_init(rng, 3, ci, co) for (ci, co, _, _) in blk])
        c = blk[-1][1]
        params["bn"].append({"gamma": np.ones((c,), np.float32),
                             "beta": np.zeros((c,), np.float32),
                             "mean": np.zeros((c,), np.float32),
                             "var": np.ones((c,), np.float32)})
    c512 = blocks[-1][-1][1]
    c256 = max(8, int(256 * cfg.width_mult))
    params["model8"] = {"up": conv_init(rng, 4, c512, c256),
                        "conv1": conv_init(rng, 3, c256, c256),
                        "conv2": conv_init(rng, 3, c256, c256),
                        "head": conv_init(rng, 1, c256, 313)}
    params["model_out"] = {"w": (rng.standard_normal((1, 1, 313, 2)) * 0.01).astype(np.float32)}
    return params


def _conv(p, x: torch.Tensor, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """NCHW conv with the tree's OIHW ``w`` and ``b``: k // 2 zeros a side
    at stride 2, ``SAME`` (dilation * (k // 2)) at stride 1; the bias added
    after the sum."""
    k = p["w"].shape[-1]
    pad = k // 2 if stride > 1 else dilation * (k // 2)
    y = F.conv2d(x, p["w"], None, stride=stride, padding=pad, dilation=dilation)
    return y + p["b"].view(1, -1, 1, 1)


def _bn(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    def c(v):
        return v.view(1, -1, 1, 1)

    inv = torch.rsqrt(p["var"] + eps)
    return (x - c(p["mean"])) * c(inv) * c(p["gamma"]) + c(p["beta"])


def apply(params, l_channel: torch.Tensor, cfg: ECCV16Config = ECCV16Config()) -> torch.Tensor:
    """L (B, H, W, 1) in [0, 100] -> ab (B, H, W, 2) in [-110, 110]; H and W
    multiples of 8 (callers resize to the official 256x256)."""
    b, h, w, _ = l_channel.shape
    x = ((l_channel - L_CENT) / L_NORM).permute(0, 3, 1, 2)
    for bi, blk in enumerate(_scaled_blocks(cfg)):
        for ci, (_, _, stride, dil) in enumerate(blk):
            x = torch.relu(_conv(params["blocks"][bi][ci], x, stride, dil))
        x = _bn(params["bn"][bi], x)
    m8 = params["model8"]
    # the tree's OIHW (out, in, 4, 4) -> ConvTranspose2d's (in, out, 4, 4)
    x = torch.relu(conv_transpose4x2(x, m8["up"]["w"].transpose(0, 1), m8["up"]["b"]))
    x = torch.relu(_conv(m8["conv1"], x))
    x = torch.relu(_conv(m8["conv2"], x))
    probs = torch.softmax(_conv(m8["head"], x), dim=1)
    ab = F.conv2d(probs, params["model_out"]["w"]) * AB_NORM
    return resize_bilinear_nchw(ab, (h, w)).permute(0, 2, 3, 1)


# -- Lab <-> RGB (D65) -----------------------------------------------------------

_RGB2XYZ = ((0.412453, 0.212671, 0.019334),
            (0.357580, 0.715160, 0.119193),
            (0.180423, 0.072169, 0.950227))
_XYZ2RGB = ((3.240479, -0.969256, 0.055648),
            (-1.537150, 1.875992, -0.204043),
            (-0.498535, 0.041556, 1.057311))
_WHITE = (0.95047, 1.0, 1.08883)


def rgb_to_lab(rgb01: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> Lab (L in [0, 100])."""
    r = torch.where(rgb01 <= 0.04045, rgb01 / 12.92, ((rgb01 + 0.055) / 1.055) ** 2.4)
    m = torch.tensor(_RGB2XYZ, dtype=rgb01.dtype, device=rgb01.device)
    t = (r @ m) / torch.tensor(_WHITE, dtype=rgb01.dtype, device=rgb01.device)

    def f(v):
        return torch.where(v > 0.008856, v ** (1 / 3), 7.787 * v + 16.0 / 116.0)

    fx, fy, fz = f(t[..., 0]), f(t[..., 1]), f(t[..., 2])
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], -1)


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """Lab -> (..., 3) RGB clipped to [0, 1]."""
    ll, a, bb = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (ll + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - bb / 200.0

    def finv(v):
        cube = v * v * v                      # JAX's integer_pow(v, 3)
        return torch.where(cube > 0.008856, cube, (v - 16.0 / 116.0) / 7.787)

    ref = torch.tensor(_WHITE, dtype=lab.dtype, device=lab.device)
    xyz = torch.stack([finv(fx), finv(fy), finv(fz)], -1) * ref
    r = xyz @ torch.tensor(_XYZ2RGB, dtype=lab.dtype, device=lab.device)
    r = torch.where(r <= 0.0031308, r * 12.92, 1.055 * r.clamp(min=0) ** (1 / 2.4) - 0.055)
    return r.clamp(0.0, 1.0)
