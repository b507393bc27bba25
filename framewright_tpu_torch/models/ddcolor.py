"""DDColor-class query-based colorization network: the port of
``framewright_tpu.models.ddcolor``, functional over the JAX package's
parameter tree (``layers.tree_to_torch``) on NHWC tensors, in f32.

A ConvNeXt encoder over the L channel (a 4x4 stride-4 patchify stem and
2x2 stride-2 downsamples, which JAX's ``SAME`` pads by nothing on sides
that are multiples of 32; blocks of a 7x7 depthwise conv with its bias,
LayerNorm with eps 1e-6, fc1, GELU in its tanh form, which ``jax.nn.gelu``
computes by default, fc2 and a layer scale), an FPN pixel decoder (1x1
laterals, bilinear upsampling, 3x3 ``SAME`` convs, then a bilinear resize
to the input and a 3x3 conv), a colour decoder in which the learnable
queries cross-attend to the 1/32, 1/16 and 1/8 features (plain PyTorch:
JAX computes the attention in XLA, outside any Pallas kernel), and the
correlation volume of pixel embeddings and refined queries, a 1x1 conv to
ab, tanh, times 110.

``config_from_params`` infers ``DDColorConfig`` from a checkpoint's array
shapes (the heads from the query width: 32 channels a head, which both
JAX configs have); ``large_config()`` is the official DDColor's size.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.models.layers import conv_init, layer_norm, linear, resize_bilinear

_DEF_DIMS = (32, 64, 128, 256)
_HEAD_DIM = 32


@dataclass(frozen=True)
class DDColorConfig:
    dims: Tuple[int, ...] = _DEF_DIMS      # encoder stage channels
    depths: Tuple[int, ...] = (1, 1, 2, 1)  # ConvNeXt blocks per stage
    num_queries: int = 64
    embed_dim: int = 128                    # query/attention dim
    pixel_dim: int = 32                     # full-res pixel embedding
    num_heads: int = 4
    dec_layers_per_scale: int = 1           # cross-attn rounds per scale


def large_config() -> DDColorConfig:
    """The official DDColor's size (what JAX loads ``ddcolor.npz`` as)."""
    return DDColorConfig(dims=(96, 192, 384, 768), depths=(3, 3, 9, 3),
                         num_queries=100, embed_dim=256, pixel_dim=64,
                         num_heads=8, dec_layers_per_scale=3)


def config_from_params(params: Dict[str, Any]) -> DDColorConfig:
    """The architecture of a parameter tree, from its arrays' shapes."""
    k, e = np.shape(params["queries"])
    return DDColorConfig(
        dims=tuple(int(np.shape(s[0]["dw"]["w"])[-1]) for s in params["stages"]),
        depths=tuple(len(s) for s in params["stages"]),
        num_queries=int(k), embed_dim=int(e),
        pixel_dim=int(np.shape(params["lateral"][0]["w"])[-1]),
        num_heads=int(e) // _HEAD_DIM, dec_layers_per_scale=len(params["dec"]) // 3)


def init_params(cfg: DDColorConfig = DDColorConfig(), seed: int = 0) -> Dict[str, Any]:
    """Seeded random parameters in the JAX ``ddcolor.init`` shapes and
    scales (numpy), for a stand-in ``ddcolor.npz``."""
    rng = np.random.default_rng(seed)

    def ln(c):
        return {"g": np.ones((c,), np.float32), "b": np.zeros((c,), np.float32)}

    def lin(ci, co, scale=1.0):
        return {"w": (rng.standard_normal((ci, co)) * (scale / np.sqrt(ci))).astype(np.float32),
                "b": np.zeros((co,), np.float32)}

    def block(dim):
        return {"dw": conv_init(rng, 7, 1, dim), "ln": ln(dim), "fc1": lin(dim, dim * 4),
                "fc2": lin(dim * 4, dim, 0.2), "gamma": np.full((dim,), 1e-2, np.float32)}

    e, pd = cfg.embed_dim, cfg.pixel_dim
    p: Dict[str, Any] = {"stem": conv_init(rng, 4, 1, cfg.dims[0]), "stages": [], "downs": []}
    for si, dim in enumerate(cfg.dims):
        p["stages"].append([block(dim) for _ in range(cfg.depths[si])])
        if si + 1 < len(cfg.dims):
            p["downs"].append({"ln": ln(dim), "conv": conv_init(rng, 2, dim, cfg.dims[si + 1])})
    p["lateral"] = [conv_init(rng, 1, d, pd) for d in cfg.dims]
    p["fpn_out"] = [conv_init(rng, 3, pd, pd) for _ in cfg.dims]
    p["pix_up"] = conv_init(rng, 3, pd, pd)
    p["queries"] = (rng.standard_normal((cfg.num_queries, e)) * 0.02).astype(np.float32)
    p["feat_proj"] = [lin(d, e) for d in cfg.dims[1:]]
    p["dec"] = [{"q": lin(e, e), "k": lin(e, e), "v": lin(e, e), "o": lin(e, e, 0.5),
                 "ln1": ln(e), "ffn1": lin(e, e * 2), "ffn2": lin(e * 2, e, 0.5), "ln2": ln(e)}
                for _ in range(3 * cfg.dec_layers_per_scale)]
    p["q_final"] = lin(e, pd)
    out = conv_init(rng, 1, cfg.num_queries, 2)
    p["out"] = {"w": out["w"] * np.float32(0.01), "b": out["b"] * np.float32(0.0)}
    return p


def _conv(p, x: torch.Tensor, stride: int = 1, padding: int = None, groups: int = 1
          ) -> torch.Tensor:
    """NHWC conv with the tree's OIHW ``w``, ``SAME`` at stride 1 (k // 2)
    unless ``padding`` is given; the bias added after the sum, as JAX adds
    it."""
    w = p["w"]
    pad = w.shape[-1] // 2 if padding is None else padding
    y = F.conv2d(x.permute(0, 3, 1, 2), w, None, stride=stride, padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1) + p["b"]


def _ln(p, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, p["g"], p["b"], eps=1e-6)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _convnext_block(p, x: torch.Tensor) -> torch.Tensor:
    y = _conv(p["dw"], x, groups=x.shape[-1])
    y = _ln(p["ln"], y)
    y = linear(p["fc2"], _gelu(linear(p["fc1"], y)))
    return x + p["gamma"] * y


def _encode(p, cfg: DDColorConfig, x: torch.Tensor) -> List[torch.Tensor]:
    """L (B, H, W, 1) -> features at 1/4, 1/8, 1/16, 1/32."""
    feats = []
    h = _conv(p["stem"], x, stride=4, padding=0)
    for si in range(len(cfg.dims)):
        for blk in p["stages"][si]:
            h = _convnext_block(blk, h)
        feats.append(h)
        if si + 1 < len(cfg.dims):
            h = _conv(p["downs"][si]["conv"], _ln(p["downs"][si]["ln"], h), stride=2,
                      padding=0)
    return feats


def _cross_attn(layer, q: torch.Tensor, kv: torch.Tensor, heads: int) -> torch.Tensor:
    """q (B, K, D) attends to kv (B, N, D)."""
    b, kq, d = q.shape
    hd = d // heads

    def split(t):
        return t.reshape(b, -1, heads, hd).permute(0, 2, 1, 3)

    qq = split(linear(layer["q"], q))
    kk = split(linear(layer["k"], kv))
    vv = split(linear(layer["v"], kv))
    att = torch.softmax((qq @ kk.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    o = (att @ vv).permute(0, 2, 1, 3).reshape(b, kq, d)
    q = _ln(layer["ln1"], q + linear(layer["o"], o))
    f = linear(layer["ffn2"], _gelu(linear(layer["ffn1"], q)))
    return _ln(layer["ln2"], q + f)


def apply(params, l_channel: torch.Tensor, cfg: DDColorConfig = DDColorConfig()) -> torch.Tensor:
    """L (B, H, W, 1) in [0, 100] -> ab (B, H, W, 2) in [-110, 110]; H and W
    multiples of 32."""
    b, h, w, _ = l_channel.shape
    feats = _encode(params, cfg, l_channel / 100.0 - 0.5)

    # pixel decoder: top-down FPN to 1/4, then upsample to full res
    pix = _conv(params["lateral"][-1], feats[-1])
    for si in range(len(feats) - 2, -1, -1):
        lat = _conv(params["lateral"][si], feats[si])
        pix = lat + resize_bilinear(pix, lat.shape[1:3])
        pix = _conv(params["fpn_out"][si], pix)
    pix = _conv(params["pix_up"], resize_bilinear(pix, (h, w)))     # (B, H, W, pixel_dim)

    # colour decoder: queries refine over scales coarse -> fine
    q = params["queries"].expand(b, *params["queries"].shape)
    li = 0
    for scale_idx in (2, 1, 0):                 # feats[3], [2], [1] = 1/32 .. 1/8
        feat = feats[scale_idx + 1]
        kv = linear(params["feat_proj"][scale_idx], feat.reshape(b, -1, feat.shape[-1]))
        for _ in range(cfg.dec_layers_per_scale):
            q = _cross_attn(params["dec"][li], q, kv, cfg.num_heads)
            li += 1

    # correlation volume: (B, H, W, pixel_dim) x (B, K, pixel_dim) -> (B, H, W, K)
    qp = linear(params["q_final"], q)
    vol = torch.einsum("bhwd,bkd->bhwk", pix, qp)
    return torch.tanh(_conv(params["out"], vol)) * 110.0
