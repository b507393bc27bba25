"""Restormer: the port of ``framewright_tpu.models.restormer`` on NHWC
tensors, functional over the JAX package's parameter tree (numpy in,
``layers.tree_to_torch`` onto the device).

A 4-level U-shape of transformer blocks. A block: the bias-free
LayerNorm (variance about the mean, but x itself, not x - mean, scaled:
the official ``BiasFree_LayerNorm``), MDTA (a 1x1 conv to q, k, v, a
depthwise 3x3, then per head the C/heads x C/heads attention over the
L2-normalised channel rows of q and k, times a learned temperature, the
softmax over the last axis), then the same norm and GDFN (1x1 to two
halves, depthwise 3x3, exact-erf GELU of the first times the second,
1x1 back). Downsampling: a 3x3 conv to half the channels then
``pixel_unshuffle(2)``; upsampling: a 3x3 conv to twice the channels
then ``pixel_shuffle(2)``; the decoder concatenates the skip (then a 1x1
reduce except at level 0). Every conv is bias-free. The output is
x + the last conv's delta. ``apply_padded`` reflect-pads the bottom and
right to multiples of 2^(levels - 1) and crops back.

The temporal denoiser's ``restormer`` method runs it on the blend at
the widths of the checkpoint (``config_from_params``: JAX's
``RestormerConfig()`` for the JAX package's ``restormer.npz``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.models.layers import conv, pixel_shuffle, pixel_unshuffle


@dataclass(frozen=True)
class RestormerConfig:
    in_ch: int = 3
    dim: int = 16                      # official: 48
    num_blocks: Tuple[int, ...] = (1, 1, 1, 2)   # official: (4, 6, 6, 8)
    num_refinement: int = 1            # official: 4
    heads: Tuple[int, ...] = (1, 2, 4, 8)
    ffn_expansion: float = 2.66


def config_from_params(params: Dict[str, Any]) -> RestormerConfig:
    """The widths a Restormer tree holds (heads from each level's
    temperature)."""
    def heads(blocks):
        return int(np.asarray(blocks[0]["temperature"]).shape[0])

    w = np.asarray(params["embed"]["w"])
    enc = params["enc"]
    hidden = np.asarray(params["latent"][0]["ffn_out"]["w"]).shape[2]
    dim_last = np.asarray(params["latent"][0]["proj"]["w"]).shape[3]
    return RestormerConfig(
        in_ch=int(w.shape[2]), dim=int(w.shape[3]),
        num_blocks=tuple(len(b) for b in enc) + (len(params["latent"]),),
        num_refinement=len(params["refine"]),
        heads=tuple(heads(b) for b in enc) + (heads(params["latent"]),),
        ffn_expansion=hidden / dim_last)


def port_state_dict(sd) -> Dict[str, Any]:
    """swz30's Restormer state dict -> the JAX ``restormer`` tree (JAX's
    ``torch_port.port_restormer``, the block counts read from the keys;
    every conv bias-free)."""
    def arr(key: str) -> np.ndarray:
        v = sd[key]
        return np.asarray(v.detach().float().cpu().numpy() if hasattr(v, "detach") else v,
                          np.float32)

    def conv(prefix: str) -> Dict[str, np.ndarray]:
        return {"w": arr(prefix + ".weight").transpose(2, 3, 1, 0).copy()}

    def blocks(prefix: str):
        n = len({k[len(prefix) + 1:].split(".")[0] for k in sd if k.startswith(prefix + ".")})
        return [{"norm1": {"gamma": arr(f"{prefix}.{j}.norm1.body.weight")},
                 "qkv": conv(f"{prefix}.{j}.attn.qkv"),
                 "qkv_dw": conv(f"{prefix}.{j}.attn.qkv_dwconv"),
                 "proj": conv(f"{prefix}.{j}.attn.project_out"),
                 "temperature": arr(f"{prefix}.{j}.attn.temperature"),
                 "norm2": {"gamma": arr(f"{prefix}.{j}.norm2.body.weight")},
                 "ffn_in": conv(f"{prefix}.{j}.ffn.project_in"),
                 "ffn_dw": conv(f"{prefix}.{j}.ffn.dwconv"),
                 "ffn_out": conv(f"{prefix}.{j}.ffn.project_out")} for j in range(n)]

    return {
        "embed": conv("patch_embed.proj"),
        "enc": [blocks(f"encoder_level{i}") for i in (1, 2, 3)],
        "down": [conv(f"down{i}_{i + 1}.body.0") for i in (1, 2, 3)],
        "latent": blocks("latent"),
        "up": [conv(f"up{i}_{i - 1}.body.0") for i in (4, 3, 2)],
        "reduce": [conv("reduce_chan_level3"), conv("reduce_chan_level2"), None],
        "dec": [blocks(f"decoder_level{i}") for i in (3, 2, 1)],
        "refine": blocks("refinement"),
        "output": conv("output"),
    }


def _conv_nb(rng: np.random.Generator, k: int, cin: int, cout: int) -> Dict[str, np.ndarray]:
    bound = np.sqrt(1.0 / (k * k * cin)) * np.sqrt(3.0)
    return {"w": rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32)}


def init_params(cfg: RestormerConfig = RestormerConfig(), seed: int = 0) -> Dict[str, Any]:
    """Seeded random parameters in the JAX ``restormer.init`` shapes (a
    stand-in for tests and the card's smoke; drawn with numpy)."""
    rng = np.random.default_rng(seed)

    def block(dim, heads):
        hidden = int(dim * cfg.ffn_expansion)
        return {"norm1": {"gamma": np.ones((dim,), np.float32)},
                "qkv": _conv_nb(rng, 1, dim, dim * 3),
                "qkv_dw": _conv_nb(rng, 3, 1, dim * 3),
                "proj": _conv_nb(rng, 1, dim, dim),
                "temperature": np.ones((heads, 1, 1), np.float32),
                "norm2": {"gamma": np.ones((dim,), np.float32)},
                "ffn_in": _conv_nb(rng, 1, dim, hidden * 2),
                "ffn_dw": _conv_nb(rng, 3, 1, hidden * 2),
                "ffn_out": _conv_nb(rng, 1, hidden, dim)}

    n = len(cfg.num_blocks)
    dims = [cfg.dim * 2 ** i for i in range(n)]
    p: Dict[str, Any] = {"embed": _conv_nb(rng, 3, cfg.in_ch, cfg.dim), "enc": [], "down": [],
                         "up": [], "reduce": [], "dec": []}
    for lv in range(n - 1):
        p["enc"].append([block(dims[lv], cfg.heads[lv]) for _ in range(cfg.num_blocks[lv])])
        p["down"].append(_conv_nb(rng, 3, dims[lv], dims[lv] // 2))
    p["latent"] = [block(dims[-1], cfg.heads[-1]) for _ in range(cfg.num_blocks[-1])]
    for lv in range(n - 2, -1, -1):
        p["up"].append(_conv_nb(rng, 3, dims[lv + 1], dims[lv + 1] * 2))
        cat = dims[lv] * 2
        p["reduce"].append(None if lv == 0 else _conv_nb(rng, 1, cat, dims[lv]))
        dec = dims[lv] if lv > 0 else cat
        p["dec"].append([block(dec, cfg.heads[lv]) for _ in range(cfg.num_blocks[lv])])
    p["refine"] = [block(dims[0] * 2, cfg.heads[0]) for _ in range(cfg.num_refinement)]
    p["output"] = _conv_nb(rng, 3, dims[0] * 2, cfg.in_ch)
    return p


def _ln_bias_free(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    var = (x * x).mean(-1, keepdim=True) - x.mean(-1, keepdim=True) ** 2
    return x * torch.rsqrt(var + eps) * p["gamma"].to(x.dtype)


def _normalize(t: torch.Tensor) -> torch.Tensor:
    """torch ``F.normalize`` as JAX writes it: t / max(||t||, 1e-12)."""
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)


def _mdta(p, x: torch.Tensor, heads: int) -> torch.Tensor:
    b, h, w, c = x.shape
    qkv = conv(p["qkv_dw"], conv(p["qkv"], x), groups=c * 3)
    q, k, v = qkv.split(c, dim=-1)
    hd = c // heads

    def rows(t):                       # (B, H, W, C) -> (B, heads, hd, HW)
        return t.reshape(b, h * w, heads, hd).permute(0, 2, 3, 1)

    q, k, v = _normalize(rows(q)), _normalize(rows(k)), rows(v)
    att = torch.matmul(q, k.transpose(-1, -2)) * p["temperature"].to(x.dtype)
    att = torch.softmax(att, dim=-1)
    out = torch.matmul(att, v).permute(0, 3, 1, 2).reshape(b, h, w, c)
    return conv(p["proj"], out)


def _gdfn(p, x: torch.Tensor) -> torch.Tensor:
    c2 = p["ffn_in"]["w"].shape[0]
    a, g = conv(p["ffn_dw"], conv(p["ffn_in"], x), groups=c2).chunk(2, dim=-1)
    return conv(p["ffn_out"], F.gelu(a) * g)


def _block(p, x: torch.Tensor, heads: int) -> torch.Tensor:
    x = x + _mdta(p, _ln_bias_free(p["norm1"], x), heads)
    return x + _gdfn(p, _ln_bias_free(p["norm2"], x))


def apply(params, x: torch.Tensor, cfg: RestormerConfig = RestormerConfig()) -> torch.Tensor:
    """x (B, H, W, C) in [0, 1], sides divisible by 2^(levels - 1) ->
    x + the restoration delta."""
    n = len(cfg.num_blocks)
    feat = conv(params["embed"], x)
    skips = []
    for lv in range(n - 1):
        for bp in params["enc"][lv]:
            feat = _block(bp, feat, cfg.heads[lv])
        skips.append(feat)
        feat = pixel_unshuffle(conv(params["down"][lv], feat), 2)
    for bp in params["latent"]:
        feat = _block(bp, feat, cfg.heads[-1])
    for i, lv in enumerate(range(n - 2, -1, -1)):
        feat = torch.cat([pixel_shuffle(conv(params["up"][i], feat), 2), skips[lv]], dim=-1)
        if params["reduce"][i] is not None:
            feat = conv(params["reduce"][i], feat)
        for bp in params["dec"][i]:
            feat = _block(bp, feat, cfg.heads[lv])
    for bp in params["refine"]:
        feat = _block(bp, feat, cfg.heads[0])
    return x + conv(params["output"], feat)


def apply_padded(params, x: torch.Tensor,
                 cfg: RestormerConfig = RestormerConfig()) -> torch.Tensor:
    """``apply`` at any size: reflect-padded at the bottom and right to
    multiples of 2^(levels - 1), then cropped."""
    div = 2 ** (len(cfg.num_blocks) - 1)
    h, w = x.shape[1:3]
    hp, wp = -(-h // div) * div, -(-w // div) * div
    if (hp, wp) != (h, w):
        x = F.pad(x.permute(0, 3, 1, 2), (0, wp - w, 0, hp - h),
                  mode="reflect").permute(0, 2, 3, 1)
    return apply(params, x, cfg)[:, :h, :w, :]
