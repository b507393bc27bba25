"""TVSR (temporal window-attention video SR): the port of
``framewright_tpu.models.tvsr`` on NHWC tensors, functional over the JAX
package's parameter tree.

conv_first on every frame, then ``depth / 2`` pairs of blocks (the pairs'
weights stacked on a leading axis, as the JAX tree holds them); a block is
joint attention over the T x win^2 tokens of a spatial window (plain,
then shifted by half a window with the Swin mask tiled across the
frames), then a LayerNorm and a tanh-approximated GELU MLP
(``jax.nn.gelu``'s default, which this model keeps). The logits are f32
(the JAX ``einsum`` with ``preferred_element_type=f32``), scaled by
hd^-0.5, softmaxed in f32 and cast back. conv_body plus conv_first's
features, pixel-shuffle 2x stages with leaky ReLU 0.1, conv_hr,
conv_last, added to the bicubic upscale of the input. No published
checkpoint: the registry's ``TVSR_x4`` runs seeded weights.

The attention runs on at most ``_WINDOW_CHUNK`` windows at a time (a
window's f32 logits are heads x (T win^2)^2 values: 6.5 MB at T = 10,
window 8), the upsampling tail on one frame at a time.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.models.layers import (
    conv,
    conv_init,
    layer_norm,
    linear,
    pixel_shuffle,
    resize_bicubic,
)

_WINDOW_CHUNK = 256


@dataclass(frozen=True)
class TVSRConfig:
    dim: int = 64
    heads: int = 4
    window: int = 8
    depth: int = 6          # even: (plain, shifted) pairs
    mlp_ratio: int = 2
    scale: int = 4


def init_params(cfg: TVSRConfig = TVSRConfig(), seed: int = 0) -> Dict[str, Any]:
    """Seeded random parameters in the JAX ``tvsr.init`` shapes (pairs
    stacked; drawn with numpy)."""
    rng = np.random.default_rng(seed)
    d = cfg.dim

    def lin(ci, co):
        return {"w": (rng.standard_normal((ci, co)) * ci ** -0.5).astype(np.float32),
                "b": np.zeros((co,), np.float32)}

    def block():
        return {"ln1_g": np.ones((d,), np.float32), "ln1_b": np.zeros((d,), np.float32),
                "qkv": lin(d, 3 * d), "proj": lin(d, d),
                "ln2_g": np.ones((d,), np.float32), "ln2_b": np.zeros((d,), np.float32),
                "fc1": lin(d, cfg.mlp_ratio * d), "fc2": lin(cfg.mlp_ratio * d, d)}

    pairs = [{"a": block(), "b": block()} for _ in range(cfg.depth // 2)]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)

    return {"conv_first": conv_init(rng, 3, 3, d), "pairs": stack(*pairs),
            "conv_body": conv_init(rng, 3, d, d), "up1": conv_init(rng, 3, d, d * 4),
            "up2": conv_init(rng, 3, d, d * 4), "conv_hr": conv_init(rng, 3, d, d),
            "conv_last": conv_init(rng, 3, d, 3)}


@functools.lru_cache(maxsize=4)
def _spatial_mask(h: int, w: int, win: int, shift: int, device: torch.device) -> torch.Tensor:
    """(nW, win^2, win^2) additive Swin mask of the rolled windows, on
    ``device`` (made once a size). JAX tiles it across the T frames into
    (nW, L, L) (token = frame * win^2 + s); ``_tmsa`` adds it to the
    logits viewed as (.., T, win^2, T, win^2), the same values without
    the tiled copy (13 GB at T = 10 on a 960x544 frame)."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(h // win, win, w // win, win).transpose(0, 2, 1, 3).reshape(-1, win * win)
    m = np.where(img[:, :, None] == img[:, None, :], 0.0, -1e9).astype(np.float32)
    return torch.from_numpy(m).to(device)


def _take(tree, i: int):
    return {k: _take(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _tmsa(blk, x: torch.Tensor, cfg: TVSRConfig, shift: int, mask) -> torch.Tensor:
    """Temporal-spatial window attention on x (B, T, h, w, C)."""
    b, t, h, w, c = x.shape
    win, heads = cfg.window, cfg.heads
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(2, 3))
    nh, nw = h // win, w // win
    L = t * win * win
    hd = c // heads
    tok = x.reshape(b, t, nh, win, nw, win, c).permute(0, 2, 4, 1, 3, 5, 6).reshape(-1, L, c)
    out = torch.empty_like(tok)
    for s in range(0, tok.shape[0], _WINDOW_CHUNK):
        e = min(tok.shape[0], s + _WINDOW_CHUNK)
        qkv = linear(blk["qkv"], layer_norm(tok[s:e], blk["ln1_g"], blk["ln1_b"]))
        q, k, v = (z.reshape(e - s, L, heads, hd).transpose(1, 2) for z in qkv.chunk(3, -1))
        att = torch.matmul(q.float(), k.float().transpose(-1, -2)).mul_(hd ** -0.5)
        if mask is not None:
            sq = win * win
            m = mask[torch.arange(s, e, device=mask.device) % (nh * nw)]
            att.view(e - s, heads, t, sq, t, sq).add_(m[:, None, None, :, None, :])
        a = torch.softmax(att, dim=-1).to(x.dtype)
        del att
        out[s:e] = linear(blk["proj"], torch.matmul(a, v).transpose(1, 2).reshape(e - s, L, c))
    out = out.reshape(b, nh, nw, t, win, win, c).permute(0, 3, 1, 4, 2, 5, 6).reshape(
        b, t, h, w, c)
    if shift:
        out = torch.roll(out, (shift, shift), dims=(2, 3))
    return out


def _mlp(blk, x: torch.Tensor) -> torch.Tensor:
    y = layer_norm(x, blk["ln2_g"], blk["ln2_b"])
    return linear(blk["fc2"], F.gelu(linear(blk["fc1"], y), approximate="tanh"))


def apply(params, frames: torch.Tensor, cfg: TVSRConfig = TVSRConfig()) -> torch.Tensor:
    """(B, T, H, W, 3) in [0, 1], sides multiples of the window -> (B, T,
    sH, sW, 3)."""
    b, t, h, w, _ = frames.shape
    win = cfg.window
    shift = win // 2
    flat = frames.reshape(b * t, h, w, 3)
    x = conv(params["conv_first"], flat).reshape(b, t, h, w, cfg.dim)
    x0 = x
    mask = _spatial_mask(h, w, win, shift, torch.device(frames.device))
    pairs = params["pairs"]
    for i in range(pairs["a"]["ln1_g"].shape[0]):
        pa, pb = _take(pairs["a"], i), _take(pairs["b"], i)
        x = x + _tmsa(pa, x, cfg, 0, None)
        x = x + _mlp(pa, x)
        x = x + _tmsa(pb, x, cfg, shift, mask)
        x = x + _mlp(pb, x)
    feat = conv(params["conv_body"], x.reshape(b * t, h, w, cfg.dim)) \
        + x0.reshape(b * t, h, w, cfg.dim)
    s = cfg.scale
    out = frames.new_empty((b * t, h * s, w * s, 3))
    for i in range(b * t):                     # the tail a frame at a time
        y = F.leaky_relu(pixel_shuffle(conv(params["up1"], feat[i:i + 1]), 2), 0.1)
        if s == 4:
            y = F.leaky_relu(pixel_shuffle(conv(params["up2"], y), 2), 0.1)
        y = conv(params["conv_last"], F.leaky_relu(conv(params["conv_hr"], y), 0.1))
        out[i:i + 1] = resize_bicubic(flat[i:i + 1], (h * s, w * s)).to(y.dtype) + y
    return out.reshape(b, t, h * s, w * s, 3)
