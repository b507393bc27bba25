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
window 8), the upsampling tail on one frame at a time. ``apply(...,
bands=)`` runs a window in row bands (the video SR's spatial split), each
band its own rows of the whole frame's result.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.parallel.bands import Bands
from framewright_tpu_torch.parallel.mesh import device_current
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
    (nW, L, L) (token = frame * win^2 + s); ``_attend`` adds it to the
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


def _attend(blk, x: torch.Tensor, cfg: TVSRConfig, mask) -> torch.Tensor:
    """Joint attention within each window of x (B, T, h, w, C), its
    windows in row-major order; ``mask`` (additive, one a window of x,
    repeated over the batch) or None."""
    b, t, h, w, c = x.shape
    win, heads = cfg.window, cfg.heads
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
    return out.reshape(b, nh, nw, t, win, win, c).permute(0, 3, 1, 4, 2, 5, 6).reshape(
        b, t, h, w, c)


def _mlp(blk, x: torch.Tensor) -> torch.Tensor:
    y = layer_norm(x, blk["ln2_g"], blk["ln2_b"])
    return linear(blk["fc2"], F.gelu(linear(blk["fc1"], y), approximate="tanh"))


def _tail(params, feat: torch.Tensor, frame: torch.Tensor, scale: int) -> torch.Tensor:
    """One frame's tail: conv_body's features (1, h, w, dim) and the frame
    (1, h, w, 3) -> (1, sh, sw, 3)."""
    _, h, w, _ = frame.shape
    y = F.leaky_relu(pixel_shuffle(conv(params["up1"], feat), 2), 0.1)
    if scale == 4:
        y = F.leaky_relu(pixel_shuffle(conv(params["up2"], y), 2), 0.1)
    y = conv(params["conv_last"], F.leaky_relu(conv(params["conv_hr"], y), 0.1))
    return resize_bicubic(frame, (h * scale, w * scale)).to(y.dtype) + y


# The row bands of the spatial split: cut on window rows, no halo held;
# conv_first reads 1 row of frame around a band, conv_body and the tail
# TAIL_HALO rows of features (1 for conv_body, 3 for up1, up2 at 2x,
# conv_hr and conv_last at 4x; the bicubic base 2).
TAIL_HALO = 4


def _shifted(blk, xs, j: int, bands, cfg: TVSRConfig, mask) -> torch.Tensor:
    """The shifted block's attention on band j's rows of xs (each (B, T,
    rows, w, C)): one band, JAX's roll of the whole frame by half a window
    on both axes; several, half a window of rows from each neighbour band
    (cyclic, as the roll is), whose windows are then the rolled frame's,
    and the roll along the width only."""
    shift = cfg.window // 2
    if len(xs) == 1:
        out = _attend(blk, torch.roll(xs[0], (-shift, -shift), dims=(2, 3)), cfg, mask)
        return torch.roll(out, (shift, shift), dims=(2, 3))
    ext = torch.roll(bands.with_rows(xs, j, shift, axis=2, cyclic=True), -shift, dims=3)
    out = torch.roll(_attend(blk, ext, cfg, mask), shift, dims=3)
    return out[:, :, shift:shift + xs[j].shape[2]]


def apply(params, frames: torch.Tensor, cfg: TVSRConfig = TVSRConfig(),
          bands=None) -> torch.Tensor:
    """(B, T, H, W, 3) in [0, 1], sides multiples of the window -> (B, T,
    sH, sW, 3). ``bands`` (``parallel.bands.Bands`` of H whose cuts lie on
    window rows, no halo) splits it by rows, ``params`` then a list of the
    tree on each band's device; ``frames`` lies on the first band's, and
    so does the result. A band holds its own rows of the features; the
    attention is local to its windows, but for the shifted blocks
    (``_shifted``), which take their windows' rows of the whole frame's
    mask; conv_first takes one row of frame around the band, conv_body and
    the tail ``TAIL_HALO`` rows of features (the bicubic base its frame
    rows). Each band computes its own rows of the whole frame's result."""
    b, t, h, w, _ = frames.shape
    if bands is None:
        bands, params = Bands.split(h, [frames.device], 0), [params]
    win, s = cfg.window, cfg.scale
    shift = win // 2
    nh, nw = h // win, w // win
    devs = bands.devices
    full_mask = _spatial_mask(h, w, win, shift, torch.device(frames.device))
    masks, xs = [], []
    for (a, e), p, d in zip(bands.cuts, params, devs):
        lo, hi = max(0, a - 1), min(h, e + 1)
        with device_current(d):
            f = frames[:, :, lo:hi].to(d).reshape(b * t, hi - lo, w, 3)
            xs.append(conv(p["conv_first"], f)[:, a - lo:e - lo].reshape(
                b, t, e - a, w, cfg.dim))
        if len(bands) == 1:
            masks.append(full_mask)
        else:
            # the shifted windows over rows a - shift .. e + shift: rolled
            # window rows a / win - 1 .. e / win - 1
            k = [r % nh for r in range(a // win - 1, e // win)]
            masks.append(full_mask.view(nh, nw, win * win, win * win)[k].reshape(
                -1, win * win, win * win).to(d))
    x0 = xs
    pairs = [p["pairs"] for p in params]
    for i in range(pairs[0]["a"]["ln1_g"].shape[0]):
        nxt = []
        for j, d in enumerate(devs):
            pa = _take(pairs[j]["a"], i)
            with device_current(d):
                x = xs[j] + _attend(pa, xs[j], cfg, None)
                nxt.append(x + _mlp(pa, x))
        xs, nxt = nxt, []
        for j, d in enumerate(devs):
            pb = _take(pairs[j]["b"], i)
            with device_current(d):
                x = xs[j] + _shifted(pb, xs, j, bands, cfg, masks[j])
                nxt.append(x + _mlp(pb, x))
        xs = nxt
    outs = []
    for j, ((a, e), p, d) in enumerate(zip(bands.cuts, params, devs)):
        with device_current(d):
            x = bands.with_rows(xs, j, TAIL_HALO, axis=2)
            r0 = a - TAIL_HALO if j > 0 else a        # the frame row of x's first row
            n = x.shape[2]
            feat = (conv(p["conv_body"], x.reshape(b * t, n, w, cfg.dim))
                    + bands.with_rows(x0, j, TAIL_HALO, axis=2).reshape(b * t, n, w, cfg.dim))
            flat = frames[:, :, r0:r0 + n].to(d).reshape(b * t, n, w, 3)
            out = frames.new_empty((b * t, (e - a) * s, w * s, 3), device=d)
            for i in range(b * t):             # the tail a frame at a time
                y = _tail(p, feat[i:i + 1], flat[i:i + 1], s)
                out[i:i + 1] = y[:, (a - r0) * s:(e - r0) * s]
            outs.append(out)
    return bands.gather(outs, s, frames.device).reshape(b, t, h * s, w * s, 3)
