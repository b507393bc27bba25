"""Diffusion super-resolution: the port of
``framewright_tpu.models.diffusion_sr`` on NHWC tensors, functional over
the JAX package's parameter tree.

A conditional UNet denoiser (x0 prediction) on the noisy HR image
concatenated with the bicubic upsample of the LR frame, sampled with
DDIM. The UNet: a 3x3 conv in, per level a residual block (a per-pixel
norm over channels without affine, SiLU, 3x3 conv; the norm again with
FiLM scale and shift from the time embedding, SiLU, 3x3 conv; a 1x1 skip
where the widths differ) and a stride-2 3x3 pool but at the last level;
a middle block; per level back up a nearest-neighbour resize to the skip's
size, the concatenation with it and a residual block; a 3x3 head (zero
at init) added to the condition. The time embedding is sinusoidal, then
two linear layers with SiLU between; a style vector (guided SR) adds its
projection to it.

Dtypes as in JAX: every op runs in the activation dtype (bf16 in the SR
processor's default, or f32), a conv's products summed in f32 with its
bias added in f32 and one rounding to the activation dtype
(``preferred_element_type``: here an f32 convolution of the bf16
values, whose products are exact); the bicubic condition is resized with
the cubic weights rounded to the input's dtype, as ``jax.image.resize``
does; the DDIM state stays f32.

The sampler draws its starting noise as ``jax.random.normal(PRNGKey(k),
(B, H*s, W*s, 3))`` does (``ops.jax_random``): frame i of a batch gets
slice i of its batch's draw, so a frame's output depends on its position
in the dispatch batch (and a tile's on its position in its batch of
tiles), as in JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.models.layers import conv_init, cubic_weights, jax_conv_init
from framewright_tpu_torch.ops import jax_random


@dataclass(frozen=True)
class DiffusionSRConfig:
    scale: int = 4
    base_ch: int = 32
    ch_mults: Tuple[int, ...] = (1, 2, 4)
    time_dim: int = 64
    steps: int = 8                  # DDIM sampling steps
    train_steps: int = 1000         # diffusion schedule length
    propagate_t: float = 0.35       # video: re-noise the previous output to this
                                    # fraction of the chain (0 disables)


STYLE_DIM = 16


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` as XLA computes it in f32:
    start * (1 - t) + stop * t with t = i * (1 / (num - 1)), the last point
    ``stop`` (equal to JAX's for the sampler's ranges: start t_hi to 0,
    and 0 to 1)."""
    if num == 1:
        return np.asarray([start], np.float32)
    t = np.arange(num - 1, dtype=np.float32) * (np.float32(1.0) / np.float32(num - 1))
    out = np.float32(start) * (np.float32(1.0) - t) + np.float32(stop) * t
    return np.append(out, np.float32(stop)).astype(np.float32)


def alphas_cumprod(n: int) -> np.ndarray:
    """The cosine schedule (Nichol & Dhariwal), clipped to [1e-5, 1], f32."""
    t = _linspace_f32(0.0, 1.0, n + 1)
    f = np.cos((t + np.float32(0.008)) / np.float32(1.008)
               * np.float32(math.pi / 2)).astype(np.float32) ** 2
    return np.clip(f[1:] / f[0], np.float32(1e-5), np.float32(1.0)).astype(np.float32)


def _time_embed(t_frac: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of t in [0, 1] -> (B, dim) f32 (XLA folds the
    frequencies' two scalings into one f32 constant)."""
    half = dim // 2
    c = np.float32(-math.log(10000.0)) / np.float32(max(half - 1, 1))
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t_frac.device)
                      * torch.tensor(c, device=t_frac.device))
    ang = t_frac.float()[:, None] * freqs[None] * 1000.0
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -- parameters --------------------------------------------------------------------

def init_params(cfg: DiffusionSRConfig = DiffusionSRConfig(), seed: int = 0) -> Dict[str, Any]:
    """Seeded random parameters in the JAX ``diffusion_sr.init`` shapes
    (drawn with numpy; the output head and the style projection zero, as
    there)."""
    rng = np.random.default_rng(seed)
    ch = [cfg.base_ch * m for m in cfg.ch_mults]
    td = cfg.time_dim

    def normal(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    def res(cin, cout):
        return {"conv1": conv_init(rng, 3, cin, cout), "conv2": conv_init(rng, 3, cout, cout),
                "temb": {"w": normal(td, cout * 2), "b": np.zeros((cout * 2,), np.float32)},
                "skip": conv_init(rng, 1, cin, cout) if cin != cout else None}

    p: Dict[str, Any] = {
        "temb": {"w1": normal(td, td), "b1": np.zeros((td,), np.float32),
                 "w2": normal(td, td), "b2": np.zeros((td,), np.float32)},
        "conv_in": conv_init(rng, 3, 6, ch[0]),
        "down": [{"res": res(ch[max(0, i - 1)] if i else ch[0], ch[i]),
                  "pool": conv_init(rng, 3, ch[i], ch[i]) if i + 1 < len(ch) else None}
                 for i in range(len(ch))],
        "mid": res(ch[-1], ch[-1]),
        "style_proj": {"w": np.zeros((STYLE_DIM, td), np.float32),
                       "b": np.zeros((td,), np.float32)},
        "up": [{"res": res(ch[i] * 2, ch[max(0, i - 1)])} for i in range(len(ch) - 1, -1, -1)],
        "conv_out": {"w": np.zeros((3, 3, ch[0], 3), np.float32),
                     "b": np.zeros((3,), np.float32)},
    }
    return p


def jax_init(cfg: DiffusionSRConfig = DiffusionSRConfig(), seed: int = 0) -> Dict[str, Any]:
    """JAX's ``diffusion_sr.init(PRNGKey(seed), cfg)``: the same tree and
    draws (``ops.jax_random``; the normals within a few f32 ulps of
    XLA's, its erfinv on another log1p)."""
    keys = iter(jax_random.split(seed, 64))
    ch = [cfg.base_ch * m for m in cfg.ch_mults]
    td = cfg.time_dim

    def normal(key, *shape):
        return (jax_random.normal(key, shape) * np.float32(0.02)).numpy()

    def res(key, cin, cout):
        k = jax_random.split(key, 4)
        return {"conv1": jax_conv_init(k[0], 3, cin, cout),
                "conv2": jax_conv_init(k[1], 3, cout, cout),
                "temb": {"w": normal(k[2], td, cout * 2), "b": np.zeros((cout * 2,), np.float32)},
                "skip": jax_conv_init(k[3], 1, cin, cout) if cin != cout else None}

    p: Dict[str, Any] = {"temb": {"w1": normal(next(keys), td, td),
                                  "b1": np.zeros((td,), np.float32),
                                  "w2": normal(next(keys), td, td),
                                  "b2": np.zeros((td,), np.float32)},
                         "conv_in": jax_conv_init(next(keys), 3, 6, ch[0]),
                         "down": [], "mid": None, "up": []}
    for i in range(len(ch)):
        r = res(next(keys), ch[max(0, i - 1)] if i else ch[0], ch[i])
        pool = jax_conv_init(next(keys), 3, ch[i], ch[i]) if i + 1 < len(ch) else None
        p["down"].append({"res": r, "pool": pool})
    p["mid"] = res(next(keys), ch[-1], ch[-1])
    p["style_proj"] = {"w": np.zeros((STYLE_DIM, td), np.float32),
                       "b": np.zeros((td,), np.float32)}
    for i in range(len(ch) - 1, -1, -1):
        p["up"].append({"res": res(next(keys), ch[i] * 2, ch[max(0, i - 1)])})
    out = jax_conv_init(next(keys), 3, ch[0], 3)
    p["conv_out"] = {"w": out["w"] * np.float32(0.0), "b": out["b"] * np.float32(0.0)}
    return p


# -- the UNet ------------------------------------------------------------------------

def _conv(p, x: torch.Tensor, dtype: torch.dtype, stride: int = 1) -> torch.Tensor:
    """JAX's ``_conv`` -> ``dtype``: SAME padding (at stride 2 the extra
    row and column go below and right), products summed in f32 with the
    f32 bias, one rounding to ``dtype``. ``x`` may be f32 holding values
    that JAX's XLA feeds a convolution without rounding them (see
    ``denoise``)."""
    w = p["w"]
    k = w.shape[-1]
    xf = x.permute(0, 3, 1, 2).float()
    if stride == 1:
        pad = (k // 2,) * 4
    else:
        pads = []
        for n in (x.shape[2], x.shape[1]):               # width, then height
            total = max((-(-n // stride) - 1) * stride + k - n, 0)
            pads += [total // 2, total - total // 2]
        pad = tuple(pads)
    if any(pad):
        xf = F.pad(xf, pad)
    y = F.conv2d(xf, w.to(dtype).float(), stride=stride)
    y += p["b"].to(dtype).float().view(1, -1, 1, 1)
    return y.permute(0, 2, 3, 1).to(dtype)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands it: 1 / (1 + exp(-x)), each op
    rounded to x's dtype."""
    return 1 / (1 + torch.exp(-x))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * _sigmoid(x)


def _silu_to_conv(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` feeding a 3x3 conv: the product in f32, unrounded."""
    return x.float() * _sigmoid(x).float()


def _norm(x: torch.Tensor, eps: float = 1e-5, x32: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """Per-pixel norm over channels, no affine, as XLA computes JAX's: the
    mean (of ``x32``, x's unrounded f32 value, when given) and the
    deviation in x's dtype, the squares summed in f32, eps in x's
    dtype."""
    m = (x if x32 is None else x32).mean(-1, keepdim=True).to(x.dtype)
    d = x - m
    v = d.float().square().mean(-1, keepdim=True).to(x.dtype)
    return d * torch.rsqrt(v + torch.tensor(eps, dtype=x.dtype, device=x.device))


def _res(p, x: torch.Tensor, temb: torch.Tensor, x32: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """A residual block on x (the activation dtype; ``x32`` its unrounded
    f32 value when a residual sum made it) -> the f32 sum skip + h,
    unrounded (the caller rounds it, but for a 3x3 conv)."""
    dt = x.dtype
    h = _conv(p["conv1"], _silu_to_conv(_norm(x, x32=x32)), dt)
    ss = temb @ p["temb"]["w"].to(dt) + p["temb"]["b"].to(dt)
    scale, shift = ss[:, None, None, :].chunk(2, dim=-1)
    h = _conv(p["conv2"], _silu_to_conv(_norm(h) * (1 + scale) + shift), dt)
    skip = _conv(p["skip"], x, dt) if p["skip"] is not None else x
    return skip.float() + h.float()


def _resize_nearest(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(method="nearest")`` of NHWC x: source index
    floor((i + 0.5) * in / out)."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                         mode="nearest-exact").permute(0, 2, 3, 1)


def denoise(params, x_noisy: torch.Tensor, cond_up: torch.Tensor, t_frac: torch.Tensor,
            cfg: DiffusionSRConfig, style: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x0 predicted from the noisy HR image, the bicubic condition (both
    (B, H, W, 3) in [-1, 1], in the activation dtype) and t (B,) f32;
    ``style`` (B, 16) enters through the time embedding. -> f32.

    Rounding as XLA compiles JAX's bf16 graph on the CPU: each
    elementwise op rounds to the activation dtype, but a value that an
    elementwise op hands straight to a 3x3 convolution (the SiLU before
    each conv, a residual sum before the pool or the head) or to the
    caller's cast to f32 (the head's sum with the condition) stays
    unrounded f32, as does the middle block's channel mean of its input
    (the last level's residual sum); 1x1 convolutions (matrix products
    there) and the time embedding's products take rounded operands."""
    dt = x_noisy.dtype
    temb = _time_embed(t_frac, cfg.time_dim).to(dt)
    pt = params["temb"]
    temb = _silu(temb @ pt["w1"].to(dt) + pt["b1"].to(dt))
    temb = temb @ pt["w2"].to(dt) + pt["b2"].to(dt)
    if style is not None and "style_proj" in params:
        sp = params["style_proj"]
        temb = temb + (style.to(dt) @ sp["w"].to(dt) + sp["b"].to(dt))

    h = _conv(params["conv_in"], torch.cat([x_noisy, cond_up], -1), dt)
    skips = []
    for down in params["down"]:
        h32 = _res(down["res"], h, temb)
        h = h32.to(dt)
        skips.append(h)
        if down["pool"] is not None:
            h = _conv(down["pool"], h32, dt, stride=2)
    h = _res(params["mid"], h, temb, x32=h32).to(dt)
    for up in params["up"]:
        skip = skips.pop()
        if h.shape[1] != skip.shape[1]:
            h = _resize_nearest(h, skip.shape[1:3])
        h32 = _res(up["res"], torch.cat([h, skip], -1), temb)
        h = h32.to(dt)
    return cond_up.float() + _conv(params["conv_out"], h32, dt).float()


def _cubic_lowp(n_in: int, n_out: int, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(cubic_weights(n_in, n_out).astype(np.float32)).to(
        device=device, dtype=dtype)


def resize_bicubic(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``framewright_tpu.models.layers.resize_bicubic`` in x's dtype:
    ``jax.image.resize(method="cubic")`` with its weight matrices cast to
    x's dtype, each of the two products rounded to x's dtype, in the
    order JAX's ``einsum`` contracts them: the width first when the input
    is wider than high, else the height (an f32 x gives the f32 resize)."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    wh = _cubic_lowp(h, oh, x.dtype, x.device)                  # (oh, h)
    ww = _cubic_lowp(w, ow, x.dtype, x.device)                  # (ow, w)
    if w > h:
        return torch.einsum("nhpc,oh->nopc", torch.einsum("nhwc,pw->nhpc", x, ww), wh)
    return torch.einsum("nowc,pw->nopc", torch.einsum("nhwc,oh->nowc", x, wh), ww)


# -- DDIM --------------------------------------------------------------------------

def timesteps(cfg: DiffusionSRConfig, t_start_frac: float = 1.0) -> Tuple[int, np.ndarray]:
    """(n_steps, the descending integer timesteps t_start .. 0), as JAX
    computes them."""
    n_steps = max(1, int(cfg.steps * t_start_frac))
    t_hi = int((cfg.train_steps - 1) * t_start_frac)
    return n_steps, _linspace_f32(t_hi, 0, n_steps + 1).astype(np.int32)


def ddim_sample(params, lr: torch.Tensor, cfg: DiffusionSRConfig = DiffusionSRConfig(),
                seed: int = 0, init_hr: Optional[torch.Tensor] = None,
                t_start_frac: float = 1.0, style: Optional[torch.Tensor] = None,
                guidance_scale: float = 1.0, noise: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """lr (B, h, w, 3) in [0, 1] -> (B, h*s, w*s, 3) in [0, 1] in lr's
    dtype. ``seed`` is the JAX key's (``PRNGKey(seed)``); ``noise`` (f32,
    the output's shape) replaces its draw. ``init_hr`` with
    ``t_start_frac`` < 1 re-noises it part of the chain (SDEdit);
    ``style`` with ``guidance_scale`` != 1 runs classifier-free guidance."""
    b, h, w, _ = lr.shape
    hh, ww = h * cfg.scale, w * cfg.scale
    dev = lr.device
    cond = resize_bicubic(lr, (hh, ww)) * 2.0 - 1.0
    acp = alphas_cumprod(cfg.train_steps)
    n_steps, ts = timesteps(cfg, t_start_frac)
    a0 = torch.tensor(acp[ts[0]], device=dev)
    if noise is None:
        noise = jax_random.normal(seed, (b, hh, ww, 3), dev)
    if init_hr is not None:
        base = init_hr.float() * 2.0 - 1.0
        x = torch.sqrt(a0) * base + torch.sqrt(1 - a0) * noise
    else:
        x = noise
    if style is not None and guidance_scale != 1.0:
        def fn(xt, tf):
            c = cond.to(xt.dtype)
            x0_c = denoise(params, xt, c, tf, cfg, style=style)
            x0_u = denoise(params, xt, c, tf, cfg, style=None)
            g = torch.tensor(guidance_scale, dtype=torch.float32, device=dev)
            return x0_u + g * (x0_c - x0_u)
    else:
        def fn(xt, tf):
            return denoise(params, xt, cond.to(xt.dtype), tf, cfg, style=style)

    for i in range(n_steps):
        a_t = torch.tensor(acp[ts[i]], device=dev)
        a_n = torch.tensor(1.0 if i == n_steps - 1 else acp[ts[i + 1]], device=dev)
        tf = torch.full((b,), np.float32(ts[i]) / np.float32(cfg.train_steps),
                        dtype=torch.float32, device=dev)
        x0 = fn(x.to(cond.dtype), tf).clamp(-1.0, 1.0)
        eps = (x - torch.sqrt(a_t) * x0) * torch.rsqrt(1 - a_t)
        x = torch.sqrt(a_n) * x0 + torch.sqrt(1 - a_n) * eps
    return ((x + 1.0) / 2.0).clamp(0.0, 1.0).to(lr.dtype)


def apply(params, x: torch.Tensor, cfg: DiffusionSRConfig = DiffusionSRConfig()) -> torch.Tensor:
    """The registry forward: DDIM from ``PRNGKey(0)``'s noise."""
    return ddim_sample(params, x, cfg, seed=0)


def sample_video(params, frames: torch.Tensor, cfg: DiffusionSRConfig = DiffusionSRConfig(),
                 flow_fn: Optional[Callable] = None) -> torch.Tensor:
    """(B, T, h, w, 3) -> (B, T, H, W, 3): frame 0 from ``PRNGKey(0)``'s
    noise, each next frame from the (optionally ``flow_fn``-warped)
    previous output re-noised to ``propagate_t`` of the chain with
    ``PRNGKey(1)``'s."""
    outs = [ddim_sample(params, frames[:, 0], cfg, seed=0)]
    for t in range(1, frames.shape[1]):
        prev = outs[-1]
        warped = prev if flow_fn is None else flow_fn(prev, frames[:, t])
        outs.append(ddim_sample(params, frames[:, t], cfg, seed=1, init_hr=warped,
                                t_start_frac=cfg.propagate_t))
    return torch.stack(outs, 1)
