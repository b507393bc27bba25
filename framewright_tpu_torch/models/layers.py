"""Building blocks on NHWC tensors, with the JAX package's semantics
(``framewright_tpu.models.layers``): NHWC activations at the public
functions, OIHW weights inside, f32 accumulation in every conv."""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def conv_init(rng: np.random.Generator, k: int, c_in: int, c_out: int,
              gain: float = 1.0) -> Dict[str, np.ndarray]:
    """Seeded Kaiming-uniform init (torch Conv2d's default) in HWIO
    layout, with the bounds of ``framewright_tpu.models.layers.conv_init``."""
    bound = gain * np.sqrt(1.0 / (k * k * c_in)) * np.sqrt(3.0)
    w = rng.uniform(-bound, bound, (k, k, c_in, c_out)).astype(np.float32)
    b = rng.uniform(-bound, bound, (c_out,)).astype(np.float32)
    return {"w": w, "b": b}


def jax_conv_init(key, k: int, c_in: int, c_out: int, gain: float = 1.0
                  ) -> Dict[str, np.ndarray]:
    """JAX's ``conv_init(key, k, c_in, c_out)``, the same draws
    (``ops.jax_random``): HWIO ``w`` and ``b`` uniform in +-bound from the
    two keys of ``split(key)``."""
    from framewright_tpu_torch.ops import jax_random

    wkey, bkey = jax_random.split(key)
    bound = gain * np.sqrt(1.0 / (k * k * c_in)) * np.sqrt(3.0)
    return {"w": jax_random.uniform(wkey, (k, k, c_in, c_out), minval=-bound,
                                    maxval=bound).numpy(),
            "b": jax_random.uniform(bkey, (c_out,), minval=-bound, maxval=bound).numpy()}


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv, NHWC in and out, OIHW weights. Like the JAX
    ``conv2d``: weights cast to the activation dtype, products summed in
    f32, bias added in f32, one rounding to the activation dtype."""
    xf = x.permute(0, 3, 1, 2).float()
    wf = w.to(x.dtype).float()
    y = F.conv2d(xf, wf, padding=w.shape[-1] // 2)
    y += b.float().view(1, -1, 1, 1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def mul_weak(x: torch.Tensor, s: float) -> torch.Tensor:
    """x * s with JAX's weakly typed Python scalar: against a bf16 operand
    the scalar is bf16(s) and the product rounds to bf16."""
    if x.dtype == torch.bfloat16:
        return x * torch.tensor(s, dtype=x.dtype)
    return x * s


def lrelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, mul_weak(x, slope))


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Channel-wise PReLU of an NHWC tensor, as the JAX ``prelu``: alpha
    cast to x's dtype, so in bf16 the product rounds to bf16."""
    return torch.where(x >= 0, x, x * alpha.to(x.dtype))


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, H, W, C*r*r) -> (N, H*r, W*r, C), torch channel order
    (channel c*r*r + i*r + j lands at offset (i, j))."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, c // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, H*r, W*r, C) -> (N, H, W, C*r*r), torch channel order
    (channel c*r*r + i*r + j holds offset (i, j))."""
    n, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    x = x.reshape(n, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, h, w, c * r * r)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of an NHWC tensor."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def out_epilogue(out: torch.Tensor, out_mode: str, full_range: bool):
    """The uint8 output contract on a float RGB image (B, H, W, 3):
    exactly ``framewright_tpu.models.rrdb._out_epilogue`` (rgb_u8:
    round half up of clip(out) * 255; yuv420_u8: BT.601 Y, U, V with 2x2
    chroma means, limited range unless ``full_range``). The RRDB tail
    kernel computes it in its store; the SRVGG path applies it here."""
    y = out.float().clamp(0.0, 1.0).mul_(255.0)
    if out_mode == "rgb_u8":
        return torch.floor(y + 0.5).to(torch.uint8)
    if out_mode != "yuv420_u8":
        raise ValueError(f"out_mode must be rgb_u8 or yuv420_u8, got {out_mode!r}")
    kr, kg, kb = 0.299, 0.587, 0.114
    r, g, b = y[..., 0], y[..., 1], y[..., 2]
    yy = kr * r + kg * g + kb * b
    uu = (b - yy) / (2.0 * (1.0 - kb))
    vv = (r - yy) / (2.0 * (1.0 - kr))
    if not full_range:
        yy = yy * (219.0 / 255.0) + 16.0
        uu = uu * (224.0 / 255.0)
        vv = vv * (224.0 / 255.0)
    n, hh, ww = yy.shape
    uu = uu.reshape(n, hh // 2, 2, ww // 2, 2).mean(dim=(2, 4))
    vv = vv.reshape(n, hh // 2, 2, ww // 2, 2).mean(dim=(2, 4))
    return (torch.floor(yy + 0.5).clamp(0, 255).to(torch.uint8),
            torch.floor(uu + 128.5).clamp(0, 255).to(torch.uint8),
            torch.floor(vv + 128.5).clamp(0, 255).to(torch.uint8))


def cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) f64 weights of ``jax.image.resize(method="cubic")``
    along one axis (``jax._src.image.scale.compute_weight_mat``): Keys'
    cubic with a = -0.5 at half-pixel centres, its support stretched by
    n_in / n_out when downsampling (antialiasing); taps outside the
    input are dropped and each output's weights renormalised to sum to
    1."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T


@functools.lru_cache(maxsize=8)
def _cubic_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """``cubic_weights`` in f32 on ``device``, built once."""
    return torch.from_numpy(cubic_weights(n_in, n_out).astype(np.float32)).to(device)


def resize_bicubic(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``framewright_tpu.models.layers.resize_bicubic``, which is
    ``jax.image.resize(method="cubic")``: NHWC (N, h, w, C) -> (N, oh,
    ow, C) in f32 (results not clipped). Not ``F.interpolate(mode=
    "bicubic")``, whose a = -0.75 and clamped edges differ from it by up
    to ~19 LSB. Separable, as JAX's: two f32 matrix products with the
    ``cubic_weights`` matrices, width first (the caller sets the
    precision: TF32 off on the card)."""
    x = x.float()
    n, h, w, c = x.shape
    oh, ow = out_hw
    y = x.transpose(2, 3).reshape(n * h * c, w) @ _cubic_matrix(w, ow, x.device).t()
    y = _cubic_matrix(h, oh, x.device) @ y.view(n, h, c * ow)      # (n, oh, c ow)
    return y.view(n, oh, c, ow).transpose(2, 3)


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 2,
                     pad: int = 1, out_pad: int = 0) -> torch.Tensor:
    """Transposed conv with torch ``ConvTranspose2d`` semantics on NHWC x,
    weight in torch's (in, out, kh, kw) layout: the JAX
    ``conv2d_transpose`` with its HWIO kernel ``w.transpose(2, 3, 0, 1)``
    (kernel 4, stride 2, padding 1 is IFNet's 2x head). f32 sums."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b, stride=stride,
                           padding=pad, output_padding=out_pad)
    return y.permute(0, 2, 3, 1)


def resize_bilinear_nchw(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``resize_bilinear`` on an NCHW tensor."""
    if tuple(out_hw) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                         antialias=False)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``framewright_tpu.models.layers.resize_bilinear`` (align_corners
    False) on NHWC x: half-pixel source coordinates clamped at 0 and two
    taps a side, without antialiasing, downward (the JAX gather, which is
    torch's) and upward (``jax.image.resize(linear)``, whose dropped
    outside taps give torch's clamp)."""
    return resize_bilinear_nchw(x.permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)


def tree_to_torch(params, device, dtype: torch.dtype = torch.float32):
    """A JAX-layout parameter tree (nested dicts and lists of numpy arrays,
    None leaves kept) -> the same tree of tensors on ``device``: a conv's
    HWIO ``w`` (4-D) becomes OIHW, a stack of them (5-D, leading axis the
    stack) (n, O, I, kh, kw); floating leaves are cast to ``dtype``. Conv
    weights are stored channels-last (each of a stack's too), as ``conv``
    passes NHWC activations: cuDNN then runs NHWC implicit-GEMM kernels,
    not its NCHW FFT algorithms with their large workspaces."""
    def leaf(key, a):
        a = np.asarray(a)
        if key == "w" and a.ndim == 4:            # (kh, kw, I, O) -> (O, kh, kw, I)
            t = torch.from_numpy(np.array(a.transpose(3, 0, 1, 2), order="C"))
            t = t.permute(0, 3, 1, 2)
        elif key == "w" and a.ndim == 5:          # (n, kh, kw, I, O) -> (n, O, kh, kw, I)
            t = torch.from_numpy(np.array(a.transpose(0, 4, 1, 2, 3), order="C"))
            t = t.permute(0, 1, 4, 2, 3)
        else:
            t = torch.from_numpy(np.array(a, order="C"))
        return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key) for v in node]
        return None if node is None else leaf(key, node)

    return walk(params)


def conv(p, x: torch.Tensor, stride: int = 1, padding=None, groups: int = 1) -> torch.Tensor:
    """A convolution of NHWC ``x`` with ``p["w"]`` (OIHW, from
    ``tree_to_torch``) and ``p["b"]`` when present, in x's dtype: JAX's
    ``padding="SAME"`` at stride 1 (kh // 2, kw // 2) unless ``padding``
    (an int or an (h, w) pair) is given."""
    w = p["w"]
    if padding is None:
        padding = (w.shape[2] // 2, w.shape[3] // 2)
    b = p.get("b")
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), None if b is None else b.to(x.dtype),
                 stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ p["w"] + p["b"]`` (w (in, out), as the JAX trees hold it),
    in x's dtype."""
    return torch.matmul(x, p["w"].to(x.dtype)) + p["b"].to(x.dtype)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """The JAX transformers' LayerNorm over the last axis, in x's dtype
    (mean, the mean of squared deviations, ``rsqrt``), op for op."""
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * g.to(x.dtype) + b.to(x.dtype)
