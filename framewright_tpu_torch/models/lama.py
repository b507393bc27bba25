"""LaMa-class inpainting (an FFC ResNet): the port of
``framewright_tpu.models.lama`` on NHWC tensors, functional over the JAX
package's parameter tree, in f32.

The image times (1 - mask) concatenated with the mask; a reflect-padded
7x7 head with BatchNorm (stored inference affine: gamma, beta, mean,
var) and ReLU; ``n_down`` stride-2 3x3 convs; ``n_blocks`` residual
pairs of Fast Fourier Convolutions on (local, global) channel splits (the
global branch: 1x1 conv, BN, ReLU, then the Fourier unit, an ortho
``rfft2``, a 1x1 conv on the stacked real and imaginary parts, BN, ReLU,
``irfft2``, added to its input, then a 1x1 conv); ``n_down`` transposed
3x3 stride-2 convs (output padding 1) with BN and ReLU; a reflect-padded
7x7 tail, the sigmoid, and the composite through the mask. The FFTs run
with ``torch.fft`` on the tensor's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.models.layers import conv_init


@dataclass(frozen=True)
class LamaConfig:
    ngf: int = 64
    n_down: int = 3
    n_blocks: int = 9
    global_ratio: float = 0.5   # channel fraction in the global branch
    in_ch: int = 4              # RGB + mask


def config_from_params(params: Dict[str, Any]) -> LamaConfig:
    """The architecture of a parameter tree (released checkpoints differ:
    LaMa-Fourier 9 blocks, Big-LaMa 18; both ratio 0.75)."""
    head_w = params["head"]["w"]
    blk = params["blocks"][0]["ffc1"]
    cl = int(blk["bn_l"]["gamma"].shape[0])
    cg = int(blk["bn_g"]["gamma"].shape[0])
    return LamaConfig(ngf=int(head_w.shape[-1]), n_down=len(params["downs"]),
                      n_blocks=len(params["blocks"]), global_ratio=cg / (cl + cg),
                      in_ch=int(head_w.shape[-2]))


def init_params(cfg: LamaConfig = LamaConfig(), seed: int = 0) -> Dict[str, Any]:
    """Seeded random parameters in the JAX ``lama.init`` shapes (numpy;
    BN at its identity statistics), for a stand-in ``big-lama.npz``."""
    rng = np.random.default_rng(seed)

    def bn(c):
        return {"gamma": np.ones((c,), np.float32), "beta": np.zeros((c,), np.float32),
                "mean": np.zeros((c,), np.float32), "var": np.ones((c,), np.float32)}

    def ffc(cin, cout):
        cg_in, cg_out = int(cin * cfg.global_ratio), int(cout * cfg.global_ratio)
        cl_in, cl_out = cin - cg_in, cout - cg_out
        p: Dict[str, Any] = {}
        if cl_in and cl_out:
            p["ll"] = conv_init(rng, 3, cl_in, cl_out)
        if cl_in and cg_out:
            p["lg"] = conv_init(rng, 3, cl_in, cg_out)
        if cg_in and cl_out:
            p["gl"] = conv_init(rng, 3, cg_in, cl_out)
        if cg_in and cg_out:
            mid = cg_out // 2
            p["gg"] = {"conv1": conv_init(rng, 1, cg_in, mid), "bn1": bn(mid),
                       "fu": {"conv": conv_init(rng, 1, 2 * mid, 2 * mid), "bn": bn(2 * mid)},
                       "conv2": conv_init(rng, 1, mid, cg_out)}
        p["bn_l"] = bn(cl_out) if cl_out else None
        p["bn_g"] = bn(cg_out) if cg_out else None
        return p

    ngf = cfg.ngf
    params: Dict[str, Any] = {"head": conv_init(rng, 7, cfg.in_ch, ngf), "head_bn": bn(ngf),
                              "downs": [], "blocks": [], "ups": []}
    ch = ngf
    for _ in range(cfg.n_down):
        params["downs"].append({"conv": conv_init(rng, 3, ch, ch * 2), "bn": bn(ch * 2)})
        ch *= 2
    for _ in range(cfg.n_blocks):
        params["blocks"].append({"ffc1": ffc(ch, ch), "ffc2": ffc(ch, ch)})
    for _ in range(cfg.n_down):
        params["ups"].append({"conv": conv_init(rng, 3, ch, ch // 2), "bn": bn(ch // 2)})
        ch //= 2
    params["tail"] = conv_init(rng, 7, ngf, 3)
    return params


def _bn(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    inv = torch.rsqrt(p["var"] + eps)
    return (x - p["mean"]) * inv * p["gamma"] + p["beta"]


def _conv(p, x: torch.Tensor, stride: int = 1, reflect: int = 0) -> torch.Tensor:
    """NHWC conv in f32: ``reflect`` pads that much by reflection, then a
    VALID conv; otherwise k // 2 zeros a side (SAME at stride 1, torch's
    padding at stride 2); the bias when the tree has one."""
    w = p["w"]
    xc = x.permute(0, 3, 1, 2)
    if reflect:
        xc = F.pad(xc, (reflect,) * 4, mode="reflect")
        pad = 0
    else:
        pad = w.shape[-1] // 2
    y = F.conv2d(xc, w, p.get("b"), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _fourier_unit(p, x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    fx = torch.fft.rfft2(x.float(), dim=(1, 2), norm="ortho")
    z = torch.cat([fx.real, fx.imag], dim=-1)
    z = torch.relu(_bn(p["bn"], _conv(p["conv"], z)))
    real, imag = z.chunk(2, dim=-1)
    y = torch.fft.irfft2(torch.complex(real.contiguous(), imag.contiguous()), s=(h, w),
                         dim=(1, 2), norm="ortho")
    return y.to(x.dtype)


def _spectral_transform(p, x: torch.Tensor) -> torch.Tensor:
    y = torch.relu(_bn(p["bn1"], _conv(p["conv1"], x)))
    y = y + _fourier_unit(p["fu"], y)
    return _conv(p["conv2"], y)


def _ffc(p, xl: torch.Tensor, xg: Optional[torch.Tensor]):
    out_l = out_g = 0.0
    if "ll" in p:
        out_l = out_l + _conv(p["ll"], xl)
    if "gl" in p and xg is not None:
        out_l = out_l + _conv(p["gl"], xg)
    if "lg" in p:
        out_g = out_g + _conv(p["lg"], xl)
    if "gg" in p and xg is not None:
        out_g = out_g + _spectral_transform(p["gg"], xg)
    yl = torch.relu(_bn(p["bn_l"], out_l)) if p["bn_l"] is not None else None
    yg = torch.relu(_bn(p["bn_g"], out_g)) if p["bn_g"] is not None else None
    return yl, yg


def _conv_transpose(p, x: torch.Tensor) -> torch.Tensor:
    """torch's ConvTranspose2d(3, stride 2, padding 1, output_padding 1)
    on NHWC x (JAX's ``conv2d_transpose``: the input dilated by zeros,
    correlated with the flipped kernel), as its four output phases, each a
    forward convolution of x with the taps that land on it: output (2m, 2n)
    takes the centre tap on x[m, n]; an odd row or column takes taps 2 and
    0 on x[m] and x[m + 1] (zero past the edge). cuDNN's transposed
    convolution (a backward-data algorithm) may sum with atomics and
    differ from run to run; its forward ones do not. The tree's kernel is
    held OIHW by ``tree_to_torch``."""
    w = p["w"]                                       # (out, in, 3, 3)
    bias = p.get("b")
    xc = x.permute(0, 3, 1, 2)
    _, _, h, wd = xc.shape
    xp = F.pad(xc, (0, 1, 0, 1))
    odd = [2, 0]
    ee = F.conv2d(xc, w[:, :, 1:2, 1:2], bias)
    eo = F.conv2d(xp[:, :, :h], w[:, :, 1:2][..., odd], bias)
    oe = F.conv2d(xp[..., :wd], w[:, :, odd][..., 1:2], bias)
    oo = F.conv2d(xp, w[:, :, odd][..., odd], bias)
    even_rows = torch.stack([ee, eo], -1).flatten(-2)      # (B, C, h, 2w)
    odd_rows = torch.stack([oe, oo], -1).flatten(-2)
    y = torch.stack([even_rows, odd_rows], -2).flatten(-3, -2)   # (B, C, 2h, 2w)
    return y.permute(0, 2, 3, 1)


def apply(params, image: torch.Tensor, mask: torch.Tensor,
          cfg: LamaConfig = LamaConfig()) -> torch.Tensor:
    """image (B, H, W, 3) in [0, 1], mask (B, H, W, 1) with 1 = hole, H and
    W multiples of 2 ** n_down -> the composite: holes filled, the rest
    passed through."""
    x = torch.cat([image * (1.0 - mask), mask], dim=-1)
    y = torch.relu(_bn(params["head_bn"], _conv(params["head"], x, reflect=3)))
    for d in params["downs"]:
        y = torch.relu(_bn(d["bn"], _conv(d["conv"], y, stride=2)))
    cg = int(y.shape[-1] * cfg.global_ratio)
    cl = y.shape[-1] - cg
    yl, yg = y[..., :cl], y[..., cl:]
    for blk in params["blocks"]:
        rl, rg = yl, yg
        yl, yg = _ffc(blk["ffc1"], yl, yg)
        yl, yg = _ffc(blk["ffc2"], yl, yg)
        yl = rl + yl
        yg = rg + yg
    y = torch.cat([yl, yg], dim=-1)
    for u in params["ups"]:
        y = torch.relu(_bn(u["bn"], _conv_transpose(u["conv"], y)))
    out = torch.sigmoid(_conv(params["tail"], y, reflect=3))
    return image * (1.0 - mask) + out * mask


def apply_padded(params, image: torch.Tensor, mask: torch.Tensor,
                 cfg: LamaConfig = LamaConfig()) -> torch.Tensor:
    """``apply`` on any H, W: the image reflect-padded, the mask
    zero-padded below and right to multiples of 2 ** n_down, the result
    cropped back."""
    div = 2 ** cfg.n_down
    _, h, w, _ = image.shape
    hp, wp = -(-h // div) * div, -(-w // div) * div
    if (hp, wp) != (h, w):
        image = F.pad(image.permute(0, 3, 1, 2), (0, wp - w, 0, hp - h),
                      mode="reflect").permute(0, 2, 3, 1)
        mask = F.pad(mask, (0, 0, 0, wp - w, 0, hp - h))
    return apply(params, image, mask, cfg)[:, :h, :w, :]


def infer_arch(sd) -> Dict[str, Any]:
    """(ngf, n_down, n_blocks, ratio) of saic-mdal's FFCResNetGenerator
    state dict (LaMa-Fourier: 9 blocks; Big-LaMa: 18; both ratio 0.75):
    the port's copy of ``framewright_tpu.models.torch_port.infer_lama_arch``."""
    import re

    from framewright_tpu_torch.errors import InputError

    idx = sorted({int(m.group(1)) for k in sd
                  for m in [re.match(r"model\.(\d+)\.conv1\.ffc\.", k)] if m})
    if not idx:
        raise InputError("not an FFCResNetGenerator state dict (no model.{i}.conv1.ffc keys)")
    n_down = idx[0] - 2
    last = 1 + n_down
    cl = int(np.shape(sd[f"model.{last}.ffc.convl2l.weight"])[0])
    cg = int(np.shape(sd[f"model.{last}.ffc.convl2g.weight"])[0])
    return {"ngf": int(np.shape(sd["model.1.ffc.convl2l.weight"])[0]), "n_down": n_down,
            "n_blocks": len(idx), "ratio": cg / (cl + cg)}


def port_state_dict(sd) -> Dict[str, Any]:
    """saic-mdal's FFCResNetGenerator state dict (``model.{i}.*``) -> the
    JAX ``lama`` tree (numpy, dtypes kept), its widths from ``infer_arch``:
    the port's copy of ``framewright_tpu.models.torch_port.port_lama``.
    (1) The upstream FourierUnit's 1x1 conv takes interleaved (real, imag)
    channels where the tree stacks all reals, then all imaginaries: its
    rows, columns and BN are permuted. (2) The last down FFC's l2l and l2g
    convs (and BNs) are concatenated into one down conv. (3) A
    ConvTranspose2d's (in, out, 3, 3) kernel is stored (3, 3, in, out),
    unflipped (``_conv_transpose`` flips it)."""
    from framewright_tpu_torch.models.layers import np_leaf, port_conv

    arch = infer_arch(sd)
    n_down, ratio = arch["n_down"], arch["ratio"]

    def bn(prefix):
        return {"gamma": np_leaf(sd[f"{prefix}.weight"]), "beta": np_leaf(sd[f"{prefix}.bias"]),
                "mean": np_leaf(sd[f"{prefix}.running_mean"]),
                "var": np_leaf(sd[f"{prefix}.running_var"])}

    def fu(prefix, c):
        perm = np.array([2 * j for j in range(c)] + [2 * j + 1 for j in range(c)])
        w = np_leaf(sd[f"{prefix}.conv_layer.weight"])[:, :, 0, 0]
        return {"conv": {"w": w[np.ix_(perm, perm)].T[None, None]},
                "bn": {k: v[perm] for k, v in bn(f"{prefix}.bn").items()}}

    def ffc(prefix, ch):
        f = f"{prefix}.ffc"
        return {"ll": port_conv(sd, f"{f}.convl2l", bias=False),
                "lg": port_conv(sd, f"{f}.convl2g", bias=False),
                "gl": port_conv(sd, f"{f}.convg2l", bias=False),
                "gg": {"conv1": port_conv(sd, f"{f}.convg2g.conv1.0", bias=False),
                       "bn1": bn(f"{f}.convg2g.conv1.1"),
                       "fu": fu(f"{f}.convg2g.fu", int(ch * ratio) // 2),
                       "conv2": port_conv(sd, f"{f}.convg2g.conv2", bias=False)},
                "bn_l": bn(f"{prefix}.bn_l"), "bn_g": bn(f"{prefix}.bn_g")}

    params: Dict[str, Any] = {"head": port_conv(sd, "model.1.ffc.convl2l", bias=False),
                              "head_bn": bn("model.1.bn_l"), "downs": [], "blocks": [],
                              "ups": []}
    ch = arch["ngf"]
    for i in range(n_down):
        m = f"model.{2 + i}"
        if i == n_down - 1:              # the transition FFC: l2l | l2g
            wl = port_conv(sd, f"{m}.ffc.convl2l", bias=False)["w"]
            wg = port_conv(sd, f"{m}.ffc.convl2g", bias=False)["w"]
            bl, bg = bn(f"{m}.bn_l"), bn(f"{m}.bn_g")
            params["downs"].append({"conv": {"w": np.concatenate([wl, wg], axis=-1)},
                                    "bn": {k: np.concatenate([bl[k], bg[k]]) for k in bl}})
        else:
            params["downs"].append({"conv": port_conv(sd, f"{m}.ffc.convl2l", bias=False),
                                    "bn": bn(f"{m}.bn_l")})
        ch *= 2
    for j in range(arch["n_blocks"]):
        m = f"model.{2 + n_down + j}"
        params["blocks"].append({"ffc1": ffc(f"{m}.conv1", ch), "ffc2": ffc(f"{m}.conv2", ch)})
    u0 = 3 + n_down + arch["n_blocks"]
    for i in range(n_down):
        wt = np_leaf(sd[f"model.{u0 + 3 * i}.weight"])             # (in, out, 3, 3)
        params["ups"].append({"conv": {"w": np.transpose(wt, (2, 3, 0, 1)),
                                       "b": np_leaf(sd[f"model.{u0 + 3 * i}.bias"])},
                              "bn": bn(f"model.{u0 + 3 * i + 1}")})
    params["tail"] = port_conv(sd, f"model.{u0 + 3 * n_down + 1}")
    return params
