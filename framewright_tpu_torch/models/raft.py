"""RAFT optical flow: the port of ``framewright_tpu.models.raft`` on NHWC
tensors, functional over the JAX package's parameter tree.

The published "basic" RAFT: feature and context encoders at 1/8
resolution (residual units; instance norm in the feature encoder, the
context encoder's BatchNorms folded into its convs when a checkpoint is
ported), the all-pairs correlation of the two feature maps as one matrix
product per image (the features rounded to bf16, products summed in f32,
as the JAX ``einsum`` with ``preferred_element_type=f32``; divided by
sqrt(C)), a 4-level pyramid of 2x2 average pools, a bilinear lookup of
(2r + 1)^2 taps a level around the current coordinates (zero outside,
``grid_sample`` with align_corners=True), ``iters`` SepConvGRU updates,
and the convex 8x upsampling of the last update's mask.

The correlation volume holds (H/8 x W/8)^2 f32 values a pair: 4.2 GB at
1080p, 5.6 GB with its pyramid; ``planner.raft_pair_bytes`` counts it and
the temporal denoiser runs as many pairs at once as the plan allows.

``port_state_dict`` reads princeton-vl's ``raft-things.pth`` (the
``module.`` prefix of a DataParallel save stripped; the context
encoder's BatchNorms folded into their convs, eval-mode exact): the
port's copy of ``framewright_tpu.models.torch_port.port_raft``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.models.layers import conv, conv_init


@dataclass(frozen=True)
class RAFTConfig:
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 12
    enc_dims: Tuple[int, int, int] = (64, 96, 128)
    fnet_out: int = 256


# -- parameters ----------------------------------------------------------------

def init_params(cfg: RAFTConfig = RAFTConfig(), seed: int = 0) -> Dict[str, Any]:
    """Seeded random parameters in the JAX ``raft.init`` shapes (a
    stand-in for tests and the card's smoke; drawn with numpy)."""
    rng = np.random.default_rng(seed)

    def unit(cin, cout):
        p = {"conv1": conv_init(rng, 3, cin, cout), "conv2": conv_init(rng, 3, cout, cout)}
        if cin != cout:
            p["down"] = conv_init(rng, 1, cin, cout)
        return p

    def encoder(out_dim):
        d1, d2, d3 = cfg.enc_dims
        return {"conv1": conv_init(rng, 7, 3, d1),
                "layer1": [unit(d1, d1), unit(d1, d1)],
                "layer2": [unit(d1, d2), unit(d2, d2)],
                "layer3": [unit(d2, d3), unit(d3, d3)],
                "conv2": conv_init(rng, 1, d3, out_dim)}

    hd = cfg.hidden_dim
    gru_in = hd + cfg.context_dim + hd
    cor_planes = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2

    def sep(kh, kw):
        bound = float(3.0 / (kh * kw * gru_in)) ** 0.5
        return {"w": rng.uniform(-bound, bound, (kh, kw, gru_in, hd)).astype(np.float32),
                "b": rng.uniform(-bound, bound, (hd,)).astype(np.float32)}

    update = {"convc1": conv_init(rng, 1, cor_planes, 256),
              "convc2": conv_init(rng, 3, 256, 192),
              "convf1": conv_init(rng, 7, 2, 128),
              "convf2": conv_init(rng, 3, 128, 64),
              "conv": conv_init(rng, 3, 192 + 64, hd - 2)}
    for a in ("1", "2"):
        for g in ("z", "r", "q"):
            update[f"conv{g}{a}"] = sep(*((1, 5) if a == "1" else (5, 1)))
    update.update(flow1=conv_init(rng, 3, hd, 256), flow2=conv_init(rng, 3, 256, 2),
                  mask1=conv_init(rng, 3, hd, 256), mask2=conv_init(rng, 1, 256, 64 * 9))
    return {"fnet": encoder(cfg.fnet_out), "cnet": encoder(hd + cfg.context_dim),
            "update": update}


def port_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """princeton-vl RAFT state dict -> the JAX ``raft`` tree (numpy):
    OIHW -> HWIO, the context encoder's BatchNorms folded (``norm3`` read
    as its ``downsample.1`` copy)."""
    sd = {k[len("module."):] if k.startswith("module.") else k: np.asarray(
        v.detach().cpu().float().numpy() if hasattr(v, "detach") else v, np.float32)
        for k, v in sd.items()}
    eps = 1e-5

    def conv_p(prefix: str, bn: str = "") -> Dict[str, np.ndarray]:
        w = sd[prefix + ".weight"].transpose(2, 3, 1, 0)
        b = sd[prefix + ".bias"]
        if bn:
            sc = sd[bn + ".weight"] / np.sqrt(np.maximum(sd[bn + ".running_var"], 0.0) + eps)
            w, b = w * sc, b * sc + sd[bn + ".bias"] - sd[bn + ".running_mean"] * sc
        return {"w": w, "b": b}

    def encoder(pre: str, batch: bool) -> Dict[str, Any]:
        def n(p, suffix):
            return f"{p}.{suffix}" if batch else ""

        def unit(p: str, strided: bool) -> Dict[str, Any]:
            out = {"conv1": conv_p(f"{p}.conv1", n(p, "norm1")),
                   "conv2": conv_p(f"{p}.conv2", n(p, "norm2"))}
            if strided:
                out["down"] = conv_p(f"{p}.downsample.0", n(p, "downsample.1"))
            return out

        return {"conv1": conv_p(f"{pre}.conv1", n(pre, "norm1")),
                "layer1": [unit(f"{pre}.layer1.0", False), unit(f"{pre}.layer1.1", False)],
                "layer2": [unit(f"{pre}.layer2.0", True), unit(f"{pre}.layer2.1", False)],
                "layer3": [unit(f"{pre}.layer3.0", True), unit(f"{pre}.layer3.1", False)],
                "conv2": conv_p(f"{pre}.conv2")}

    u = "update_block"
    names = {"convc1": "encoder.convc1", "convc2": "encoder.convc2",
             "convf1": "encoder.convf1", "convf2": "encoder.convf2", "conv": "encoder.conv",
             "flow1": "flow_head.conv1", "flow2": "flow_head.conv2",
             "mask1": "mask.0", "mask2": "mask.2"}
    names.update({f"conv{g}{a}": f"gru.conv{g}{a}" for g in "zrq" for a in "12"})
    return {"fnet": encoder("fnet", False), "cnet": encoder("cnet", True),
            "update": {k: conv_p(f"{u}.{v}") for k, v in names.items()}}


# -- encoders --------------------------------------------------------------------

def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean((1, 2), keepdim=True)
    var = x.var((1, 2), keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps)


def _res_unit(p, x: torch.Tensor, stride: int, norm: bool) -> torch.Tensor:
    def n(v):
        return _instance_norm(v) if norm else v

    y = F.relu(n(conv(p["conv1"], x, stride=stride, padding=1)))
    y = F.relu(n(conv(p["conv2"], y)))
    if "down" in p:
        x = n(conv(p["down"], x, stride=stride, padding=0))
    return F.relu(x + y)


def _encoder(p, x: torch.Tensor, norm: bool) -> torch.Tensor:
    y = conv(p["conv1"], x, stride=2, padding=3)
    y = F.relu(_instance_norm(y) if norm else y)
    for layer, stride in ((p["layer1"], 1), (p["layer2"], 2), (p["layer3"], 2)):
        y = _res_unit(layer[0], y, stride, norm)
        y = _res_unit(layer[1], y, 1, norm)
    return conv(p["conv2"], y)


# -- correlation ------------------------------------------------------------------

def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """All-pairs correlation of (B, h, w, C) feature maps -> ``levels``
    volumes (B*h*w, h_l, w_l) f32: the features rounded to bf16, their
    products summed in f32 (exact products of bf16 values), / sqrt(C)."""
    b, h, w, c = fmap1.shape
    f1 = fmap1.reshape(b, h * w, c).to(torch.bfloat16).float()
    f2 = fmap2.reshape(b, h * w, c).to(torch.bfloat16).float()
    # one volume, scaled in place (a pair's is 4.2 GB at 1080p)
    vol = torch.bmm(f1, f2.transpose(1, 2)).div_(np.float32(np.sqrt(np.float32(c))))
    vol = vol.reshape(b * h * w, 1, h, w)
    pyramid = [vol[:, 0]]
    for _ in range(levels - 1):
        # 2x2 means, an odd last row or column dropped (JAX's VALID window)
        vol = F.avg_pool2d(vol, 2) if min(vol.shape[2:]) >= 2 else vol[:, :, :0, :0]
        pyramid.append(vol[:, 0])
    return pyramid


def _bilinear_gather(vol: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """Sample (N, h_l, w_l) volumes at float coordinates (N, P), zero
    outside (grid_sample, align_corners=True)."""
    n, hl, wl = vol.shape
    if hl * wl == 0:                     # a level pooled away: every tap outside
        return torch.zeros_like(cx)
    x0, y0 = torch.floor(cx), torch.floor(cy)
    fx, fy = cx - x0, cy - y0
    flat = vol.reshape(n, hl * wl)
    x0i, y0i = x0.long(), y0.long()

    def tap(yi, xi, wgt):
        valid = (yi >= 0) & (yi < hl) & (xi >= 0) & (xi < wl)
        idx = yi.clamp(0, hl - 1) * wl + xi.clamp(0, wl - 1)
        return torch.gather(flat, 1, idx) * wgt * valid.to(vol.dtype)

    return (tap(y0i, x0i, (1 - fy) * (1 - fx)) + tap(y0i, x0i + 1, (1 - fy) * fx)
            + tap(y0i + 1, x0i, fy * (1 - fx)) + tap(y0i + 1, x0i + 1, fy * fx))


def corr_lookup(pyramid: List[torch.Tensor], coords: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, h, w, levels * (2r + 1)^2) correlation features around
    ``coords`` (B, h, w, 2) (x, y) in level-0 pixels."""
    b, h, w, _ = coords.shape
    n = b * h * w
    d = torch.arange(-radius, radius + 1, dtype=coords.dtype, device=coords.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    dx, dy = dx.reshape(1, -1), dy.reshape(1, -1)
    cx, cy = coords[..., 0].reshape(n, 1), coords[..., 1].reshape(n, 1)
    outs = [_bilinear_gather(vol, cx / 2.0 ** lvl + dx, cy / 2.0 ** lvl + dy)
            for lvl, vol in enumerate(pyramid)]
    return torch.cat(outs, dim=1).reshape(b, h, w, -1)


# -- update block ------------------------------------------------------------------

def _conv_gemm(p, x: torch.Tensor) -> torch.Tensor:
    """A stride-1 SAME convolution of the update block on NHWC x as one
    matrix product over the kh x kw shifted copies of x (f32 sums of the
    same products as the convolution's). On the card cuDNN picks its f32
    FFT algorithms for these shapes (~1 s a 1080p pair's 8 updates) when
    TF32 is off; the product is cuBLAS's f32 GEMM."""
    w = p["w"]                                       # (O, I, kh, kw)
    o, i, kh, kw = w.shape
    h, wd = x.shape[1:3]
    if kh == kw == 1:
        cols = x
    else:
        xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
        cols = torch.cat([xp[:, a:a + h, b:b + wd] for a in range(kh) for b in range(kw)],
                         dim=-1)
    # cols' channel (a kw + b) I + c holds tap (a, b) of channel c
    wm = w.permute(2, 3, 1, 0).reshape(kh * kw * i, o).to(x.dtype)
    return torch.matmul(cols, wm) + p["b"].to(x.dtype)


def _update(p, net: torch.Tensor, inp: torch.Tensor, corr: torch.Tensor,
            flow: torch.Tensor):
    conv = _conv_gemm
    c = F.relu(conv(p["convc2"], F.relu(conv(p["convc1"], corr))))
    f = F.relu(conv(p["convf2"], F.relu(conv(p["convf1"], flow))))
    m = F.relu(conv(p["conv"], torch.cat([c, f], -1)))
    x = torch.cat([inp, m, flow], -1)
    for a in ("1", "2"):                               # SepConvGRU: 1x5, then 5x1
        hx = torch.cat([net, x], -1)
        z = torch.sigmoid(conv(p["convz" + a], hx))
        r = torch.sigmoid(conv(p["convr" + a], hx))
        q = torch.tanh(conv(p["convq" + a], torch.cat([r * net, x], -1)))
        net = (1 - z) * net + z * q
    delta = conv(p["flow2"], F.relu(conv(p["flow1"], net)))
    mask = 0.25 * conv(p["mask2"], F.relu(conv(p["mask1"], net)))
    return net, mask, delta


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """8x upsample of (B, h, w, 2) flow by the softmax-weighted 3x3
    neighbourhood of the scaled coarse flow."""
    b, h, w, _ = flow.shape
    mask = torch.softmax(mask.reshape(b, h, w, 9, 8, 8), dim=3)
    f = F.pad((8.0 * flow).permute(0, 3, 1, 2), (1, 1, 1, 1)).permute(0, 2, 3, 1)
    nbhd = torch.stack([f[:, i:i + h, j:j + w, :] for i in range(3) for j in range(3)], dim=3)
    up = torch.einsum("bhwkuv,bhwkc->bhwuvc", mask, nbhd)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, 2)


def apply(params, img0: torch.Tensor, img1: torch.Tensor,
          cfg: RAFTConfig = RAFTConfig()) -> torch.Tensor:
    """Flow img0 -> img1 in pixels, (B, H, W, 2) (x, y); inputs (B, H, W,
    3) in [0, 1], sides multiples of 8."""
    b = img0.shape[0]
    fmaps = _encoder(params["fnet"], torch.cat([img0, img1], 0) * 2.0 - 1.0, norm=True)
    ctx = _encoder(params["cnet"], img0 * 2.0 - 1.0, norm=False)
    net = torch.tanh(ctx[..., :cfg.hidden_dim])
    inp = F.relu(ctx[..., cfg.hidden_dim:])
    pyramid = corr_pyramid(fmaps[:b], fmaps[b:], cfg.corr_levels)
    del fmaps
    h8, w8 = net.shape[1:3]
    ys, xs = torch.meshgrid(torch.arange(h8, dtype=torch.float32, device=img0.device),
                            torch.arange(w8, dtype=torch.float32, device=img0.device),
                            indexing="ij")
    coords0 = torch.stack([xs, ys], -1).expand(b, h8, w8, 2)
    coords1 = coords0
    mask = None
    for _ in range(cfg.iters):
        corr = corr_lookup(pyramid, coords1, cfg.corr_radius)
        net, mask, delta = _update(params["update"], net, inp, corr.to(net.dtype),
                                   (coords1 - coords0).to(net.dtype))
        coords1 = coords1 + delta.float()
    return convex_upsample((coords1 - coords0).float(), mask.float())


def estimate_flow(params, img0: torch.Tensor, img1: torch.Tensor,
                  cfg: RAFTConfig = RAFTConfig()) -> torch.Tensor:
    """``apply`` at any size: edge-padded to multiples of 8, cropped back
    (``warp(img1, flow) ~ img0``)."""
    h, w = img0.shape[1:3]
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    if (hp, wp) != (h, w):
        def pad(x):
            return F.pad(x.permute(0, 3, 1, 2), (0, wp - w, 0, hp - h),
                         mode="replicate").permute(0, 2, 3, 1)
        img0, img1 = pad(img0), pad(img1)
    return apply(params, img0, img1, cfg)[:, :h, :w, :]
