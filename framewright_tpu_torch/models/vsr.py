"""BasicVSR: the port of ``framewright_tpu.models.vsr`` on NHWC tensors,
functional over the JAX package's parameter tree.

SpyNet flows between neighbouring frames (ImageNet-normalised inputs, a
``spynet_levels`` pyramid of 2x2 means, coarse to fine: the flow
upsampled bilinearly with align_corners=True and doubled, the support
frame warped with border padding, five 7x7 convs with ReLU on [ref,
warped, flow] adding to the flow); backward then forward recurrent
propagation (each step warps the carried features by the step's flow
with zero padding, mmediting's, concatenates the frame and runs the
trunk: a 3x3 conv with leaky ReLU 0.1 and ``num_blocks`` residual blocks
conv-ReLU-conv, the weights stacked on a leading axis as the JAX tree
holds them); the fusion 1x1 over [backward, forward], two pixel-shuffle
2x stages, conv_hr and conv_last with leaky ReLU 0.1, added to the
bilinear 4x upscale of the frame. Sides must be multiples of
2^(spynet_levels - 1) (the VSR processor pads to 32).

The upsampling tail runs one frame at a time (its 4x intermediates are
the largest buffers). ``port_state_dict`` reads mmediting's BasicVSR
checkpoint (``generator.`` prefix, both SpyNet namings): the port's copy
of ``framewright_tpu.models.torch_port.port_basicvsr``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.errors import InputError
from framewright_tpu_torch.models.layers import conv, conv_init, pixel_shuffle, resize_bilinear
from framewright_tpu_torch.ops.warp import flow_warp

_SPY_MEAN = (0.485, 0.456, 0.406)
_SPY_STD = (0.229, 0.224, 0.225)
_SPY_CHANNELS = ((8, 32), (32, 64), (64, 32), (32, 16), (16, 2))


@dataclass(frozen=True)
class BasicVSRConfig:
    mid_channels: int = 64
    num_blocks: int = 30
    scale: int = 4
    spynet_levels: int = 6


def init_params(cfg: BasicVSRConfig = BasicVSRConfig(), seed: int = 0) -> Dict[str, Any]:
    """Seeded random parameters in the JAX ``vsr.init`` shapes (the
    trunks' blocks stacked; drawn with numpy)."""
    rng = np.random.default_rng(seed)
    mid = cfg.mid_channels

    def trunk():
        def stack():
            ps = [conv_init(rng, 3, mid, mid) for _ in range(cfg.num_blocks)]
            return {"w": np.stack([p["w"] for p in ps]), "b": np.stack([p["b"] for p in ps])}

        return {"head": conv_init(rng, 3, 3 + mid, mid), "conv1": stack(), "conv2": stack()}

    return {"spynet": [[conv_init(rng, 7, ci, co) for ci, co in _SPY_CHANNELS]
                       for _ in range(cfg.spynet_levels)],
            "backward": trunk(), "forward": trunk(),
            "fusion": conv_init(rng, 1, 2 * mid, mid),
            "upsample1": conv_init(rng, 3, mid, mid * 4),
            "upsample2": conv_init(rng, 3, mid, 64 * 4),
            "conv_hr": conv_init(rng, 3, 64, 64), "conv_last": conv_init(rng, 3, 64, 3)}


def port_state_dict(sd: Mapping[str, Any], num_blocks: int = 30,
                    spynet_levels: int = 6) -> Dict[str, Any]:
    """mmediting's BasicVSR state dict -> the JAX ``vsr`` tree (numpy)."""
    sd = {k: np.asarray(v.detach().cpu().float().numpy() if hasattr(v, "detach") else v,
                        np.float32) for k, v in sd.items()}
    if any(k.startswith("generator.") for k in sd):
        sd = {k[len("generator."):]: v for k, v in sd.items() if k.startswith("generator.")}

    def conv_p(*prefixes):
        for p in prefixes:
            if p + ".weight" in sd:
                return {"w": sd[p + ".weight"].transpose(2, 3, 1, 0), "b": sd[p + ".bias"]}
        raise InputError(f"BasicVSR checkpoint: no conv at any of {prefixes}")

    def trunk(prefix):
        blocks = [(conv_p(f"{prefix}.main.2.{i}.conv1"), conv_p(f"{prefix}.main.2.{i}.conv2"))
                  for i in range(num_blocks)]
        return {"head": conv_p(f"{prefix}.main.0"),
                **{f"conv{j + 1}": {"w": np.stack([b[j]["w"] for b in blocks]),
                                    "b": np.stack([b[j]["b"] for b in blocks])}
                   for j in range(2)}}

    return {"spynet": [[conv_p(f"spynet.basic_module.{lv}.basic_module.{j}.conv",
                               f"spynet.basic_module.{lv}.basic_module.{2 * j}",
                               f"spynet.basic_module.{lv}.basic_module.{j}")
                        for j in range(5)] for lv in range(spynet_levels)],
            "backward": trunk("backward_resblocks"), "forward": trunk("forward_resblocks"),
            "fusion": conv_p("fusion"),
            "upsample1": conv_p("upsample1.upsample_conv", "upsample1"),
            "upsample2": conv_p("upsample2.upsample_conv", "upsample2"),
            "conv_hr": conv_p("conv_hr"), "conv_last": conv_p("conv_last")}


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def spynet_flow(params, ref: torch.Tensor, supp: torch.Tensor, levels: int = 6) -> torch.Tensor:
    """Coarse-to-fine flow ref -> supp, (B, H, W, 2) in pixels (x, y)."""
    mean = torch.tensor(_SPY_MEAN, dtype=ref.dtype, device=ref.device)
    std = torch.tensor(_SPY_STD, dtype=ref.dtype, device=ref.device)
    ref_p, supp_p = [(ref - mean) / std], [(supp - mean) / std]
    for _ in range(levels - 1):
        ref_p.append(_avg_pool2(ref_p[-1]))
        supp_p.append(_avg_pool2(supp_p[-1]))
    b, h, w, _ = ref_p[-1].shape
    flow = ref.new_zeros((b, h, w, 2))
    for lv in range(levels - 1, -1, -1):
        if flow.shape[1] != ref_p[lv].shape[1]:
            flow = F.interpolate(flow.permute(0, 3, 1, 2), size=ref_p[lv].shape[1:3],
                                 mode="bilinear", align_corners=True).permute(0, 2, 3, 1) * 2.0
        warped = flow_warp(supp_p[lv], flow)
        x = torch.cat([ref_p[lv], warped, flow], dim=-1)
        mods = params[min(levels - 1 - lv, len(params) - 1)]
        for i, p in enumerate(mods):
            x = conv(p, x)
            if i < len(mods) - 1:
                x = F.relu(x)
        flow = flow + x
    return flow


def _trunk(p, x: torch.Tensor) -> torch.Tensor:
    h = F.leaky_relu(conv(p["head"], x), 0.1)
    w1, b1, w2, b2 = p["conv1"]["w"], p["conv1"]["b"], p["conv2"]["w"], p["conv2"]["b"]
    for i in range(w1.shape[0]):
        y = F.relu(conv({"w": w1[i], "b": b1[i]}, h))
        h = h + conv({"w": w2[i], "b": b2[i]}, y)
    return h


def _propagate(p, frames: torch.Tensor, flows: torch.Tensor, reverse: bool) -> torch.Tensor:
    """frames (T, B, H, W, 3), flows (T-1, B, H, W, 2) -> (T, B, H, W,
    mid): reverse, flows[t] warps the state from t+1 into t; forward,
    flows[t] warps it from t into t+1."""
    t, b, h, w, _ = frames.shape
    mid = p["head"]["b"].shape[0]
    carry = frames.new_zeros((b, h, w, mid))
    zero = frames.new_zeros((b, h, w, 2))
    feats = [None] * t
    order = range(t - 1, -1, -1) if reverse else range(t)
    for i in order:
        if reverse:
            flow = flows[i] if i < t - 1 else zero
        else:
            flow = flows[i - 1] if i > 0 else zero
        warped = flow_warp(carry, flow, padding_mode="zeros")
        carry = _trunk(p, torch.cat([frames[i], warped], dim=-1))
        feats[i] = carry
    return torch.stack(feats)


def apply(params, frames: torch.Tensor, cfg: BasicVSRConfig = BasicVSRConfig()) -> torch.Tensor:
    """(B, T, H, W, 3) in [0, 1], sides multiples of 2^(spynet_levels -
    1) -> (B, T, 4H, 4W, 3)."""
    b, t, h, w, c = frames.shape
    ref = frames[:, 1:].reshape(b * (t - 1), h, w, c)
    sup = frames[:, :-1].reshape(b * (t - 1), h, w, c)
    flow_fw = spynet_flow(params["spynet"], ref, sup, cfg.spynet_levels)
    flow_bw = spynet_flow(params["spynet"], sup, ref, cfg.spynet_levels)
    flow_fw = flow_fw.reshape(b, t - 1, h, w, 2).transpose(0, 1)
    flow_bw = flow_bw.reshape(b, t - 1, h, w, 2).transpose(0, 1)
    frames_t = frames.transpose(0, 1)
    feat_bw = _propagate(params["backward"], frames_t, flow_bw, reverse=True)
    feat_fw = _propagate(params["forward"], frames_t, flow_fw, reverse=False)
    feats = torch.cat([feat_bw, feat_fw], dim=-1).transpose(0, 1).reshape(b * t, h, w, -1)
    del feat_bw, feat_fw
    flat = frames.reshape(b * t, h, w, c)
    out = frames.new_empty((b * t, 4 * h, 4 * w, c))
    for i in range(b * t):                     # the tail a frame at a time
        y = F.leaky_relu(conv(params["fusion"], feats[i:i + 1]), 0.1)
        y = F.leaky_relu(pixel_shuffle(conv(params["upsample1"], y), 2), 0.1)
        y = F.leaky_relu(pixel_shuffle(conv(params["upsample2"], y), 2), 0.1)
        y = conv(params["conv_last"], F.leaky_relu(conv(params["conv_hr"], y), 0.1))
        base = resize_bilinear(flat[i:i + 1], (4 * h, 4 * w))
        out[i:i + 1] = (y.float() + base.float()).to(frames.dtype)
    return out.reshape(b, t, 4 * h, 4 * w, c)
