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
the largest buffers). ``apply(..., bands=)`` runs a window in row bands
(the video SR's spatial split), each band its own rows of the whole
frame's result. ``port_state_dict`` reads mmediting's BasicVSR
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
from framewright_tpu_torch.parallel.bands import Bands
from framewright_tpu_torch.parallel.mesh import device_current

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


# The row bands of the spatial split: a band holds BAND_HALO rows of each
# neighbour, enough for the trunk's head conv (1 row) and each residual
# block (2 rows) between two exchanges, and for the tail (3 input rows:
# upsample1, upsample2 at 2x, conv_hr and conv_last at 4x; the bilinear
# base 1).
BAND_HALO = 3


def _trunk(ps, xs, bands) -> list:
    """The trunk (the head conv and ``num_blocks`` residual blocks) on
    each band's rows (its own and the halo), the halo rows exchanged from
    their owners after the head and every block, so that every row a band
    holds is the whole frame's."""
    hs = []
    for p, x, d in zip(ps, xs, bands.devices):
        with device_current(d):
            hs.append(F.leaky_relu(conv(p["head"], x), 0.1))
    bands.exchange(hs)
    for k in range(ps[0]["conv1"]["w"].shape[0]):
        for j, (p, d) in enumerate(zip(ps, bands.devices)):
            with device_current(d):
                y = F.relu(conv({"w": p["conv1"]["w"][k], "b": p["conv1"]["b"][k]}, hs[j]))
                hs[j] = hs[j] + conv({"w": p["conv2"]["w"][k], "b": p["conv2"]["b"][k]}, y)
        bands.exchange(hs)
    return hs


def _propagate(ps, frames, flows, bands, reverse: bool) -> list:
    """One direction's recurrent propagation on row bands: frames[j] (T,
    B, rows_j, W, 3) and flows[j] (T - 1, B, rows_j, W, 2) hold band j's
    rows; reverse, flows[t] warps the state from t+1 into t; forward, from
    t into t+1. Each step warps the carried features, gathered whole (a
    flow may point anywhere in the neighbour frame), into the band's rows
    with zero padding, concatenates the frame and runs ``_trunk``. -> each
    band's (T, B, rows_j, W, mid)."""
    t, b, _, w, _ = frames[0].shape
    mid = ps[0]["head"]["b"].shape[0]
    devs = list(dict.fromkeys(bands.devices))
    carry = {d: frames[0].new_zeros((b, bands.height, w, mid), device=d) for d in devs}
    feats = [[None] * t for _ in bands.devices]
    order = range(t - 1, -1, -1) if reverse else range(t)
    for i in order:
        xs = []
        for j, d in enumerate(bands.devices):
            with device_current(d):
                if reverse:
                    flow = flows[j][i] if i < t - 1 else None
                else:
                    flow = flows[j][i - 1] if i > 0 else None
                if flow is None:
                    flow = frames[j].new_zeros(frames[j].shape[1:-1] + (2,))
                warped = flow_warp(carry[d], flow, padding_mode="zeros",
                                   row0=bands.span(j)[0])
                xs.append(torch.cat([frames[j][i], warped], dim=-1))
        hs = _trunk(ps, xs, bands)
        for j, h in enumerate(hs):
            feats[j][i] = h
        carry = {d: bands.gather(hs, 1, d) for d in devs}
    return [torch.stack(f) for f in feats]


def _flows(params, frames: torch.Tensor, cfg: BasicVSRConfig):
    """SpyNet's forward and backward flows of a window (B, T, H, W, 3) ->
    two (T - 1, B, H, W, 2)."""
    b, t, h, w, c = frames.shape
    ref = frames[:, 1:].reshape(b * (t - 1), h, w, c)
    sup = frames[:, :-1].reshape(b * (t - 1), h, w, c)
    flow_fw = spynet_flow(params["spynet"], ref, sup, cfg.spynet_levels)
    flow_bw = spynet_flow(params["spynet"], sup, ref, cfg.spynet_levels)
    return (flow_fw.reshape(b, t - 1, h, w, 2).transpose(0, 1),
            flow_bw.reshape(b, t - 1, h, w, 2).transpose(0, 1))


def _tail(params, feat: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """One frame's upsampling tail: its fused features (1, h, w, 2 mid)
    and the frame (1, h, w, 3) -> (1, 4h, 4w, 3) in the frame's dtype."""
    _, h, w, _ = frame.shape
    y = F.leaky_relu(conv(params["fusion"], feat), 0.1)
    y = F.leaky_relu(pixel_shuffle(conv(params["upsample1"], y), 2), 0.1)
    y = F.leaky_relu(pixel_shuffle(conv(params["upsample2"], y), 2), 0.1)
    y = conv(params["conv_last"], F.leaky_relu(conv(params["conv_hr"], y), 0.1))
    base = resize_bilinear(frame, (4 * h, 4 * w))
    return (y.float() + base.float()).to(frame.dtype)


def apply(params, frames: torch.Tensor, cfg: BasicVSRConfig = BasicVSRConfig(),
          bands=None) -> torch.Tensor:
    """(B, T, H, W, 3) in [0, 1], sides multiples of 2^(spynet_levels -
    1) -> (B, T, 4H, 4W, 3). ``bands`` (``parallel.bands.Bands`` of H,
    ``BAND_HALO``) splits it by rows, ``params`` then a list of the tree
    on each band's device; ``frames`` lies on the first band's, and so does
    the result. SpyNet's flows are computed once there on the whole
    frames, and each band takes its rows of them; the propagations run on
    the bands (``_propagate``), the tail a frame at a time on each band's
    rows and halo. Each band computes its own rows of the whole frame's
    result."""
    b, t, h, w, c = frames.shape
    if bands is None:
        bands, params = Bands.split(h, [frames.device], BAND_HALO), [params]
    flow_fw, flow_bw = _flows(params[0], frames, cfg)
    spans = [bands.span(j) for j in range(len(bands))]
    frames_t = frames.transpose(0, 1)

    def rows(x):
        return [x[:, :, lo:hi].to(d) for (lo, hi), d in zip(spans, bands.devices)]

    fr = rows(frames_t)
    feat_bw = _propagate([p["backward"] for p in params], fr, rows(flow_bw), bands, True)
    feat_fw = _propagate([p["forward"] for p in params], fr, rows(flow_fw), bands, False)
    del flow_fw, flow_bw
    outs = []
    for j, d in enumerate(bands.devices):
        n = spans[j][1] - spans[j][0]
        with device_current(d):
            feats = torch.cat([feat_bw[j], feat_fw[j]], dim=-1).transpose(0, 1)
            feat_bw[j] = feat_fw[j] = None
            feats = feats.reshape(b * t, n, w, -1)
            flat = fr[j].transpose(0, 1).reshape(b * t, n, w, c)
            out = frames.new_empty((b * t, 4 * n, 4 * w, c), device=d)
            for i in range(b * t):             # the tail a frame at a time
                out[i:i + 1] = _tail(params[j], feats[i:i + 1], flat[i:i + 1])
            outs.append(out)
    return bands.gather(outs, 4, frames.device).reshape(b, t, 4 * h, 4 * w, c)
