"""RetinaFace with the MobileNetV1-0.25 backbone: the port of
``framewright_tpu.models.retinaface`` as an ``nn.Module`` (NCHW inside,
NHWC at ``apply``), f32.

    backbone: MobileNetV1-0.25 (3x3 conv, then depthwise-separable
              blocks, leaky ReLU 0.1), features at /8, /16, /32
    FPN:      1x1 laterals to 64 channels, nearest 2x merges, 3x3 smooth
    SSH:      3x3 + 5x5 + 7x7 context branches concatenated to 64, ReLU
    heads:    2 anchors a cell and level: class (2), box (4), landmarks (10)

Convolutions pad k // 2 on both sides at every stride, as torch pads
them (the JAX module pads explicitly at stride 2 for the same reason).
``apply`` takes RGB in [0, 1], sides multiples of 32, and returns the
face scores, the decoded boxes (xyxy in [0, 1]) and landmarks of every
anchor; ``nms_host`` is the JAX module's numpy NMS. Parameter names
follow the JAX parameter tree (``stage1.0.conv.weight``,
``stage2.3.dw.weight``, ``ssh.1.conv5_1.bias``, ``head_cls.2.weight``);
``registry.from_jax_params`` maps the JAX tree to them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class RetinaFaceConfig:
    min_sizes: Tuple[Tuple[int, int], ...] = ((16, 32), (64, 128), (256, 512))
    steps: Tuple[int, ...] = (8, 16, 32)
    variances: Tuple[float, float] = (0.1, 0.2)
    score_thresh: float = 0.5
    nms_iou: float = 0.4
    top_k: int = 256


# (in, out, stride) of each block of mobilenet0.25
_STAGE1 = [(3, 8, 2), (8, 16, 1), (16, 32, 2), (32, 32, 1), (32, 64, 2), (64, 64, 1)]
_STAGE2 = [(64, 128, 2)] + [(128, 128, 1)] * 5
_STAGE3 = [(128, 256, 2), (256, 256, 1)]


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups)


class _Block(nn.Module):
    """The first block of the backbone (``conv``: a full 3x3 conv), or a
    depthwise-separable one (``dw`` 3x3, ``pw`` 1x1), each conv followed
    by leaky ReLU 0.1."""

    def __init__(self, cin: int, cout: int, stride: int, full: bool):
        super().__init__()
        self.stride = stride
        if full:
            self.conv = _conv(cin, cout, 3, stride)
        else:
            self.dw = _conv(cin, cin, 3, stride, groups=cin)
            self.pw = _conv(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "conv"):
            return F.leaky_relu(self.conv(x), 0.1)
        x = F.leaky_relu(self.dw(x), 0.1)
        return F.leaky_relu(self.pw(x), 0.1)


class _SSH(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv3 = _conv(64, 32, 3)
        self.conv5_1 = _conv(64, 16, 3)
        self.conv5_2 = _conv(16, 16, 3)
        self.conv7_2 = _conv(16, 16, 3)
        self.conv7_3 = _conv(16, 16, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c3 = self.conv3(x)
        c5_1 = F.leaky_relu(self.conv5_1(x), 0.1)
        c5 = self.conv5_2(c5_1)
        c7 = self.conv7_3(F.leaky_relu(self.conv7_2(c5_1), 0.1))
        return F.relu(torch.cat([c3, c5, c7], 1))


def _stage(plan, first_full: bool) -> nn.ModuleList:
    return nn.ModuleList(_Block(ci, co, s, first_full and i == 0)
                         for i, (ci, co, s) in enumerate(plan))


def priors(fh: int, fw: int, min_sizes, step: int, img_h: int, img_w: int) -> np.ndarray:
    """One level's anchors (cx, cy, w, h) in [0, 1], per cell the
    ``min_sizes`` in turn (torch's prior_box order)."""
    ys, xs = np.meshgrid(np.arange(fh), np.arange(fw), indexing="ij")
    out = []
    for ms in min_sizes:
        cx = (xs + 0.5) * step / img_w
        cy = (ys + 0.5) * step / img_h
        sw = np.full_like(cx, ms / img_w, dtype=np.float32)
        sh = np.full_like(cy, ms / img_h, dtype=np.float32)
        out.append(np.stack([cx, cy, sw, sh], -1).reshape(-1, 4))
    return np.stack(out, axis=1).reshape(-1, 4).astype(np.float32)


class RetinaFace(nn.Module):
    def __init__(self, cfg: RetinaFaceConfig = RetinaFaceConfig()):
        super().__init__()
        self.cfg = cfg
        self.stage1 = _stage(_STAGE1, True)
        self.stage2 = _stage(_STAGE2, False)
        self.stage3 = _stage(_STAGE3, False)
        self.fpn_lat = nn.ModuleList(_conv(c, 64, 1) for c in (64, 128, 256))
        self.fpn_merge = nn.ModuleList(_conv(64, 64, 3) for _ in range(2))
        self.ssh = nn.ModuleList(_SSH() for _ in range(3))
        self.head_cls = nn.ModuleList(_conv(64, 4, 1) for _ in range(3))
        self.head_box = nn.ModuleList(_conv(64, 8, 1) for _ in range(3))
        self.head_ldm = nn.ModuleList(_conv(64, 20, 1) for _ in range(3))
        self.register_buffer("_mean", torch.tensor([104.0, 117.0, 123.0]).view(1, 3, 1, 1),
                             persistent=False)

    def apply(self, x: torch.Tensor):
        """x: (B, H, W, 3) RGB in [0, 1], H and W multiples of 32 ->
        (scores (B, N), boxes (B, N, 4) xyxy in [0, 1], landmarks (B, N,
        10)); N anchors."""
        b, h, w, _ = x.shape
        # the checkpoint expects BGR minus the means, on 0-255
        xb = x.flip(-1).permute(0, 3, 1, 2) * 255.0 - self._mean
        f1 = xb
        for blk in self.stage1:
            f1 = blk(f1)
        f2 = f1
        for blk in self.stage2:
            f2 = blk(f2)
        f3 = f2
        for blk in self.stage3:
            f3 = blk(f3)
        l1, l2, l3 = (F.leaky_relu(lat(f), 0.1) for lat, f in zip(self.fpn_lat, (f1, f2, f3)))
        u2 = F.interpolate(l3, size=l2.shape[-2:], mode="nearest-exact")
        l2 = F.leaky_relu(self.fpn_merge[1](l2 + u2), 0.1)
        u1 = F.interpolate(l2, size=l1.shape[-2:], mode="nearest-exact")
        l1 = F.leaky_relu(self.fpn_merge[0](l1 + u1), 0.1)
        scores, boxes, ldms, pri = [], [], [], []
        for i, f in enumerate((l1, l2, l3)):
            f = self.ssh[i](f)
            fh, fw = f.shape[-2:]

            def head(conv, k):
                return conv(f).permute(0, 2, 3, 1).reshape(b, fh * fw * 2, k)

            scores.append(torch.softmax(head(self.head_cls[i], 2), -1)[..., 1])
            boxes.append(head(self.head_box[i], 4))
            ldms.append(head(self.head_ldm[i], 10))
            pri.append(priors(fh, fw, self.cfg.min_sizes[i], self.cfg.steps[i], h, w))
        score = torch.cat(scores, 1)
        loc = torch.cat(boxes, 1)
        ldm = torch.cat(ldms, 1)
        p = torch.from_numpy(np.concatenate(pri, 0)).to(x.device)[None]
        v0, v1 = self.cfg.variances
        cxcy = p[..., :2] + loc[..., :2] * v0 * p[..., 2:]
        wh = p[..., 2:] * torch.exp(loc[..., 2:] * v1)
        box_xyxy = torch.cat([cxcy - wh / 2, cxcy + wh / 2], -1)
        ldm_xy = p[..., None, :2] + ldm.reshape(b, -1, 5, 2) * v0 * p[..., None, 2:]
        return score, box_xyxy, ldm_xy.reshape(b, -1, 10)

    @classmethod
    def from_state_dict(cls, cfg: RetinaFaceConfig, sd: Dict[str, torch.Tensor],
                        device) -> "RetinaFace":
        net = cls(cfg)
        net.load_state_dict({k: v.float() for k, v in sd.items()})
        return net.to(device).eval().requires_grad_(False)


def init_params(seed: int = 0) -> Dict:
    """Seeded random parameters in the JAX module's tree (HWIO numpy
    arrays; depthwise (3, 3, C, 1)) at mobilenet0.25's widths, drawn with
    numpy in the shapes of ``retinaface.init``: weights normal / sqrt(fan
    in), biases 0. For smoke runs and benchmarks; a restore never draws a
    detector."""
    rng = np.random.default_rng(seed)

    def conv(k, ci, co):
        return {"w": (rng.standard_normal((k, k, ci, co)) / np.sqrt(k * k * ci)
                      ).astype(np.float32), "b": np.zeros((co,), np.float32)}

    def dw(k, c):
        return {"w": (rng.standard_normal((k, k, c, 1)) / np.sqrt(k * k)).astype(np.float32),
                "b": np.zeros((c,), np.float32)}

    def stage(plan, first_full):
        return [{"conv": conv(3, ci, co)} if first_full and i == 0
                else {"dw": dw(3, ci), "pw": conv(1, ci, co)}
                for i, (ci, co, _) in enumerate(plan)]

    return {
        "stage1": stage(_STAGE1, True), "stage2": stage(_STAGE2, False),
        "stage3": stage(_STAGE3, False),
        "fpn_lat": [conv(1, c, 64) for c in (64, 128, 256)],
        "fpn_merge": [conv(3, 64, 64) for _ in range(2)],
        "ssh": [{"conv3": conv(3, 64, 32), "conv5_1": conv(3, 64, 16),
                 "conv5_2": conv(3, 16, 16), "conv7_2": conv(3, 16, 16),
                 "conv7_3": conv(3, 16, 16)} for _ in range(3)],
        "head_cls": [conv(1, 64, 4) for _ in range(3)],
        "head_box": [conv(1, 64, 8) for _ in range(3)],
        "head_ldm": [conv(1, 64, 20) for _ in range(3)],
    }


def nms_host(scores: np.ndarray, boxes: np.ndarray, iou: float,
             score_thresh: float, top_k: int) -> List[int]:
    """Plain host NMS over decoded boxes (xyxy, normalized)."""
    keep_idx = np.where(scores >= score_thresh)[0]
    if keep_idx.size == 0:
        return []
    order = keep_idx[np.argsort(-scores[keep_idx])][:top_k]
    bxs = boxes[order]
    areas = np.maximum(0, bxs[:, 2] - bxs[:, 0]) * \
        np.maximum(0, bxs[:, 3] - bxs[:, 1])
    keep = []
    sup = np.zeros(len(order), bool)
    for i in range(len(order)):
        if sup[i]:
            continue
        keep.append(int(order[i]))
        xx1 = np.maximum(bxs[i, 0], bxs[i + 1:, 0])
        yy1 = np.maximum(bxs[i, 1], bxs[i + 1:, 1])
        xx2 = np.minimum(bxs[i, 2], bxs[i + 1:, 2])
        yy2 = np.minimum(bxs[i, 3], bxs[i + 1:, 3])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        ov = inter / np.maximum(areas[i] + areas[i + 1:] - inter, 1e-9)
        sup[i + 1:] |= ov > iou
    return keep


def port_state_dict(sd) -> Dict:
    """Pytorch_Retinaface's mobilenet0.25 state dict -> the JAX
    ``retinaface`` tree (numpy f32): the port's copy of
    ``framewright_tpu.models.torch_port.port_retinaface``. Each
    BatchNorm folds into the conv before it (w * g / sqrt(v + eps),
    beta - mean * g / sqrt(v + eps)); a depthwise kernel is stored
    (k, k, C, 1)."""
    from framewright_tpu_torch.models.layers import np_leaf

    eps = 1e-5

    def f32(key):
        return np_leaf(sd[key]).astype(np.float32)

    def bn_scale(prefix):
        g, beta = f32(f"{prefix}.weight"), f32(f"{prefix}.bias")
        mean, var = f32(f"{prefix}.running_mean"), f32(f"{prefix}.running_var")
        scale = g / np.sqrt(var + eps)
        return scale, beta - mean * scale

    def conv_bn(prefix):
        scale, shift = bn_scale(f"{prefix}.1")
        return {"w": f32(f"{prefix}.0.weight").transpose(2, 3, 1, 0) * scale, "b": shift}

    def conv_dw(prefix):
        sc, dw_b = bn_scale(f"{prefix}.1")
        dw = f32(f"{prefix}.0.weight").transpose(2, 3, 0, 1)      # (C, 1, k, k) -> (k, k, C, 1)
        pw_s, pw_b = bn_scale(f"{prefix}.4")
        return {"dw": {"w": dw * sc[None, None, :, None], "b": dw_b},
                "pw": {"w": f32(f"{prefix}.3.weight").transpose(2, 3, 1, 0) * pw_s,
                       "b": pw_b}}

    def head(prefix):
        return {"w": f32(f"{prefix}.conv1x1.weight").transpose(2, 3, 1, 0),
                "b": f32(f"{prefix}.conv1x1.bias")}

    return {
        "stage1": [{"conv": conv_bn("body.stage1.0")}]
                  + [conv_dw(f"body.stage1.{i}") for i in range(1, 6)],
        "stage2": [conv_dw(f"body.stage2.{i}") for i in range(6)],
        "stage3": [conv_dw(f"body.stage3.{i}") for i in range(2)],
        "fpn_lat": [conv_bn(f"fpn.output{i}") for i in (1, 2, 3)],
        "fpn_merge": [conv_bn("fpn.merge1"), conv_bn("fpn.merge2")],
        "ssh": [{"conv3": conv_bn(f"ssh{i}.conv3X3"), "conv5_1": conv_bn(f"ssh{i}.conv5X5_1"),
                 "conv5_2": conv_bn(f"ssh{i}.conv5X5_2"),
                 "conv7_2": conv_bn(f"ssh{i}.conv7X7_2"),
                 "conv7_3": conv_bn(f"ssh{i}.conv7x7_3")} for i in (1, 2, 3)],
        "head_cls": [head(f"ClassHead.{i}") for i in range(3)],
        "head_box": [head(f"BboxHead.{i}") for i in range(3)],
        "head_ldm": [head(f"LandmarkHead.{i}") for i in range(3)],
    }
