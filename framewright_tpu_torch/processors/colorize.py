"""Black-and-white colorization, keyframes propagated along motion: the
port of ``framewright_tpu.processors.colorize``.

A keyframe every ``keyframe_interval`` frames, and on a scene cut
(``frame_pair_scores`` of the previous and the current frame at or above
the threshold), is coloured by the method:

- ``palette``: luma-indexed interpolation between the palette's (cb, cr)
  anchors;
- ``exemplar``: the mean chroma of ``reference_image``'s pixels in the
  same luma band (16 bands; empty bands from the nearest populated one);
- ``eccv16`` and ``ddcolor``: the network on the L channel resized to
  256x256 (``models/colorizer_net``, ``models/ddcolor``), its ab resized
  back, times 2 x ``saturation``, then Lab -> RGB, rounded half up. The
  checkpoints are ``<weights_dir>/eccv16.npz`` and ``ddcolor.npz`` (their
  widths read from the arrays); ``setup`` raises ``InputError`` naming the
  file when it is missing (the JAX colorizer draws ``PRNGKey(7)`` and
  ``PRNGKey(9)`` nets instead, and its restorer never passes a weights
  directory).

Between keyframes the previous coloured frame is backward-warped to the
current one along the IFNet flow of the grey frames (the JAX draw
``ifnet.init(PRNGKey(4))`` at ``COLORIZE_ARCH``, from
``models/weights/colorize_ifnet_key4.npz``), and its chroma is put under
the current frame's own luma. The nets, the flow and the warp run on the
card in f32, the Lab maths of the net path too; the YCbCr maths is the
JAX module's numpy on the host, with its truncating ``astype(np.uint8)``
in the palette, exemplar and propagation paths.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np
import torch

from framewright_tpu_torch.errors import InputError
from framewright_tpu_torch.hw import full_f32, resolve_device
from framewright_tpu_torch.processors.base import to_float
from framewright_tpu_torch.processors.scene_detection import frame_pair_scores

logger = logging.getLogger(__name__)

NET_METHODS = ("eccv16", "ddcolor")


def rgb_to_ycbcr(f: np.ndarray):
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return y, cb, cr


def ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    return np.clip(np.stack([r, g, b], -1), 0, 255)


@dataclass
class ColorizeConfig:
    method: str = "palette"          # palette | exemplar | eccv16 | ddcolor
    weights_dir: Optional[str] = None
    keyframe_interval: int = 24
    scene_change_threshold: float = 0.30
    saturation: float = 0.5
    reference_image: Optional[np.ndarray] = None  # exemplar mode
    # luma -> (cb, cr) anchor points for the palette colorizer:
    # sepia-like warm tones in shadows, neutral-blue sky in highlights
    palette: List = field(default_factory=lambda: [
        (0.0, 135.0, 135.0), (0.35, 125.0, 140.0),
        (0.7, 120.0, 128.0), (1.0, 124.0, 124.0),
    ])
    device: str = "cuda"


class Colorizer:
    def __init__(self, config: Optional[ColorizeConfig] = None):
        self.config = config or ColorizeConfig()
        self.device = resolve_device(self.config.device)
        self.flow_net = None
        self._net = None

    def setup(self, height: int = 0, width: int = 0) -> None:
        """Load the propagation flow net and the method's network onto the
        device (once); a missing checkpoint raises ``InputError`` before
        any compute."""
        if self.flow_net is not None:
            return
        from framewright_tpu_torch.models import registry
        from framewright_tpu_torch.models.ifnet import COLORIZE_ARCH
        from framewright_tpu_torch.models.layers import tree_to_torch

        if self.config.method in NET_METHODS:
            npz = (Path(self.config.weights_dir or registry.default_weights_dir())
                   / f"{self.config.method}.npz")
            if not npz.is_file():
                raise InputError(f"colorize with {self.config.method} needs {npz} (the JAX "
                                 "package's .npz layout; the port never draws it at random)")
            if self.config.method == "ddcolor":
                from framewright_tpu_torch.models import ddcolor as net
            else:
                from framewright_tpu_torch.models import colorizer_net as net
            tree = registry._read_checkpoint(npz)
            arch = net.config_from_params(tree)
            params = tree_to_torch(tree, self.device)
            self._net = lambda l: net.apply(params, l, arch)
            logger.info("colorize %s %s: %s", self.config.method, arch, npz)
        self.flow_net = registry.load_align_ifnet(
            self.device, registry.COLORIZE_IFNET_NPZ, COLORIZE_ARCH)

    # ------------------------------------------------------------------
    def _net_keyframe(self, frame: np.ndarray) -> np.ndarray:
        """The network's keyframe: Lab of the frame, ab from L at 256x256,
        back to the frame's size, on the device."""
        from framewright_tpu_torch.models import colorizer_net as cn
        from framewright_tpu_torch.models.layers import resize_bilinear

        h, w = frame.shape[:2]
        with torch.no_grad(), full_f32():
            rgb01 = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)[None].float()
            lab = cn.rgb_to_lab(rgb01 / 255.0)
            ab = self._net(resize_bilinear(lab[..., :1], (256, 256)))
            ab = resize_bilinear(ab, (h, w)) * (self.config.saturation * 2.0)
            out = cn.lab_to_rgb(torch.cat([lab[..., :1], ab], -1))[0]
            return torch.clamp(out * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()

    def _colorize_keyframe(self, frame: np.ndarray) -> np.ndarray:
        """Chroma for a keyframe (the method's), under its own luma."""
        cfg = self.config
        if cfg.method in NET_METHODS and self._net is not None:
            return self._net_keyframe(frame)
        f = frame.astype(np.float32)
        y, _, _ = rgb_to_ycbcr(f)
        if cfg.method == "exemplar" and cfg.reference_image is not None:
            ref = cfg.reference_image.astype(np.float32)
            ry, rcb, rcr = rgb_to_ycbcr(ref)
            # luma-bucket colour transfer: the mean chroma of the reference's
            # pixels in the same luma band
            bins = 16
            q = np.clip((y / 256.0 * bins).astype(int), 0, bins - 1)
            rq = np.clip((ry / 256.0 * bins).astype(int), 0, bins - 1)
            cb_map = np.full(bins, np.nan)
            cr_map = np.full(bins, np.nan)
            for k in range(bins):
                sel = rq == k
                if sel.sum() > 16:
                    cb_map[k] = rcb[sel].mean()
                    cr_map[k] = rcr[sel].mean()
            # empty luma buckets from the nearest populated one, so content
            # brighter or darker than the exemplar still colourises
            pop = np.where(~np.isnan(cb_map))[0]
            if len(pop) == 0:
                cb_map[:] = 128.0
                cr_map[:] = 128.0
            else:
                for k in range(bins):
                    if np.isnan(cb_map[k]):
                        j = pop[np.argmin(np.abs(pop - k))]
                        cb_map[k] = cb_map[j]
                        cr_map[k] = cr_map[j]
            cb, cr = cb_map[q], cr_map[q]
        else:
            lum = y / 255.0
            pts = np.asarray(self.config.palette, np.float32)
            cb = np.interp(lum, pts[:, 0], pts[:, 1])
            cr = np.interp(lum, pts[:, 0], pts[:, 2])
        s = cfg.saturation
        cb = 128.0 + (cb - 128.0) * s * 2.0
        cr = 128.0 + (cr - 128.0) * s * 2.0
        return ycbcr_to_rgb(y, cb, cr).astype(np.uint8)

    def _warp_previous(self, colored_prev: np.ndarray, gray_prev: np.ndarray,
                       gray_cur: np.ndarray) -> np.ndarray:
        """The previous coloured frame backward-warped onto the current
        one (f32, 0-255), along the IFNet flow of the grey pair."""
        from framewright_tpu_torch.ops.warp import flow_warp

        def up(f):
            return torch.from_numpy(np.ascontiguousarray(f)).to(self.device)[None]

        with torch.no_grad(), full_f32():
            flow = self.flow_net.estimate_flow(to_float(up(gray_cur)), to_float(up(gray_prev)))
            return flow_warp(up(colored_prev).float(), flow)[0].cpu().numpy()

    def _propagate(self, colored_prev: np.ndarray, gray_prev: np.ndarray,
                   gray_cur: np.ndarray) -> np.ndarray:
        """The warped previous chroma under the current frame's luma."""
        warped = self._warp_previous(colored_prev, gray_prev, gray_cur)
        y_cur, _, _ = rgb_to_ycbcr(gray_cur.astype(np.float32))
        _, cb, cr = rgb_to_ycbcr(warped)
        return ycbcr_to_rgb(y_cur, cb, cr).astype(np.uint8)

    # ------------------------------------------------------------------
    def colorize_stream(self, frames_iter: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        cfg = self.config
        prev_gray: Optional[np.ndarray] = None
        prev_colored: Optional[np.ndarray] = None
        since_key = 0
        for frame in frames_iter:
            self.setup()
            is_key = prev_colored is None or since_key >= cfg.keyframe_interval
            if prev_gray is not None and not is_key:
                score = float(frame_pair_scores(prev_gray[None], frame[None])[0])
                if score >= cfg.scene_change_threshold:
                    is_key = True
            if is_key:
                colored = self._colorize_keyframe(frame)
                since_key = 0
            else:
                colored = self._propagate(prev_colored, prev_gray, frame)
                since_key += 1
            prev_gray, prev_colored = frame, colored
            yield colored
