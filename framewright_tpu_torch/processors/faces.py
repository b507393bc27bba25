"""Face detection and restoration: the port of
``framewright_tpu.processors.faces``.

Detectors: ``FaceDetector``, the skin-chroma segmentation (YCbCr gates,
a binary opening and connected components in numpy and
``scipy.ndimage``, a copy of the JAX one, so its boxes are JAX's), and
``RetinaFaceDetector`` (``models/retinaface`` on the restore's device,
``nms_host`` on the host), which needs real weights; ``make_detector
("auto")`` takes RetinaFace when ``RetinaFace_mnet025.npz`` is in the
weights directory, else the skin detector, as in JAX.

``FaceRestorer`` crops each box (expanded 1.6x), resizes it to the
backend's size with ``layers.resize_bicubic`` (JAX's cubic resize, not
torch's bicubic), restores it, resizes it back and pastes it with a
feathered mask times ``strength``. Backends: ``sr``
(realesr-general-x4v3's plain f32 forward on the crop, the registry's
weights or its seeded init as for every SR row), ``gfpgan`` (GFPGANv1.4
from ``<weights_dir>/GFPGANv1.4.npz``, applied as ``clip((G(2x - 1) +
1) / 2, 0, 1)``; ``InputError`` without it: the JAX restorer runs a tiny
random stand-in instead) and ``codeformer`` (``models/codeformer`` at the
checkpoint's widths, from ``<weights_dir>/CodeFormer.npz`` or sczhou's
``CodeFormer.pth``, on crops of its ``img_size`` in [0, 1] with
``fidelity_weight`` as its w; ``InputError`` without it: the JAX
restorer's is ``PRNGKey(7)``'s stand-in). The weights directory is the
caller's (the JAX restorer never passes its own to the face restorer;
ROADMAP.md "JAX faults").
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
from scipy import ndimage

from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.hw import full_f32, resolve_device

logger = logging.getLogger(__name__)

RETINAFACE_NAME = "RetinaFace_mnet025"
GFPGAN_NAME = "GFPGANv1.4"
CODEFORMER_NAME = "CodeFormer"
_BACKENDS = ("sr", "gfpgan", "codeformer")


@dataclass
class FaceBox:
    x0: int
    y0: int
    x1: int
    y1: int
    confidence: float = 0.0

    @property
    def w(self) -> int:
        return self.x1 - self.x0

    @property
    def h(self) -> int:
        return self.y1 - self.y0

    def expand(self, factor: float, bounds: Tuple[int, int]) -> "FaceBox":
        bh, bw = bounds
        cx, cy = (self.x0 + self.x1) / 2, (self.y0 + self.y1) / 2
        nw, nh = self.w * factor, self.h * factor
        return FaceBox(
            max(0, int(cx - nw / 2)), max(0, int(cy - nh / 2)),
            min(bw, int(cx + nw / 2)), min(bh, int(cy + nh / 2)),
            self.confidence,
        )


class FaceDetector:
    """Skin-chroma segmentation detector (classical YCbCr gates)."""

    def __init__(self, min_face_frac: float = 0.002, max_faces: int = 8):
        self.min_face_frac = min_face_frac
        self.max_faces = max_faces

    def detect(self, frame: np.ndarray) -> List[FaceBox]:
        f = frame.astype(np.float32)
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
        cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
        skin = (cb > 77) & (cb < 127) & (cr > 133) & (cr < 173) & (y > 40)
        # clean small speckles
        skin = ndimage.binary_opening(skin, iterations=1)
        labels, n = ndimage.label(skin)
        if n == 0:
            return []
        boxes: List[FaceBox] = []
        h, w = skin.shape
        min_area = self.min_face_frac * h * w
        for sl in ndimage.find_objects(labels):
            if sl is None:
                continue
            ys, xs = sl
            bh, bw = ys.stop - ys.start, xs.stop - xs.start
            area = bh * bw
            if area < min_area:
                continue
            aspect = bh / max(bw, 1)
            if not (0.6 <= aspect <= 2.4):
                continue
            fill = skin[sl].mean()
            if fill < 0.35:
                continue
            boxes.append(FaceBox(xs.start, ys.start, xs.stop, ys.stop,
                                 confidence=float(fill)))
        boxes.sort(key=lambda bx: -bx.confidence)
        return boxes[: self.max_faces]


class RetinaFaceDetector:
    """RetinaFace mobilenet0.25 (``models/retinaface``) on ``device``,
    from ``<weights_dir>/RetinaFace_mnet025.npz``: a missing file raises
    ``InputError`` (a randomly initialized detector would detect noise),
    so callers fall back to the skin detector explicitly."""

    def __init__(self, weights_dir: Optional[str] = None, score_thresh: float = 0.5,
                 max_faces: int = 8, pad_mult: int = 32, device: str = "cuda"):
        from framewright_tpu_torch.models.registry import load_aux
        from framewright_tpu_torch.models.retinaface import RetinaFace

        spec, sd, _ = load_aux(RETINAFACE_NAME, weights_dir)
        self.device = resolve_device(device)
        self.model = RetinaFace.from_state_dict(spec.arch_config, sd, self.device)
        self.score_thresh = score_thresh
        self.max_faces = max_faces
        self.pad_mult = pad_mult

    def detect(self, frame: np.ndarray) -> List[FaceBox]:
        from framewright_tpu_torch.models.retinaface import nms_host

        cfg = self.model.cfg
        h, w = frame.shape[:2]
        ph, pw = -h % self.pad_mult, -w % self.pad_mult
        x = np.pad(frame, ((0, ph), (0, pw), (0, 0)))
        with torch.no_grad(), full_f32():
            xt = torch.from_numpy(x[None]).to(self.device).float() / 255.0
            score, boxes, _ = self.model.apply(xt)
        score = score[0].cpu().numpy()
        boxes = boxes[0].cpu().numpy()
        keep = nms_host(score, boxes, cfg.nms_iou, self.score_thresh, cfg.top_k)
        out: List[FaceBox] = []
        hh, ww = h + ph, w + pw
        for i in keep[: self.max_faces]:
            x0 = int(np.clip(boxes[i, 0] * ww, 0, w - 1))
            y0 = int(np.clip(boxes[i, 1] * hh, 0, h - 1))
            x1 = int(np.clip(boxes[i, 2] * ww, x0 + 1, w))
            y1 = int(np.clip(boxes[i, 3] * hh, y0 + 1, h))
            out.append(FaceBox(x0, y0, x1, y1, confidence=float(score[i])))
        return out


def make_detector(kind: str = "auto", weights_dir: Optional[str] = None,
                  device: str = "cuda"):
    """``retinaface``: RetinaFace (raises without its weights); ``auto``:
    RetinaFace when its weights exist, else the skin-chroma detector
    (logged); ``heuristic``: the skin-chroma detector."""
    from framewright_tpu_torch.models.registry import aux_path

    if kind == "retinaface" or (kind == "auto" and aux_path(RETINAFACE_NAME, weights_dir)):
        return RetinaFaceDetector(weights_dir=weights_dir, device=device)
    if kind == "auto":
        logger.info("no %s weights: the skin-chroma face detector", RETINAFACE_NAME)
    return FaceDetector()


@dataclass
class FaceRestoreConfig:
    strength: float = 0.8
    backend: str = "sr"           # sr | gfpgan | codeformer
    sr_model: str = "realesr-general-x4v3"
    detector: str = "auto"        # auto | retinaface | heuristic
    expand: float = 1.6
    crop_size: int = 128          # the sr backend's input; gfpgan: its out_size;
                                  # codeformer: its img_size
    weights_dir: Optional[str] = None
    device: str = "cuda"
    fidelity_weight: float = 0.5  # codeformer w: 0 quality .. 1 fidelity


@dataclass
class FaceRestoreResult:
    frames: int = 0
    faces_restored: int = 0


class FaceRestorer:
    def __init__(self, config: Optional[FaceRestoreConfig] = None):
        self.config = config or FaceRestoreConfig()
        if self.config.backend not in _BACKENDS:
            raise ConfigError(f"unknown face backend {self.config.backend!r} "
                              f"({' | '.join(_BACKENDS)})")
        self.device = resolve_device(self.config.device)
        self.detector = make_detector(self.config.detector, self.config.weights_dir,
                                      self.config.device)
        self.model = None
        self.result = FaceRestoreResult()

    def setup(self, height: int, width: int) -> None:
        """Load the backend's model (``InputError`` when gfpgan's or
        codeformer's weights are missing)."""
        from framewright_tpu_torch.models import registry

        cfg = self.config
        if cfg.backend == "codeformer":
            from framewright_tpu_torch.models.codeformer import CodeFormer

            spec, sd, src = registry.load_aux(CODEFORMER_NAME, cfg.weights_dir)
            self.model = CodeFormer.from_state_dict(spec.arch_config, sd, self.device)
            cfg.crop_size = spec.arch_config.img_size
            logger.info("face restoration: %s (w=%.2f) from %s", CODEFORMER_NAME,
                        cfg.fidelity_weight, src)
            return
        if cfg.backend == "gfpgan":
            from framewright_tpu_torch.models.gfpgan import GFPGAN

            spec, sd, src = registry.load_aux(GFPGAN_NAME, cfg.weights_dir)
            self.model = GFPGAN.from_state_dict(spec.arch_config, sd, self.device)
            cfg.crop_size = spec.arch_config.out_size
            logger.info("face restoration: %s from %s", GFPGAN_NAME, src)
            return
        from framewright_tpu_torch.models.srvgg import SRVGGNet

        spec, sd, src = registry.load_weights(cfg.sr_model, cfg.weights_dir)
        self.model = SRVGGNet.from_state_dict(spec.arch_config, sd, self.device)
        logger.info("face restoration: %s from %s", cfg.sr_model, src)

    def teardown(self) -> None:
        self.model = None

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        """The backend on (1, s, s, 3) in [0, 1]."""
        if self.config.backend == "codeformer":
            return self.model.apply(x, float(self.config.fidelity_weight))
        if self.config.backend == "gfpgan":
            return ((self.model.apply(x * 2.0 - 1.0) + 1.0) / 2.0).clamp(0.0, 1.0)
        return self.model.apply(x).clamp(0.0, 1.0)

    def _enhance_crop(self, crop: np.ndarray) -> np.ndarray:
        """Enhance one face crop at the model's size; back at the crop's
        size as uint8."""
        from framewright_tpu_torch.models.layers import resize_bicubic
        from framewright_tpu_torch.processors.base import to_float, to_uint8

        ch, cw = crop.shape[:2]
        s = self.config.crop_size
        with torch.no_grad(), full_f32():
            x = to_float(torch.from_numpy(np.ascontiguousarray(crop[None])).to(self.device))
            y = resize_bicubic(self._run(resize_bicubic(x, (s, s))), (ch, cw))
            return to_uint8(y)[0].cpu().numpy()

    @staticmethod
    def _feather_mask(h: int, w: int, border: int = 8) -> np.ndarray:
        m = np.ones((h, w), np.float32)
        ramp = np.linspace(0, 1, max(border, 1), endpoint=False)
        m[:border] *= ramp[:, None]
        m[-border:] *= ramp[::-1][:, None]
        m[:, :border] *= ramp[None, :]
        m[:, -border:] *= ramp[::-1][None, :]
        return m[..., None]

    def restore_frame(self, frame: np.ndarray) -> np.ndarray:
        boxes = self.detector.detect(frame)
        if not boxes:
            return frame
        out = frame.astype(np.float32)
        for box in boxes:
            eb = box.expand(self.config.expand, frame.shape[:2])
            if eb.w < 12 or eb.h < 12:
                continue
            crop = frame[eb.y0:eb.y1, eb.x0:eb.x1]
            enhanced = self._enhance_crop(crop).astype(np.float32)
            mask = self._feather_mask(eb.h, eb.w) * self.config.strength
            region = out[eb.y0:eb.y1, eb.x0:eb.x1]
            out[eb.y0:eb.y1, eb.x0:eb.x1] = region * (1 - mask) + enhanced * mask
            self.result.faces_restored += 1
        return np.clip(out, 0, 255).astype(np.uint8)

    def process_stream(self, frames_iter: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        started = False
        for f in frames_iter:
            if not started:
                self.setup(f.shape[0], f.shape[1])
                started = True
            self.result.frames += 1
            yield self.restore_frame(f)
