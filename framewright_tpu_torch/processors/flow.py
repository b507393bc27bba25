"""Dense optical flow with selectable backends: the port of
``framewright_tpu.processors.flow`` (``FlowField``, ``FlowEstimator``).

Backends, on the card in f32:

- ``ifnet``: the IFNet pyramid flow (``models/ifnet.IFNet.estimate_flow``)
  at ``ALIGN_ARCH`` with the JAX package's ``ifnet.init(PRNGKey(1))``
  weights, ``models/weights/align_ifnet_key1.npz`` (the JAX backend draws
  the same key);
- ``raft``: ``models/raft`` with ``RAFTConfig(iters=iters)`` on the user's
  ``<weights_dir>/raft-things.npz`` (or princeton-vl's ``.pth``); without
  it ``setup`` raises ``InputError`` naming the file and the directory
  (the JAX backend draws random RAFT weights).

The confidence (forward-backward consistency), the occlusion mask and
the flow magnitude are the JAX module's numpy, on the host; ``warp_frame``
warps on the card and rounds to uint8 as JAX does.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.hw import full_f32, resolve_device
from framewright_tpu_torch.processors.base import to_uint8

logger = logging.getLogger(__name__)

VALID_FLOW_BACKENDS = ("ifnet", "raft")


@dataclass
class FlowField:
    flow: np.ndarray          # (H, W, 2) pixels, (x, y)
    magnitude: np.ndarray     # (H, W)
    confidence: np.ndarray    # (H, W) in [0, 1]
    iterations_used: int = 0

    @property
    def flow_x(self) -> np.ndarray:
        return self.flow[..., 0]

    @property
    def flow_y(self) -> np.ndarray:
        return self.flow[..., 1]


class FlowEstimator:
    """Frame-pair dense flow with a selectable backend."""

    def __init__(self, backend: str = "ifnet", iters: int = 12,
                 weights_dir: Optional[str] = None, device: str = "cuda"):
        if backend not in VALID_FLOW_BACKENDS:
            raise ConfigError(f"flow backend must be one of {VALID_FLOW_BACKENDS}")
        self.backend = backend
        self.iters = iters
        self.weights_dir = weights_dir
        self.device = resolve_device(device)
        self._fn = None

    def setup(self) -> None:
        """Load the backend's weights onto the device (once)."""
        if self._fn is not None:
            return
        from framewright_tpu_torch.models import registry

        if self.backend == "raft":
            from framewright_tpu_torch.models import raft
            from framewright_tpu_torch.models.layers import tree_to_torch

            _, tree, src = registry.load_aux("raft-things", self.weights_dir)
            params, cfg = tree_to_torch(tree, self.device), raft.RAFTConfig(iters=self.iters)
            logger.info("flow RAFT: %s", src)

            def fn(a, b):
                return raft.estimate_flow(params, a, b, cfg)
        else:
            fn = registry.load_align_ifnet(self.device).estimate_flow
        self._fn = fn

    def _upload(self, frame: np.ndarray) -> torch.Tensor:
        """(1, H, W, C) f32 on the device: uint8 / 255, else as it is."""
        t = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)
        return (t.float() / 255.0 if frame.dtype == np.uint8 else t.float())[None]

    def _flows(self, *pairs) -> list:
        with torch.no_grad(), full_f32():
            return [self._fn(a, b)[0].cpu().numpy().astype(np.float32) for a, b in pairs]

    def estimate(self, frame0: np.ndarray, frame1: np.ndarray,
                 with_confidence: bool = True) -> FlowField:
        """Flow from frame0 toward frame1 (uint8 or float HWC)."""
        self.setup()
        a, b = self._upload(frame0), self._upload(frame1)
        if with_confidence:
            fw, bw = self._flows((a, b), (b, a))
            conf = self._consistency_confidence(fw, bw)
        else:
            (fw,) = self._flows((a, b))
            conf = np.ones(fw.shape[:2], np.float32)
        mag = np.hypot(fw[..., 0], fw[..., 1])
        iters = self.iters if self.backend == "raft" else 0
        return FlowField(flow=fw, magnitude=mag, confidence=conf, iterations_used=iters)

    def estimate_bidirectional(self, frame0: np.ndarray,
                               frame1: np.ndarray) -> Tuple[FlowField, FlowField]:
        self.setup()
        a, b = self._upload(frame0), self._upload(frame1)
        fw, bw = self._flows((a, b), (b, a))
        return (FlowField(fw, np.hypot(fw[..., 0], fw[..., 1]),
                          self._consistency_confidence(fw, bw)),
                FlowField(bw, np.hypot(bw[..., 0], bw[..., 1]),
                          self._consistency_confidence(bw, fw)))

    @staticmethod
    def check_flow_consistency(fw: np.ndarray, bw: np.ndarray, alpha: float = 0.01,
                               beta: float = 0.5) -> np.ndarray:
        """Occlusion mask: True where forward and backward flows agree
        (|f(p) + b(p + f(p))|^2 < a*(|f|^2+|b|^2) + beta, the
        Sundaram/Brox criterion; nearest sampling)."""
        h, w, _ = fw.shape
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        px = np.clip(xs + fw[..., 0], 0, w - 1)
        py = np.clip(ys + fw[..., 1], 0, h - 1)
        bw_at = bw[py.astype(np.int32), px.astype(np.int32)]
        err = np.sum((fw + bw_at) ** 2, axis=-1)
        bound = alpha * (np.sum(fw ** 2, -1) + np.sum(bw_at ** 2, -1)) + beta
        return err < bound

    @staticmethod
    def _consistency_confidence(fw: np.ndarray, bw: np.ndarray) -> np.ndarray:
        h, w, _ = fw.shape
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        px = np.clip(xs + fw[..., 0], 0, w - 1).astype(np.int32)
        py = np.clip(ys + fw[..., 1], 0, h - 1).astype(np.int32)
        err = np.sqrt(np.sum((fw + bw[py, px]) ** 2, axis=-1))
        return np.exp(-err).astype(np.float32)

    def warp_frame(self, frame: np.ndarray, flow: np.ndarray) -> np.ndarray:
        """Backward-warp ``frame`` by ``flow``: out[p] = frame[p + flow[p]]
        (uint8 in, uint8 out: clip(x * 255 + 0.5))."""
        from framewright_tpu_torch.ops.warp import flow_warp

        f = self._upload(frame)
        fl = torch.from_numpy(np.ascontiguousarray(flow, np.float32)).to(self.device)[None]
        with torch.no_grad(), full_f32():
            out = flow_warp(f, fl)[0]
            if frame.dtype == np.uint8:
                return to_uint8(out).cpu().numpy()
            return out.cpu().numpy()
