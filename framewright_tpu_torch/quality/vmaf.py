"""A VMAF-class perceptual score: the port of
``framewright_tpu.quality.vmaf``.

The elementary features VMAF fuses, computed on the luma of reference
and distorted frames in plain PyTorch, f32, on the restore's device:
multi-scale VIF (visual information fidelity over four scales of a 2x2
mean pyramid, a separable Gaussian of sigma 1.2 with zero borders,
horizontal pass first), a detail-loss measure (the share of the
reference's high-frequency energy kept), and motion (the mean absolute
difference of the blurred reference against the previous reference
frame). A fixed linear head maps them to 0-100, as JAX's. Without
libvmaf's trained model the fusion is approximate, so the score is
named ``vmaf_proxy``; it falls with noise, blur and blocking, which is
what a gate needs. Every f32 convolution runs in full f32
(``hw.full_f32``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.hw import full_f32, resolve_device

_SIGMA_N = 2.0          # VIF noise variance (the visual system's model)


def _luma(frames: np.ndarray) -> np.ndarray:
    """BT.601 luma of uint8 frames, f32 on 0-255 (numpy, as JAX's)."""
    f = frames.astype(np.float32)
    if f.ndim == 4 and f.shape[-1] == 3:
        return f @ np.asarray([0.299, 0.587, 0.114], np.float32)
    return f[..., 0] if f.ndim == 4 else f


def _gauss_kernel(sigma: float) -> np.ndarray:
    r = int(3 * sigma)
    ax = np.arange(-r, r + 1, dtype=np.float32)
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    return g / g.sum()


class _Features:
    """The feature programs on one device (JAX's ``_build_jit``)."""

    def __init__(self, device: torch.device):
        k = torch.from_numpy(_gauss_kernel(1.2)).to(device)
        self.r = (len(k) - 1) // 2
        self.kx = k.view(1, 1, 1, -1)
        self.ky = k.view(1, 1, -1, 1)

    def blur(self, x: torch.Tensor) -> torch.Tensor:
        """Separable Gaussian of (N, H, W), zero borders (SAME)."""
        y = F.conv2d(x[:, None], self.kx, padding=(0, self.r))
        return F.conv2d(y, self.ky, padding=(self.r, 0))[:, 0]

    @staticmethod
    def down2(x: torch.Tensor) -> torch.Tensor:
        n, h, w = x.shape
        return x[:, : h // 2 * 2, : w // 2 * 2].reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    def vif_scale(self, ref: torch.Tensor, dis: torch.Tensor):
        """VIF numerator and denominator at one scale, per frame."""
        blur = self.blur
        mu_r, mu_d = blur(ref), blur(dis)
        s_rr = (blur(ref * ref) - mu_r * mu_r).clamp_min(0.0)
        s_dd = (blur(dis * dis) - mu_d * mu_d).clamp_min(0.0)
        s_rd = blur(ref * dis) - mu_r * mu_d
        g = s_rd / (s_rr + 1e-4)
        sv = (s_dd - g * s_rd).clamp_min(0.0)
        num = torch.log1p(g * g * s_rr / (sv + _SIGMA_N))
        den = torch.log1p(s_rr / _SIGMA_N)
        return num.sum(dim=(1, 2)) + 1e-6, den.sum(dim=(1, 2)) + 1e-6

    def __call__(self, ref: torch.Tensor, dis: torch.Tensor, prev_ref: torch.Tensor) -> dict:
        """ref, dis, prev_ref: (N, H, W) f32 luma on 0-255 -> per-frame
        features."""
        ref = ref / 255.0 * 255.0       # JAX's own (it rounds a value by an ulp)
        vifs = []
        r, d = ref, dis
        for _ in range(4):
            num, den = self.vif_scale(r, d)
            vifs.append(num / den)
            r, d = self.down2(r), self.down2(d)
        blur_ref = self.blur(ref)
        hf_r = ref - blur_ref
        hf_d = dis - self.blur(dis)
        keep = torch.minimum(hf_d.abs(), hf_r.abs()).sum(dim=(1, 2))
        total = hf_r.abs().sum(dim=(1, 2)) + 1e-6
        motion = (blur_ref - self.blur(prev_ref)).abs().mean(dim=(1, 2))
        return {"vif": torch.stack(vifs), "dlm": keep / total, "motion": motion}


@dataclass
class VMAFResult:
    score: float = 0.0                       # 0-100, higher = better
    per_frame: List[float] = field(default_factory=list)
    vif: float = 0.0
    dlm: float = 0.0
    motion: float = 0.0

    def to_dict(self) -> dict:
        return {"vmaf_proxy": round(self.score, 2),
                "vif": round(self.vif, 4), "dlm": round(self.dlm, 4),
                "motion": round(self.motion, 3),
                "frames": len(self.per_frame)}


class VMAFProxy:
    """Scores uint8 reference and distorted frames of one shape, (N, H,
    W[, 3]): ``score(ref, dis)``. ``device``: where the features run (the
    card unless the caller asks for the CPU)."""

    # linear fusion head (JAX's): pristine -> ~100, heavy degradation ->
    # < 30; coarse scales weigh more, motion forgives a little
    W_VIF = (8.0, 10.0, 12.0, 14.0)
    W_DLM = 46.0
    BIAS = 6.0
    MOTION_RELIEF = 0.06

    def __init__(self, device: str = "cuda"):
        self.device = resolve_device(device)
        self._features = None

    def features(self, ref: np.ndarray, dis: np.ndarray) -> dict:
        """Per-frame features as numpy: vif (4, N), dlm (N,), motion (N,)."""
        if ref.shape != dis.shape:
            raise ValueError(f"shape mismatch {ref.shape} vs {dis.shape}")
        if self._features is None:
            self._features = _Features(self.device)
        r = torch.from_numpy(_luma(ref)).to(self.device)
        d = torch.from_numpy(_luma(dis)).to(self.device)
        prev = torch.cat([r[:1], r[:-1]])
        with torch.no_grad(), full_f32():
            f = self._features(r, d, prev)
        return {k: v.cpu().numpy() for k, v in f.items()}

    def score(self, ref: np.ndarray, dis: np.ndarray) -> VMAFResult:
        f = self.features(ref, dis)
        vif, dlm, motion = f["vif"], f["dlm"], f["motion"]
        per = self.BIAS + dlm * self.W_DLM
        for s, w in enumerate(self.W_VIF):
            per = per + np.clip(vif[s], 0, 1.2) * w
        per = per + np.minimum(motion * self.MOTION_RELIEF, 2.0)
        per = np.clip(per, 0.0, 100.0)
        return VMAFResult(score=float(per.mean()), per_frame=[float(v) for v in per],
                          vif=float(vif.mean()), dlm=float(dlm.mean()),
                          motion=float(motion.mean()))
