"""A/B runs and the SR ensemble: the port of ``framewright_tpu.testing``.

``ABTestRunner`` restores one clip once per config variant with the
port's ``VideoRestorer`` (the gate on, the checkpoint off, as JAX's) and
scores each by its QA report's mean PSNR and SSIM against the bicubic
upscale of its input; ``winner`` picks the best by a metric.

The SR ensemble: several SR models of one scale run on the same frames and their uint8
outputs are combined on the host, as the JAX class does in numpy:
``weighted`` (the weighted mean, clipped and truncated to uint8),
``median`` (``np.median`` over the members, truncated) or
``max_sharpness`` (per frame, the member whose grey image has the
largest variance of its wrapped 4-neighbour Laplacian). Each member is
the port's ``SuperResolution``, so the members run their kernel paths on
the card; ``dispatch`` enqueues every member's batch before
``materialize`` waits for them (the JAX class runs them one after the
other through ``process_batch``). Each member plans its batch for an
equal share of the card's memory (``hbm_utilization`` / members) less
an equal share of ``reserved_bytes`` (the restore's pre-SR and face
reserves), and the ensemble's ``plan.frames`` is the smallest of
theirs. The restorer passes ``weights_dir`` (the JAX restorer builds
the ensemble without it).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import ConfigError

STRATEGIES = ("weighted", "median", "max_sharpness")


@dataclass
class ABVariant:
    name: str
    overrides: Dict


@dataclass
class ABResult:
    variant: str
    psnr: float
    ssim: float
    fps: float
    seconds: float


class ABTestRunner:
    """One clip through config variants, each written to
    ``work_dir/<name>.y4m`` and scored by its QA report."""

    def __init__(self, base_config: Config, work_dir: Path):
        self.base = base_config
        self.work_dir = Path(work_dir)

    def run(self, source: Path, variants: List[ABVariant],
            sample_frames: int = 8) -> List[ABResult]:
        """``sample_frames`` is JAX's argument, read by nothing there or
        here: the gate scores every frame."""
        from framewright_tpu_torch.restorer import VideoRestorer

        results = []
        for var in variants:
            cfg = self.base.with_overrides(project_dir=str(self.work_dir / var.name),
                                           validate_output=True, checkpoint_enabled=False,
                                           **var.overrides)
            out = self.work_dir / f"{var.name}.y4m"
            t0 = time.time()
            res = VideoRestorer(cfg).restore_video(source, output=out)
            dt = time.time() - t0
            q = res.quality
            results.append(ABResult(variant=var.name, psnr=q.psnr if q else 0.0,
                                    ssim=q.ssim if q else 0.0,
                                    fps=round(res.frames_out / dt, 2) if dt else 0.0,
                                    seconds=round(dt, 2)))
        return results

    @staticmethod
    def winner(results: List[ABResult], metric: str = "psnr") -> ABResult:
        return max(results, key=lambda r: getattr(r, metric))


@dataclass(frozen=True)
class EnsemblePlan:
    frames: int                    # frames a dispatch takes (the members' smallest)
    est_bytes: int                 # the members' planned bytes together


class EnsembleSR:
    name = "ensemble_sr"

    def __init__(self, model_names: List[str], strategy: str = "weighted",
                 weights: Optional[List[float]] = None, weights_dir: Optional[str] = None,
                 compute_dtype: str = "float32", device: str = "cuda",
                 hbm_utilization: float = 0.85, reserved_bytes: int = 0):
        from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution

        if strategy not in STRATEGIES:
            raise ConfigError(f"ensemble strategy must be one of {STRATEGIES}, got {strategy!r}")
        self.strategy = strategy
        self.weights = weights or [1.0] * len(model_names)
        n_members = max(1, len(model_names))
        self.members = [SuperResolution(SRConfig(model_name=n, compute_dtype=compute_dtype,
                                                 weights_dir=weights_dir, device=device,
                                                 hbm_utilization=hbm_utilization / n_members,
                                                 reserved_bytes=reserved_bytes // n_members))
                        for n in model_names]
        self.scale = 0
        self.device = None

    def setup(self, height: int, width: int) -> None:
        scales = set()
        for m in self.members:
            m.setup(height, width)
            scales.add(m.scale)
        if len(scales) != 1:
            raise ConfigError(f"ensemble members disagree on scale: {scales}")
        self.scale = scales.pop()
        self.device = self.members[0].device

    @property
    def plan(self) -> EnsemblePlan:
        return EnsemblePlan(min(m.plan.frames for m in self.members),
                            sum(m.plan.est_bytes for m in self.members))

    @property
    def dispatches(self) -> int:
        return self.members[0].dispatches

    def output_size(self, height: int, width: int):
        return height * self.scale, width * self.scale

    def teardown(self) -> None:
        for m in self.members:
            m.teardown()

    def dispatch(self, frames: np.ndarray) -> list:
        return [m.dispatch(frames) for m in self.members]

    def materialize(self, handles: list) -> np.ndarray:
        outs = np.stack([m.materialize(h).astype(np.float32)
                         for m, h in zip(self.members, handles)])
        return self.vote(outs)

    def process_batch(self, frames: np.ndarray) -> np.ndarray:
        return self.materialize(self.dispatch(frames))

    def vote(self, outs: np.ndarray) -> np.ndarray:
        """The members' f32 outputs (M, B, H, W, 3) -> uint8 (B, H, W, 3)."""
        if self.strategy == "median":
            return np.median(outs, axis=0).astype(np.uint8)
        if self.strategy == "max_sharpness":
            keep = []
            for b in range(outs.shape[1]):
                sharp = [self._sharpness(outs[m, b]) for m in range(len(self.members))]
                keep.append(outs[int(np.argmax(sharp)), b])
            return np.stack(keep).astype(np.uint8)
        w = np.asarray(self.weights, np.float32)[:, None, None, None, None]
        return np.clip((outs * w).sum(0) / w.sum(), 0, 255).astype(np.uint8)

    @staticmethod
    def _sharpness(frame: np.ndarray) -> float:
        g = frame.mean(-1)
        lap = (4 * g - np.roll(g, 1, 0) - np.roll(g, -1, 0)
               - np.roll(g, 1, 1) - np.roll(g, -1, 1))
        return float(lap.var())
