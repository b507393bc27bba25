"""Output quality validation: the port of
``framewright_tpu.quality.validators``.

The gate compares each output frame with the bicubic upscale of its
input (``layers.resize_bicubic``): min_psnr 25 dB, min_ssim 0.85, and
no dropped, black or non-finite frame. On the restore's YUV path the SR
processor computes the per-frame scores in its device pass and the
restorer feeds them to ``observe_scores``; on any other path sampled
(input, output) pairs are kept by ``observe`` and scored at the end.
With ``min_vmaf > 0`` the sampled pairs are also scored by
``quality.vmaf.VMAFProxy`` on ``device`` against their references, the
inputs resized bicubically on 0-255, clipped and truncated to uint8 (as
JAX's), and the gate needs the score at ``min_vmaf`` or above; the
restore keeps the RGB writer path for it.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class QualityReport:
    psnr: float = 0.0
    ssim: float = 0.0
    vmaf: float = 0.0                      # vmaf_proxy; 0 = not computed
    min_psnr: float = 25.0
    min_ssim: float = 0.85
    min_vmaf: float = 0.0
    samples: int = 0
    passed: bool = False
    per_sample_psnr: List[float] = field(default_factory=list)
    per_sample_ssim: List[float] = field(default_factory=list)
    temporal_ok: bool = True
    first_frame: int = 0                   # a resumed run scores frames from here on
    notes: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        d = {
            "psnr": round(self.psnr, 3),
            "ssim": round(self.ssim, 4),
            "samples": self.samples,
            "passed": self.passed,
            "temporal_ok": self.temporal_ok,
            "notes": self.notes,
        }
        if self.vmaf:
            d["vmaf_proxy"] = round(self.vmaf, 2)
        if self.first_frame:
            d["first_frame"] = self.first_frame
        return d


class QualityValidator:
    """Collects per-frame scores (or sampled pairs) while the restore
    streams, and gates them at the end.

    The reference image is the bicubic upscale of the input frame: a
    structural-fidelity check that catches corruption, colour shifts
    and tile seams. Enhancement should add detail, so the thresholds are
    gates against breakage.

    ``first_frame`` is the index of the first frame observed (a resumed
    restore's start): frame numbers in the notes count from the clip's
    start, and the report says that the frames before it are not in it."""

    def __init__(self, min_psnr: float = 25.0, min_ssim: float = 0.85,
                 sample_every: int = 25, max_samples: int = 24,
                 min_vmaf: float = 0.0, first_frame: int = 0, device: str = "cuda"):
        self.min_psnr = min_psnr
        self.device = device          # where the VMAF features run
        self.min_ssim = min_ssim
        self.min_vmaf = min_vmaf
        self.sample_every = max(1, sample_every)
        self.max_samples = max_samples
        self.first_frame = first_frame
        self._pairs: List[Tuple[np.ndarray, np.ndarray]] = []
        self._frame_count = 0
        self._luma_track: List[float] = []
        self._device_psnr: List[float] = []
        self._device_ssim: List[float] = []
        self.integrity_failures: List[Tuple[int, str]] = []

    def observe(self, in_frame: np.ndarray, out_frame: np.ndarray) -> None:
        """Take a (pre-stage, post-stage) pair of uint8 frames; every
        ``sample_every``-th is kept for scoring, up to ``max_samples``."""
        i = self._frame_count
        self._frame_count += 1
        self._luma_track.append(float(out_frame.mean()))
        if i % self.sample_every == 0 and len(self._pairs) < self.max_samples:
            self._pairs.append((in_frame.copy(), out_frame.copy()))

    def observe_scores(self, psnr, ssim, luma, std=None, finite=None) -> None:
        """Take per-frame scores computed on the device in the SR pass
        (``SRConfig.device_stats``). ``std`` and ``finite`` carry the
        integrity signals: a non-finite frame fails, and so does a black
        or flat one (std < 0.5 and luma < 4)."""
        base = self.first_frame + self._frame_count
        self._frame_count += len(psnr)
        self._device_psnr.extend(float(v) for v in psnr)
        self._device_ssim.extend(float(v) for v in ssim)
        self._luma_track.extend(float(v) for v in luma)
        if finite is not None:
            for k, ok in enumerate(finite):
                if not bool(ok):
                    self.integrity_failures.append((base + k, "non-finite pixels"))
        if std is not None:
            for k, s in enumerate(std):
                if float(s) < 0.5 and float(luma[k]) < 4.0:
                    self.integrity_failures.append((base + k, "black/flat frame"))

    def validate(self) -> QualityReport:
        rep = QualityReport(min_psnr=self.min_psnr, min_ssim=self.min_ssim,
                            samples=len(self._pairs), first_frame=self.first_frame)
        if self.first_frame:
            rep.notes.append(f"resumed run: frames 0-{self.first_frame - 1} were scored "
                             "by an earlier run and are not in this report")
        for idx, why in self.integrity_failures[:8]:
            rep.notes.append(f"frame {idx} integrity: {why}")
        if self._device_psnr and not self._pairs:
            rep.samples = len(self._device_psnr)
            rep.per_sample_psnr = [round(p, 2) for p in self._device_psnr]
            rep.per_sample_ssim = [round(s, 4) for s in self._device_ssim]
            rep.psnr = float(np.mean(self._device_psnr))
            rep.ssim = float(np.mean(self._device_ssim))
            rep.temporal_ok = self._check_temporal()
            if not rep.temporal_ok:
                rep.notes.append("luma discontinuity: possible dropped/black frames")
            rep.passed = (rep.psnr >= self.min_psnr and rep.ssim >= self.min_ssim
                          and rep.temporal_ok and not self.integrity_failures)
            return rep
        if not self._pairs:
            rep.passed = True
            rep.notes.append("no samples collected")
            return rep
        psnrs, ssims = self._score_pairs()
        rep.per_sample_psnr = [round(p, 2) for p in psnrs]
        rep.per_sample_ssim = [round(s, 4) for s in ssims]
        rep.psnr = float(np.mean(psnrs))
        rep.ssim = float(np.mean(ssims))
        if self.min_vmaf > 0:
            rep.vmaf = self._score_vmaf()
            rep.min_vmaf = self.min_vmaf
            if rep.vmaf < self.min_vmaf:
                rep.notes.append(f"vmaf_proxy {rep.vmaf:.1f} < gate {self.min_vmaf}")
        rep.temporal_ok = self._check_temporal()
        if not rep.temporal_ok:
            rep.notes.append("luma discontinuity: possible dropped/black frames")
        rep.passed = (rep.psnr >= self.min_psnr and rep.ssim >= self.min_ssim
                      and rep.temporal_ok
                      and (self.min_vmaf <= 0 or rep.vmaf >= self.min_vmaf))
        return rep

    def _score_vmaf(self) -> float:
        """The VMAF proxy of the kept pairs against their references."""
        import torch

        from framewright_tpu_torch.models.layers import resize_bicubic
        from framewright_tpu_torch.quality.vmaf import VMAFProxy

        refs = np.stack([
            np.clip(resize_bicubic(torch.from_numpy(i[None]).float(), o.shape[:2])[0].numpy(),
                    0, 255).astype(np.uint8)
            for i, o in self._pairs])
        outs = np.stack([o for _, o in self._pairs])
        return VMAFProxy(self.device).score(refs, outs).score

    def _score_pairs(self) -> Tuple[List[float], List[float]]:
        """PSNR and SSIM of each kept pair against the bicubic upscale of
        its input, on the CPU."""
        import torch

        from framewright_tpu_torch.models.layers import resize_bicubic
        from framewright_tpu_torch.ops import metrics

        psnrs, ssims = [], []
        for inp, out in self._pairs:
            ref = resize_bicubic(torch.from_numpy(inp[None]).float() / 255.0, out.shape[:2])
            o = torch.from_numpy(out[None]).float() / 255.0
            psnrs.append(float(metrics.psnr(o, ref)))
            ssims.append(float(metrics.ssim(o, ref)))
        return psnrs, ssims

    def _check_temporal(self) -> bool:
        """Flag a black or white frame between two normal ones."""
        lum = np.asarray(self._luma_track)
        for i in range(1, len(lum) - 1):
            if lum[i] < 2.0 and lum[i - 1] > 20 and lum[i + 1] > 20:
                return False
        return True
