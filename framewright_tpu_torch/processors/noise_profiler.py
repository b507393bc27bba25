"""Noise profiling: the port's copy of
``framewright_tpu.processors.noise_profiler`` (numpy, on the host).

Luma, chroma and motion-gated temporal noise sigmas in 8-bit pixel
units, FFT frequency bands, edge and flat Laplacian energy, grain
intensity, uniformity and correlation, impulse share and blockiness,
aggregated over sampled frames into a ``NoiseProfile`` whose
classification picks the denoiser and its strength. ``TemporalDenoiser``
in ``auto`` mode profiles its first frames with it.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

# Var(3x3 second-difference Laplacian) = 20 sigma^2 for iid noise
_LAP_VAR = np.sqrt(20.0)
_MAD_TO_SIGMA = 1.0 / 0.6745


class NoiseType(Enum):
    """Reference taxonomy (noise_profiler.py:44-55)."""

    GAUSSIAN = "gaussian"
    SALT_PEPPER = "salt_pepper"
    FILM_GRAIN = "film_grain"
    COMPRESSION = "compression"
    TEMPORAL = "temporal"
    CHROMA = "chroma"
    MIXED = "mixed"
    MINIMAL = "minimal"


@dataclass
class NoiseCharacteristics:
    """Per-frame (or aggregated) noise measurements.

    Sigmas are true noise std estimates in 8-bit pixel units; the
    *_noise fields are the reference's 0-100 scores derived from them
    (sigma * 2, the reference's scaling) so the classification
    thresholds carry over unchanged."""

    luma_sigma: float = 0.0
    chroma_sigma: float = 0.0
    temporal_sigma: float = 0.0
    low_freq: float = 0.0        # band shares, sum ~100
    mid_freq: float = 0.0
    high_freq: float = 0.0
    edge_noise: float = 0.0      # Laplacian std near edges (0-100)
    flat_noise: float = 0.0      # Laplacian std in flat regions (0-100)
    grain_intensity: float = 0.0
    grain_uniformity: float = 0.0
    grain_correlation: float = 0.0  # lag-1 autocorr of the HP residual:
    #                                 white sensor noise ~0, film grain
    #                                 (multi-pixel speckle) clearly > 0
    impulse_fraction: float = 0.0  # salt&pepper pixel share (0-1)
    blockiness: float = 0.0        # 8-px-grid boundary energy excess

    @property
    def luminance_noise(self) -> float:
        return min(100.0, self.luma_sigma * 2.0)

    @property
    def chroma_noise(self) -> float:
        return min(100.0, self.chroma_sigma * 2.0)

    @property
    def temporal_noise(self) -> float:
        return min(100.0, self.temporal_sigma * 4.0)

    def overall(self) -> float:
        return self.luminance_noise * 0.6 + self.chroma_noise * 0.4


@dataclass
class NoiseProfile:
    """Aggregated profile + recommendations (reference NoiseProfile)."""

    characteristics: NoiseCharacteristics = field(
        default_factory=NoiseCharacteristics)
    overall_level: float = 0.0
    dominant_type: NoiseType = NoiseType.MINIMAL
    secondary_types: List[NoiseType] = field(default_factory=list)
    recommended_denoiser: str = "none"   # none|bilateral|temporal|nafnet
    recommended_strength: float = 0.0    # 0-1
    sigma_norm: float = 0.0              # luma sigma in [0,1] pixel units
    similarity_sigma: float = 0.0        # for TemporalDenoiser rejection
    preserve_grain: bool = False
    chroma_only: bool = False
    temporal_recommended: bool = False
    qp_removal: bool = False
    confidence: float = 0.0
    frames_analyzed: int = 0

    def to_dict(self) -> Dict:
        c = self.characteristics
        return {
            "overall_level": round(self.overall_level, 2),
            "dominant_type": self.dominant_type.value,
            "secondary_types": [t.value for t in self.secondary_types],
            "luma_sigma": round(c.luma_sigma, 3),
            "chroma_sigma": round(c.chroma_sigma, 3),
            "temporal_sigma": round(c.temporal_sigma, 3),
            "freq_bands": [round(c.low_freq, 1), round(c.mid_freq, 1),
                           round(c.high_freq, 1)],
            "edge_noise": round(c.edge_noise, 2),
            "flat_noise": round(c.flat_noise, 2),
            "grain_intensity": round(c.grain_intensity, 2),
            "grain_uniformity": round(c.grain_uniformity, 2),
            "grain_correlation": round(c.grain_correlation, 3),
            "impulse_fraction": round(c.impulse_fraction, 5),
            "blockiness": round(c.blockiness, 3),
            "recommended_denoiser": self.recommended_denoiser,
            "recommended_strength": round(self.recommended_strength, 3),
            "preserve_grain": self.preserve_grain,
            "chroma_only": self.chroma_only,
            "qp_removal": self.qp_removal,
            "confidence": round(self.confidence, 2),
            "frames_analyzed": self.frames_analyzed,
        }

    def config_overrides(self) -> Dict:
        """Config-field overrides for the auto-enhance plan (the
        reference ProcessingPlan contribution)."""
        rec: Dict = {}
        if self.qp_removal:
            rec["qp_removal"] = True
        if self.recommended_denoiser != "none":
            rec["denoise"] = True
            rec["denoise_model"] = self.recommended_denoiser
            rec["denoise_strength"] = round(self.recommended_strength, 3)
        if self.preserve_grain:
            rec["grain_preserve"] = True
        return rec


def _lap(g: np.ndarray) -> np.ndarray:
    """3x3 second-difference Laplacian (interior only)."""
    return (4.0 * g[1:-1, 1:-1] - g[:-2, 1:-1] - g[2:, 1:-1]
            - g[1:-1, :-2] - g[1:-1, 2:])


def _grad_mag(g: np.ndarray) -> np.ndarray:
    gx = np.abs(np.diff(g, axis=1, prepend=g[:, :1]))
    gy = np.abs(np.diff(g, axis=0, prepend=g[:1]))
    return gx + gy


def _dilate(mask: np.ndarray, iters: int = 2) -> np.ndarray:
    """Binary 3x3 dilation via shifted maxima (no scipy)."""
    m = mask
    for _ in range(iters):
        p = np.pad(m, 1)
        m = (p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:]
             | p[1:-1, 1:-1] | p[:-2, :-2] | p[:-2, 2:] | p[2:, :-2]
             | p[2:, 2:])
    return m


def _mad_sigma(vals: np.ndarray) -> float:
    if vals.size < 64:
        return 0.0
    med = np.median(vals)
    return float(np.median(np.abs(vals - med)) * _MAD_TO_SIGMA)


def _sigma_from_lap(g: np.ndarray, flat: Optional[np.ndarray] = None) -> float:
    """True Gaussian-sigma estimate: MAD of the Laplacian in flat
    regions / sqrt(20) (the calibrated form of the reference's
    Laplacian-variance method, noise_profiler.py:278)."""
    lap = _lap(g)
    if flat is not None:
        flat_i = flat[1:-1, 1:-1]
        if flat_i.sum() > 256:
            lap = lap[flat_i]
    return _mad_sigma(np.ravel(lap)) / _LAP_VAR


def _box5(g: np.ndarray) -> np.ndarray:
    """5x5 box blur via cumulative sums."""
    p = np.pad(g, 2, mode="edge")
    c = np.cumsum(np.cumsum(p, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    h, w = g.shape
    return (c[5:5 + h, 5:5 + w] - c[:h, 5:5 + w]
            - c[5:5 + h, :w] + c[:h, :w]) / 25.0


class NoiseProfiler:
    """Analyze sampled frames into a NoiseProfile.

    Reference analog: NoiseProfiler.analyze_video (noise_profiler.py:
    157) — this variant consumes in-memory frames (the pipeline is
    stream-based; callers sample frames from the decode ring)."""

    def __init__(self, sample_frames: int = 12, crop: int = 512):
        self.sample_frames = sample_frames
        self.crop = crop

    # ------------------------------------------------------------------
    def analyze_frames(self, frames: Iterable[np.ndarray]) -> NoiseProfile:
        frames = list(frames)
        if not frames:
            return NoiseProfile()
        if len(frames) > self.sample_frames:
            idx = np.linspace(0, len(frames) - 1, self.sample_frames)
            frames = [frames[int(i)] for i in idx]
        chars: List[NoiseCharacteristics] = []
        prev_y = None
        for f in frames:
            y, u, v = self._yuv(self._crop(f))
            chars.append(self._frame_chars(y, u, v, prev_y))
            prev_y = y
        agg = self._aggregate(chars)
        profile = NoiseProfile(characteristics=agg,
                               overall_level=agg.overall(),
                               frames_analyzed=len(frames))
        profile.dominant_type = self._classify(agg)
        profile.secondary_types = self._secondary(agg,
                                                  profile.dominant_type)
        self._recommend(profile)
        profile.confidence = min(1.0, len(frames) / 10.0)
        return profile

    # ------------------------------------------------------------------
    def _crop(self, f: np.ndarray) -> np.ndarray:
        h, w = f.shape[:2]
        ch, cw = min(h, self.crop), min(w, self.crop)
        r0, c0 = (h - ch) // 2, (w - cw) // 2
        return f[r0:r0 + ch, c0:c0 + cw]

    @staticmethod
    def _yuv(f: np.ndarray):
        x = f.astype(np.float32)
        if x.ndim == 2:
            return x, np.zeros_like(x), np.zeros_like(x)
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        u = -0.169 * r - 0.331 * g + 0.5 * b
        v = 0.5 * r - 0.419 * g - 0.081 * b
        return y, u, v

    def _frame_chars(self, y, u, v, prev_y) -> NoiseCharacteristics:
        c = NoiseCharacteristics()
        # masks must come from a SMOOTHED copy: conditioning on the raw
        # gradient selects small-noise pixels and biases the noise
        # estimate down ~3x (selection bias); box-blurring first makes
        # the mask content-driven, not noise-driven
        smooth = _box5(y)
        grad = _grad_mag(smooth)
        flat = grad < 10.0
        c.luma_sigma = _sigma_from_lap(y, flat)
        c.chroma_sigma = 0.5 * (_sigma_from_lap(u, flat)
                                + _sigma_from_lap(v, flat))

        # temporal: frame-difference sigma in static regions
        # (motion-gated, reference _estimate_temporal_noise:301; the
        # motion mask uses the smoothed difference, same bias reason)
        if prev_y is not None and prev_y.shape == y.shape:
            d = y - prev_y
            static = np.abs(_box5(d)) < 15.0
            if static.sum() > 100:
                c.temporal_sigma = _mad_sigma(d[static]) / np.sqrt(2.0)

        # frequency bands (reference _analyze_frequency_domain:331)
        mag = np.abs(np.fft.fftshift(np.fft.fft2(y)))
        rows, cols = y.shape
        cy, cx = rows // 2, cols // 2
        yy, xx = np.ogrid[:rows, :cols]
        dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        maxd = np.sqrt(cy * cy + cx * cx)
        mag[cy, cx] = 0.0
        bands = []
        for m in (dist < maxd * 0.1,
                  (dist >= maxd * 0.1) & (dist < maxd * 0.4),
                  dist >= maxd * 0.4):
            bands.append(float(mag[m].mean()) if m.any() else 0.0)
        tot = sum(bands) + 1e-10
        c.low_freq, c.mid_freq, c.high_freq = (100.0 * b / tot
                                               for b in bands)

        # edge vs flat Laplacian energy (reference
        # _analyze_spatial_noise:378; gradient threshold standing in
        # for Canny)
        lap = _lap(y)
        edge_region = _dilate(grad > 40.0, iters=2)[1:-1, 1:-1]
        flat_region = ~edge_region
        if edge_region.sum() > 100:
            c.edge_noise = min(100.0, float(lap[edge_region].std()) * 2)
        if flat_region.sum() > 100:
            c.flat_noise = min(100.0, float(lap[flat_region].std()) * 2)

        # grain (reference _analyze_grain:418); correlation separates
        # true film grain (correlated speckle) from white gaussian
        # noise, which the reference's intensity/uniformity test alone
        # cannot (both are spatially uniform)
        hp_s = y - smooth
        a, b = hp_s[:, :-1].ravel(), hp_s[:, 1:].ravel()
        denom = float(np.sqrt((a * a).mean() * (b * b).mean())) + 1e-9
        c.grain_correlation = float((a * b).mean()) / denom
        hp = np.abs(hp_s)
        c.grain_intensity = min(100.0, float(hp.mean()) * 4.0)
        bs = 64
        stds = [float(hp[i:i + bs, j:j + bs].std())
                for i in range(0, y.shape[0] - bs, bs)
                for j in range(0, y.shape[1] - bs, bs)]
        if stds:
            m = float(np.mean(stds))
            c.grain_uniformity = (100.0 - min(100.0,
                                              float(np.std(stds)) / m * 100.0)
                                  if m > 0 else 100.0)

        # impulse (salt & pepper): pixels far from their local median —
        # a direct detector the reference approximates via the
        # high-frequency band share
        # blockiness: energy excess at 8-pixel grid boundaries — the
        # direct codec-artifact detector (the reference infers
        # compression from flat/low-freq ratios, which false-positives
        # on quiet-luma content)
        col_d = np.abs(np.diff(y, axis=1)).mean(axis=0)
        if len(col_d) >= 16:
            grid = float(col_d[7::8].mean())
            nong = float(np.delete(col_d, np.s_[7::8]).mean()) + 1e-6
            c.blockiness = min(10.0, max(0.0, grid / nong - 1.0))

        med = np.median(np.stack([
            y[1:-1, 1:-1], y[:-2, 1:-1], y[2:, 1:-1],
            y[1:-1, :-2], y[1:-1, 2:]]), axis=0)
        c.impulse_fraction = float((np.abs(y[1:-1, 1:-1] - med) > 96).mean())
        return c

    @staticmethod
    def _aggregate(chars: Sequence[NoiseCharacteristics]
                   ) -> NoiseCharacteristics:
        agg = NoiseCharacteristics()
        if not chars:
            return agg
        for name in ("luma_sigma", "chroma_sigma", "low_freq", "mid_freq",
                     "high_freq", "edge_noise", "flat_noise",
                     "grain_intensity", "grain_uniformity",
                     "grain_correlation", "impulse_fraction",
                     "blockiness"):
            setattr(agg, name,
                    float(np.median([getattr(c, name) for c in chars])))
        temps = [c.temporal_sigma for c in chars if c.temporal_sigma > 0]
        agg.temporal_sigma = float(np.median(temps)) if temps else 0.0
        return agg

    # ------------------------------------------------------------------
    @staticmethod
    def _classify(c: NoiseCharacteristics) -> NoiseType:
        """Reference decision tree (_classify_noise_type:504) with a
        direct impulse detector in place of the freq-share heuristic."""
        # impulse check precedes the minimal gate: the robust (MAD)
        # sigma is immune to sparse impulses, so a salt&pepper clip
        # reads as low "overall" noise yet still needs repair
        if c.impulse_fraction > 0.002:
            return NoiseType.SALT_PEPPER
        if c.blockiness > 0.25:
            # blocking is a defect even when "noise" reads low — the
            # block-flattened case has near-zero sigma by construction,
            # so this check precedes the minimal gate
            return NoiseType.COMPRESSION
        if c.overall() < 5.0:
            return NoiseType.MINIMAL
        if (c.grain_intensity > 20.0 and c.grain_uniformity > 60.0
                and c.grain_correlation > 0.15):
            return NoiseType.FILM_GRAIN
        if c.chroma_noise > c.luminance_noise * 1.5:
            return NoiseType.CHROMA
        if c.temporal_noise > c.luminance_noise:
            return NoiseType.TEMPORAL
        if c.mid_freq > 30.0:
            return NoiseType.GAUSSIAN
        return NoiseType.MIXED

    @staticmethod
    def _secondary(c: NoiseCharacteristics, dominant: NoiseType
                   ) -> List[NoiseType]:
        out = []
        checks = [
            (NoiseType.TEMPORAL, c.temporal_noise > 10.0),
            (NoiseType.CHROMA, c.chroma_noise > 15.0),
            (NoiseType.FILM_GRAIN, c.grain_intensity > 15.0),
            (NoiseType.SALT_PEPPER, c.impulse_fraction > 0.001),
        ]
        for t, hit in checks:
            if hit and t != dominant:
                out.append(t)
        return out

    @staticmethod
    def _recommend(p: NoiseProfile) -> None:
        """Reference _determine_recommendations:542 mapped onto this
        framework's denoisers (temporal_denoise.py methods + the QP
        remover)."""
        c = p.characteristics
        level = p.overall_level
        p.sigma_norm = c.luma_sigma / 255.0
        # photometric rejection width for aligned-frame blending:
        # diff variance between two aligned noisy frames = 2 sigma^2
        p.similarity_sigma = max(0.03, 3.0 * p.sigma_norm)
        t = p.dominant_type
        if t == NoiseType.MINIMAL:
            p.recommended_denoiser = "none"
            return
        if t == NoiseType.SALT_PEPPER:
            # impulse noise: the aggressive spatial net handles it;
            # temporal blending would smear impulses across frames
            p.recommended_denoiser = "nafnet"
            p.recommended_strength = min(1.0, max(0.5, level / 40.0))
            return
        if t == NoiseType.FILM_GRAIN:
            p.recommended_denoiser = "temporal"
            p.recommended_strength = min(0.6, level / 50.0)
            p.preserve_grain = True
            return
        if t == NoiseType.COMPRESSION:
            p.qp_removal = True
            if level >= 15.0:
                p.recommended_denoiser = "bilateral"
                p.recommended_strength = min(1.0, level / 40.0)
            else:
                p.recommended_denoiser = "none"
            return
        if t == NoiseType.CHROMA:
            p.recommended_denoiser = "temporal"
            p.recommended_strength = min(1.0, c.chroma_noise / 40.0)
            p.chroma_only = True
            return
        if t == NoiseType.TEMPORAL or c.temporal_noise > 15.0:
            p.recommended_denoiser = "temporal"
            p.recommended_strength = min(1.0, level / 40.0)
            p.temporal_recommended = True
            return
        if level < 20.0:
            p.recommended_denoiser = "bilateral"
            p.recommended_strength = level / 40.0
        else:
            p.recommended_denoiser = "nafnet"
            p.recommended_strength = min(1.0, level / 60.0)


def profile_frames(frames: Iterable[np.ndarray], sample_frames: int = 12) -> NoiseProfile:
    """The noise profile of the first ``sample_frames`` frames."""
    return NoiseProfiler(sample_frames=sample_frames).analyze_frames(frames)
