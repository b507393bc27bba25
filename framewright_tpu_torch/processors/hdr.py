"""The port of ``framewright_tpu.processors.hdr``: numpy on the host, as in
JAX, op for op (the HDR10+ sidecar's JSON is JAX's byte for byte).

SDR <-> HDR conversion.

Capability parity with the reference's HDR stack
(processors/hdr_conversion.py:284 HDRConverter, hdr_expansion.py:103
HDRExpander inverse tone mapping, enhancement/hdr_export.py:711
HDR10/HLG export with tone mappers): transfer-function math on arrays;
container signaling (HDR10 metadata) rides the export presets.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# PQ (SMPTE ST 2084) constants
_M1 = 2610 / 16384
_M2 = 2523 / 4096 * 128
_C1 = 3424 / 4096
_C2 = 2413 / 4096 * 32
_C3 = 2392 / 4096 * 32


def pq_encode(linear_nits: np.ndarray, peak_nits: float = 10000.0) -> np.ndarray:
    """Linear light (nits) -> PQ signal [0,1]."""
    y = np.clip(linear_nits / peak_nits, 0.0, 1.0)
    ym = y ** _M1
    return ((_C1 + _C2 * ym) / (1.0 + _C3 * ym)) ** _M2


def pq_decode(signal: np.ndarray, peak_nits: float = 10000.0) -> np.ndarray:
    """PQ signal [0,1] -> linear light (nits)."""
    e = np.clip(signal, 0.0, 1.0) ** (1.0 / _M2)
    num = np.maximum(e - _C1, 0.0)
    den = _C2 - _C3 * e
    return peak_nits * (num / np.maximum(den, 1e-8)) ** (1.0 / _M1)


def hlg_oetf(linear: np.ndarray) -> np.ndarray:
    """Linear [0,1] -> HLG signal (BT.2100)."""
    a, b, c = 0.17883277, 0.28466892, 0.55991073
    return np.where(linear <= 1 / 12,
                    np.sqrt(3 * linear),
                    a * np.log(np.maximum(12 * linear - b, 1e-8)) + c)


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, x * 12.92, 1.055 * x ** (1 / 2.4) - 0.055)


def hable_tonemap(x: np.ndarray) -> np.ndarray:
    """Filmic (Uncharted 2) tone mapper for HDR->SDR."""
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30

    def f(v):
        return ((v * (A * v + C * B) + D * E) / (v * (A * v + B) + D * F)) - E / F

    white = f(np.asarray(11.2))
    return f(x) / white


def reinhard_tonemap(x: np.ndarray, white: float = 4.0) -> np.ndarray:
    return x * (1.0 + x / (white * white)) / (1.0 + x)


@dataclass
class HDRConfig:
    mode: str = "expand"            # expand (SDR->HDR) | tonemap (HDR->SDR)
    target: str = "hdr10"           # hdr10 (PQ) | hlg | hdr10plus (PQ +
                                    # ST 2094-40 dynamic metadata sidecar)
    peak_nits: float = 1000.0       # mastering peak for expansion
    sdr_nits: float = 203.0         # reference white
    highlight_boost: float = 0.6    # how aggressively to expand highlights
    tonemapper: str = "hable"       # hable | reinhard


class HDRConverter:
    def __init__(self, config: Optional[HDRConfig] = None):
        self.config = config or HDRConfig()
        # hdr10plus: collect ST 2094-40 per-scene stats during expansion
        self.collector = (Hdr10PlusCollector()
                          if self.config.target == "hdr10plus" else None)

    # ------------------------------------------------------------------
    def expand_frame(self, frame: np.ndarray) -> np.ndarray:
        """SDR uint8 -> HDR signal uint8 (PQ- or HLG-encoded, 10-bit
        values scaled into 8-bit containers here; true 10-bit lands at
        encode via pixel_format yuv420p10le)."""
        cfg = self.config
        lin = srgb_to_linear(frame.astype(np.float32) / 255.0)
        # inverse tone mapping: keep midtones at reference white, expand
        # highlights with a power curve (reference HDRExpander approach)
        luma = lin.max(axis=-1, keepdims=True)
        boost = 1.0 + cfg.highlight_boost * np.clip(luma - 0.6, 0, 1) ** 2 \
            * (cfg.peak_nits / cfg.sdr_nits - 1.0)
        nits = lin * cfg.sdr_nits * boost
        if self.collector is not None:
            self.collector.record(nits)
        if cfg.target == "hlg":
            sig = hlg_oetf(np.clip(nits / cfg.peak_nits, 0, 1))
        else:                       # hdr10 and hdr10plus are PQ-encoded
            sig = pq_encode(nits)
        return np.clip(sig * 255.0 + 0.5, 0, 255).astype(np.uint8)

    def tonemap_frame(self, frame: np.ndarray) -> np.ndarray:
        """HDR (PQ-encoded) uint8 -> SDR uint8."""
        cfg = self.config
        nits = pq_decode(frame.astype(np.float32) / 255.0)
        rel = nits / cfg.sdr_nits
        mapped = (hable_tonemap(rel) if cfg.tonemapper == "hable"
                  else reinhard_tonemap(rel))
        return np.clip(linear_to_srgb(mapped) * 255.0 + 0.5, 0, 255).astype(np.uint8)

    def process_stream(self, frames_iter: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        fn = self.expand_frame if self.config.mode == "expand" else self.tonemap_frame
        for f in frames_iter:
            yield fn(f)


# ---------------------------------------------------------------------------
# HDR10+ dynamic metadata (SMPTE ST 2094-40)
# ---------------------------------------------------------------------------

class Hdr10PlusCollector:
    """Per-scene dynamic tone-mapping metadata for HDR10+ export
    (reference enhancement/hdr_export.py:711 HDR10+/DolbyVision modes).

    Records per-frame MaxSCL (per-channel peak nits) and average MaxRGB
    while the HDR expansion runs, segments scenes on luminance jumps,
    and emits the hdr10plus_tool-compatible JSON the encoder muxes as
    an itu_t_t35 SEI. Values are in 0.00001-nit units per the spec."""

    def __init__(self, scene_jump_nits: float = 80.0):
        self.scene_jump = scene_jump_nits
        self.frames: List[Dict] = []
        self._last_avg: Optional[float] = None

    def record(self, nits: np.ndarray) -> None:
        """nits: (H, W, 3) linear luminance in cd/m2 (pre-PQ)."""
        maxscl = [float(nits[..., c].max()) for c in range(3)]
        maxrgb = nits.max(axis=-1)
        avg = float(maxrgb.mean())
        new_scene = (self._last_avg is None
                     or abs(avg - self._last_avg) > self.scene_jump)
        self._last_avg = avg
        self.frames.append({"maxscl": maxscl, "avg": avg,
                            "scene_start": new_scene})

    def scenes(self) -> List[Tuple[int, int]]:
        bounds = [i for i, f in enumerate(self.frames) if f["scene_start"]]
        bounds.append(len(self.frames))
        return [(a, b) for a, b in zip(bounds, bounds[1:]) if b > a]

    def to_json(self) -> str:
        import json as _json

        units = 100000.0   # 0.00001 nit units (ST 2094-40)
        scene_info = []
        for idx, (a, b) in enumerate(self.scenes()):
            seg = self.frames[a:b]
            maxscl = [int(max(f["maxscl"][c] for f in seg) * units)
                      for c in range(3)]
            avg = int(np.mean([f["avg"] for f in seg]) * units)
            for off in range(b - a):
                scene_info.append({
                    "LuminanceParameters": {
                        "AverageRGB": avg,
                        "MaxScl": maxscl,
                        "LuminanceDistributions": {
                            "DistributionIndex":
                                [1, 5, 10, 25, 50, 75, 90, 95, 99],
                            "DistributionValues": maxscl[:1] * 9,
                        },
                    },
                    "NumberOfWindows": 1,
                    "TargetedSystemDisplayMaximumLuminance": 400,
                    "SceneFrameIndex": off,
                    "SceneId": idx,
                })
        doc = {
            "JSONInfo": {"HDR10plusProfile": "B",
                         "Version": "1.0"},
            "SceneInfo": scene_info,
            "SceneInfoSummary": {
                "SceneFirstFrameIndex":
                    [a for a, _ in self.scenes()],
                "SceneFrameNumbers":
                    [b - a for a, b in self.scenes()],
            },
        }
        return _json.dumps(doc, indent=1)
