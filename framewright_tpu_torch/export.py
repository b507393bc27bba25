"""Export presets, sidecar metadata and comparison artifacts (the port of
``framewright_tpu.export``): JAX's encode presets, the JSON sidecar of a
restore (it names the port's version), a before/after thumbnail grid
resized on the port's ``models.layers.resize_bilinear`` on an explicit
device, and the before/after slider page."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np

from framewright_tpu_torch.errors import ConfigError


@dataclass(frozen=True)
class ExportPreset:
    name: str
    description: str
    codec: str = "libx265"
    crf: int = 18
    encode_preset: str = "medium"
    pixel_format: str = "yuv420p"
    max_height: int = 0          # 0 = keep
    target_fps: float = 0.0      # 0 = keep
    extra_args: tuple = ()


# framewright_tpu/export.py:33-60
EXPORT_PRESETS: Dict[str, ExportPreset] = {
    p.name: p for p in [
        ExportPreset("youtube", "YouTube upload (H.264 high bitrate)",
                     codec="libx264", crf=17, encode_preset="slow",
                     extra_args=("-movflags", "+faststart")),
        ExportPreset("youtube_hdr", "YouTube HDR10",
                     codec="libx265", crf=16, pixel_format="yuv420p10le",
                     extra_args=("-x265-params",
                                 "hdr10=1:colorprim=bt2020:transfer=smpte2084")),
        ExportPreset("vimeo", "Vimeo upload", codec="libx264", crf=16,
                     encode_preset="slow"),
        ExportPreset("archive", "Archival master (near-lossless HEVC)",
                     codec="libx265", crf=10, encode_preset="slow"),
        ExportPreset("archive_ffv1", "Archival lossless (FFV1)",
                     codec="ffv1", crf=0),
        ExportPreset("web", "Web embed (small H.264)", codec="libx264",
                     crf=23, encode_preset="medium", max_height=1080),
        ExportPreset("mobile", "Mobile-friendly", codec="libx264", crf=24,
                     max_height=720),
        ExportPreset("plex", "Plex/Jellyfin direct play", codec="libx264",
                     crf=18),
        ExportPreset("prores_proxy", "Editing proxy (ProRes)",
                     codec="prores_ks", crf=0,
                     extra_args=("-profile:v", "0")),
    ]
}


def get_export_preset(name: str) -> ExportPreset:
    if name not in EXPORT_PRESETS:
        raise ConfigError(f"Unknown export preset {name!r}; available: {sorted(EXPORT_PRESETS)}")
    return EXPORT_PRESETS[name]


def apply_export_preset(config, name: str):
    """``config`` with the preset's encode settings."""
    p = get_export_preset(name)
    return config.with_overrides(codec=p.codec, crf=p.crf, encode_preset=p.encode_preset,
                                 pixel_format=p.pixel_format)


def write_sidecar(output_path: Path, config, result, source: str) -> Path:
    """``<output>.json`` saying how the output was made: JAX's keys, the
    version under ``framewright_tpu_torch_version``."""
    from framewright_tpu_torch import __version__

    sidecar = {
        "framewright_tpu_torch_version": __version__,
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "source": str(source),
        "output": str(output_path),
        "config": config.to_dict(),
        "config_hash": config.get_hash(),
        "frames_out": result.frames_out,
        "duration_s": round(result.duration_s, 2),
        "quality": result.quality.to_dict() if result.quality else None,
    }
    path = Path(str(output_path) + ".json")
    path.write_text(json.dumps(sidecar, indent=2))
    return path


def comparison_grid(before: List[np.ndarray], after: List[np.ndarray], max_cols: int = 4,
                    device: str = "cuda") -> np.ndarray:
    """Before | after thumbnail pairs (120 px high, the after frame resized
    to the before frame's thumbnail) side by side, up to ``max_cols``,
    as one uint8 image; the resizes run on ``device``."""
    import torch

    from framewright_tpu_torch.hw import resolve_device
    from framewright_tpu_torch.models.layers import resize_bilinear

    if len(before) != len(after) or not before:
        raise ValueError("comparison_grid needs as many after frames as before frames, >= 1")
    dev = resolve_device(device)
    th = 120

    def thumb(frame: np.ndarray, tw: int) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(frame[None])).to(dev).float() / 255.0
        return resize_bilinear(x, (th, tw))[0].cpu().numpy()

    pairs = []
    for b, a in zip(before[:max_cols], after[:max_cols]):
        tw = max(2, int(round(b.shape[1] * th / b.shape[0])))
        divider = np.ones((th, 2, 3), np.float32)
        pairs.append(np.concatenate([thumb(b, tw), divider, thumb(a, tw)], axis=1))
    sep = np.ones((th, 6, 3), np.float32) * 0.5
    row = pairs[0]
    for p in pairs[1:]:
        row = np.concatenate([row, sep, p], axis=1)
    return np.clip(row * 255 + 0.5, 0, 255).astype(np.uint8)


def comparison_html(before_png: str, after_png: str, title: str = "Comparison") -> str:
    """A self-contained before/after slider page; the image paths are
    relative references."""
    return f"""<!doctype html><html><head><meta charset="utf-8"><title>{title}</title>
<style>
body{{font-family:system-ui;margin:2rem;background:#111;color:#eee}}
.wrap{{position:relative;max-width:960px;overflow:hidden}}
.wrap img{{display:block;width:100%}}
.after{{position:absolute;inset:0;clip-path:inset(0 50% 0 0)}}
input[type=range]{{width:100%;max-width:960px}}
</style></head><body><h1>{title}</h1>
<div class="wrap"><img src="{before_png}" alt="before">
<div class="after"><img src="{after_png}" alt="after"></div></div>
<input type="range" min="0" max="100" value="50" oninput="
document.querySelector('.after').style.clipPath='inset(0 '+(100-this.value)+'% 0 0)'">
<p>Drag the slider: left = before, right = after.</p></body></html>"""
