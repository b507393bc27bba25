"""Hardware-aware preset registry and smart selection (the port's
``framewright_tpu/presets.py``): presets are ``Config`` deltas; the
registry filters them by the detected hardware and downshifts what the
hardware cannot sustain; the smart selector combines a content
``AnalysisReport`` with the hardware to pick and tune one.

On a card, JAX's rules read the card: a preset's ``min_memory_gb`` is the
card's total memory, ``accelerator_only`` (JAX's ``tpu_only``) means a
CUDA card, and ``adjust_for_hardware`` downshifts only on ``CPU_ONLY``
(the compact x4 model in float32, at its own scale: the port's Config
refuses another) or on a card with less than 8 GB (256-pixel tiles).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from framewright_tpu_torch.config import PRESETS, Config, get_preset, with_model_scale
from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.hw import HardwareInfo, HardwareTier, detect_hardware

logger = logging.getLogger(__name__)


@dataclass
class PresetInfo:
    name: str
    description: str
    min_memory_gb: float = 0.0
    accelerator_only: bool = False
    overrides: Dict = field(default_factory=dict)


class PresetRegistry:
    """Built-in presets and user registrations, filtered by hardware."""

    def __init__(self, hardware: Optional[HardwareInfo] = None):
        self.hardware = hardware or detect_hardware()
        self._extra: Dict[str, PresetInfo] = {}
        self._builtin = {
            "fast": PresetInfo("fast", PRESETS["fast"]["description"]),
            "quality": PresetInfo("quality", PRESETS["quality"]["description"],
                                  min_memory_gb=8),
            "archive": PresetInfo("archive", PRESETS["archive"]["description"],
                                  min_memory_gb=8),
            "ultimate": PresetInfo("ultimate", PRESETS["ultimate"]["description"],
                                   min_memory_gb=12),
        }

    def register(self, info: PresetInfo) -> None:
        self._extra[info.name] = info

    def available(self) -> List[PresetInfo]:
        mem_gb = self.hardware.memory_per_device / 2**30
        out = []
        for info in {**self._builtin, **self._extra}.values():
            if info.accelerator_only and self.hardware.platform != "cuda":
                continue
            if mem_gb and mem_gb < info.min_memory_gb:
                continue
            out.append(info)
        return sorted(out, key=lambda i: i.name)

    def build_config(self, name: str, **overrides) -> Config:
        """The preset's config with ``overrides``, adjusted to the hardware.
        A registered preset's name is not kept in ``Config.preset``, which
        names the built-in presets only (JAX keeps any name there)."""
        if name in self._builtin:
            base = {**get_preset(name), "preset": name}
        elif name in self._extra:
            base = dict(self._extra[name].overrides)
        else:
            raise ConfigError(f"Unknown preset {name!r}")
        base.update(with_model_scale(overrides))
        return self.adjust_for_hardware(Config(**base))

    def adjust_for_hardware(self, cfg: Config) -> Config:
        """Downshift what the hardware cannot sustain: on the CPU the
        compact x4 model in float32, on a card under 8 GB 256-pixel tiles."""
        hw = self.hardware
        adjust = {}
        if hw.tier is HardwareTier.CPU_ONLY:
            if cfg.sr_model.startswith("RealESRGAN"):
                adjust["sr_model"] = "realesr-general-x4v3"
            adjust["compute_dtype"] = "float32"
        if 0 < hw.memory_per_device / 2**30 < 8 and cfg.tile_size == 0:
            adjust["tile_size"] = 256
        if adjust:
            logger.info("hardware adjustment: %s", adjust)
            return cfg.with_overrides(**with_model_scale(adjust))
        return cfg


class SmartPresetSelector:
    """Content analysis and hardware -> a preset and tuned overrides."""

    def __init__(self, registry: Optional[PresetRegistry] = None):
        self.registry = registry or PresetRegistry()

    def select(self, report, nb_frames: int = 0) -> Config:
        """report: ``processors.analysis.AnalysisReport``."""
        return self.select_with_info(report, nb_frames)[2]

    def select_with_info(self, report, nb_frames: int = 0):
        """-> (preset name, overrides, Config)."""
        from framewright_tpu_torch.processors.analysis import recommend_settings

        names = {p.name for p in self.registry.available()}
        if report.quality_score < 50 and "archive" in names:
            preset = "archive"
        elif report.quality_score < 75 and "quality" in names:
            preset = "quality"
        else:
            preset = "fast"
        overrides = recommend_settings(report)
        if nb_frames > 100_000:          # very long videos keep the fast model
            overrides["sr_model"] = "realesr-general-x4v3"
        logger.info("smart selector: preset=%s overrides=%s", preset, overrides)
        return preset, overrides, self.registry.build_config(preset, **overrides)
