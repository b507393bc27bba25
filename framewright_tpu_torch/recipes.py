"""Recipe library: named end-to-end restoration workflows (the port of
``framewright_tpu.recipes``). A recipe is a ``Config`` delta (JAX's
table, as it stands) plus ordered pre-stages. ``RecipeExecutor`` streams
the source through the pre-stages (the port's VHS, deinterlace, inverse
telecine, defect repair and gate-weave processors, on the host as in
JAX) into a staged file written by ``open_writer`` (a ``.y4m`` source
goes through JAX's 4:2:0 round trip there), then restores the staged
file with the recipe's config on ``device``.

The table is JAX's but for ``realtime_preview``'s description, which
drops JAX's "22 fps/chip" (a TPU v5e rate). The config is JAX's
``Config(**overrides)``, not the layered
``build_config``: the environment does not reach it. A recipe that names
a model with another ``scale_factor`` (``youtube_ready``:
realesr-general-x4v3 at 2 with ``outscale=2.0``) runs at the model's
scale, which JAX's restore writes too (``config.at_model_scale``)."""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

from framewright_tpu_torch.config import Config, at_model_scale
from framewright_tpu_torch.errors import ConfigError

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class Recipe:
    name: str
    description: str
    config_overrides: Dict = field(default_factory=dict)
    pre_stages: tuple = ()         # processor names run before the restore
    notes: str = ""


# framewright_tpu/recipes.py:30-117
RECIPES: Dict[str, Recipe] = {
    r.name: r for r in [
        Recipe(
            "vhs_family_video",
            "Home VHS tapes: tracking/dropout repair, deinterlace, mild "
            "denoise, 2x upscale",
            config_overrides=dict(
                scale_factor=2, sr_model="RealESRGAN_x2plus", denoise=True,
                denoise_strength=0.6, deinterlace="yadif",
                temporal_consistency=True, crf=18,
            ),
            pre_stages=("vhs", "deinterlace"),
        ),
        Recipe(
            "silent_film_restoration",
            "Pre-1930 film: dedup pulldown padding, defect repair, "
            "gate-weave stabilization, flicker fix, interpolate to 24fps",
            config_overrides=dict(
                scale_factor=2, sr_model="RealESRGAN_x2plus",
                deduplicate=True, interpolation=True, target_fps=24.0,
                denoise=True, temporal_consistency=True, defect_repair=True,
                grain_preserve=True, crf=14,
            ),
            pre_stages=("defects", "gate_weave"),
        ),
        Recipe(
            "dvd_upscale",
            "480p/576p DVD rips: deinterlace/IVTC, deblock, 4x upscale",
            config_overrides=dict(
                scale_factor=4, sr_model="RealESRGAN_x4plus",
                deinterlace="auto", inverse_telecine=True, denoise=True,
                denoise_strength=0.4, crf=17,
            ),
            pre_stages=("telecine", "deinterlace"),
        ),
        Recipe(
            "anime_remaster",
            "Animated content: anime-tuned model, strong line cleanup",
            config_overrides=dict(
                scale_factor=4, sr_model="RealESRGAN_x4plus_anime_6B",
                denoise=False, crf=16,
            ),
        ),
        Recipe(
            "bw_archive_colorize",
            "B&W archive: full restore + colorization pass",
            config_overrides=dict(
                scale_factor=2, sr_model="RealESRGAN_x2plus", denoise=True,
                colorize=True, grain_preserve=True,
                temporal_consistency=True, crf=14,
            ),
            pre_stages=("defects",),
        ),
        Recipe(
            "youtube_ready",
            "Fast cleanup + 2x for web upload",
            config_overrides=dict(
                scale_factor=2, sr_model="realesr-general-x4v3",
                outscale=2.0, denoise=False, crf=18, codec="libx264",
            ),
        ),
        Recipe(
            "realtime_preview",
            "Near-realtime 2x with the trained-in-repo compact model "
            "(packaged weights, works with no downloads)",
            config_overrides=dict(
                scale_factor=2, sr_model="FW_fastvgg_x2",
                outscale=2.0, denoise=False, validate_output=False,
            ),
        ),
        Recipe(
            "home_movie_8mm",
            "8mm/Super8 transfers: heavy gate weave + grain management",
            config_overrides=dict(
                scale_factor=2, sr_model="RealESRGAN_x2plus",
                stabilize=True, denoise=True, grain_preserve=True,
                temporal_consistency=True, deduplicate=True,
                interpolation=True, target_fps=24.0, crf=15,
            ),
            pre_stages=("gate_weave",),
        ),
    ]
}


def get_recipe(name: str) -> Recipe:
    if name not in RECIPES:
        raise ConfigError(f"Unknown recipe {name!r}; available: {sorted(RECIPES)}")
    return RECIPES[name]


def recipe_config(name: str, **overrides) -> Config:
    """The recipe's config under ``overrides``, at its model's scale."""
    return Config(**at_model_scale({**get_recipe(name).config_overrides, **overrides}))


class RecipeExecutor:
    """Run a recipe: the pre-stages stream into a staged file, then the
    restore runs on it with the recipe's config on ``device`` (``auto``:
    the card; ``DeviceError`` without one, before any pre-stage)."""

    def __init__(self, recipe: Recipe, project_dir: Path, device: str = "auto"):
        from framewright_tpu_torch.hw import resolve_device

        self.recipe = recipe
        self.project_dir = Path(project_dir)
        self.device = resolve_device(device).type

    def config(self) -> Config:
        return recipe_config(self.recipe.name, project_dir=self.project_dir,
                             device_platform=self.device)

    def prestage(self, source: Path) -> Path:
        """The source through the pre-stages into
        ``<project_dir>/work/prestaged<suffix>`` (the source itself when
        the recipe has none)."""
        from framewright_tpu_torch.io.video import open_reader, open_writer

        source = Path(source)
        if not self.recipe.pre_stages:
            return source
        staged = self.project_dir / "work" / f"prestaged{source.suffix or '.y4m'}"
        staged.parent.mkdir(parents=True, exist_ok=True)
        n = 0
        with open_reader(source) as r:
            stream = iter(r)
            for stage in self.recipe.pre_stages:
                stream = self._wrap_stage(stage, stream)
            with open_writer(staged, r.width, r.height, fps=r.fps) as w:
                for frame in stream:
                    w.write_frame(frame)
                    n += 1
        logger.info("recipe pre-stages %s: %d frames", self.recipe.pre_stages, n)
        return staged

    def execute(self, source: Path, output: Optional[Path] = None):
        from framewright_tpu_torch.restorer import VideoRestorer

        cfg = self.config()
        return VideoRestorer(cfg).restore_video(self.prestage(source), output=output)

    @staticmethod
    def _wrap_stage(stage: str, stream):
        if stage == "vhs":
            from framewright_tpu_torch.processors.vhs import VHSProcessor

            return VHSProcessor().process_stream(stream)
        if stage == "deinterlace":
            from framewright_tpu_torch.processors.format import Deinterlacer

            return Deinterlacer().process_stream(stream)
        if stage == "telecine":
            from framewright_tpu_torch.processors.format import InverseTelecine

            return InverseTelecine().process_stream(stream)
        if stage == "defects":
            from framewright_tpu_torch.processors.film import DefectRepairer

            return DefectRepairer().process_stream(stream)
        if stage == "gate_weave":
            from framewright_tpu_torch.processors.film import GateWeaveStabilizer

            return iter(GateWeaveStabilizer().stabilize(list(stream)))
        raise ConfigError(f"Unknown recipe pre-stage {stage!r}")
