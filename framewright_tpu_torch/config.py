"""The fields of ``framewright_tpu.config.Config`` that the port's
restore path reads, with the same names, defaults and validation, plus
the two the port adds (``weights_dir``, ``max_frames``); the JAX presets
``fast``, ``quality``, ``archive`` and ``ultimate`` (``PRESETS``,
``get_preset``, ``build_config``: preset < the caller's values, as the
JAX CLI resolves them).

Colorization (``colorize``, ``colorize_model``, ``colorize_saturation``,
``colorize_keyframe_interval``, ``colorize_strength``) and gap filling
(``fill_missing_frames``, ``gap_jump_ratio``) have JAX's names and
defaults. ``colorize_strength`` is read by nothing, in JAX as in the port:
the field is kept and maps to nothing. A restore with
``colorize_model="exemplar"`` raises ``ConfigError``: the restore has no
way to hand over the reference image, and JAX silently runs the palette
then (exemplar stays on the processor API, ``ColorizeConfig.
reference_image``). ``verbose`` (the CLI's ``--verbose``: DEBUG logging)
does not change the output and is left out of the hash, as in JAX. The
diffusion SR's ``diffusion_steps`` and
``diffusion_strength``, and the pre-SR stream's VHS repair, stabilization,
watermark and subtitle inpainting, QP removal, the latent temporal model
and the scene-adaptive filter, HDR output after SR and ``auto_enhance``
have JAX's names, defaults and validation. The SR ensemble (``sr_ensemble``,
``ensemble_strategy``), ``outscale``, the enhancement cap
(``max_enhancement_strength``) and guided enhancement (``sr_prompt``,
``sr_style_preset``, ``reference_images_dir``, ``reference_strength``,
``guidance_scale``) have JAX's names, defaults and validation.
``codec``, ``crf``, ``encode_preset`` and ``pixel_format`` reach the
ffmpeg writer; the Y4M and PNG writers ignore them, as the JAX ones do.

Scale-out (``mesh_shape``, ``sharding_strategy``, ``scene_chunk_frames``,
``chunk_overlap_frames``, ``multihost``) has JAX's names, defaults and
validation. The restore splits each SR dispatch's frames over the
mesh's cards (``restorer.build_sr``, ``parallel.distributor.ShardedSR``;
``mesh_shape``: () = every local card; ``batch_size`` stays the frames
of a dispatch, as in JAX), unless ``sharding_strategy="none"``, which
JAX's restorer never maps; with one card nothing is split. ``spatial`` splits frames too (the spatial split
is ROADMAP A11b). ``multihost`` brings up the process group when the
restorer is built (``parallel.dcn.ensure_distributed``);
``scene_chunk_frames`` is the streaming restore's chunk;
``chunk_overlap_frames`` is read by nothing, in JAX as in the port. The
subtitle (``subtitle_region``, ``subtitle_ocr_engine``,
``subtitle_languages``), format (``inverse_telecine``,
``crop_letterbox``, ``aspect_correction``) and audio (``process_audio``,
``audio_denoise``, ``audio_sync_correction``) fields have JAX's names,
defaults and validation and map to nothing: JAX's restore reads none of
them (the ``subtitles`` and ``audio`` verbs and the processors run those
tools).

The layers (JAX's ``build_config``): CLI > ``FRAMEWRIGHT_*`` environment
variables (``Config.env_overrides``) > a config file (``Config.load``,
JSON or, with PyYAML, YAML; a file JAX's ``Config.save`` wrote loads
here, its XLA-only fields read and logged as ignored) > preset >
defaults. A layer that names ``sr_model`` without ``scale_factor``
brings the model's scale with it (the port's ``Config`` refuses a scale
other than the model's; JAX accepts one and writes the model's)."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from framewright_tpu_torch.errors import ConfigError

logger = logging.getLogger(__name__)

# what the port runs: the RRDB and SRVGG models of the registry (the
# other families are queued in ROADMAP.md A)
_VALID_DTYPES = ("bfloat16", "float32", "int8")
_VALID_DEVICES = ("auto", "cuda", "cpu")
_VALID_REPORTS = ("json", "html", "none")
_VALID_DENOISERS = ("auto", "nafnet", "restormer", "temporal", "bilateral", "none")
_VALID_DEINTERLACE = ("auto", "off", "yadif", "bwdif")
_VALID_GRAIN = ("auto", "off", "preserve", "remove", "match")
_VALID_OUTPUT_FORMATS = ("auto", "y4m", "png", "mp4", "mkv")
_VALID_FACE_MODELS = ("gfpgan", "codeformer", "sr")
_VALID_COLORIZE = ("palette", "eccv16", "ddcolor")    # a restore's; exemplar: the processor
_VALID_SHARDING = ("data", "spatial", "none", "auto")

# framewright_tpu/config.py:28-87
PRESETS: Dict[str, Dict[str, Any]] = {
    "fast": {
        "description": "Quick processing - compact model (FW_fastvgg_x2, the "
                       "repository's trained weights), bf16, no extras",
        "scale_factor": 2,
        "sr_model": "FW_fastvgg_x2",
        "compute_dtype": "bfloat16",
        "denoise": False,
        "face_restore": False,
        "interpolation": False,
        "temporal_consistency": False,
        "crf": 23,
    },
    "quality": {
        "description": "Balanced quality/speed - RRDB SR + temporal consistency",
        "scale_factor": 2,
        "sr_model": "RealESRGAN_x2plus",
        "compute_dtype": "bfloat16",
        "denoise": True,
        "denoise_model": "auto",
        "face_restore": False,
        "interpolation": False,
        "temporal_consistency": True,
        "crf": 18,
    },
    "archive": {
        "description": "Archival restoration - full restoration stack, fp32 accumulate",
        "scale_factor": 4,
        "sr_model": "RealESRGAN_x4plus",
        "compute_dtype": "bfloat16",
        "denoise": True,
        "denoise_model": "auto",
        "face_restore": True,
        "interpolation": True,
        "target_fps": 0.0,
        "deduplicate": True,
        "temporal_consistency": True,
        "defect_repair": True,
        "crf": 14,
    },
    "ultimate": {
        "description": "Everything on - slowest, best possible output",
        "scale_factor": 4,
        "sr_model": "RealESRGAN_x4plus",
        "compute_dtype": "bfloat16",
        "denoise": True,
        "denoise_model": "auto",
        "face_restore": True,
        "interpolation": True,
        "deduplicate": True,
        "temporal_consistency": True,
        "defect_repair": True,
        "colorize": False,
        "grain_preserve": True,
        "crf": 12,
        "validate_output": True,
    },
}
# fields that do not change the output's pixels: a checkpoint survives a
# change of these (those of ``framewright_tpu.config.Config.get_hash``'s
# list that the port has)
_HASH_EXCLUDED = ("project_dir", "output_path", "verbose", "dry_run", "checkpoint_interval",
                  "checkpoint_enabled", "resume", "keep_intermediates")
# fields of JAX's Config that the port reads and ignores: XLA's settings, the CPU
# fallback the port refuses by design (ROADMAP "JAX faults"), and fields JAX's own
# restore reads nowhere
_JAX_ONLY = ("accum_dtype", "allow_cpu_fallback", "frames_dir", "hbm_budget_gb", "inpaint",
             "motion_blur_reduction", "png_compression", "xla_cache_dir")


@dataclass
class Config:
    # --- I/O ---------------------------------------------------------------
    project_dir: Path = field(default_factory=lambda: Path("./framewright_project"))
    output_path: Optional[Path] = None
    output_format: str = "auto"          # auto|y4m|png|mp4|mkv (mp4/mkv need ffmpeg)
    keep_intermediates: bool = False     # keep work_dir/enhanced.y4m

    # --- Super-resolution ----------------------------------------------------
    scale_factor: int = 2
    sr_model: str = "RealESRGAN_x2plus"
    tile_size: int = 0                    # 0 = the planner decides (tiles only a
                                          # frame that does not fit at batch 1)
    tile_overlap: int = 8                 # halo pixels a tile edge (0: the
                                          # family's receptive overlap)
    batch_size: int = 0                   # frames per device step; 0 = auto (a VSR
                                          # model's chunk: 0 = 8)
    outscale: float = 0.0                 # final bicubic resize factor; 0 = the model's
    sr_ensemble: str = ""                 # comma list of SR models voted with sr_model
    ensemble_strategy: str = "weighted"   # weighted|median|max_sharpness
    max_enhancement_strength: float = 1.0  # < 1 lerps the SR output toward the
                                           # plain upscale (authenticity guard)
    weights_dir: Optional[Path] = None    # <name>.npz here, else packaged/random
    max_frames: int = 0                   # 0 = the whole clip

    # --- Compute / device ------------------------------------------------------
    compute_dtype: str = "bfloat16"       # bfloat16 | float32 | int8 (static scales)
    device_platform: str = "auto"         # auto (= cuda) | cuda | cpu
    hbm_utilization: float = 0.85         # share of free card memory to plan for

    # --- Scale-out ---------------------------------------------------------------
    mesh_shape: Tuple[int, ...] = ()      # () = every local card on the frames axis
    sharding_strategy: str = "auto"       # data|spatial|none|auto (none: one card)
    scene_chunk_frames: int = 100         # the streaming restore's chunk
    chunk_overlap_frames: int = 4         # read by nothing (as in JAX)
    multihost: bool = False               # bring up the process group (parallel.dcn)

    # --- Pre-SR stream (in this order, before super-resolution) -----------------
    long_form: str = "auto"               # auto|on|off: anchor drift correction
    long_form_threshold: int = 1500       # auto engages at >= this many frames
    anchor_interval: int = 50             # frames between global anchors
    long_form_strength: float = 0.5       # drift-correction blend
    deinterlace: str = "auto"             # auto|off|yadif|bwdif
    denoise: bool = False
    denoise_model: str = "nafnet"         # auto|temporal|nafnet|bilateral
    denoise_strength: float = 0.5
    temporal_window: int = 7              # 2r+1 frames a denoise window
    flow_model: str = "ifnet"             # the alignment flow net
    scene_threshold: float = 0.30         # scene-change score that cuts windows
    temporal_consistency: bool = False
    temporal_model: str = "attention"     # attention (cross-frame) | ema | latent
    defect_repair: bool = False           # scratches and dust, after deinterlacing
    defect_scratch_sensitivity: float = 12.0   # column-scratch detector threshold
    defect_dust_sensitivity: float = 45.0      # dust / speck detector threshold
    vhs_restore: bool = False             # VHS repair, after deinterlacing
    vhs_fix_tracking: bool = True
    vhs_fix_dropouts: bool = True
    vhs_fix_chroma: bool = True
    vhs_fix_dot_crawl: bool = True
    vhs_tracking_threshold: float = 30.0
    fill_missing_frames: bool = False     # synthesize dropped frames (IFNet), after
                                          # defect repair
    gap_jump_ratio: float = 1.8           # motion-discontinuity gap detector
    stabilize: bool = False               # after defect repair
    stabilize_smoothing: int = 15         # trajectory smoothing radius (frames)
    stabilize_crop: float = 0.95          # retained frame fraction (crop-zoom)
    stabilize_rotation: bool = True       # estimate roll as well as translation
    inpaint_model: str = "lama"           # lama (<weights_dir>/big-lama.npz) | diffusion
    watermark_removal: bool = False       # inpaint static overlays, after stabilization
    watermark_auto_detect: bool = True
    watermark_regions: Tuple[Tuple[int, int, int, int], ...] = ()   # (x0, y0, x1, y1)
    subtitle_removal: bool = False        # the same in the bottom third
    subtitle_region: str = "bottom"       # OCR band: bottom|top|full (maps to nothing)
    subtitle_ocr_engine: str = "auto"     # auto|tesseract|none (maps to nothing)
    subtitle_languages: Tuple[str, ...] = ("eng",)
    inverse_telecine: bool = False        # maps to nothing (as in JAX's restore)
    crop_letterbox: bool = False          # maps to nothing
    aspect_correction: bool = False       # maps to nothing
    qp_removal: bool = False              # codec deblocking and deringing, before denoise
    qp_strength: float = 0.0              # DCT threshold; 0 = auto from blockiness
    scene_adaptive: bool = False          # per-scene sharpen / NR deltas, last pre-SR

    # --- Deduplication: SR on the unique frames only ---------------------------
    deduplicate: bool = False
    dedup_similarity: float = 0.98        # dHash Hamming similarity of a duplicate
    dedup_hash_size: int = 8

    # --- Post-SR grain (forces the RGB writer path) ----------------------------
    grain_preserve: bool = False
    grain_strength: float = 0.3
    grain_mode: str = "auto"              # auto|off|preserve|remove|match (auto =
                                          # match when grain_preserve, else off)
    grain_target: float = 0.0             # match target level; 0 = measured once
    seed: int = 0                         # the grain generator's seed
    hdr_output: str = "none"              # none|hdr10|hdr10plus|hlg: last after SR
    hdr_peak_nits: float = 1000.0         # mastering peak of the SDR -> HDR expansion
    hdr_highlight_boost: float = 0.6

    # --- Diffusion SR (DiffusionSR_x4) -------------------------------------------
    diffusion_steps: int = 8              # DDIM steps (replace the checkpoint's 1)
    diffusion_strength: float = 0.35      # propagate_t (a restore does not read it)

    # --- Auto-enhance: analyze the source, then toggle stages --------------------
    auto_enhance: bool = False
    auto_detect_content: bool = True

    # --- Interpolation (after SR, at the output size) --------------------------
    interpolation: bool = False
    target_fps: float = 0.0               # 0 = 2x the (deduplicated) source fps
    interpolation_model: str = "rife-v4.6"   # <weights_dir>/<name>.npz
    interpolation_passes: int = 1
    scene_change_skip: bool = True        # hold the left frame across a cut

    # --- Guided enhancement (after SR and the gate, before grain) ---------------
    sr_prompt: str = ""                   # style prompt (a controlled vocabulary)
    sr_style_preset: str = ""             # a processors/guided.py STYLE_PRESETS name
    guidance_scale: float = 5.0           # the diffusion guided backend's
    reference_images_dir: Optional[Path] = None  # *.png stills to match
    reference_strength: float = 0.5       # statistics-transfer blend

    # --- Faces (after SR, before the gate) --------------------------------------
    face_restore: bool = False
    face_model: str = "gfpgan"            # gfpgan | codeformer | sr
    face_strength: float = 0.8
    face_fidelity: float = 0.5            # codeformer w: 0 quality..1 fidelity

    # --- Colorization (pre-SR, after inpainting, before QP removal) -------------
    colorize: bool = False
    colorize_model: str = "ddcolor"       # palette | eccv16 | ddcolor (<weights_dir>/
                                          # eccv16.npz, ddcolor.npz); exemplar: the
                                          # processor API only
    colorize_saturation: float = 0.5      # chroma strength (0-1)
    colorize_keyframe_interval: int = 24  # flow-propagation keyframe gap
    colorize_strength: float = 1.0        # read by nothing (as in JAX)

    # --- Audio (the audio verb's; a restore reads none, as in JAX) --------------
    process_audio: bool = True
    audio_denoise: bool = False
    audio_sync_correction: bool = False

    # --- Encoding (the ffmpeg writer; Y4M and PNG ignore them) ------------------
    codec: str = "libx265"
    crf: int = 18
    encode_preset: str = "medium"
    pixel_format: str = "yuv420p"
    preset: str = ""                      # the preset this config came from

    # --- Checkpoint / resume ---------------------------------------------------
    checkpoint_enabled: bool = True
    checkpoint_interval: int = 50         # frames between checkpoint saves
    resume: bool = True
    max_runtime_minutes: float = 0.0      # 0 = unlimited; else stop the
                                          # enhance loop at the budget (a
                                          # rerun resumes from the checkpoint)
    stage_max_retries: int = 1            # retries of the enhance stage on a
                                          # TransientError

    # --- Validation / quality gates --------------------------------------------
    validate_output: bool = True
    min_ssim: float = 0.85
    min_psnr: float = 25.0
    min_vmaf: float = 0.0                 # vmaf_proxy gate on the sampled RGB
                                          # pairs; 0 = off
    continue_on_error: bool = True        # bicubic copies of a batch that ran out of memory
    quality_report_format: str = "json"   # json | html | none
    dry_run: bool = False                 # the plan only: nothing processed or written
    verbose: bool = False                 # DEBUG logging (the CLI's --verbose)

    # Derived (set in __post_init__)
    work_dir: Path = field(init=False, repr=False, default=None)        # type: ignore[assignment]
    checkpoint_dir: Path = field(init=False, repr=False, default=None)  # type: ignore[assignment]

    _DERIVED = ("work_dir", "checkpoint_dir")

    def __post_init__(self) -> None:
        self.project_dir = Path(self.project_dir)
        if self.output_path is not None:
            self.output_path = Path(self.output_path)
        if self.weights_dir is not None:
            self.weights_dir = Path(self.weights_dir)
        if self.reference_images_dir is not None:
            self.reference_images_dir = Path(self.reference_images_dir)
        self.watermark_regions = tuple(tuple(int(v) for v in r) for r in self.watermark_regions)
        self.mesh_shape = tuple(int(d) for d in self.mesh_shape)
        self.subtitle_languages = tuple(self.subtitle_languages)
        self.work_dir = self.project_dir / "work"
        self.checkpoint_dir = self.project_dir / "checkpoints"
        self._validate()

    def _validate(self) -> None:
        from framewright_tpu_torch.models.registry import MODEL_SPECS

        if self.sr_model not in MODEL_SPECS:
            raise ConfigError(f"Unknown sr_model {self.sr_model!r}; the port "
                              f"runs {sorted(MODEL_SPECS)}")
        scale = MODEL_SPECS[self.sr_model].scale
        if self.scale_factor != scale:
            raise ConfigError(f"{self.sr_model} upscales x{scale}, "
                              f"scale_factor is {self.scale_factor}")
        if self.compute_dtype not in _VALID_DTYPES:
            raise ConfigError(f"compute_dtype must be one of {_VALID_DTYPES}")
        if self.device_platform not in _VALID_DEVICES:
            raise ConfigError(f"device_platform must be one of {_VALID_DEVICES}")
        if self.batch_size < 0 or self.max_frames < 0:
            raise ConfigError("batch_size and max_frames must be >= 0")
        if not (0.0 < self.hbm_utilization <= 1.0):
            raise ConfigError("hbm_utilization must be in (0, 1]")
        if self.checkpoint_interval < 1:
            raise ConfigError("checkpoint_interval must be >= 1")
        if self.quality_report_format not in _VALID_REPORTS:
            raise ConfigError(f"quality_report_format must be one of {_VALID_REPORTS}")
        if self.tile_size < 0 or self.tile_size % 8:
            raise ConfigError("tile_size must be 0 (auto) or a positive multiple of 8")
        if self.tile_overlap < 0:
            raise ConfigError("tile_overlap must be >= 0")
        if self.stage_max_retries < 0:
            raise ConfigError("stage_max_retries must be >= 0")
        if self.ensemble_strategy not in ("weighted", "median", "max_sharpness"):
            raise ConfigError("ensemble_strategy must be weighted|median|max_sharpness")
        for name in self.ensemble_models():
            if name not in MODEL_SPECS:
                raise ConfigError(f"Unknown ensemble model {name!r}; the port runs "
                                  f"{sorted(MODEL_SPECS)}")
        if not (0.0 <= self.max_enhancement_strength <= 1.0):
            raise ConfigError("max_enhancement_strength must be in [0, 1]")
        if self.outscale < 0:
            raise ConfigError("outscale must be >= 0")
        if self.sharding_strategy not in _VALID_SHARDING:
            raise ConfigError(f"sharding_strategy must be one of {_VALID_SHARDING}")
        if self.mesh_shape and any(d < 1 for d in self.mesh_shape):
            raise ConfigError("mesh_shape entries must be >= 1")
        if self.subtitle_region not in ("bottom", "top", "full"):
            raise ConfigError("subtitle_region must be bottom|top|full")
        if self.subtitle_ocr_engine not in ("auto", "tesseract", "none"):
            raise ConfigError("subtitle_ocr_engine must be auto|tesseract|none")
        self._validate_pre_sr()
        self._validate_post_sr()

    def _validate_pre_sr(self) -> None:
        if self.long_form not in ("auto", "on", "off"):
            raise ConfigError("long_form must be auto|on|off")
        if self.anchor_interval < 1:
            raise ConfigError("anchor_interval must be >= 1")
        if self.deinterlace not in _VALID_DEINTERLACE:
            raise ConfigError(f"deinterlace must be one of {_VALID_DEINTERLACE}")
        if self.denoise_model not in _VALID_DENOISERS:
            raise ConfigError(f"denoise_model must be one of {_VALID_DENOISERS}")
        if self.flow_model not in ("ifnet", "raft"):
            raise ConfigError("flow_model must be ifnet|raft")
        if self.temporal_window < 1 or self.temporal_window % 2 == 0:
            raise ConfigError("temporal_window must be an odd integer >= 1")
        if self.temporal_model not in ("attention", "ema", "latent"):
            raise ConfigError("temporal_model must be attention|ema|latent")
        if not (0 <= self.crf <= 51):
            raise ConfigError("crf must be in [0, 51]")
        if not (0.0 <= self.dedup_similarity <= 1.0):
            raise ConfigError("dedup_similarity must be in [0, 1]")
        if self.grain_mode not in _VALID_GRAIN:
            raise ConfigError("grain_mode must be auto|off|preserve|remove|match")
        if not (0.0 < self.stabilize_crop <= 1.0):
            raise ConfigError("stabilize_crop must be in (0, 1]")
        if self.stabilize_smoothing < 1:
            raise ConfigError("stabilize_smoothing must be >= 1")
        if self.preset and self.preset not in PRESETS:
            get_preset(self.preset)          # raises: an unknown preset

    def _validate_post_sr(self) -> None:
        if self.target_fps < 0:
            raise ConfigError("target_fps must be >= 0")
        if self.interpolation_passes not in (1, 2, 3):
            raise ConfigError("interpolation_passes must be 1-3")
        if self.interpolation_model != "rife-v4.6":
            raise ConfigError("interpolation_model: the port runs rife-v4.6 (IFNet)")
        if self.output_format not in _VALID_OUTPUT_FORMATS:
            raise ConfigError(f"output_format must be one of {_VALID_OUTPUT_FORMATS}")
        if self.face_model not in _VALID_FACE_MODELS:
            raise ConfigError(f"face_model must be one of {_VALID_FACE_MODELS}")
        if self.colorize and self.colorize_model not in _VALID_COLORIZE:
            raise ConfigError(f"colorize_model must be one of {_VALID_COLORIZE} in a restore"
                              + (" (exemplar needs a reference image: the processor API, "
                                 "ColorizeConfig.reference_image)"
                                 if self.colorize_model == "exemplar" else ""))
        if self.sr_style_preset:
            from framewright_tpu_torch.processors.guided import STYLE_PRESETS

            if self.sr_style_preset not in STYLE_PRESETS:
                raise ConfigError(f"sr_style_preset must be one of {sorted(STYLE_PRESETS)}")
        if self.guidance_scale <= 0:
            raise ConfigError("guidance_scale must be > 0")
        if self.hdr_output not in ("none", "hdr10", "hdr10plus", "hlg"):
            raise ConfigError("hdr_output must be none|hdr10|hdr10plus|hlg")
        if self.diffusion_steps < 1 or self.diffusion_steps > 1000:
            raise ConfigError("diffusion_steps must be in [1, 1000]")
        if not (0.0 < self.diffusion_strength <= 1.0):
            raise ConfigError("diffusion_strength must be in (0, 1]")

    def with_overrides(self, **overrides: Any) -> "Config":
        """This config with ``overrides`` (JAX's ``Config.with_overrides``)."""
        d = self.to_dict()
        d.update(overrides)
        return Config(**d)

    @classmethod
    def from_preset(cls, name: str, **overrides: Any) -> "Config":
        """A preset's fields under ``overrides`` (JAX's ``Config.from_preset``;
        overrides naming a model bring its scale)."""
        kwargs = {**get_preset(name), **with_model_scale(overrides)}
        kwargs.setdefault("preset", name)
        return cls(**kwargs)

    def ensemble_models(self) -> List[str]:
        """Extra SR models voted with ``sr_model`` (may be empty)."""
        return [m.strip() for m in self.sr_ensemble.split(",") if m.strip()]

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            if f.name in self._DERIVED:
                continue
            v = getattr(self, f.name)
            out[f.name] = str(v) if isinstance(v, Path) else v
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        """A config from a dict (JAX's ``Config.from_dict``): the port's
        fields; any other key (a JAX-only field such as ``xla_cache_dir``)
        is logged as ignored."""
        known = {f.name for f in dataclasses.fields(cls)} - set(cls._DERIVED)
        ignored = sorted(k for k in d if k not in known)
        if ignored:
            logger.info("config: ignored fields the port does not use: %s", ignored)
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path: Path) -> None:
        """Write ``to_dict`` as JSON, or YAML for a ``.yaml`` / ``.yml``
        path (JAX's ``Config.save``)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        d = json.loads(json.dumps(self.to_dict()))          # tuples -> lists
        if path.suffix in (".yaml", ".yml"):
            path.write_text(_yaml().safe_dump(d, sort_keys=True))
        else:
            path.write_text(json.dumps(d, indent=2, sort_keys=True))

    @classmethod
    def load(cls, path: Path) -> "Config":
        """Read a file ``save`` (the port's or JAX's) wrote."""
        path = Path(path)
        text = path.read_text()
        d = _yaml().safe_load(text) if path.suffix in (".yaml", ".yml") else json.loads(text)
        return cls.from_dict(d)

    @classmethod
    def env_overrides(cls, environ: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        """``FRAMEWRIGHT_<FIELD>`` variables -> config values (JAX's
        ``Config.env_overrides``): bools from 1/true/yes/on, tuples from
        comma lists (ints when every part is one), ints, floats, else the
        string. ``environ`` defaults to ``os.environ``."""
        env = environ if environ is not None else dict(os.environ)
        fields = {f.name: f for f in dataclasses.fields(cls) if f.name not in cls._DERIVED}
        out: Dict[str, Any] = {}
        for key, raw in env.items():
            name = key[len("FRAMEWRIGHT_"):].lower()
            if not key.startswith("FRAMEWRIGHT_") or name not in fields:
                continue
            ftype = str(fields[name].type)
            try:
                if "bool" in ftype:
                    out[name] = raw.strip().lower() in ("1", "true", "yes", "on")
                elif "Tuple" in ftype or "tuple" in ftype:
                    parts = [x.strip() for x in raw.split(",") if x.strip()]
                    try:
                        out[name] = tuple(int(x) for x in parts)
                    except ValueError:          # string tuples (languages)
                        out[name] = tuple(parts)
                elif "int" in ftype:
                    out[name] = int(raw)
                elif "float" in ftype:
                    out[name] = float(raw)
                else:
                    out[name] = raw
            except ValueError as exc:
                raise ConfigError(f"Bad env override {key}={raw!r}: {exc}") from exc
        return out

    def get_hash(self) -> str:
        """Identity of the output a restore with this config writes, which
        keys its checkpoint: every field but those that do not change the
        output's pixels (the JAX package's list). ``weights_dir`` changes
        them and is hashed; so are ``tile_size``, ``tile_overlap`` and
        ``stage_max_retries``, as in the JAX package."""
        d = self.to_dict()
        for k in _HASH_EXCLUDED:
            d.pop(k, None)
        blob = json.dumps(d, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


# ``config_schema``'s groups: JAX's (the section comments of its Config,
# ``framewright_tpu/config.py:531``), less the fields the port does not
# have, with the port's two in I/O and Super-resolution
_SCHEMA_GROUPS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("I/O", ("project_dir", "output_path", "output_format", "keep_intermediates",
             "max_frames")),
    ("Super-resolution", ("scale_factor", "sr_model", "tile_size", "tile_overlap",
                          "batch_size", "outscale", "sr_ensemble", "ensemble_strategy",
                          "weights_dir")),
    ("Compute / device", ("compute_dtype", "device_platform", "hbm_utilization")),
    ("Parallelism", ("mesh_shape", "sharding_strategy", "scene_chunk_frames",
                     "chunk_overlap_frames", "multihost")),
    ("Denoise / temporal", ("denoise", "denoise_model", "denoise_strength", "temporal_window",
                            "flow_model", "temporal_consistency", "temporal_model",
                            "qp_removal", "qp_strength", "scene_threshold", "grain_preserve",
                            "grain_strength", "grain_mode", "grain_target", "scene_adaptive",
                            "long_form", "long_form_threshold", "anchor_interval",
                            "long_form_strength")),
    ("Deduplication / interpolation", ("deduplicate", "dedup_similarity", "dedup_hash_size",
                                       "interpolation", "target_fps", "interpolation_model",
                                       "interpolation_passes", "scene_change_skip")),
    ("Faces / inpainting / color", ("face_restore", "face_model", "face_strength",
                                    "face_fidelity", "inpaint_model", "watermark_removal",
                                    "watermark_auto_detect", "watermark_regions",
                                    "subtitle_removal", "subtitle_region",
                                    "subtitle_ocr_engine", "subtitle_languages", "colorize",
                                    "colorize_model", "colorize_saturation",
                                    "colorize_keyframe_interval", "colorize_strength")),
    ("Diffusion SR", ("diffusion_steps", "diffusion_strength")),
    ("Guided SR", ("sr_prompt", "sr_style_preset", "guidance_scale", "reference_images_dir",
                   "reference_strength")),
    ("Auto-enhance", ("auto_enhance", "auto_detect_content")),
    ("Format / geometry", ("deinterlace", "inverse_telecine", "crop_letterbox",
                           "aspect_correction", "stabilize", "stabilize_smoothing",
                           "stabilize_crop", "stabilize_rotation", "defect_repair",
                           "defect_scratch_sensitivity", "defect_dust_sensitivity",
                           "fill_missing_frames", "gap_jump_ratio", "hdr_output",
                           "hdr_peak_nits", "hdr_highlight_boost")),
    ("VHS restoration", ("vhs_restore", "vhs_fix_tracking", "vhs_fix_dropouts",
                         "vhs_fix_chroma", "vhs_fix_dot_crawl", "vhs_tracking_threshold")),
    ("Authenticity guard", ("max_enhancement_strength",)),
    ("Audio", ("process_audio", "audio_denoise", "audio_sync_correction")),
    ("Encoding", ("codec", "crf", "encode_preset", "pixel_format")),
    ("Checkpoint / resume", ("checkpoint_enabled", "checkpoint_interval", "resume",
                             "max_runtime_minutes", "stage_max_retries")),
    ("Validation / quality gates", ("validate_output", "min_ssim", "min_psnr", "min_vmaf",
                                    "continue_on_error", "quality_report_format")),
    ("Misc", ("verbose", "dry_run", "seed", "preset")),
)


def config_schema() -> list:
    """Every field of ``Config`` grouped as JAX's ``config_schema`` groups
    them, for the API's settings editor: ``[{"group": ..., "fields":
    [{"name", "type", "default", "choices"?}, ...]}, ...]``; the choices
    are the values the port accepts."""
    from framewright_tpu_torch.models.registry import MODEL_SPECS

    choices = {
        "compute_dtype": _VALID_DTYPES, "device_platform": _VALID_DEVICES,
        "denoise_model": _VALID_DENOISERS, "sharding_strategy": _VALID_SHARDING,
        "sr_model": tuple(sorted(MODEL_SPECS)), "output_format": _VALID_OUTPUT_FORMATS,
        "ensemble_strategy": ("weighted", "median", "max_sharpness"),
        "face_model": _VALID_FACE_MODELS, "grain_mode": _VALID_GRAIN,
        "deinterlace": _VALID_DEINTERLACE, "hdr_output": ("none", "hdr10", "hdr10plus", "hlg"),
        "quality_report_format": _VALID_REPORTS, "subtitle_region": ("bottom", "top", "full"),
        "temporal_model": ("attention", "latent", "ema"), "flow_model": ("ifnet", "raft"),
        "long_form": ("auto", "on", "off"), "colorize_model": _VALID_COLORIZE,
    }
    fdefs = {f.name: f for f in dataclasses.fields(Config) if f.init}
    groups = []
    for title, names in _SCHEMA_GROUPS:
        fields = []
        for name in names:
            f = fdefs.pop(name)
            default = (f.default_factory() if f.default is dataclasses.MISSING  # type: ignore[misc]
                       else f.default)
            if isinstance(default, bool):
                ftype = "bool"
            elif isinstance(default, int):
                ftype = "int"
            elif isinstance(default, float):
                ftype = "float"
            else:
                ftype = "str"
                default = (",".join(str(v) for v in default) if isinstance(default, tuple)
                           else "" if default is None else str(default))
            entry = {"name": name, "type": ftype, "default": default}
            if name in choices:
                entry["choices"] = list(choices[name])
            fields.append(entry)
        groups.append({"group": title, "fields": fields})
    return groups


def get_preset(name: str) -> Dict[str, Any]:
    """A preset's fields (without its description), as the JAX
    ``get_preset``."""
    if name not in PRESETS:
        raise ConfigError(f"Unknown preset {name!r}. Available: {sorted(PRESETS)}")
    return {k: v for k, v in PRESETS[name].items() if k != "description"}


def _yaml():
    """PyYAML, which a ``.yaml`` config file needs (as in JAX)."""
    try:
        import yaml
    except ImportError as exc:
        raise ConfigError("a .yaml config file needs the PyYAML module (yaml); "
                          "use a .json file") from exc
    return yaml


def with_model_scale(layer: Dict[str, Any]) -> Dict[str, Any]:
    """A layer naming ``sr_model`` but no ``scale_factor`` brings the
    model's scale."""
    model = layer.get("sr_model")
    if model is None or layer.get("scale_factor") is not None:
        return layer
    from framewright_tpu_torch.models.registry import get_model

    return {**layer, "scale_factor": get_model(model).scale}   # an unknown model raises


def at_model_scale(layer: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX-shaped layer (a recipe's, a phrase's, the wizard's) that names
    ``sr_model``, with the model's scale: JAX keeps another
    ``scale_factor`` beside the model and writes the model's scale, the
    port's ``Config`` refuses one."""
    model = layer.get("sr_model")
    if model is None:
        return layer
    from framewright_tpu_torch.models.registry import get_model

    return {**layer, "scale_factor": get_model(model).scale}


def build_config(preset: str = "", config_file: Optional[Path] = None,
                 cli_overrides: Optional[Dict[str, Any]] = None,
                 environ: Optional[Dict[str, str]] = None) -> Config:
    """Layered resolution, JAX's precedence: CLI > env > config file >
    preset > defaults. ``cli_overrides`` values that are None are not
    set; ``environ`` defaults to ``os.environ``."""
    kwargs: Dict[str, Any] = {}
    if preset:
        kwargs.update(with_model_scale(get_preset(preset)))
        kwargs["preset"] = preset
    if config_file is not None:
        kwargs.update(Config.load(config_file).to_dict())
    kwargs.update(with_model_scale(Config.env_overrides(environ)))
    kwargs.update(with_model_scale({k: v for k, v in (cli_overrides or {}).items()
                                     if v is not None}))
    return Config.from_dict(kwargs)
