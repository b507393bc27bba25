"""The fields of ``framewright_tpu.config.Config`` that the port's
restore path reads, with the same names, defaults and validation, plus
the two the port adds (``weights_dir``, ``max_frames``); the ``fast`` and
``quality`` presets (``PRESETS``, ``get_preset``, ``build_config``: preset
< the caller's values, as the JAX CLI resolves them).

A stage the port does not run yet raises ``ConfigError`` naming its
ROADMAP.md item when it is switched on; it never runs silently without
it. ``face_restore`` and ``interpolation`` are accepted off, and ``crf``
is accepted and ignored, as the JAX Y4M writer ignores it."""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

from framewright_tpu_torch.errors import ConfigError

# what the port runs: the RRDB and SRVGG models of the registry (the
# other families are queued in ROADMAP.md A)
_VALID_DTYPES = ("bfloat16", "float32", "int8")
_VALID_DEVICES = ("auto", "cuda", "cpu")
_VALID_REPORTS = ("json", "html", "none")
_VALID_DENOISERS = ("auto", "nafnet", "restormer", "temporal", "bilateral", "none")
_VALID_DEINTERLACE = ("auto", "off", "yadif", "bwdif")
_VALID_GRAIN = ("auto", "off", "preserve", "remove", "match")

# framewright_tpu/config.py:28-87, the two presets the port runs
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
}
# the JAX presets that need stages not ported yet
_WAITING_PRESETS = {
    "archive": "frame interpolation (ROADMAP.md A6b) and face restoration (A9)",
    "ultimate": "frame interpolation (ROADMAP.md A6b) and face restoration (A9)",
}
# fields that do not change the output's pixels: a checkpoint survives a
# change of these (those of ``framewright_tpu.config.Config.get_hash``'s
# list that the port has)
_HASH_EXCLUDED = ("project_dir", "output_path", "checkpoint_interval",
                  "checkpoint_enabled", "resume")


@dataclass
class Config:
    # --- I/O ---------------------------------------------------------------
    project_dir: Path = field(default_factory=lambda: Path("./framewright_project"))
    output_path: Optional[Path] = None

    # --- Super-resolution ----------------------------------------------------
    scale_factor: int = 2
    sr_model: str = "RealESRGAN_x2plus"
    batch_size: int = 0                   # frames per device step; 0 = auto
    weights_dir: Optional[Path] = None    # <name>.npz here, else packaged/random
    max_frames: int = 0                   # 0 = the whole clip

    # --- Compute / device ------------------------------------------------------
    compute_dtype: str = "bfloat16"       # bfloat16 | float32 | int8 (static scales)
    device_platform: str = "auto"         # auto (= cuda) | cuda | cpu
    hbm_utilization: float = 0.85         # share of free card memory to plan for

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
    temporal_model: str = "attention"     # attention (cross-frame) | ema
    defect_repair: bool = False           # scratches and dust, after deinterlacing
    defect_scratch_sensitivity: float = 12.0   # column-scratch detector threshold
    defect_dust_sensitivity: float = 45.0      # dust / speck detector threshold

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

    # --- Stages of the presets that the port does not run (accepted off) ----
    face_restore: bool = False
    interpolation: bool = False
    crf: int = 18                         # encoder quality; the Y4M writer ignores it
    preset: str = ""                      # the preset this config came from

    # --- Checkpoint / resume ---------------------------------------------------
    checkpoint_enabled: bool = True
    checkpoint_interval: int = 50         # frames between checkpoint saves
    resume: bool = True
    max_runtime_minutes: float = 0.0      # 0 = unlimited; else stop the
                                          # enhance loop at the budget (a
                                          # rerun resumes from the checkpoint)

    # --- Validation / quality gates --------------------------------------------
    validate_output: bool = True
    min_ssim: float = 0.85
    min_psnr: float = 25.0
    min_vmaf: float = 0.0                 # > 0 is not ported (ROADMAP.md A)
    continue_on_error: bool = True        # bicubic copies of a batch that ran out of memory
    quality_report_format: str = "json"   # json | html | none

    # Derived (set in __post_init__)
    checkpoint_dir: Path = field(init=False, repr=False, default=None)  # type: ignore[assignment]

    _DERIVED = ("checkpoint_dir",)

    def __post_init__(self) -> None:
        self.project_dir = Path(self.project_dir)
        if self.output_path is not None:
            self.output_path = Path(self.output_path)
        if self.weights_dir is not None:
            self.weights_dir = Path(self.weights_dir)
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
        if self.min_vmaf > 0:
            raise ConfigError("min_vmaf > 0 needs the VMAF gate (sampled RGB "
                              "pairs, quality/vmaf.py), not ported yet: "
                              "ROADMAP.md A3.4")
        self._validate_pre_sr()

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
        if self.denoise and self.denoise_model == "restormer":
            raise ConfigError("denoise_model='restormer' needs models/restormer, not "
                              "ported yet: ROADMAP.md A6")
        if self.denoise and self.flow_model == "raft":
            raise ConfigError("flow_model='raft' needs models/raft, not ported yet: "
                              "ROADMAP.md A6")
        if self.temporal_model == "latent":
            raise ConfigError("temporal_model='latent' needs processors/latent_temporal, "
                              "not ported yet: ROADMAP.md A10")
        if self.face_restore:
            raise ConfigError("face_restore needs processors/faces, not ported yet: "
                              "ROADMAP.md A9")
        if self.interpolation:
            raise ConfigError("interpolation needs processors/interpolation, not "
                              "ported yet: ROADMAP.md A6b")
        if self.preset and self.preset not in PRESETS:
            get_preset(self.preset)          # raises, naming what it waits for

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            if f.name in self._DERIVED:
                continue
            v = getattr(self, f.name)
            out[f.name] = str(v) if isinstance(v, Path) else v
        return out

    def get_hash(self) -> str:
        """Identity of the output a restore with this config writes, which
        keys its checkpoint: every field but those that do not change the
        output's pixels (the JAX package's list). ``weights_dir`` changes
        them and is hashed."""
        d = self.to_dict()
        for k in _HASH_EXCLUDED:
            d.pop(k, None)
        blob = json.dumps(d, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def get_preset(name: str) -> Dict[str, Any]:
    """A preset's fields (without its description), as the JAX
    ``get_preset``; ``archive`` and ``ultimate`` raise ``ConfigError``
    naming the ROADMAP.md items they wait for."""
    if name in _WAITING_PRESETS:
        raise ConfigError(f"preset {name!r} needs {_WAITING_PRESETS[name]}, not ported yet")
    if name not in PRESETS:
        raise ConfigError(f"Unknown preset {name!r}. Available: {sorted(PRESETS)}")
    return {k: v for k, v in PRESETS[name].items() if k != "description"}


def build_config(preset: str = "", overrides: Optional[Dict[str, Any]] = None) -> Config:
    """The preset's fields, then every override that is not None (the JAX
    CLI's precedence: preset < flags)."""
    kwargs: Dict[str, Any] = {}
    if preset:
        kwargs.update(get_preset(preset))
        kwargs["preset"] = preset
    kwargs.update({k: v for k, v in (overrides or {}).items() if v is not None})
    return Config(**kwargs)
