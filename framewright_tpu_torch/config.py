"""The fields of ``framewright_tpu.config.Config`` that the port's
restore path reads, with the same names and defaults, plus the two the
port adds (``weights_dir``, ``max_frames``)."""

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
