"""The fields of ``framewright_tpu.config.Config`` that the port's
restore path reads, with the same names and defaults, plus the two the
port adds (``weights_dir``, ``max_frames``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from framewright_tpu_torch.errors import ConfigError

# what the port runs: the RRDB and SRVGG models of the registry in bf16 and
# int8 (float32 and the other families are queued in ROADMAP.md A)
_VALID_DTYPES = ("bfloat16", "int8")
_VALID_DEVICES = ("auto", "cuda", "cpu")


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
    compute_dtype: str = "bfloat16"       # bfloat16 | int8 (static scales)
    device_platform: str = "auto"         # auto (= cuda) | cuda | cpu
    hbm_utilization: float = 0.85         # share of free card memory to plan for

    def __post_init__(self) -> None:
        self.project_dir = Path(self.project_dir)
        if self.output_path is not None:
            self.output_path = Path(self.output_path)
        if self.weights_dir is not None:
            self.weights_dir = Path(self.weights_dir)
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
            raise ConfigError(f"compute_dtype must be one of {_VALID_DTYPES} "
                              "(float32 is not ported yet: ROADMAP.md A1)")
        if self.device_platform not in _VALID_DEVICES:
            raise ConfigError(f"device_platform must be one of {_VALID_DEVICES}")
        if self.batch_size < 0 or self.max_frames < 0:
            raise ConfigError("batch_size and max_frames must be >= 0")
        if not (0.0 < self.hbm_utilization <= 1.0):
            raise ConfigError("hbm_utilization must be in (0, 1]")
