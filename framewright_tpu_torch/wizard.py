"""Interactive setup wizard (the port of ``framewright_tpu.wizard``):
JAX's questions build a ``Config`` for users who do not know the flags.
The input and print functions are injectable (tests script the answers;
front ends without a terminal pass their own). The config is JAX's
``Config(**answers)`` at the named model's scale; "Keep resolution"
names JAX's ``sr_model="none"`` (no SR), which the port does not have:
``ConfigError``."""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from framewright_tpu_torch.config import Config, at_model_scale

logger = logging.getLogger(__name__)


@dataclass
class Question:
    key: str
    prompt: str
    choices: List[Tuple[str, Dict]]      # (label, config delta)
    default: int = 0


QUESTIONS: List[Question] = [
    Question(
        "content", "What kind of footage is this?",
        [
            ("Old film (pre-1960)", {"deduplicate": True, "grain_preserve": True,
                                     "defect_repair": True, "denoise": True}),
            ("VHS / analog tape", {"denoise": True, "deinterlace": "yadif",
                                   "temporal_consistency": True}),
            ("DVD / low-res digital", {"denoise": True}),
            ("Animation", {"sr_model": "RealESRGAN_x4plus_anime_6B",
                           "scale_factor": 4}),
            ("Modern digital video", {}),
        ],
    ),
    Question(
        "goal", "How much should the resolution increase?",
        [
            ("Keep resolution (cleanup only)", {"scale_factor": 1, "sr_model": "none"}),
            ("2x", {"scale_factor": 2, "sr_model": "RealESRGAN_x2plus"}),
            ("4x", {"scale_factor": 4, "sr_model": "RealESRGAN_x4plus"}),
        ],
        default=1,
    ),
    Question(
        "motion", "Smooth the motion (frame interpolation)?",
        [
            ("No", {}),
            ("Yes, double the frame rate", {"interpolation": True}),
            ("Yes, to 60 fps", {"interpolation": True, "target_fps": 60.0}),
        ],
    ),
    Question(
        "faces", "Are there faces that need restoring?",
        [("No", {}), ("Yes", {"face_restore": True})],
    ),
    Question(
        "speed", "Speed vs quality?",
        [
            ("Fast draft", {"crf": 23, "compute_dtype": "bfloat16"}),
            ("Balanced", {"crf": 18}),
            ("Archival quality (slow)", {"crf": 12, "validate_output": True}),
        ],
        default=1,
    ),
]


class Wizard:
    def __init__(self, input_fn: Optional[Callable[[str], str]] = None,
                 print_fn: Optional[Callable[[str], None]] = None):
        self.input_fn = input_fn or input       # the builtins' of the moment
        self.print_fn = print_fn or print
        self.answers: Dict[str, int] = {}

    def ask(self, q: Question) -> Dict:
        """Print the question and its numbered choices (``*`` the default),
        read until a number of the list or an empty line (the default)."""
        self.print_fn(f"\n{q.prompt}")
        for i, (label, _) in enumerate(q.choices, start=1):
            marker = "*" if (i - 1) == q.default else " "
            self.print_fn(f"  {i}{marker} {label}")
        while True:
            raw = self.input_fn(f"choice [1-{len(q.choices)}, enter={q.default + 1}]: ").strip()
            if not raw:
                idx = q.default
                break
            if raw.isdigit() and 1 <= int(raw) <= len(q.choices):
                idx = int(raw) - 1
                break
            self.print_fn("  please enter a number from the list")
        self.answers[q.key] = idx
        return q.choices[idx][1]

    def run(self, **extra) -> Config:
        overrides: Dict = {}
        for q in QUESTIONS:
            overrides.update(self.ask(q))
        overrides.update(extra)
        cfg = Config(**at_model_scale(overrides))
        self.print_fn("\nPlan:")
        for k in ("scale_factor", "sr_model", "denoise", "interpolation",
                  "face_restore", "deduplicate", "crf"):
            self.print_fn(f"  {k} = {getattr(cfg, k)}")
        return cfg
