"""Natural-language command interface (the port of
``framewright_tpu.nlp``): rule-based intent and entity extraction, "restore
my old VHS tape and double the frame rate" -> a ``Config`` delta, a preset
or recipe and a plan description. JAX's regexes and rules, copied.

``build_config_from_text`` builds JAX's ``Config(**kwargs)`` (not the
layered ``build_config``: the environment does not reach it), at the
named model's scale (``config.at_model_scale``: "anime ... 2x" names the
x4 anime model at 2, which the port's ``Config`` refuses and JAX's
restore writes at 4)."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

_SCALE_RE = re.compile(r"\b(2|4)\s*x\b|\bx\s*(2|4)\b|\b(double|quadruple)\b.{0,16}\b(size|resolution)\b")
_FPS_RE = re.compile(r"\b(\d{2,3})\s*fps\b")
_TARGET_RES = {
    "4k": 2160, "uhd": 2160, "2160p": 2160,
    "1080p": 1080, "full hd": 1080, "fhd": 1080,
    "720p": 720, "hd": 720,
}

_KEYWORD_RULES: List[Tuple[re.Pattern, Dict]] = [
    (re.compile(r"\b(denois\w*|noise|noisy|grainy|grain\b.{0,12}remov)"),
     {"denoise": True}),
    (re.compile(r"\b(keep|preserve).{0,12}grain"),
     {"grain_preserve": True, "denoise": False}),
    (re.compile(r"\b(colori[sz]e|add colou?r|black.?and.?white|b&w|bw\b)"),
     {"colorize": True}),
    (re.compile(r"\bface(s)?\b"), {"face_restore": True}),
    (re.compile(r"\b(watermark|logo)\b"), {"watermark_removal": True}),
    (re.compile(r"\bsubtitles?\b.{0,20}\b(remove|burn)"), {"subtitle_removal": True}),
    (re.compile(r"\b(interpolat|smooth(er)? motion|double.{0,12}frame ?rate|60 ?fps)"),
     {"interpolation": True}),
    (re.compile(r"\b(dedup|duplicate frames?|jerky|stutter)"),
     {"deduplicate": True}),
    (re.compile(r"\b(deinterlac|interlac|comb(ing)?)\b"), {"deinterlace": "yadif"}),
    (re.compile(r"\b(stabili[sz]|shaky|jitter)\b"), {"stabilize": True}),
    (re.compile(r"\bflicker\b"), {"temporal_consistency": True}),
    (re.compile(r"\bvhs|tape\b"), {"_recipe": "vhs_family_video"}),
    (re.compile(r"\bsilent (film|movie)|old film|1920s|1930s\b"),
     {"_recipe": "silent_film_restoration"}),
    (re.compile(r"\bdvd\b"), {"_recipe": "dvd_upscale"}),
    (re.compile(r"\banime|cartoon|animation\b"),
     {"sr_model": "RealESRGAN_x4plus_anime_6B", "scale_factor": 4}),
    (re.compile(r"\b(fast|quick(ly)?|draft)\b"), {"_preset": "fast"}),
    (re.compile(r"\b(best|maximum|highest) quality|archival|archive\b"),
     {"_preset": "archive"}),
    (re.compile(r"\b8 ?mm|super ?8\b"), {"_recipe": "home_movie_8mm"}),
    (re.compile(r"\bhdr10\+|hdr10 ?plus\b"), {"hdr_output": "hdr10plus"}),
    (re.compile(r"\bhdr\b"), {"hdr_output": "hdr10"}),
    (re.compile(r"\bblock(y|iness)|compression artifacts?|deblock"),
     {"qp_removal": True}),
    (re.compile(r"\bcodeformer\b"),
     {"face_restore": True, "face_model": "codeformer"}),
    (re.compile(r"\bscene.{0,6}(aware|adaptive)|adapt.{0,12}per scene"),
     {"scene_adaptive": True}),
    (re.compile(r"\b(accurate|precise|best) (optical )?flow|raft\b"),
     {"flow_model": "raft"}),
    (re.compile(r"\bensemble\b"),
     {"sr_ensemble": "realesr-general-x4v3",
      "ensemble_strategy": "weighted"}),
]


@dataclass
class ParsedCommand:
    overrides: Dict = field(default_factory=dict)
    preset: str = ""
    recipe: str = ""
    source: str = ""
    matched_phrases: List[str] = field(default_factory=list)

    def describe(self) -> str:
        parts = []
        if self.recipe:
            parts.append(f"recipe '{self.recipe}'")
        elif self.preset:
            parts.append(f"preset '{self.preset}'")
        for k, v in self.overrides.items():
            parts.append(f"{k}={v}")
        return "plan: " + (", ".join(parts) if parts else "default restore")


def parse_command(text: str) -> ParsedCommand:
    """Free text -> restoration plan."""
    low = text.lower()
    cmd = ParsedCommand()

    # file path / URL mention
    m = re.search(r"(\S+\.(?:y4m|mp4|mkv|avi|mov|webm))\b", text, re.IGNORECASE)
    if m:
        cmd.source = m.group(1)

    # scale factor / target resolution
    m = _SCALE_RE.search(low)
    if m:
        if m.group(1) or m.group(2):
            cmd.overrides["scale_factor"] = int(m.group(1) or m.group(2))
        elif m.group(3) == "double":
            cmd.overrides["scale_factor"] = 2
        else:
            cmd.overrides["scale_factor"] = 4
    for word, res in _TARGET_RES.items():
        if re.search(rf"\b(to|in|at)\s+{re.escape(word)}\b", low):
            cmd.overrides.setdefault("scale_factor", 2 if res <= 1080 else 4)
            cmd.matched_phrases.append(word)
            break

    m = _FPS_RE.search(low)
    if m:
        cmd.overrides["interpolation"] = True
        cmd.overrides["target_fps"] = float(m.group(1))

    for pattern, delta in _KEYWORD_RULES:
        pm = pattern.search(low)
        if not pm:
            continue
        cmd.matched_phrases.append(pm.group(0).strip())
        for k, v in delta.items():
            if k == "_preset":
                cmd.preset = cmd.preset or v
            elif k == "_recipe":
                cmd.recipe = cmd.recipe or v
            else:
                cmd.overrides.setdefault(k, v)

    # scale models consistency: if scale set to 2 pick the x2 model
    if cmd.overrides.get("scale_factor") == 2 and "sr_model" not in cmd.overrides:
        cmd.overrides["sr_model"] = "RealESRGAN_x2plus"
    if cmd.overrides.get("scale_factor") == 4 and "sr_model" not in cmd.overrides:
        cmd.overrides["sr_model"] = "RealESRGAN_x4plus"
    return cmd


def build_config_from_text(text: str, **extra):
    """Text -> (Config, ParsedCommand): the recipe's fields, or the
    preset's, under the phrase's overrides and ``extra``."""
    from framewright_tpu_torch.config import Config, at_model_scale, get_preset
    from framewright_tpu_torch.recipes import get_recipe

    cmd = parse_command(text)
    kwargs: Dict = {}
    if cmd.recipe:
        kwargs.update(get_recipe(cmd.recipe).config_overrides)
    elif cmd.preset:
        kwargs.update(get_preset(cmd.preset))
        kwargs["preset"] = cmd.preset
    kwargs.update(cmd.overrides)
    kwargs.update(extra)
    return Config(**at_model_scale(kwargs)), cmd
