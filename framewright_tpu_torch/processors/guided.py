"""Guided (prompt-steered) enhancement: the port of
``framewright_tpu.processors.guided`` (``parse_style``, ``STYLE_PRESETS``,
``GuidedConfig``, ``ClassicalGuidedBackend``, ``ReferenceGuidedBackend``,
``make_backend``), numpy on the host, as in JAX.

A prompt (after a preset's words) becomes a style vector over a fixed
vocabulary (sharpness, grain, warmth, saturation, brightness, contrast,
anime, portrait), each known word moving its axis by 0.6 within [-1, 1].
The classical backend applies it to a uint8 frame, scaled by
``strength``: unsharp mask with a wrapped 1-2-1 blur, a red/blue warmth
shift, saturation about BT.601 luma, a gamma, contrast about mid-grey,
then seeded grain or a light denoise; the output is clipped and rounded
half up. The reference backend matches a frame's YCbCr mean and standard
deviation to those pooled over up to 16 ``*.png`` stills of a directory
(read with Pillow, imported at first use) and its grain level to theirs
(``film.GrainManager``, mode match). The restorer runs the backend on
each SR output frame after the quality gate (``post_fx``, JAX
``restorer.py:671-700``); ``rng_states`` / ``set_rng_states`` let a
resumed restore continue the backends' generators where a straight run
had them.

``backend="diffusion"`` (``DiffusionGuidedBackend``) runs DiffusionSR_x4
(``models.diffusion_sr``, the registry's checkpoint: the weights
directory's ``DiffusionSR_x4.npz``, else the one trained in this
repository) on the card in f32, with the style vector in its time
embedding and classifier-free guidance at ``guidance_scale``, from
``PRNGKey(seed)``'s noise, at the registry row's one step (JAX's
``steps`` field is not read there either); its output is the x4 frame,
as JAX's (the restorer never selects it: it passes ``backend="auto"``).
A reference directory without stills raises ``InputError`` (JAX:
FileNotFoundError).
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

from framewright_tpu_torch.errors import InputError

logger = logging.getLogger(__name__)

STYLE_DIM = 16

# axis -> (negative pole words, positive pole words)
_VOCAB = {
    0: (("soft", "smooth", "dreamy"), ("sharp", "crisp", "detailed", "detail")),
    1: (("clean", "denoised", "noiseless"), ("grainy", "grain", "filmic", "film")),
    2: (("cool", "cold", "blue"), ("warm", "golden", "sunny")),
    3: (("muted", "desaturated", "faded", "pastel"), ("vivid", "vibrant", "saturated",
                                                      "colorful")),
    4: (("dark", "moody", "dim"), ("bright", "luminous", "light")),
    5: (("flat", "low-contrast"), ("contrasty", "punchy", "dramatic", "contrast")),
    6: ((), ("anime", "cartoon", "illustration")),
    7: ((), ("portrait", "face", "skin")),
}

STYLE_PRESETS: Dict[str, str] = {
    "natural": "clean detailed natural colors",
    "cinematic": "sharp contrasty warm cinematic film grain",
    "anime": "crisp clean vivid anime illustration",
    "vintage": "soft warm faded filmic grain",
    "documentary": "sharp clean neutral detailed",
    "portrait": "soft warm portrait skin detail",
}


def parse_style(prompt: str) -> np.ndarray:
    """Prompt -> (STYLE_DIM,) f32 vector in [-1, 1]; unknown words are
    ignored."""
    vec = np.zeros((STYLE_DIM,), np.float32)
    unknown = []
    for w in re.findall(r"[a-z][a-z-]+", prompt.lower()):
        hit = False
        for axis, (neg, pos) in _VOCAB.items():
            if w in pos:
                vec[axis] = min(1.0, vec[axis] + 0.6)
                hit = True
            elif w in neg:
                vec[axis] = max(-1.0, vec[axis] - 0.6)
                hit = True
        if not hit:
            unknown.append(w)
    if unknown:
        logger.debug("guided: words outside the style vocabulary ignored: %s", unknown[:8])
    return vec


@dataclass
class GuidedConfig:
    prompt: str = ""
    preset: str = ""                 # a STYLE_PRESETS name; the prompt follows it
    strength: float = 0.8
    guidance_scale: float = 5.0      # classifier-free guidance (diffusion)
    backend: str = "auto"            # auto | classical | diffusion
    seed: int = 0
    device: str = "cuda"             # the diffusion backend's
    weights_dir: Optional[str] = None

    def style_vector(self) -> np.ndarray:
        return parse_style(STYLE_PRESETS.get(self.preset, "") + " " + self.prompt)


class ClassicalGuidedBackend:
    """The style vector applied to a uint8 frame in numpy."""

    def __init__(self, cfg: GuidedConfig):
        self.cfg = cfg
        self.vec = cfg.style_vector() * cfg.strength
        self._rng = np.random.default_rng(cfg.seed)

    @staticmethod
    def _blur3(x: np.ndarray) -> np.ndarray:
        y = (x + np.roll(x, 1, 0) * 0.5 + np.roll(x, -1, 0) * 0.5) / 2.0
        return (y + np.roll(y, 1, 1) * 0.5 + np.roll(y, -1, 1) * 0.5) / 2.0

    def enhance(self, frame: np.ndarray) -> np.ndarray:
        """uint8 (H, W, 3) -> uint8 of the same size."""
        v = self.vec
        f = frame.astype(np.float32) / 255.0
        if abs(v[0]) > 1e-3:  # sharpness
            f = np.clip(f + v[0] * 0.8 * (f - self._blur3(f)), 0, 1)
        if abs(v[2]) > 1e-3:  # warmth
            f[..., 0] = np.clip(f[..., 0] * (1 + 0.08 * v[2]), 0, 1)
            f[..., 2] = np.clip(f[..., 2] * (1 - 0.08 * v[2]), 0, 1)
        if abs(v[3]) > 1e-3:  # saturation
            luma = f @ np.asarray([0.299, 0.587, 0.114], np.float32)
            f = np.clip(luma[..., None] + (f - luma[..., None]) * (1 + 0.5 * v[3]), 0, 1)
        if abs(v[4]) > 1e-3:  # brightness (gamma)
            f = np.clip(f, 1e-6, 1.0) ** (1.0 / (1.0 + 0.35 * v[4]))
        if abs(v[5]) > 1e-3:  # contrast about mid-grey
            f = np.clip(0.5 + (f - 0.5) * (1 + 0.4 * v[5]), 0, 1)
        if v[1] > 1e-3:       # grain
            g = self._rng.standard_normal(f.shape[:2]).astype(np.float32)
            f = np.clip(f + (0.04 * v[1]) * g[..., None], 0, 1)
        elif v[1] < -1e-3:    # light denoise
            f = f + (-v[1]) * 0.6 * (self._blur3(f) - f)
        return np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8)

    def rng_states(self) -> List[dict]:
        return [self._rng.bit_generator.state]

    def set_rng_states(self, states: List[dict]) -> None:
        self._rng.bit_generator.state = states[0]

    def process_stream(self, frames: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        for fr in frames:
            yield self.enhance(fr)


class DiffusionGuidedBackend:
    """Style-conditioned diffusion SR with classifier-free guidance
    (JAX ``processors/guided.py:155-192``): uint8 (H, W, 3) -> uint8 (4H,
    4W, 3)."""

    def __init__(self, cfg: GuidedConfig):
        import torch

        from framewright_tpu_torch.hw import resolve_device
        from framewright_tpu_torch.models.layers import tree_to_torch
        from framewright_tpu_torch.models.registry import load_params

        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        spec, tree, self.weights_source = load_params("DiffusionSR_x4", cfg.weights_dir)
        self.arch = spec.arch_config
        self.params = tree_to_torch(tree, self.device, torch.float32)
        self.vec = torch.from_numpy(cfg.style_vector()[None]).to(self.device)

    def enhance(self, frame: np.ndarray) -> np.ndarray:
        import torch

        from framewright_tpu_torch.hw import full_f32
        from framewright_tpu_torch.models.diffusion_sr import ddim_sample

        lr = torch.from_numpy(frame[None].astype(np.float32) / 255.0).to(self.device)
        with torch.no_grad(), full_f32():
            out = ddim_sample(self.params, lr, self.arch, seed=self.cfg.seed, style=self.vec,
                              guidance_scale=self.cfg.guidance_scale)
        return np.clip(out[0].cpu().numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)

    def rng_states(self) -> List[dict]:
        return []

    def set_rng_states(self, states: List[dict]) -> None:
        pass


class ReferenceGuidedBackend:
    """A frame's YCbCr statistics and grain level matched to reference
    stills."""

    def __init__(self, reference_dir, strength: float = 0.5, seed: int = 0):
        from framewright_tpu_torch.io.png_seq import load_frame
        from framewright_tpu_torch.processors.film import GrainManager, estimate_grain_level

        ref_dir = Path(reference_dir)
        paths = sorted(ref_dir.glob("*.png")) if ref_dir.is_dir() else []
        if not paths:
            raise InputError(f"no reference images (*.png) in {reference_dir}")
        stats, grains = [], []
        for p in paths[:16]:
            img = load_frame(p).astype(np.float32)
            ycc = self._to_ycc(img).reshape(-1, 3)
            stats.append((ycc.mean(0), ycc.std(0)))
            grains.append(estimate_grain_level(img.astype(np.uint8)))
        self.ref_mean = np.mean([s[0] for s in stats], axis=0)
        self.ref_std = np.mean([s[1] for s in stats], axis=0) + 1e-6
        self.ref_grain = float(np.mean(grains))
        self.strength = strength
        self._grain = GrainManager(mode="match", strength=strength, seed=seed)

    @staticmethod
    def _to_ycc(rgb: np.ndarray) -> np.ndarray:
        m = np.asarray([[0.299, 0.587, 0.114],
                        [-0.1687, -0.3313, 0.5],
                        [0.5, -0.4187, -0.0813]], np.float32)
        return rgb @ m.T

    @staticmethod
    def _from_ycc(ycc: np.ndarray) -> np.ndarray:
        m = np.asarray([[1.0, 0.0, 1.402],
                        [1.0, -0.344136, -0.714136],
                        [1.0, 1.772, 0.0]], np.float32)
        return ycc @ m.T

    def enhance(self, frame: np.ndarray) -> np.ndarray:
        f = self._to_ycc(frame.astype(np.float32))
        flat = f.reshape(-1, 3)
        mu, sd = flat.mean(0), flat.std(0) + 1e-6
        matched = (f - mu) * (self.ref_std / sd) + self.ref_mean
        out = np.clip(self._from_ycc(f + self.strength * (matched - f)), 0, 255).astype(np.uint8)
        return self._grain.process(out, target_level=self.ref_grain)

    def rng_states(self) -> List[dict]:
        return [self._grain.rng.bit_generator.state]

    def set_rng_states(self, states: List[dict]) -> None:
        self._grain.rng.bit_generator.state = states[0]

    def process_stream(self, frames: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        for fr in frames:
            yield self.enhance(fr)


class _Chain:
    """The base backend, then the reference matching."""

    def __init__(self, base, ref):
        self.base, self.ref = base, ref

    def enhance(self, frame: np.ndarray) -> np.ndarray:
        return self.ref.enhance(self.base.enhance(frame))

    def rng_states(self) -> List[dict]:
        return self.base.rng_states() + self.ref.rng_states()

    def set_rng_states(self, states: List[dict]) -> None:
        n = len(self.base.rng_states())
        self.base.set_rng_states(states[:n])
        self.ref.set_rng_states(states[n:])

    def process_stream(self, frames: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        for fr in frames:
            yield self.enhance(fr)


def make_backend(cfg: GuidedConfig, reference_dir: Optional[str] = None):
    """The diffusion backend for ``backend="diffusion"``, else the
    classical one (as in JAX), followed by the reference matching when
    ``reference_dir`` is given."""
    base = (DiffusionGuidedBackend(cfg) if cfg.backend == "diffusion"
            else ClassicalGuidedBackend(cfg))
    if reference_dir:
        return _Chain(base, ReferenceGuidedBackend(reference_dir, strength=cfg.strength,
                                                   seed=cfg.seed))
    return base
