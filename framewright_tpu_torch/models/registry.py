"""The RRDB rows of the model table, weight loading, and the bridge from
the JAX package's parameter pytrees to the port's state dicts.

Weights resolve like ``framewright_tpu.models.registry.init_model``:
``<weights_dir>/<name>.npz`` (the JAX package's export format), a
basicsr ``<weights_dir>/<name>.pth``, the checkpoints trained in this
repository (read as data from ``framewright_tpu/models/weights``), or a
seeded random init. The state dict holds OIHW tensors named like the
official basicsr RRDBNet (``conv_first.weight``,
``body.0.rdb1.conv1.weight``, ...).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from framewright_tpu_torch.errors import ConfigError, InputError
from framewright_tpu_torch.models.layers import conv_init
from framewright_tpu_torch.models.rrdb import RRDBConfig


@dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str
    scale: int
    arch_config: RRDBConfig
    url: str = ""


MODEL_SPECS: Dict[str, ModelSpec] = {s.name: s for s in (
    ModelSpec("RealESRGAN_x2plus", "rrdb", 2, RRDBConfig(num_block=23, scale=2),
              "https://github.com/xinntao/Real-ESRGAN/releases/download/v0.2.1/RealESRGAN_x2plus.pth"),
    ModelSpec("RealESRGAN_x4plus", "rrdb", 4, RRDBConfig(num_block=23, scale=4),
              "https://github.com/xinntao/Real-ESRGAN/releases/download/v0.1.0/RealESRGAN_x4plus.pth"),
    ModelSpec("RealESRGAN_x4plus_anime_6B", "rrdb", 4, RRDBConfig(num_block=6, scale=4),
              "https://github.com/xinntao/Real-ESRGAN/releases/download/v0.2.2.4/RealESRGAN_x4plus_anime_6B.pth"),
    ModelSpec("FW_fast6_x2", "rrdb", 2, RRDBConfig(num_block=6, scale=2)),
)}

_CONVS = ("conv_first", "conv_body", "conv_up1", "conv_up2", "conv_hr",
          "conv_last")


def get_model(name: str) -> ModelSpec:
    if name not in MODEL_SPECS:
        raise ConfigError(f"Unknown model {name!r}. The port runs "
                          f"{sorted(MODEL_SPECS)}")
    return MODEL_SPECS[name]


def default_weights_dir() -> Path:
    env = os.environ.get("FRAMEWRIGHT_WEIGHTS_DIR")
    if env:
        return Path(env)
    return Path.home() / ".framewright_tpu" / "models"


def packaged_weights_dir() -> Path:
    """Checkpoints trained in this repository. They ship beside the JAX
    package; the port reads them as data files and imports nothing."""
    return (Path(__file__).resolve().parents[2] / "framewright_tpu" / "models"
            / "weights")


def read_npz(path: Path) -> Dict[str, Any]:
    """The package's ``.npz`` format (``torch_port.export_npz``): dotted
    keys, digit components as list indices, stacked ``body.*`` leaves,
    float16 storage -> a nested dict of numpy arrays."""
    root: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            none_leaf = key.endswith(".__none__")
            name = key[: -len(".__none__")] if none_leaf else key
            node = root
            parts = name.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = None if none_leaf else data[key]

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def init_params(cfg: RRDBConfig, seed: int = 0) -> Dict[str, Any]:
    """Seeded random RRDBNet parameters as a JAX-layout pytree (HWIO
    numpy arrays, body as a list), drawn with numpy."""
    rng = np.random.default_rng(seed)
    nf, gc = cfg.num_feat, cfg.num_grow_ch
    in_ch = cfg.num_in_ch * {2: 4, 1: 16}.get(cfg.scale, 1)

    def rdb():
        return {f"conv{k + 1}": conv_init(rng, 3, nf + k * gc, gc if k < 4 else nf)
                for k in range(5)}

    return {
        "conv_first": conv_init(rng, 3, in_ch, nf),
        "body": [{"rdb1": rdb(), "rdb2": rdb(), "rdb3": rdb()}
                 for _ in range(cfg.num_block)],
        "conv_body": conv_init(rng, 3, nf, nf),
        "conv_up1": conv_init(rng, 3, nf, nf),
        "conv_up2": conv_init(rng, 3, nf, nf),
        "conv_hr": conv_init(rng, 3, nf, nf),
        "conv_last": conv_init(rng, 3, nf, cfg.num_out_ch),
    }


def _body_blocks(body) -> List[Dict[str, Any]]:
    if isinstance(body, list):
        return body
    first = body
    while isinstance(first, dict):   # stacked storage: leaves (num_block, ...)
        first = next(iter(first.values()))
    n = int(np.asarray(first).shape[0])

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    return [take(body, i) for i in range(n)]


def from_jax_params(params: Dict[str, Any],
                    dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """JAX RRDBNet pytree (HWIO numpy arrays; body as a list of blocks or
    stacked) -> the port's state dict (OIHW), cast to ``dtype``."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(prefix: str, p: Dict[str, Any]) -> None:
        w = np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)
        sd[prefix + ".weight"] = torch.from_numpy(np.ascontiguousarray(w)).to(dtype)
        sd[prefix + ".bias"] = torch.from_numpy(
            np.asarray(p["b"], np.float32).copy()).to(dtype)

    for name in _CONVS:
        conv(name, params[name])
    for i, blk in enumerate(_body_blocks(params["body"])):
        for r in ("rdb1", "rdb2", "rdb3"):
            for k in range(1, 6):
                conv(f"body.{i}.{r}.conv{k}", blk[r][f"conv{k}"])
    return sd


def bf16_masters(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every weight and bias rounded to bf16 once, kept in f32 storage.
    The JAX restore path casts its master parameters to bf16 on the host
    before any weight transform, in bf16 and in int8 mode alike
    (``registry.init_model(dtype=bf16)``); the kernel layouts, the int8
    scales and the plain path all derive from these values."""
    return {k: v.to(torch.bfloat16).float() for k, v in sd.items()}


def load_weights(name: str, weights_dir: Optional[Path] = None,
                 allow_random: bool = True, seed: int = 0,
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[ModelSpec, Dict[str, torch.Tensor], str]:
    """Resolve a model's weights -> (spec, state dict, source label)."""
    spec = get_model(name)
    wdir = Path(weights_dir) if weights_dir else default_weights_dir()
    for npz in (wdir / f"{name}.npz", packaged_weights_dir() / f"{name}.npz"):
        if npz.is_file():
            return spec, from_jax_params(read_npz(npz), dtype), str(npz)
    pth = wdir / f"{name}.pth"
    if pth.is_file():
        sd = torch.load(pth, map_location="cpu", weights_only=True)
        sd = sd.get("params_ema", sd.get("params", sd))
        return spec, {k: v.to(dtype) for k, v in sd.items()}, str(pth)
    if not allow_random:
        raise InputError(f"No weights for {name!r} in {wdir} (looked for "
                         f".npz/.pth). Download from {spec.url}")
    return (spec, from_jax_params(init_params(spec.arch_config, seed), dtype),
            f"random(seed={seed})")
