"""The RRDB and SRVGG rows of the model table, the temporal denoiser's
NAFNet row, weight loading, and the bridge from the JAX package's
parameter pytrees to the port's state dicts.

Weights resolve like ``framewright_tpu.models.registry.init_model``:
``<weights_dir>/<name>.npz`` (the JAX package's export format), a
basicsr ``<weights_dir>/<name>.pth``, the checkpoints trained in this
repository (read as data from ``framewright_tpu/models/weights``), or a
seeded random init. The state dict holds OIHW tensors named like the
official basicsr RRDBNet (``conv_first.weight``,
``body.0.rdb1.conv1.weight``, ...) or SRVGGNetCompact (``body.0.weight``,
``body.1.weight`` for the first PReLU, ...), the official NAFNet or
Practical-RIFE IFNet.

The denoiser's ``FW_nafnet_dn`` (``AUX_SPECS``) and the alignment IFNet
(``load_align_ifnet``) load from their checkpoints only: a missing or
unreadable file raises ``InputError`` (the JAX denoiser falls back to a
random NAFNet; ROADMAP.md, "JAX faults the port must not copy").
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from framewright_tpu_torch.errors import ConfigError, InputError
from framewright_tpu_torch.models.ifnet import ALIGN_ARCH, IFNet
from framewright_tpu_torch.models.layers import conv_init
from framewright_tpu_torch.models.nafnet import NAFNetConfig
from framewright_tpu_torch.models.rrdb import RRDBConfig
from framewright_tpu_torch.models.srvgg import SRVGGConfig

_SRVGG_URL = "https://github.com/xinntao/Real-ESRGAN/releases/download/v0.2.5.0/"


@dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str                              # rrdb | srvgg | nafnet
    scale: int
    arch_config: Union[RRDBConfig, SRVGGConfig, NAFNetConfig]
    url: str = ""


MODEL_SPECS: Dict[str, ModelSpec] = {s.name: s for s in (
    ModelSpec("RealESRGAN_x2plus", "rrdb", 2, RRDBConfig(num_block=23, scale=2),
              "https://github.com/xinntao/Real-ESRGAN/releases/download/v0.2.1/RealESRGAN_x2plus.pth"),
    ModelSpec("RealESRGAN_x4plus", "rrdb", 4, RRDBConfig(num_block=23, scale=4),
              "https://github.com/xinntao/Real-ESRGAN/releases/download/v0.1.0/RealESRGAN_x4plus.pth"),
    ModelSpec("RealESRGAN_x4plus_anime_6B", "rrdb", 4, RRDBConfig(num_block=6, scale=4),
              "https://github.com/xinntao/Real-ESRGAN/releases/download/v0.2.2.4/RealESRGAN_x4plus_anime_6B.pth"),
    ModelSpec("FW_fast6_x2", "rrdb", 2, RRDBConfig(num_block=6, scale=2)),
    ModelSpec("FW_fastvgg_x2", "srvgg", 2, SRVGGConfig(num_conv=16, scale=2)),
    ModelSpec("FW_fastvgg_x4", "srvgg", 4, SRVGGConfig(num_conv=32, scale=4)),
    ModelSpec("realesr-animevideov3", "srvgg", 4, SRVGGConfig(num_conv=16, scale=4),
              _SRVGG_URL + "realesr-animevideov3.pth"),
    ModelSpec("realesr-general-x4v3", "srvgg", 4, SRVGGConfig(num_conv=32, scale=4),
              _SRVGG_URL + "realesr-general-x4v3.pth"),
)}

# models that are not super-resolution: the temporal denoiser's NAFNet,
# trained in this repository (framewright_tpu/models/registry.py:185-197)
AUX_SPECS: Dict[str, ModelSpec] = {s.name: s for s in (
    ModelSpec("FW_nafnet_dn", "nafnet", 1,
              NAFNetConfig(width=16, enc_blocks=(1, 1, 2), middle_blocks=2,
                           dec_blocks=(1, 1, 1))),
)}
# the alignment IFNet's weights: ifnet.init(PRNGKey(1), ALIGN_ARCH) of the
# JAX package, written by scripts/export_align_ifnet.py
ALIGN_IFNET_NPZ = Path(__file__).resolve().parent / "weights" / "align_ifnet_key1.npz"

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


def _read_checkpoint(path: Path) -> Dict[str, Any]:
    """``read_npz``, an unreadable file raised as ``InputError``."""
    try:
        return read_npz(path)
    except Exception as exc:  # noqa: BLE001 - zip, header or dtype faults
        raise InputError(f"unreadable checkpoint {path}: {exc}") from exc


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


def init_params(cfg: Union[RRDBConfig, SRVGGConfig], seed: int = 0) -> Dict[str, Any]:
    """Seeded random parameters as a JAX-layout pytree (HWIO numpy
    arrays, body as a list), drawn with numpy, in the shapes of the JAX
    package's ``rrdb.init`` or ``srvgg.init`` (PReLU alphas 0.25)."""
    rng = np.random.default_rng(seed)
    if isinstance(cfg, SRVGGConfig):
        nf = cfg.num_feat
        return {
            "body": [conv_init(rng, 3, cfg.num_in_ch, nf)]
                    + [conv_init(rng, 3, nf, nf) for _ in range(cfg.num_conv)],
            "act": [{"alpha": np.full((nf,), 0.25, np.float32)}
                    for _ in range(cfg.num_conv + 1)],
            "conv_last": conv_init(rng, 3, nf, cfg.num_out_ch * cfg.scale ** 2),
        }
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
    stacked), SRVGG pytree (``body`` convs, ``act`` alphas,
    ``conv_last``), NAFNet pytree (``intro``, ``encoders``, ...) or IFNet
    pytree (``blocks``) -> the port's state dict (OIHW; a transposed
    conv's weight (in, out, kh, kw)), cast to ``dtype``."""
    sd: Dict[str, torch.Tensor] = {}

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32, order="C")).to(dtype)

    def conv(prefix: str, p: Dict[str, Any]) -> None:
        sd[prefix + ".weight"] = tensor(np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1))
        if "b" in p:                 # NAFNet's ups convs have none
            sd[prefix + ".bias"] = tensor(p["b"])

    if "intro" in params:        # NAFNet: the official names
        def block(prefix: str, p: Dict[str, Any]) -> None:
            for k in ("conv1", "conv2", "conv3", "conv4", "conv5"):
                conv(f"{prefix}.{k}", p[k])
            conv(f"{prefix}.sca.1", p["sca"])
            for k in ("norm1", "norm2"):
                sd[f"{prefix}.{k}.weight"] = tensor(p[k]["gamma"])
                sd[f"{prefix}.{k}.bias"] = tensor(p[k]["beta"])
            for k in ("beta", "gamma"):       # (1, 1, 1, c) -> (1, c, 1, 1)
                sd[f"{prefix}.{k}"] = tensor(np.asarray(p[k], np.float32).transpose(0, 3, 1, 2))

        conv("intro", params["intro"])
        conv("ending", params["ending"])
        for i, p in enumerate(params["downs"]):
            conv(f"downs.{i}", p)
        for i, p in enumerate(params["ups"]):
            conv(f"ups.{i}.0", p)
        for stage in ("encoders", "decoders"):
            for i, blocks in enumerate(params[stage]):
                for j, p in enumerate(blocks):
                    block(f"{stage}.{i}.{j}", p)
        for j, p in enumerate(params["middles"]):
            block(f"middle_blks.{j}", p)
        return sd

    if "blocks" in params:       # IFNet: the Practical-RIFE names
        def conv_prelu(prefix: str, p: Dict[str, Any]) -> None:
            conv(prefix + ".0", p)
            sd[prefix + ".1.weight"] = tensor(p["alpha"])

        for b, blk in enumerate(params["blocks"]):
            for j, p in enumerate(blk["conv0"]):
                conv_prelu(f"block{b}.conv0.{j}", p)
            for i, p in enumerate(blk["convblock"]):
                conv_prelu(f"block{b}.convblock.{i}", p)
            # HWIO (kh, kw, in, out) -> ConvTranspose2d's (in, out, kh, kw)
            sd[f"block{b}.lastconv.0.weight"] = tensor(
                np.asarray(blk["head"]["w"], np.float32).transpose(2, 3, 0, 1))
            sd[f"block{b}.lastconv.0.bias"] = tensor(blk["head"]["b"])
        return sd

    if "act" in params:          # SRVGG: the official SRVGGNetCompact names
        for i, (p, act) in enumerate(zip(params["body"], params["act"])):
            conv(f"body.{2 * i}", p)
            sd[f"body.{2 * i + 1}.weight"] = tensor(act["alpha"])
        conv(f"body.{2 * len(params['act'])}", params["conv_last"])
        return sd

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
    """Resolve a model's weights -> (spec, state dict, source label). A
    model of ``AUX_SPECS`` is never drawn at random."""
    spec = AUX_SPECS[name] if name in AUX_SPECS else get_model(name)
    allow_random = allow_random and name not in AUX_SPECS
    wdir = Path(weights_dir) if weights_dir else default_weights_dir()
    for npz in (wdir / f"{name}.npz", packaged_weights_dir() / f"{name}.npz"):
        if npz.is_file():
            return spec, from_jax_params(_read_checkpoint(npz), dtype), str(npz)
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


def load_align_ifnet(device) -> IFNet:
    """The temporal denoiser's alignment IFNet (``ALIGN_ARCH``) with the
    JAX package's ``ifnet.init(PRNGKey(1))`` weights, from
    ``ALIGN_IFNET_NPZ``; raises ``InputError`` when the file is missing
    or unreadable (the port never draws a flow net at random)."""
    if not ALIGN_IFNET_NPZ.is_file():
        raise InputError(f"the alignment flow net's weights are missing: {ALIGN_IFNET_NPZ} "
                         "(python3 scripts/export_align_ifnet.py writes them)")
    sd = from_jax_params(_read_checkpoint(ALIGN_IFNET_NPZ), torch.float32)
    return IFNet.from_state_dict(ALIGN_ARCH, sd, device)
