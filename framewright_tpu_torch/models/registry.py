"""The RRDB, SRVGG, HAT and video-SR rows of the model table, the
temporal denoiser's NAFNet, Restormer and RAFT rows, weight loading, and
the bridge from the JAX package's parameter pytrees to the port's state
dicts.

Weights resolve like ``framewright_tpu.models.registry.init_model``:
``<weights_dir>/<name>.npz`` (the JAX package's export format), a
basicsr ``<weights_dir>/<name>.pth``, the checkpoints trained in this
repository (read as data from ``framewright_tpu/models/weights``), or a
seeded random init. The state dict holds OIHW tensors named like the
official basicsr RRDBNet (``conv_first.weight``,
``body.0.rdb1.conv1.weight``, ...) or SRVGGNetCompact (``body.0.weight``,
``body.1.weight`` for the first PReLU, ...), the official NAFNet or
Practical-RIFE IFNet.

The models that are not super-resolution (``AUX_SPECS``: the denoiser's
``FW_nafnet_dn``, interpolation's ``rife-v4.6``, the face restorer's
``GFPGANv1.4``, ``CodeFormer`` and its detector ``RetinaFace_mnet025``)
and the alignment IFNet (``load_align_ifnet``) load from their
checkpoints only: a missing or unreadable file raises ``InputError`` (the
JAX package falls back to random NAFNet, IFNet, GFPGAN and CodeFormer
weights; ROADMAP.md, "JAX faults the port must not copy"). CodeFormer
also reads sczhou's released ``CodeFormer.pth``, whose names are its
module's. ``write_npz`` writes a parameter tree in the JAX package's
``.npz`` layout.

The models that run functionally over the JAX tree (``HAT_SRx4``,
``DiffusionSR_x4`` from the checkpoint trained in this repository,
``BasicVSR``, ``TVSR_x4``; the denoiser's ``restormer`` and
``raft-things``) load as that tree of numpy arrays (``load_params``,
``load_aux``; ``from_jax_params`` passes such a tree through as f32
numpy): the SR rows from ``<name>.npz``, a published ``.pth`` through the
model module's ``port_state_dict`` (HAT, BasicVSR; RAFT's
``raft-things.pth``), else a seeded numpy draw at the row's widths (the
JAX package draws its own; ``TVSR_x4`` has no published checkpoint).
Restormer and RAFT read user weights only: ``<weights_dir>/restormer.npz``
and ``raft-things.npz`` or ``.pth``, else ``InputError``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from framewright_tpu_torch.errors import ConfigError, InputError
from framewright_tpu_torch.models import codeformer, diffusion_sr, hat, raft, restormer, tvsr, vsr
from framewright_tpu_torch.models.codeformer import CodeFormerConfig
from framewright_tpu_torch.models.gfpgan import GFPGANConfig
from framewright_tpu_torch.models.gfpgan import config_from_params as gfpgan_config_from_params
from framewright_tpu_torch.models.ifnet import ALIGN_ARCH, IFNet, IFNetConfig
from framewright_tpu_torch.models.layers import conv_init
from framewright_tpu_torch.models.nafnet import NAFNetConfig
from framewright_tpu_torch.models.retinaface import RetinaFaceConfig
from framewright_tpu_torch.models.rrdb import RRDBConfig
from framewright_tpu_torch.models.srvgg import SRVGGConfig

_SRVGG_URL = "https://github.com/xinntao/Real-ESRGAN/releases/download/v0.2.5.0/"


@dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str                   # rrdb | srvgg | hat | basicvsr | tvsr | diffusion | nafnet |
                                  # restormer | flow | ifnet | face | codeformer | detector
    scale: int
    arch_config: Union[RRDBConfig, SRVGGConfig, NAFNetConfig, IFNetConfig, GFPGANConfig,
                       CodeFormerConfig, RetinaFaceConfig, hat.HATConfig, vsr.BasicVSRConfig,
                       tvsr.TVSRConfig, restormer.RestormerConfig, raft.RAFTConfig,
                       diffusion_sr.DiffusionSRConfig]
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
    # framewright_tpu/models/registry.py:148-184
    ModelSpec("HAT_SRx4", "hat", 4, hat.official_config(),
              "https://github.com/XPixelGroup/HAT/releases/download/v0.1.0/HAT_SRx4.pth"),
    ModelSpec("BasicVSR", "basicvsr", 4, vsr.BasicVSRConfig(),
              "https://download.openmmlab.com/mmediting/restorers/basicvsr/"
              "basicvsr_reds4_20120409-0e599677.pth"),
    ModelSpec("TVSR_x4", "tvsr", 4, tvsr.TVSRConfig()),
    # steps=1: the packaged checkpoint (framewright_tpu/models/weights/
    # DiffusionSR_x4.npz) is distilled to a one-step sampler; no published
    # checkpoint exists (the JAX row's port_fn is None)
    ModelSpec("DiffusionSR_x4", "diffusion", 4,
              dataclasses.replace(diffusion_sr.DiffusionSRConfig(), steps=1)),
)}
# the families that run on their JAX tree (``load_params``) and the module
# of each; the video SR families run through ``processors.video_sr``
TREE_MODULES = {"hat": hat, "basicvsr": vsr, "tvsr": tvsr, "diffusion": diffusion_sr}
VSR_FAMILIES = ("basicvsr", "tvsr")

# models that are not super-resolution (framewright_tpu/models/registry.py:
# 185-245): the temporal denoiser's NAFNet, trained in this repository;
# interpolation's IFNet, the face restorer's GFPGAN and its detector, at
# their published widths, from the user's checkpoints
AUX_SPECS: Dict[str, ModelSpec] = {s.name: s for s in (
    ModelSpec("FW_nafnet_dn", "nafnet", 1,
              NAFNetConfig(width=16, enc_blocks=(1, 1, 2), middle_blocks=2,
                           dec_blocks=(1, 1, 1))),
    ModelSpec("rife-v4.6", "ifnet", 1, IFNetConfig(),
              "https://github.com/hzwer/Practical-RIFE (v4.6, flownet.pkl)"),
    ModelSpec("GFPGANv1.4", "face", 1, GFPGANConfig(),
              "https://github.com/TencentARC/GFPGAN/releases/download/v1.3.0/GFPGANv1.4.pth"),
    ModelSpec("CodeFormer", "codeformer", 1, CodeFormerConfig(),
              "https://github.com/sczhou/CodeFormer/releases/download/v0.1.0/codeformer.pth"),
    ModelSpec("RetinaFace_mnet025", "detector", 1, RetinaFaceConfig(),
              "https://github.com/biubug6/Pytorch_Retinaface (mobilenet0.25_Final.pth)"),
    # the temporal denoiser's restormer method (framewright_tpu/processors/
    # temporal_denoise.py:170-209: RestormerConfig() once weighted) and its
    # RAFT flow (registry.py:232-238)
    ModelSpec("restormer", "restormer", 1, restormer.RestormerConfig(),
              "https://github.com/swz30/Restormer (a denoising checkpoint, ported to .npz)"),
    ModelSpec("raft-things", "flow", 1, raft.RAFTConfig(),
              "https://dl.dropboxusercontent.com/s/4j4z58wuv8o0mfz/models.zip"),
)}
# when to use each model (the ``models guide`` verb; JAX's MODEL_GUIDE
# without its TPU throughput figures)
MODEL_GUIDE: Dict[str, str] = {
    "RealESRGAN_x4plus": "Real footage, 4x: the general-purpose restoration default. "
                         "Pre-1960 film: add grain preservation.",
    "RealESRGAN_x2plus": "Real footage, 2x: the 1080p->4K default (the RDB, K1 and K2 "
                         "kernels; int8 mode).",
    "RealESRGAN_x4plus_anime_6B": "Anime/animation stills, 4x: 6-block body, crisper lines, "
                                  "~4x fewer FLOPs.",
    "realesr-animevideov3": "Anime VIDEO, 4x: the fastest SR (SRVGG family, the chain "
                            "kernels); light degradations.",
    "realesr-general-x4v3": "Mixed/unknown content, 4x: general SRVGG with denoise built in.",
    "FW_fast6_x2": "Speed-first real footage, 2x: the 6-block RRDB trained in this "
                   "repository (models/distill.py).",
    "FW_fastvgg_x2": "Speed-first 2x preview/proxy work (SRVGG trained in this repository).",
    "FW_fastvgg_x4": "Speed-first 4x (SRVGG trained in this repository).",
    "HAT_SRx4": "Maximum-detail stills/archival 4x: window-attention SR; slowest, highest "
                "ceiling with real weights.",
    "DiffusionSR_x4": "Generative detail for heavily degraded 4x content; stochastic: pair "
                      "with temporal consistency.",
    "BasicVSR": "Video SR with temporal propagation: best on pans/static cameras where "
                "neighbouring frames carry real detail.",
    "TVSR_x4": "Transformer video SR, 4x: stronger than BasicVSR on complex motion, costlier.",
}
# the JAX package's seeded IFNet draws, written by scripts/export_align_ifnet.py:
# ifnet.init(PRNGKey(1), ALIGN_ARCH) (the denoiser's alignment and
# FlowEstimator's ifnet backend), PRNGKey(4) at COLORIZE_ARCH (colorize's
# propagation flow) and PRNGKey(5) at ALIGN_ARCH (the gap filler's synthesis)
ALIGN_IFNET_NPZ = Path(__file__).resolve().parent / "weights" / "align_ifnet_key1.npz"
COLORIZE_IFNET_NPZ = ALIGN_IFNET_NPZ.with_name("colorize_ifnet_key4.npz")
GAPFILL_IFNET_NPZ = ALIGN_IFNET_NPZ.with_name("gapfill_ifnet_key5.npz")

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
    float16 storage -> a nested dict of numpy arrays. Digit keys that are
    not 0..n-1 stay a dict (CodeFormer's ``fuse`` is keyed by resolution,
    "32", "64", ...: the JAX ``import_npz`` takes them for list indices
    and fails)."""
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
        if node and all(k.isdigit() for k in node) \
                and sorted(int(k) for k in node) == list(range(len(node))):
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


def write_npz(params: Dict[str, Any], path: Path) -> Path:
    """A parameter tree (nested dicts and lists of numpy arrays, None
    leaves) -> the JAX package's ``.npz`` layout (``torch_port.export_npz``:
    dotted keys, list indices as components, ``.__none__`` markers),
    written to a temporary name, then renamed."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}.{i}")
        elif node is None:              # an optional leaf: a zero-size marker
            flat[prefix + ".__none__"] = np.zeros((0,), np.int8)
        else:
            flat[prefix] = np.asarray(node)

    walk(params, "")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.stem + f".tmp{os.getpid()}.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    return path


def _tree_state_dict(params: Dict[str, Any], tensor) -> Dict[str, torch.Tensor]:
    """A GFPGAN or RetinaFace JAX tree -> the port's module names (the
    tree's own paths): a conv's HWIO ``w`` and ``b`` -> ``weight`` (OIHW;
    a depthwise (k, k, C, 1) -> (C, 1, k, k)) and ``bias``, a linear's
    (in, out) ``w`` -> ``weight`` (out, in), a modulated conv's HWIO
    ``weight`` -> (out, in, k, k), ``constant_input`` NHWC -> NCHW, other
    leaves as they are."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}.{i}")
            return
        if not isinstance(node, dict):
            a = np.asarray(node, np.float32)
            if prefix.endswith("modulated_conv.weight"):
                a = a.transpose(3, 2, 0, 1)
            elif prefix.endswith("constant_input"):
                a = a.transpose(0, 3, 1, 2)
            sd[prefix] = tensor(a)
            return
        if "w" in node and "b" in node and len(node) == 2:
            w = np.asarray(node["w"], np.float32)
            if w.ndim == 2:
                w = w.T
            elif prefix.endswith(".dw"):
                w = w.transpose(2, 3, 0, 1)
            else:
                w = w.transpose(3, 2, 0, 1)
            sd[prefix + ".weight"] = tensor(w)
            sd[prefix + ".bias"] = tensor(node["b"])
            return
        for k, v in node.items():
            walk(v, f"{prefix}.{k}" if prefix else k)

    walk(params, "")
    return sd


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
    conv's weight (in, out, kh, kw)), cast to ``dtype``; a GFPGAN
    (``stylegan_decoder``) or RetinaFace (``stage1``) pytree -> the names
    of its tree (``_tree_state_dict``)."""
    sd: Dict[str, torch.Tensor] = {}

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32, order="C")).to(dtype)

    if _runs_on_the_tree(params):
        return _np_tree(params)
    if "stylegan_decoder" in params or "stage1" in params:
        return _tree_state_dict(params, tensor)
    if "codebook" in params:     # CodeFormer: sczhou's names
        return codeformer.state_dict_from_params(
            params, codeformer.config_from_params(params), tensor)

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


def to_jax_params(sd: Dict[str, torch.Tensor], stacked: bool = False) -> Dict[str, Any]:
    """The inverse of ``from_jax_params`` for RRDBNet (the body a list of
    blocks, or ``stacked`` leaf by leaf as JAX's ``stack_body`` stores
    it), SRVGG and NAFNet state dicts -> the JAX package's tree of f32
    numpy arrays (HWIO convs)."""
    def arr(key: str) -> np.ndarray:
        return sd[key].detach().float().cpu().numpy().copy()

    def conv(prefix: str) -> Dict[str, np.ndarray]:
        p = {"w": arr(prefix + ".weight").transpose(2, 3, 1, 0).copy()}
        if prefix + ".bias" in sd:
            p["b"] = arr(prefix + ".bias")
        return p

    def count(prefix: str) -> int:
        return len({k[len(prefix):].split(".")[0] for k in sd if k.startswith(prefix)})

    if "intro.weight" in sd:                          # NAFNet
        def block(prefix: str) -> Dict[str, Any]:
            b = {k: conv(f"{prefix}.{k}") for k in ("conv1", "conv2", "conv3", "conv4", "conv5")}
            b["sca"] = conv(f"{prefix}.sca.1")
            for k in ("norm1", "norm2"):
                b[k] = {"gamma": arr(f"{prefix}.{k}.weight"), "beta": arr(f"{prefix}.{k}.bias")}
            for k in ("beta", "gamma"):                 # (1, c, 1, 1) -> (1, 1, 1, c)
                b[k] = arr(f"{prefix}.{k}").transpose(0, 2, 3, 1).copy()
            return b

        n = count("downs.")
        return {
            "intro": conv("intro"),
            "encoders": [[block(f"encoders.{i}.{j}") for j in range(count(f"encoders.{i}."))]
                         for i in range(n)],
            "downs": [conv(f"downs.{i}") for i in range(n)],
            "middles": [block(f"middle_blks.{j}") for j in range(count("middle_blks."))],
            "ups": [conv(f"ups.{i}.0") for i in range(n)],
            "decoders": [[block(f"decoders.{i}.{j}") for j in range(count(f"decoders.{i}."))]
                         for i in range(n)],
            "ending": conv("ending"),
        }
    if "conv_first.weight" not in sd:                 # SRVGG
        n = count("body.")                           # 2 (num_conv + 1) + 1 modules
        return {"body": [conv(f"body.{i}") for i in range(0, n - 1, 2)],
                "act": [{"alpha": arr(f"body.{i}.weight")} for i in range(1, n - 1, 2)],
                "conv_last": conv(f"body.{n - 1}")}
    params: Dict[str, Any] = {name: conv(name) for name in _CONVS}
    params["body"] = [{r: {f"conv{k}": conv(f"body.{i}.{r}.conv{k}") for k in range(1, 6)}
                       for r in ("rdb1", "rdb2", "rdb3")} for i in range(count("body."))]
    if stacked:
        from framewright_tpu_torch.models.rrdb import stack_body

        params = stack_body(params)
    return params


def port_checkpoint(name: str, src: Path) -> Dict[str, Any]:
    """A published ``.pth`` of an SR row -> its JAX-layout tree (the
    ``models port`` verb): RRDB and SRVGG through ``to_jax_params``, HAT
    and BasicVSR through their module's ``port_state_dict``; a row with no
    published checkpoint raises ``ConfigError``."""
    spec = get_model(name)
    sd = _torch_load(Path(src))
    if spec.family in ("rrdb", "srvgg"):
        return to_jax_params(sd)
    arch = spec.arch_config
    if spec.family == "hat":
        return hat.port_state_dict(sd, arch.depths, arch.scale)
    if spec.family == "basicvsr":
        return vsr.port_state_dict(sd, arch.num_blocks, arch.spynet_levels)
    raise ConfigError(f"{name} has no published checkpoint to port")


def _runs_on_the_tree(params: Dict[str, Any]) -> bool:
    """Whether a JAX tree is one of the models that run functionally on it
    (Restormer, RAFT, HAT, BasicVSR, TVSR), by its top-level names."""
    return any(k in params for k in ("embed", "fnet", "patch_norm", "spynet", "pairs"))


def _np_tree(node):
    """A JAX tree with every leaf as an f32 numpy array (None kept)."""
    if isinstance(node, dict):
        return {k: _np_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_np_tree(v) for v in node]
    return None if node is None else np.array(node, np.float32)


def load_params(name: str, weights_dir: Optional[Path] = None, seed: int = 0
                ) -> Tuple[ModelSpec, Dict[str, Any], str]:
    """An SR row that runs on its JAX tree (HAT, BasicVSR, TVSR,
    DiffusionSR_x4) -> (spec, the tree in f32 numpy, source label):
    ``<weights_dir>/<name>.npz``, the checkpoint trained in this repository
    (DiffusionSR_x4's), the published ``.pth`` through the model module's
    ``port_state_dict`` (HAT, BasicVSR), or a seeded numpy draw at the
    row's widths."""
    spec = get_model(name)
    wdir = Path(weights_dir) if weights_dir else default_weights_dir()
    npz, pth = wdir / f"{name}.npz", wdir / f"{name}.pth"
    for path in (npz, packaged_weights_dir() / f"{name}.npz"):
        if path.is_file():
            return spec, _np_tree(_read_checkpoint(path)), str(path)
    arch = spec.arch_config
    if pth.is_file() and spec.family in ("hat", "basicvsr"):
        sd = _torch_load(pth)
        tree = (hat.port_state_dict(sd, arch.depths, arch.scale) if spec.family == "hat"
                else vsr.port_state_dict(sd, arch.num_blocks, arch.spynet_levels))
        return spec, tree, str(pth)
    return spec, TREE_MODULES[spec.family].init_params(arch, seed), f"random(seed={seed})"


def _torch_load(path: Path) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict (``params_ema`` / ``params`` / ``state_dict``
    unwrapped); an unreadable file raises ``InputError``."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as exc:  # noqa: BLE001 - zip or pickle faults
        raise InputError(f"unreadable checkpoint {path}: {exc}") from exc
    for key in ("params_ema", "params", "state_dict"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            return sd[key]
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


def aux_path(name: str, weights_dir: Optional[Path] = None) -> Optional[Path]:
    """Where ``load_aux`` finds ``name``'s checkpoint, or None: its
    ``.npz``, or for CodeFormer sczhou's ``.pth`` too."""
    wdir = Path(weights_dir) if weights_dir else default_weights_dir()
    for npz in (wdir / f"{name}.npz", packaged_weights_dir() / f"{name}.npz"):
        if npz.is_file():
            return npz
    pth = wdir / f"{name}.pth"
    if AUX_SPECS.get(name) is not None and AUX_SPECS[name].family in ("codeformer", "flow") \
            and pth.is_file():
        return pth
    return None


def load_aux(name: str, weights_dir: Optional[Path] = None,
             dtype: torch.dtype = torch.float32
             ) -> Tuple[ModelSpec, Dict[str, torch.Tensor], str]:
    """An ``AUX_SPECS`` model's state dict from ``<weights_dir>/<name>.npz``
    (the JAX package's layout; ``default_weights_dir()`` when
    ``weights_dir`` is None), or from the weights trained in this
    repository; a missing or unreadable file raises ``InputError`` naming
    it. Never random."""
    spec = AUX_SPECS[name]
    wdir = Path(weights_dir) if weights_dir else default_weights_dir()
    npz = aux_path(name, wdir)
    if npz is not None and npz.suffix == ".pth" and spec.family == "flow":
        return spec, raft.port_state_dict(_torch_load(npz)), str(npz)
    if npz is not None and npz.suffix == ".pth":    # sczhou's names: the module's
        try:
            sd = torch.load(npz, map_location="cpu", weights_only=True)
        except Exception as exc:  # noqa: BLE001 - zip or pickle faults
            raise InputError(f"unreadable checkpoint {npz}: {exc}") from exc
        sd = sd.get("params_ema", sd.get("params", sd))
        spec = dataclasses.replace(spec, arch_config=codeformer.config_from_state_dict(sd))
        return spec, {k: v.to(dtype) for k, v in sd.items()}, str(npz)
    if npz is not None:
        params = _read_checkpoint(npz)
        if spec.family == "face":       # the widths the checkpoint has
            spec = dataclasses.replace(spec, arch_config=gfpgan_config_from_params(params))
        elif spec.family == "codeformer":
            spec = dataclasses.replace(spec, arch_config=codeformer.config_from_params(params))
        elif spec.family == "restormer":     # the widths the checkpoint has
            spec = dataclasses.replace(spec, arch_config=restormer.config_from_params(params))
        return spec, from_jax_params(params, dtype), str(npz)
    raise InputError(f"No weights for {name!r}: {wdir / (name + '.npz')} is missing (the "
                     f"JAX package's .npz layout; the port never draws them at random). "
                     f"Published weights: {spec.url}")


def load_align_ifnet(device, npz: Optional[Path] = None,
                     arch: IFNetConfig = ALIGN_ARCH) -> IFNet:
    """A seeded IFNet draw of the JAX package: by default the temporal
    denoiser's alignment IFNet (``ALIGN_ARCH``, ``ifnet.init(PRNGKey(1))``)
    from ``ALIGN_IFNET_NPZ``; colorize's (``COLORIZE_IFNET_NPZ`` at
    ``COLORIZE_ARCH``) and the gap filler's (``GAPFILL_IFNET_NPZ``) by
    their files. Raises ``InputError`` when the file is missing or
    unreadable (the port never draws a flow net at random)."""
    npz = ALIGN_IFNET_NPZ if npz is None else npz
    if not npz.is_file():
        what = "the alignment flow net" if npz == ALIGN_IFNET_NPZ else "the flow net"
        raise InputError(f"{what}'s weights are missing: {npz} "
                         "(python3 scripts/export_align_ifnet.py writes them)")
    sd = from_jax_params(_read_checkpoint(npz), torch.float32)
    return IFNet.from_state_dict(arch, sd, device)
