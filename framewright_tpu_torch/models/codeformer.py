"""CodeFormer (codebook-lookup transformer face restoration): the port of
``framewright_tpu.models.codeformer`` as an ``nn.Module`` (NCHW inside,
NHWC at ``apply``), f32.

The published architecture (sczhou/CodeFormer ``vqgan_arch.py`` and
``codeformer_arch.py``) at ``CodeFormerConfig()``'s widths:
- a VQGAN encoder from 512 to 16 pixels (nf 64, ``ch_mult`` 1, 2, 2, 4,
  4, 8, two residual blocks a scale, self-attention at 16 pixels) to a
  256-wide latent; GroupNorm with min(32, channels) groups, eps 1e-6;
- a 1024-entry codebook and a 9-layer 512-wide pre-norm transformer (8
  heads; the learned position added to queries and keys, not values;
  exact GELU) that predicts each of the 256 tokens' code, whose entry
  replaces the latent;
- the VQGAN generator, with the controllable feature transformation from
  the encoder's skips at 32-256 pixels: ``dec + w * (dec * scale +
  shift)``, ``w`` the fidelity weight (0: the codebook's prior, 1: the
  input).

Attention (the VQGAN's and the transformer's) is written as explicit
products and a softmax in f32, in JAX's order of operations. Module and
parameter names are sczhou's (``encoder.blocks.N.norm1.weight``,
``quantize.embedding.weight``, ``ft_layers.N.self_attn.in_proj_weight``,
``idx_pred_layer.1.weight``, ``fuse_convs_dict.<res>.scale.0.weight``,
...), so a released ``CodeFormer.pth`` loads as it is; ``state_dict_from_
params`` maps a JAX parameter tree (``.npz``) to them. The block walk
(``encoder_plan``, ``generator_plan``) numbers the blocks as the
construction does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from framewright_tpu_torch.models.layers import conv_init


@dataclass(frozen=True)
class CodeFormerConfig:
    img_size: int = 512
    nf: int = 64
    ch_mult: Tuple[int, ...] = (1, 2, 2, 4, 4, 8)
    res_blocks: int = 2
    attn_resolution: int = 16
    emb_dim: int = 256
    codebook_size: int = 1024
    dim_embd: int = 512
    n_head: int = 8
    n_layers: int = 9
    connect: Tuple[int, ...] = (32, 64, 128, 256)

    @property
    def latent_size(self) -> int:
        return self.img_size // 2 ** (len(self.ch_mult) - 1)


def encoder_plan(cfg: CodeFormerConfig) -> List[Tuple[str, int, int, int]]:
    """(kind, cin, cout, resolution) of each encoder block, in
    ``vqgan_arch.Encoder``'s construction order."""
    plan: List[Tuple[str, int, int, int]] = []
    res = cfg.img_size
    in_mult = (1,) + tuple(cfg.ch_mult)
    plan.append(("conv_in", 3, cfg.nf, res))
    for i in range(len(cfg.ch_mult)):
        cin = cfg.nf * in_mult[i]
        cout = cfg.nf * cfg.ch_mult[i]
        for _ in range(cfg.res_blocks):
            plan.append(("res", cin, cout, res))
            cin = cout
            if res == cfg.attn_resolution:
                plan.append(("attn", cout, cout, res))
        if i != len(cfg.ch_mult) - 1:
            plan.append(("down", cout, cout, res // 2))
            res //= 2
    c = cfg.nf * cfg.ch_mult[-1]
    plan += [("res", c, c, res), ("attn", c, c, res), ("res", c, c, res),
             ("norm", c, c, res), ("conv_out", c, cfg.emb_dim, res)]
    return plan


def generator_plan(cfg: CodeFormerConfig) -> List[Tuple[str, int, int, int, bool]]:
    """(kind, cin, cout, resolution, fuse) of each generator block;
    ``fuse`` marks the first residual block at each upsampled resolution,
    where the encoder's skip is fused."""
    plan = []
    res = cfg.latent_size
    c = cfg.nf * cfg.ch_mult[-1]
    plan.append(("conv_in", cfg.emb_dim, c, res, False))
    plan += [("res", c, c, res, False), ("attn", c, c, res, False),
             ("res", c, c, res, False)]
    for i in reversed(range(len(cfg.ch_mult))):
        cout = cfg.nf * cfg.ch_mult[i]
        for j in range(cfg.res_blocks):
            fuse = j == 0 and i != len(cfg.ch_mult) - 1
            plan.append(("res", c, cout, res, fuse))
            c = cout
            if res == cfg.attn_resolution:
                plan.append(("attn", c, c, res, False))
        if i != 0:
            plan.append(("up", c, c, res * 2, False))
            res *= 2
    plan += [("norm", c, c, res, False), ("conv_out", c, 3, res, False)]
    return plan


def _groups(c: int) -> int:
    return min(32, c)


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(_groups(c), c, eps=1e-6)


class _ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _norm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_out = nn.Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(_swish(self.norm1(x)))
        y = self.conv2(_swish(self.norm2(y)))
        if hasattr(self, "conv_out"):
            x = self.conv_out(x)
        return x + y


class _AttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = _norm(c)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hn = self.norm(x)
        q = self.q(hn).reshape(b, c, h * w).transpose(1, 2)
        k = self.k(hn).reshape(b, c, h * w).transpose(1, 2)
        v = self.v(hn).reshape(b, c, h * w).transpose(1, 2)
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), dim=-1)
        out = (att @ v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class _Down(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))      # asymmetric, then VALID


class _Up(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _NormSwish(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _swish(super().forward(x))


def _block(kind: str, cin: int, cout: int) -> nn.Module:
    if kind in ("conv_in", "conv_out"):
        return nn.Conv2d(cin, cout, 3, padding=1)
    if kind == "res":
        return _ResBlock(cin, cout)
    if kind == "attn":
        return _AttnBlock(cin)
    if kind == "down":
        return _Down(cin)
    if kind == "up":
        return _Up(cin)
    return _NormSwish(_groups(cin), cin, eps=1e-6)


class _Blocks(nn.Module):
    def __init__(self, plan):
        super().__init__()
        self.blocks = nn.ModuleList(_block(e[0], e[1], e[2]) for e in plan)


class _Quantize(nn.Module):
    def __init__(self, n: int, d: int):
        super().__init__()
        self.embedding = nn.Embedding(n, d)


class _SelfAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (packed q | k | v input
    projection), applied as JAX's ``_tf_layer`` does."""

    def __init__(self, d: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, d)


class _TransformerLayer(nn.Module):
    def __init__(self, d: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.self_attn = _SelfAttention(d)
        self.linear1 = nn.Linear(d, 2 * d)
        self.linear2 = nn.Linear(2 * d, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.norm1(x)
        w, bias = self.self_attn.in_proj_weight, self.self_attn.in_proj_bias
        q = (h + pos) @ w[:d].t() + bias[:d]
        k = (h + pos) @ w[d:2 * d].t() + bias[d:2 * d]
        v = h @ w[2 * d:].t() + bias[2 * d:]
        dh = d // self.n_head

        def split(t):
            return t.reshape(b, n, self.n_head, dh).transpose(1, 2)

        att = torch.softmax(split(q) @ split(k).transpose(2, 3) / math.sqrt(dh), dim=-1)
        out = (att @ split(v)).transpose(1, 2).reshape(b, n, d)
        x = x + self.self_attn.out_proj(out)
        return x + self.linear2(F.gelu(self.linear1(self.norm2(x))))


class _Fuse(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.encode_enc = _ResBlock(2 * c, c)
        self.scale = nn.Sequential(nn.Conv2d(c, c, 3, padding=1), nn.LeakyReLU(0.2),
                                   nn.Conv2d(c, c, 3, padding=1))
        self.shift = nn.Sequential(nn.Conv2d(c, c, 3, padding=1), nn.LeakyReLU(0.2),
                                   nn.Conv2d(c, c, 3, padding=1))

    def forward(self, enc: torch.Tensor, dec: torch.Tensor, w: float) -> torch.Tensor:
        e = self.encode_enc(torch.cat([enc, dec], dim=1))
        return dec + w * (dec * self.scale(e) + self.shift(e))


def _level_channels(cfg: CodeFormerConfig) -> Dict[int, int]:
    return {cfg.img_size // 2 ** i: cfg.nf * m for i, m in enumerate(cfg.ch_mult)}


class CodeFormer(nn.Module):
    def __init__(self, cfg: CodeFormerConfig = CodeFormerConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = _Blocks(encoder_plan(cfg))
        self.generator = _Blocks(generator_plan(cfg))
        self.quantize = _Quantize(cfg.codebook_size, cfg.emb_dim)
        self.position_emb = nn.Parameter(torch.empty(cfg.latent_size ** 2, cfg.dim_embd))
        self.feat_emb = nn.Linear(cfg.emb_dim, cfg.dim_embd)
        self.ft_layers = nn.ModuleList(_TransformerLayer(cfg.dim_embd, cfg.n_head)
                                       for _ in range(cfg.n_layers))
        self.idx_pred_layer = nn.Sequential(nn.LayerNorm(cfg.dim_embd),
                                            nn.Linear(cfg.dim_embd, cfg.codebook_size,
                                                      bias=False))
        ch = _level_channels(cfg)
        self.fuse_convs_dict = nn.ModuleDict({str(r): _Fuse(ch[r]) for r in cfg.connect})

    def forward(self, x: torch.Tensor, w: float = 0.5) -> torch.Tensor:
        """x: (B, 3, S, S) in [0, 1] -> the restored crops in [0, 1]."""
        cfg = self.cfg
        b = x.shape[0]
        h = x * 2.0 - 1.0
        enc_feats: Dict[int, torch.Tensor] = {}
        for blk, (_, _, _, res) in zip(self.encoder.blocks, encoder_plan(cfg)):
            h = blk(h)
            if res in cfg.connect:
                enc_feats[res] = h          # the last block at each resolution
        n = cfg.latent_size ** 2
        tokens = self.feat_emb(h.reshape(b, cfg.emb_dim, n).transpose(1, 2))
        pos = self.position_emb[None]
        for layer in self.ft_layers:
            tokens = layer(tokens, pos)
        idx = self.idx_pred_layer(tokens).argmax(dim=-1)           # (B, tokens)
        quant = self.quantize.embedding.weight[idx]                 # (B, tokens, emb)
        h = quant.transpose(1, 2).reshape(b, cfg.emb_dim, cfg.latent_size, cfg.latent_size)
        for blk, (_, _, _, res, fuse) in zip(self.generator.blocks, generator_plan(cfg)):
            h = blk(h)
            if fuse and res in cfg.connect:
                h = self.fuse_convs_dict[str(res)](enc_feats[res], h, w)
        return ((h + 1.0) * 0.5).clamp(0.0, 1.0)

    def apply(self, x: torch.Tensor, w: float = 0.5) -> torch.Tensor:
        """``codeformer.apply``: (B, S, S, 3) in [0, 1] -> the same shape."""
        return self(x.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)

    @classmethod
    def from_state_dict(cls, cfg: CodeFormerConfig, sd: Dict[str, torch.Tensor],
                        device) -> "CodeFormer":
        with torch.device("meta"):
            net = cls(cfg)
        net.load_state_dict({k: v.float() for k, v in sd.items()}, assign=True)
        return net.to(device).eval().requires_grad_(False)


def encode_indices(net: CodeFormer, x: torch.Tensor) -> torch.Tensor:
    """JAX's ``encode_indices``: the nearest codebook entry of each encoder
    latent (the plain VQGAN quantization, for diagnostics): (B, S, S, 3)
    in [0, 1] -> (B, L, L) indices."""
    h = x.permute(0, 3, 1, 2) * 2.0 - 1.0
    for blk in net.encoder.blocks:
        h = blk(h)
    b, c, lh, lw = h.shape
    flat = h.permute(0, 2, 3, 1).reshape(-1, c)
    book = net.quantize.embedding.weight.to(h.dtype)
    d = (flat.pow(2).sum(1, keepdim=True) - 2.0 * flat @ book.T + book.pow(2).sum(1)[None])
    return d.argmin(dim=1).reshape(b, lh, lw)


def state_dict_from_params(params: Dict, cfg: CodeFormerConfig,
                           tensor=torch.from_numpy) -> Dict[str, torch.Tensor]:
    """A JAX CodeFormer parameter tree (HWIO convs, (in, out) linears; the
    inverse of ``torch_port.port_codeformer``) -> sczhou's state dict."""
    sd: Dict[str, torch.Tensor] = {}

    def arr(a) -> np.ndarray:
        return np.array(a, np.float32)          # a writable copy

    def conv(prefix: str, p: Dict) -> None:
        sd[prefix + ".weight"] = tensor(arr(np.asarray(p["w"]).transpose(3, 2, 0, 1)))
        sd[prefix + ".bias"] = tensor(arr(p["b"]))

    def norm(prefix: str, p: Dict) -> None:
        sd[prefix + ".weight"] = tensor(arr(p["g"]))
        sd[prefix + ".bias"] = tensor(arr(p["b"]))

    def lin(prefix: str, p: Dict) -> None:
        sd[prefix + ".weight"] = tensor(arr(np.asarray(p["w"]).T))
        if "b" in p:
            sd[prefix + ".bias"] = tensor(arr(p["b"]))

    def resblock(prefix: str, p: Dict) -> None:
        for k in ("norm1", "norm2"):
            norm(f"{prefix}.{k}", p[k])
        for k in ("conv1", "conv2", "conv_out"):
            if k in p:
                conv(f"{prefix}.{k}", p[k])

    def blocks(owner: str, plan, tree) -> None:
        for i, (entry, p) in enumerate(zip(plan, tree)):
            pre, kind = f"{owner}.blocks.{i}", entry[0]
            if kind in ("conv_in", "conv_out"):
                conv(pre, p["conv"])
            elif kind == "res":
                resblock(pre, p)
            elif kind == "attn":
                norm(pre + ".norm", p["norm"])
                for k, name in (("q", "q"), ("k", "k"), ("v", "v"), ("proj", "proj_out")):
                    conv(f"{pre}.{name}", p[k])
            elif kind in ("down", "up"):
                conv(pre + ".conv", p["conv"])
            else:
                norm(pre, p["norm"])

    blocks("encoder", encoder_plan(cfg), params["encoder"])
    blocks("generator", generator_plan(cfg), params["generator"])
    sd["quantize.embedding.weight"] = tensor(arr(params["codebook"]))
    sd["position_emb"] = tensor(arr(params["position_emb"]))
    lin("feat_emb", params["feat_emb"])
    for i, p in enumerate(params["ft_layers"]):
        pre = f"ft_layers.{i}"
        norm(pre + ".norm1", p["norm1"])
        norm(pre + ".norm2", p["norm2"])
        sd[pre + ".self_attn.in_proj_weight"] = tensor(arr(np.asarray(p["qkv"]["w"]).T))
        sd[pre + ".self_attn.in_proj_bias"] = tensor(arr(p["qkv"]["b"]))
        lin(pre + ".self_attn.out_proj", p["proj"])
        lin(pre + ".linear1", p["fc1"])
        lin(pre + ".linear2", p["fc2"])
    norm("idx_pred_layer.0", params["idx_norm"])
    lin("idx_pred_layer.1", params["idx_pred"])
    for res, p in params["fuse"].items():
        pre = f"fuse_convs_dict.{res}"
        resblock(pre + ".encode_enc", p["encode_enc"])
        conv(pre + ".scale.0", p["scale1"])
        conv(pre + ".scale.2", p["scale2"])
        conv(pre + ".shift.0", p["shift1"])
        conv(pre + ".shift.2", p["shift2"])
    return sd


def config_from_params(params: Dict) -> CodeFormerConfig:
    """The ``CodeFormerConfig`` of a JAX parameter tree, read from its
    shapes and its encoder's block walk; the head count is not in the
    weights: the tree's ``n_head`` leaf when it has one, else the
    published 8."""
    enc = params["encoder"]
    nf = np.asarray(enc[0]["conv"]["w"]).shape[-1]
    # after conv_in: each level's residual blocks (and attention), a down
    # block between levels, then res, attn, res, norm, conv_out
    levels, attn_level, cur = [], None, []
    for p in enc[1:-5]:
        if "norm1" in p:
            cur.append(np.asarray(p["conv2"]["w"]).shape[-1])
        elif "q" in p:
            attn_level = len(levels)
        elif "conv" in p:
            levels.append(cur)
            cur = []
    levels.append(cur)
    latent = int(round(math.sqrt(np.asarray(params["position_emb"]).shape[0])))
    img = latent * 2 ** (len(levels) - 1)
    book = np.asarray(params["codebook"])
    n_head = int(np.asarray(params["n_head"])) if "n_head" in params else 8
    return CodeFormerConfig(
        img_size=img, nf=nf, ch_mult=tuple(lv[-1] // nf for lv in levels),
        res_blocks=len(levels[0]),
        attn_resolution=img // 2 ** attn_level if attn_level is not None else 0,
        emb_dim=book.shape[1], codebook_size=book.shape[0],
        dim_embd=np.asarray(params["position_emb"]).shape[1], n_head=n_head,
        n_layers=len(params["ft_layers"]), connect=tuple(sorted(int(r) for r in params["fuse"])))


def config_from_state_dict(sd: Dict[str, torch.Tensor], n_head: int = 8) -> CodeFormerConfig:
    """The ``CodeFormerConfig`` of a state dict in sczhou's names (a
    released ``.pth``): its shapes read through ``config_from_params``;
    the head count is the published 8 unless given."""
    enc: List[Dict] = []
    i = 0
    while f"encoder.blocks.{i}.weight" in sd or any(
            k.startswith(f"encoder.blocks.{i}.") for k in sd):
        pre = f"encoder.blocks.{i}"
        if f"{pre}.norm1.weight" in sd:
            enc.append({"norm1": None, "conv2": {"w": np.empty(
                (1, 1, 1, sd[f"{pre}.conv2.weight"].shape[0]))}})
        elif f"{pre}.q.weight" in sd:
            enc.append({"q": None})
        elif f"{pre}.conv.weight" in sd:
            enc.append({"conv": None})
        elif sd[f"{pre}.weight"].ndim == 4:
            enc.append({"conv": {"w": np.empty((1, 1, 1, sd[f"{pre}.weight"].shape[0]))}})
        else:
            enc.append({"norm": None})
        i += 1
    layers = {k.split(".")[1] for k in sd if k.startswith("ft_layers.")}
    fuse = {k.split(".")[1] for k in sd if k.startswith("fuse_convs_dict.")}
    return config_from_params({
        "encoder": enc, "position_emb": np.empty(tuple(sd["position_emb"].shape)),
        "codebook": np.empty(tuple(sd["quantize.embedding.weight"].shape)),
        "ft_layers": sorted(layers), "fuse": {r: None for r in fuse},
        "n_head": np.asarray(n_head)})


def init_params(cfg: CodeFormerConfig = CodeFormerConfig(), seed: int = 0) -> Dict:
    """Seeded random parameters in the JAX module's tree at ``cfg``'s
    widths, drawn with numpy in the shapes and scales of
    ``codeformer.init`` (a codebook of N(0, 0.02), a zero position
    embedding, unit norms). For smoke runs and benchmarks; a restore never
    draws a face model."""
    rng = np.random.default_rng(seed)

    def gn(c):
        return {"g": np.ones((c,), np.float32), "b": np.zeros((c,), np.float32)}

    def res(cin, cout):
        p = {"norm1": gn(cin), "conv1": conv_init(rng, 3, cin, cout), "norm2": gn(cout),
             "conv2": conv_init(rng, 3, cout, cout)}
        if cin != cout:
            p["conv_out"] = conv_init(rng, 1, cin, cout)
        return p

    def linear(cin, cout, bias=True):
        lim = (1.0 / cin) ** 0.5
        p = {"w": rng.uniform(-lim, lim, (cin, cout)).astype(np.float32)}
        if bias:
            p["b"] = rng.uniform(-lim, lim, (cout,)).astype(np.float32)
        return p

    def blocks(plan):
        out = []
        for kind, cin, cout, *_ in plan:
            if kind in ("conv_in", "conv_out", "down", "up"):
                out.append({"conv": conv_init(rng, 3, cin, cout)})
            elif kind == "res":
                out.append(res(cin, cout))
            elif kind == "attn":
                out.append({"norm": gn(cin), **{k: conv_init(rng, 1, cin, cin)
                                                for k in ("q", "k", "v", "proj")}})
            else:
                out.append({"norm": gn(cin)})
        return out

    d = cfg.dim_embd
    ch = _level_channels(cfg)
    return {
        "encoder": blocks(encoder_plan(cfg)),
        "generator": blocks(generator_plan(cfg)),
        "codebook": (rng.standard_normal((cfg.codebook_size, cfg.emb_dim)) * 0.02
                     ).astype(np.float32),
        "position_emb": np.zeros((cfg.latent_size ** 2, d), np.float32),
        "feat_emb": linear(cfg.emb_dim, d),
        "ft_layers": [{"norm1": gn(d), "norm2": gn(d), "qkv": linear(d, 3 * d),
                       "proj": linear(d, d), "fc1": linear(d, 2 * d), "fc2": linear(2 * d, d)}
                      for _ in range(cfg.n_layers)],
        "idx_norm": gn(d),
        "idx_pred": linear(d, cfg.codebook_size, bias=False),
        "fuse": {str(r): {"encode_enc": res(2 * ch[r], ch[r]),
                          **{k: conv_init(rng, 3, ch[r], ch[r])
                             for k in ("scale1", "scale2", "shift1", "shift2")}}
                 for r in cfg.connect},
        "n_head": np.asarray(cfg.n_head, np.int32),
    }


def port_state_dict(sd, cfg: CodeFormerConfig = None) -> Dict:
    """sczhou's CodeFormer state dict (a released ``codeformer.pth``) ->
    the JAX ``codeformer`` tree (numpy f32): the port's copy of
    ``framewright_tpu.models.torch_port.port_codeformer``, walking the
    blocks in ``encoder_plan`` / ``generator_plan`` order; Linear weights
    to (in, out), the packed attention ``in_proj`` to (d, 3d) in q|k|v
    column order. ``cfg`` defaults to the state dict's
    (``config_from_state_dict``: the published config for a released
    file, which JAX assumes). The port's own loader reads sczhou's names
    directly (``registry.load_aux``); this is the ``.npz`` that ``models
    port`` writes."""
    from framewright_tpu_torch.models.layers import np_leaf, port_conv

    cfg = cfg or config_from_state_dict(sd)

    def f32(key):
        return np_leaf(sd[key]).astype(np.float32)

    def lin(prefix, bias=True):
        p = {"w": f32(prefix + ".weight").T}
        if bias:
            p["b"] = f32(prefix + ".bias")
        return p

    def norm(prefix):
        return {"g": f32(prefix + ".weight"), "b": f32(prefix + ".bias")}

    def resblock(prefix, cin, cout):
        p = {"norm1": norm(prefix + ".norm1"), "conv1": port_conv(sd, prefix + ".conv1"),
             "norm2": norm(prefix + ".norm2"), "conv2": port_conv(sd, prefix + ".conv2")}
        if cin != cout:
            p["conv_out"] = port_conv(sd, prefix + ".conv_out")
        return p

    def blocks(owner, plan):
        out = []
        for i, (kind, cin, cout, *_) in enumerate(plan):
            pre = f"{owner}.blocks.{i}"
            if kind in ("conv_in", "conv_out"):
                out.append({"conv": port_conv(sd, pre)})
            elif kind == "res":
                out.append(resblock(pre, cin, cout))
            elif kind == "attn":
                out.append({"norm": norm(pre + ".norm"), "q": port_conv(sd, pre + ".q"),
                            "k": port_conv(sd, pre + ".k"), "v": port_conv(sd, pre + ".v"),
                            "proj": port_conv(sd, pre + ".proj_out")})
            elif kind in ("down", "up"):
                out.append({"conv": port_conv(sd, pre + ".conv")})
            elif kind == "norm":
                out.append({"norm": norm(pre)})
        return out

    def tf_layer(prefix):
        return {"norm1": norm(prefix + ".norm1"), "norm2": norm(prefix + ".norm2"),
                "qkv": {"w": f32(prefix + ".self_attn.in_proj_weight").T,
                        "b": f32(prefix + ".self_attn.in_proj_bias")},
                "proj": lin(prefix + ".self_attn.out_proj"),
                "fc1": lin(prefix + ".linear1"), "fc2": lin(prefix + ".linear2")}

    ch_map = {cfg.img_size // 2 ** i: cfg.nf * m for i, m in enumerate(cfg.ch_mult)}
    fuse = {}
    for res in cfg.connect:
        pre, ch = f"fuse_convs_dict.{res}", ch_map[res]
        fuse[str(res)] = {"encode_enc": resblock(pre + ".encode_enc", 2 * ch, ch),
                          "scale1": port_conv(sd, pre + ".scale.0"),
                          "scale2": port_conv(sd, pre + ".scale.2"),
                          "shift1": port_conv(sd, pre + ".shift.0"),
                          "shift2": port_conv(sd, pre + ".shift.2")}
    return {"encoder": blocks("encoder", encoder_plan(cfg)),
            "generator": blocks("generator", generator_plan(cfg)),
            "codebook": f32("quantize.embedding.weight"), "position_emb": f32("position_emb"),
            "feat_emb": lin("feat_emb"),
            "ft_layers": [tf_layer(f"ft_layers.{i}") for i in range(cfg.n_layers)],
            "idx_norm": norm("idx_pred_layer.0"), "idx_pred": lin("idx_pred_layer.1", bias=False),
            "fuse": fuse}
