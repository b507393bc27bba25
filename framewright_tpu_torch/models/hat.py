"""HAT (Hybrid Attention Transformer) super-resolution: the port of
``framewright_tpu.models.hat`` on NHWC tensors, functional over the JAX
package's parameter tree.

conv_first, the patch-embed LayerNorm, residual hybrid attention groups
(each: HAB blocks, then an overlapping cross-attention block and a 3x3
conv, added to the group's input), the final LayerNorm, conv_after_body
added to conv_first's features, then a 3x3 conv with leaky ReLU 0.01,
pixel-shuffle 2x stages and conv_last; the input is normalised by the
RGB mean and ``img_range`` and reflect-padded to a multiple of the
window. A HAB: LayerNorm, window self-attention (shifted by half a
window on odd blocks, with the Swin mask across the wrapped regions)
beside the channel-attention conv branch (3x3 to dim/3, exact GELU, 3x3
back, times the sigmoid of a squeeze of its global mean) weighted by
``conv_scale``, then LayerNorm and the GELU MLP. OCAB: queries from
win x win windows, keys and values projected at full resolution, zero
padded and unfolded from overlapping (1 + overlap_ratio) x win windows.
Attention logits, the relative position bias, the mask and the softmax
are f32 (q and k cast up, as the JAX code does); the rest runs in the
activation dtype (bf16 in the SR processor's default).

The attention runs on at most ``_WINDOW_CHUNK`` windows at a time, so
its f32 logits (heads x 256 x 576 values a window in OCAB at the
published window 16) stay a fixed size whatever the frame; windows are
independent, so the chunks give the whole batch's values.

``port_state_dict`` reads XPixelGroup's ``HAT_SRx4.pth``: the port's
copy of ``framewright_tpu.models.torch_port.port_hat``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.models.layers import (
    conv,
    conv_init,
    layer_norm,
    linear,
    pixel_shuffle,
)

# windows a chunk of the attention: at the published widths a chunk's
# f32 OCAB logits and their softmax are 2 x 512 x 6 x 256 x 576 x 4 B =
# 3.6 GB
_WINDOW_CHUNK = 512


@dataclass(frozen=True)
class HATConfig:
    embed_dim: int = 48
    depths: Tuple[int, ...] = (2, 2)
    num_heads: int = 4
    window: int = 8
    overlap_ratio: float = 0.5
    mlp_ratio: float = 2.0
    cab_squeeze: int = 4
    conv_scale: float = 0.01
    scale: int = 4
    img_range: float = 1.0
    rgb_mean: Tuple[float, float, float] = (0.4488, 0.4371, 0.4040)


def official_config() -> HATConfig:
    """HAT_SRx4's published widths: embed 180, 6 groups of 6 blocks, 6
    heads, window 16, squeeze 30."""
    return HATConfig(embed_dim=180, depths=(6,) * 6, num_heads=6, window=16, mlp_ratio=2.0,
                     cab_squeeze=30, scale=4)


# -- parameters ------------------------------------------------------------------

def init_params(cfg: HATConfig = HATConfig(), seed: int = 0) -> Dict[str, Any]:
    """Seeded random parameters in the JAX ``hat.init`` shapes (the
    registry's stand-in when no checkpoint is given; drawn with numpy)."""
    rng = np.random.default_rng(seed)
    d = cfg.embed_dim
    hidden = int(d * cfg.mlp_ratio)
    kv_win = int(cfg.window * (1 + cfg.overlap_ratio))

    def lin(ci, co):
        return {"w": (rng.standard_normal((ci, co)) * 0.02).astype(np.float32),
                "b": np.zeros((co,), np.float32)}

    def ln(c):
        return {"g": np.ones((c,), np.float32), "b": np.zeros((c,), np.float32)}

    def attn(win_kv):
        return {"qkv": lin(d, 3 * d), "proj": lin(d, d),
                "rpb": (rng.standard_normal(((cfg.window + win_kv - 1) ** 2, cfg.num_heads))
                        * 0.02).astype(np.float32)}

    def block():
        mid, sq = max(1, d // 3), max(1, d // cfg.cab_squeeze)
        return {"norm1": ln(d), "attn": attn(cfg.window),
                "cab": {"conv1": conv_init(rng, 3, d, mid), "conv2": conv_init(rng, 3, mid, d),
                        "att_down": lin(d, sq), "att_up": lin(sq, d)},
                "norm2": ln(d), "fc1": lin(d, hidden), "fc2": lin(hidden, d)}

    return {
        "conv_first": conv_init(rng, 3, 3, d), "patch_norm": ln(d), "norm": ln(d),
        "layers": [{"blocks": [block() for _ in range(depth)],
                    "ocab": {"norm1": ln(d), "attn": attn(kv_win), "norm2": ln(d),
                             "fc1": lin(d, hidden), "fc2": lin(hidden, d)},
                    "conv": conv_init(rng, 3, d, d)} for depth in cfg.depths],
        "conv_after_body": conv_init(rng, 3, d, d),
        "conv_before_upsample": conv_init(rng, 3, d, 64),
        "upsample": [conv_init(rng, 3, 64, 64 * 4) for _ in range(max(1, cfg.scale // 2))],
        "conv_last": conv_init(rng, 3, 64, 3),
    }


def port_state_dict(sd: Mapping[str, Any], depths=(6,) * 6, scale: int = 4) -> Dict[str, Any]:
    """The official HAT state dict (``params_ema.`` prefix stripped) ->
    the JAX ``hat`` tree (numpy; convs HWIO, linears (in, out))."""
    sd = {k[len("params_ema."):] if k.startswith("params_ema.") else k: np.asarray(
        v.detach().cpu().float().numpy() if hasattr(v, "detach") else v, np.float32)
        for k, v in sd.items()}

    def conv_p(prefix):
        return {"w": sd[prefix + ".weight"].transpose(2, 3, 1, 0), "b": sd[prefix + ".bias"]}

    def lin(prefix):
        return {"w": sd[prefix + ".weight"].T, "b": sd[prefix + ".bias"]}

    def conv1x1_as_lin(prefix):
        return {"w": sd[prefix + ".weight"][:, :, 0, 0].T, "b": sd[prefix + ".bias"]}

    def ln(prefix):
        return {"g": sd[prefix + ".weight"], "b": sd[prefix + ".bias"]}

    def attn(prefix):
        return {"qkv": lin(f"{prefix}.qkv"), "proj": lin(f"{prefix}.proj"),
                "rpb": sd[f"{prefix}.relative_position_bias_table"]}

    def block(prefix):
        cab = f"{prefix}.conv_block.cab"
        return {"norm1": ln(f"{prefix}.norm1"), "attn": attn(f"{prefix}.attn"),
                "cab": {"conv1": conv_p(f"{cab}.0"), "conv2": conv_p(f"{cab}.2"),
                        "att_down": conv1x1_as_lin(f"{cab}.3.attention.1"),
                        "att_up": conv1x1_as_lin(f"{cab}.3.attention.3")},
                "norm2": ln(f"{prefix}.norm2"), "fc1": lin(f"{prefix}.mlp.fc1"),
                "fc2": lin(f"{prefix}.mlp.fc2")}

    layers = []
    for g, depth in enumerate(depths):
        oc = f"layers.{g}.residual_group.overlap_attn"
        layers.append({
            "blocks": [block(f"layers.{g}.residual_group.blocks.{b}") for b in range(depth)],
            "ocab": {"norm1": ln(f"{oc}.norm1"), "attn": attn(oc), "norm2": ln(f"{oc}.norm2"),
                     "fc1": lin(f"{oc}.mlp.fc1"), "fc2": lin(f"{oc}.mlp.fc2")},
            "conv": conv_p(f"layers.{g}.conv")})
    return {"conv_first": conv_p("conv_first"), "patch_norm": ln("patch_embed.norm"),
            "norm": ln("norm"), "layers": layers,
            "conv_after_body": conv_p("conv_after_body"),
            "conv_before_upsample": conv_p("conv_before_upsample.0"),
            "upsample": [conv_p(f"upsample.{i}")
                         for i in range(0, max(2, scale), 2)][: max(1, scale // 2)],
            "conv_last": conv_p("conv_last")}


# -- the forward -------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _rel_index(win_q: int, win_kv: int, device: torch.device) -> torch.Tensor:
    """(Q, K) indices into the relative position table, on ``device``
    (made once: an upload waits for the card)."""
    span = win_q + win_kv - 1
    yq, xq = np.mgrid[0:win_q, 0:win_q]
    yk, xk = np.mgrid[0:win_kv, 0:win_kv]
    dq = np.stack([yq.ravel(), xq.ravel()], -1)
    dk = np.stack([yk.ravel(), xk.ravel()], -1)
    off = dq[:, None, :] - dk[None, :, :] + (win_kv - 1)
    return torch.from_numpy(off[..., 0] * span + off[..., 1]).to(device)


def _windows(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, win^2, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win * win, c)


def _unwindows(x: torch.Tensor, win: int, b: int, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(b, h // win, w // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@functools.lru_cache(maxsize=4)
def _shift_mask(h: int, w: int, win: int, shift: int, device: torch.device) -> torch.Tensor:
    """SW-MSA mask (nW, 1, Q, K): -1e9 across wrapped regions, else 0 (made
    once a size and device)."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for ys in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for xs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[ys, xs] = cnt
            cnt += 1
    tok = img.reshape(h // win, win, w // win, win).transpose(0, 2, 1, 3).reshape(-1, win * win)
    m = np.where(tok[:, :, None] - tok[:, None, :] == 0, 0.0, -1e9).astype(np.float32)
    return torch.from_numpy(m[:, None]).to(device)


def _msa(attn, q_tok: torch.Tensor, kv_tok: torch.Tensor, heads: int, win_q: int,
         win_kv: int, mask=None, kv_projected: bool = False) -> torch.Tensor:
    """q_tok (N, Q, C), kv_tok (N, K, C) (or (N, K, 2C) projected) ->
    (N, Q, C), ``_WINDOW_CHUNK`` windows at a time; ``mask`` (nW, 1, Q, K)
    repeats every nW windows."""
    n, qn, c = q_tok.shape
    hd = c // heads
    dt = q_tok.dtype
    wq, bq = attn["qkv"]["w"].to(dt), attn["qkv"]["b"].to(dt)
    idx = _rel_index(win_q, win_kv, q_tok.device)
    bias = attn["rpb"].float()[idx].permute(2, 0, 1)[None]          # (1, heads, Q, K)
    scale = np.float32(np.sqrt(np.float32(hd)))
    out = torch.empty_like(q_tok)
    for s in range(0, n, _WINDOW_CHUNK):
        e = min(n, s + _WINDOW_CHUNK)
        qt = q_tok[s:e]
        if kv_tok is q_tok:
            qkv = (torch.matmul(qt, wq) + bq).reshape(e - s, qn, 3, heads, hd)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q = (torch.matmul(qt, wq[:, :c]) + bq[:c]).reshape(e - s, qn, heads, hd)
            q = q.transpose(1, 2)
            kv = kv_tok[s:e] if kv_projected else \
                torch.matmul(kv_tok[s:e], wq[:, c:]) + bq[c:]
            kv = kv.reshape(e - s, -1, 2, heads, hd)
            k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        # JAX's order: (q k^T) / sqrt(hd) + bias + mask, in place
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)).div_(scale).add_(bias)
        if mask is not None:
            nw = mask.shape[0]
            logits.add_(mask[torch.arange(s, e, device=mask.device) % nw])
        a = torch.softmax(logits, dim=-1).to(dt)
        del logits
        out[s:e] = linear(attn["proj"], torch.matmul(a, v).transpose(1, 2).reshape(e - s, qn, c))
    return out


def _cab(p, x: torch.Tensor) -> torch.Tensor:
    y = conv(p["conv2"], F.gelu(conv(p["conv1"], x)))
    s = y.mean(dim=(1, 2))
    s = torch.sigmoid(linear(p["att_up"], F.relu(linear(p["att_down"], s))))
    return y * s[:, None, None, :]


def _mlp(p, x: torch.Tensor) -> torch.Tensor:
    return linear(p["fc2"], F.gelu(linear(p["fc1"], layer_norm(x, p["norm2"]["g"],
                                                               p["norm2"]["b"]))))


def _hab(block, x: torch.Tensor, cfg: HATConfig, shift: int, mask) -> torch.Tensor:
    b, h, w, _ = x.shape
    win = cfg.window
    xn = layer_norm(x, block["norm1"]["g"], block["norm1"]["b"])
    conv_x = _cab(block["cab"], xn)
    xs = torch.roll(xn, (-shift, -shift), dims=(1, 2)) if shift else xn
    tok = _windows(xs, win)
    att = _unwindows(_msa(block["attn"], tok, tok, cfg.num_heads, win, win,
                          mask=mask if shift else None), win, b, h, w)
    if shift:
        att = torch.roll(att, (shift, shift), dims=(1, 2))
    x = x + att + cfg.conv_scale * conv_x
    return x + _mlp(block, x)


def _ocab(p, x: torch.Tensor, cfg: HATConfig) -> torch.Tensor:
    b, h, w, c = x.shape
    win = cfg.window
    kv_win = int(win * (1 + cfg.overlap_ratio))
    pad = (kv_win - win) // 2
    xn = layer_norm(x, p["norm1"]["g"], p["norm1"]["b"])
    q_tok = _windows(xn, win)
    # k and v projected at full resolution, then zero-padded and unfolded
    # (the official order: out-of-frame tokens are zero, not the bias)
    kv = torch.matmul(xn, p["attn"]["qkv"]["w"][:, c:].to(x.dtype)) \
        + p["attn"]["qkv"]["b"][c:].to(x.dtype)
    patches = F.unfold(F.pad(kv.permute(0, 3, 1, 2), (pad, pad, pad, pad)),
                       (kv_win, kv_win), stride=win)            # (B, 2C kv^2, nH nW)
    del kv
    kv_tok = patches.reshape(b, 2 * c, kv_win * kv_win, -1).permute(0, 3, 2, 1) \
        .reshape(-1, kv_win * kv_win, 2 * c)
    del patches
    att = _msa(p["attn"], q_tok, kv_tok, cfg.num_heads, win, kv_win, kv_projected=True)
    x = x + _unwindows(att, win, b, h, w)
    return x + _mlp(p, x)


def apply(params, x: torch.Tensor, cfg: HATConfig = HATConfig()) -> torch.Tensor:
    """RGB (B, H, W, 3) in [0, 1] -> (B, H * scale, W * scale, 3), in x's
    dtype (the official HAT forward)."""
    b, h0, w0, _ = x.shape
    win = cfg.window
    mean = torch.tensor(cfg.rgb_mean, dtype=x.dtype, device=x.device)
    x = (x - mean) * cfg.img_range
    ph, pw = -h0 % win, -w0 % win
    if ph or pw:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="reflect").permute(0, 2, 3, 1)
    h, w = x.shape[1:3]
    shift = win // 2
    mask = _shift_mask(h, w, win, shift, torch.device(x.device))
    feat = conv(params["conv_first"], x)
    body = layer_norm(feat, params["patch_norm"]["g"], params["patch_norm"]["b"])
    for group in params["layers"]:
        g = body
        for bi, block in enumerate(group["blocks"]):
            g = _hab(block, g, cfg, shift if bi % 2 else 0, mask)
        g = _ocab(group["ocab"], g, cfg)
        body = body + conv(group["conv"], g)
    body = layer_norm(body, params["norm"]["g"], params["norm"]["b"])
    feat = feat + conv(params["conv_after_body"], body)
    y = F.leaky_relu(conv(params["conv_before_upsample"], feat), 0.01)
    for up in params["upsample"]:
        y = pixel_shuffle(conv(up, y), 2)
    y = conv(params["conv_last"], y)
    y = y / cfg.img_range + mean
    return y[:, : h0 * cfg.scale, : w0 * cfg.scale, :]
