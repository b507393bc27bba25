"""The SRVGG conv chain: the bf16 and int8 chain kernels, their plain
versions, and the weights they read.

Replaces ``framewright_tpu/ops/fused_srvgg.py``: ``_make_chain_kernel``
(via ``fused_conv_chain``) and ``_make_chain_kernel_int8`` (via
``fused_conv_chain_int8``), with their weight packing
(``make_fast_params``, ``make_fast_params_int8``). The kernels are in
``csrc/srvgg.cu``; its notes say what bounds them on the card and what
the design does about it.

A group is up to ``GROUP`` consecutive 3x3 64->64 convs, each followed
by its bias and PReLU, on whole NHWC frames (B, H, W, 64) bf16 in and
out. The convs run one launch each, from one buffer to the other; a
CTA reads its tile's halo straight from device memory (zero outside the
frame = SAME padding), so the TPU path's 112x112 windows, halo 8,
packed words and cyclic rolls (``_extract``, ``_assemble``,
``_block_extents``, ``_tap_roll``) have no counterpart here.

Weights keep the JAX layout, ``_wide_conv``'s (cout, 9 taps x 64 cin)
rows with taps first: the kernels' [cout][tap][cin] (OHWI), so the
port's groups equal ``make_fast_params`` and ``make_fast_params_int8``
bit for bit with no rearrangement.

int8 keeps every rounding point of ``_make_chain_kernel_int8``: the
group input quantized at ``inv[0]``; each conv's int32 products flushed
to f32 per chunk of ``TPC_I8`` taps (taps 0-3, 4-7, 8, each over all 64
input channels) as f32(p) * (ws * sa), summed in that order; + b, PReLU
in f32; within the group requantized at the next conv's ``inv``, at the
group's last conv rounded to bf16. The group boundary is part of the
semantics: every GROUP-th conv's output is rounded to bf16 and
requantized with the next group's first scale.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.ops import _build

NF = 64
GROUP = 8          # convs per group: the JAX package's default FW_VGG_G
TPC_I8 = 4         # taps per int32 flush: its default FW_VGG_TPC_I8
_TAP_CHUNKS = tuple((t, min(t + TPC_I8, 9)) for t in range(0, 9, TPC_I8))


@dataclass
class ChainGroup:
    """g convs for the bf16 chain (``make_fast_params``' group):
    w (g, 64, 576) bf16, b and alpha (g, 64, 1) f32."""
    w: torch.Tensor
    b: torch.Tensor
    alpha: torch.Tensor


@dataclass
class ChainGroupInt8:
    """g convs for the int8 chain (``make_fast_params_int8``' group):
    wq (g, 64, 576) int8, ws (g, 64, 1) f32 per-row weight scales, b and
    alpha (g, 64, 1) f32, aq (2g + 2,) float32 numpy [sa_0..sa_g,
    inv_0..inv_g]; and dq (g, 64) f32 = ws * sa_i, the dequantization
    scale of conv i, formed in float32 as the TPU kernel forms it."""
    wq: torch.Tensor
    ws: torch.Tensor
    b: torch.Tensor
    alpha: torch.Tensor
    aq: np.ndarray
    dq: torch.Tensor


def _wide_conv(conv: torch.nn.Conv2d):
    """A 64->64 conv -> (W (64, 576) float32, b (64, 1) float32) numpy,
    rows ordered by tap then source channel (``_wide_conv``)."""
    w = conv.weight.detach().float().cpu().numpy()           # OIHW
    wt = np.ascontiguousarray(w.transpose(0, 2, 3, 1).reshape(NF, 9 * NF))
    return wt, conv.bias.detach().float().cpu().numpy().reshape(NF, 1)


def _alpha(act: torch.nn.PReLU) -> np.ndarray:
    return act.weight.detach().float().cpu().numpy().reshape(NF, 1)


def _chunks(n: int):
    return [(s, min(s + GROUP, n)) for s in range(0, n, GROUP)]


def chain_weights(convs: Sequence[torch.nn.Conv2d],
                  acts: Sequence[torch.nn.PReLU]) -> list:
    """The chain's convs and PReLUs -> [ChainGroup] of up to GROUP convs
    each (``make_fast_params``)."""
    dev = convs[0].weight.device
    groups = []
    for s, e in _chunks(len(convs)):
        wide = [_wide_conv(c) for c in convs[s:e]]
        groups.append(ChainGroup(
            w=torch.from_numpy(np.stack([w for w, _ in wide])).to(dev).to(torch.bfloat16),
            b=torch.from_numpy(np.stack([b for _, b in wide])).to(dev),
            alpha=torch.from_numpy(np.stack([_alpha(a) for a in acts[s:e]])).to(dev)))
    return groups


def chain_weights_int8(convs: Sequence[torch.nn.Conv2d],
                       acts: Sequence[torch.nn.PReLU], act_amax) -> list:
    """The chain's convs and PReLUs and the (len(convs) + 1,) activation
    ranges of ``calibrate_act_scales`` -> [ChainGroupInt8]
    (``make_fast_params_int8``, its numpy float32 operations in order:
    rs = max(max|w row|, 1e-8), q = clip(round(w / rs * 127)),
    ws = rs / 127, sa = max(amax, 1e-6) / 127, inv = 1 / sa)."""
    dev = convs[0].weight.device
    amax = np.maximum(np.asarray(act_amax, np.float32), 1e-6)
    if amax.shape != (len(convs) + 1,):
        raise ValueError(f"act_amax must be ({len(convs) + 1},), got {amax.shape}")
    groups = []
    for s, e in _chunks(len(convs)):
        wqs, wss, bs = [], [], []
        for conv in convs[s:e]:
            wt, b = _wide_conv(conv)
            rs = np.maximum(np.abs(wt).max(axis=1, keepdims=True), 1e-8)
            wqs.append(np.clip(np.round(wt / rs * 127.0), -127, 127).astype(np.int8))
            wss.append((rs / 127.0).astype(np.float32))
            bs.append(b)
        sa = amax[s:e + 1] / 127.0
        inv = 1.0 / sa
        ws = np.stack(wss)
        groups.append(ChainGroupInt8(
            wq=torch.from_numpy(np.stack(wqs)).to(dev),
            ws=torch.from_numpy(ws).to(dev),
            b=torch.from_numpy(np.stack(bs)).to(dev),
            alpha=torch.from_numpy(np.stack([_alpha(a) for a in acts[s:e]])).to(dev),
            aq=np.concatenate([sa, inv]).astype(np.float32),
            dq=torch.from_numpy(np.ascontiguousarray(
                ws[:, :, 0] * sa[:-1, None])).to(dev)))
    return groups


def _check(x: torch.Tensor, out: torch.Tensor, wts, name: str) -> None:
    for arg, t in (("x", x), ("out", out)):
        if t.dtype != torch.bfloat16 or t.dim() != 4 or t.shape[-1] != NF:
            raise ValueError(f"{name}: {arg} must be (B, H, W, {NF}) bf16, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")
    if out.shape != x.shape or out.device != x.device:
        raise ValueError(f"{name}: out shape/device differs from x")
    if out.data_ptr() == x.data_ptr():
        raise ValueError(f"{name}: out must not be x (a conv reads x's halo "
                         "while it writes)")
    g = len(wts.alpha)
    if not 1 <= g <= GROUP:
        raise ValueError(f"{name}: a group holds 1..{GROUP} convs, got {g}")
    tensors = ((wts.w, wts.b) if isinstance(wts, ChainGroup)
               else (wts.wq, wts.ws, wts.b, wts.dq))
    if any(t.device != x.device or not t.is_contiguous() for t in (*tensors, wts.alpha)):
        raise ValueError(f"{name}: weights must be contiguous on x's device")


def _conv_f32(x: torch.Tensor, w_row: torch.Tensor) -> torch.Tensor:
    """NHWC x, (64, 576) tap-major weights -> NCHW f32 conv sums."""
    w = w_row.float().view(NF, 3, 3, NF).permute(0, 3, 1, 2)
    return F.conv2d(x.permute(0, 3, 1, 2).float(), w, padding=1)


def _prelu(v: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, v, v * alpha.view(1, -1, 1, 1))


def fused_conv_chain_plain(x: torch.Tensor, out: torch.Tensor, group: ChainGroup) -> None:
    """Plain PyTorch version of the bf16 chain kernel: per conv,
    bf16(prelu(conv + b)) with f32 sums, bias and PReLU."""
    feat = x
    for i in range(len(group.alpha)):
        v = _conv_f32(feat, group.w[i]) + group.b[i].view(1, -1, 1, 1)
        feat = _prelu(v, group.alpha[i]).permute(0, 2, 3, 1).to(torch.bfloat16)
    out.copy_(feat)


def _launch_buffers(x: torch.Tensor, out: torch.Tensor, g: int):
    """(src, dst) per conv: x -> t0 -> t1 -> t0 ... -> out."""
    tmp = [torch.empty_like(x) for _ in range(min(g - 1, 2))]
    srcs = [x] + [tmp[i % 2] for i in range(g - 1)]
    dsts = [tmp[i % 2] for i in range(g - 1)] + [out]
    return list(zip(srcs, dsts))


def fused_conv_chain(x: torch.Tensor, out: torch.Tensor, group: ChainGroup) -> torch.Tensor:
    """g conv + bias + PReLU steps of the bf16 chain, ``x`` (B, H, W, 64)
    bf16 -> ``out`` (same shape, not ``x``), which it returns. On a CPU
    tensor this runs the plain version; on a CUDA tensor it launches the
    kernel (g launches, one per conv) and counts one call."""
    _check(x, out, group, "fused_conv_chain")
    if x.device.type == "cpu":
        fused_conv_chain_plain(x, out, group)
        return out
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_chain: unsupported device {x.device}")
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    b, h, w, _ = x.shape
    for i, (src, dst) in enumerate(_launch_buffers(x, out, len(group.alpha))):
        _build.check(lib.fw_vgg_conv(
            src.data_ptr(), b, h, w, group.w[i].data_ptr(), group.b[i].data_ptr(),
            group.alpha[i].data_ptr(), dst.data_ptr(), stream), "fw_vgg_conv")
    fused_conv_chain.launches += 1
    return out


fused_conv_chain.launches = 0


# --- int8 -------------------------------------------------------------------

def _codes(v: torch.Tensor) -> torch.Tensor:
    return torch.round(v).clamp(-127, 127).to(torch.int8)


def _conv_codes_chunk(q: torch.Tensor, wq_row: torch.Tensor, t0: int, t1: int) -> torch.Tensor:
    """Exact integer conv of NHWC int8 codes with the taps t0..t1-1 of a
    (64, 576) int8 row, NCHW, summed in float64, -> float32 (a sum over
    at most 4 taps x 64 channels stays below 2^24, exact in float32)."""
    w = wq_row.double().view(NF, 3, 3, NF).permute(0, 3, 1, 2).clone()
    mask = torch.zeros(9, dtype=torch.float64, device=w.device)
    mask[t0:t1] = 1.0
    w = w * mask.view(1, 1, 3, 3)
    return F.conv2d(q.permute(0, 3, 1, 2).double(), w, padding=1).float()


def fused_conv_chain_int8_plain(x: torch.Tensor, out: torch.Tensor,
                                group: ChainGroupInt8, codes: Optional[list] = None) -> None:
    """Plain PyTorch version of the int8 chain kernel, with its float32
    operations in its order: q = clip(round(f32(x) inv_0)); per conv,
    acc = sum over tap chunks of f32(int sum) * dq, v = prelu(acc + b),
    then clip(round(v inv_{i+1})) within the group and bf16(v) at its
    last conv. ``codes``, a list, receives the g NHWC code tensors."""
    g = len(group.alpha)
    inv = [float(v) for v in group.aq[g + 1:]]
    q = _codes(x.float() * inv[0])
    for i in range(g):
        if codes is not None:
            codes.append(q)
        dq = group.dq[i].view(1, -1, 1, 1)
        acc = None
        for t0, t1 in _TAP_CHUNKS:
            part = _conv_codes_chunk(q, group.wq[i], t0, t1) * dq
            acc = part if acc is None else acc + part
        v = _prelu(acc + group.b[i].view(1, -1, 1, 1), group.alpha[i]).permute(0, 2, 3, 1)
        if i == g - 1:
            out.copy_(v.to(torch.bfloat16))
        else:
            q = _codes(v * inv[i + 1])


def fused_conv_chain_int8(x: torch.Tensor, out: torch.Tensor, group: ChainGroupInt8,
                          codes: Optional[list] = None) -> torch.Tensor:
    """g conv steps of the int8 chain (static scales), ``x`` (B, H, W, 64)
    bf16 -> ``out`` bf16 (not ``x``), which it returns. On a CPU tensor
    this runs the plain version; on a CUDA tensor it launches the kernels
    (g + 1 launches: the codes of x, then one per conv) and counts one
    call. ``codes``, a list, receives the g code tensors (the input's and
    those of convs 0..g-2), each in a buffer of its own; without it two
    buffers alternate."""
    _check(x, out, group, "fused_conv_chain_int8")
    if x.device.type == "cpu":
        fused_conv_chain_int8_plain(x, out, group, codes)
        return out
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_chain_int8: unsupported device {x.device}")
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    g = len(group.alpha)
    inv = [float(v) for v in group.aq[g + 1:]]
    b, h, w, _ = x.shape
    bufs = [torch.empty(x.shape, dtype=torch.int8, device=x.device)
            for _ in range(g if codes is not None else min(g, 2))]
    q = [bufs[i % len(bufs)] for i in range(g)]      # the codes conv i reads
    _build.check(lib.fw_vgg_i8_quant(x.data_ptr(), q[0].data_ptr(), b * h * w, inv[0],
                                     stream), "fw_vgg_i8_quant")
    for i in range(g):
        last = i == g - 1
        _build.check(lib.fw_vgg_i8_conv(
            q[i].data_ptr(), b, h, w, group.wq[i].data_ptr(),
            group.dq[i].data_ptr(), group.b[i].data_ptr(), group.alpha[i].data_ptr(),
            0.0 if last else inv[i + 1], None if last else q[i + 1].data_ptr(),
            out.data_ptr() if last else None, stream), "fw_vgg_i8_conv")
    fused_conv_chain_int8.launches += 1
    if codes is not None:
        codes.extend(q)
    return out


fused_conv_chain_int8.launches = 0


def conv_chain(feat: torch.Tensor, groups: list, plain: bool = False) -> torch.Tensor:
    """The whole chain, group after group, on ``feat`` (B, H, W, 64) bf16;
    bf16 or int8 after the groups' type. ``plain`` runs the plain
    versions on any device (a reference for the kernels on the card)."""
    int8 = isinstance(groups[0], ChainGroupInt8)
    if plain:
        run = fused_conv_chain_int8_plain if int8 else fused_conv_chain_plain
    else:
        run = fused_conv_chain_int8 if int8 else fused_conv_chain
    for group in groups:
        out = torch.empty_like(feat)
        run(feat, out, group)
        feat = out
    return feat
