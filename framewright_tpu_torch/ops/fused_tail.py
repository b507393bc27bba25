"""K2 (the upsampling tail with the output epilogue) and tail1, with
their plain versions.

Replaces ``framewright_tpu/ops/fused_tail.py``: ``_make_tail2_kernel``
(via ``fused_tail2_blocks``) and ``_tail_kernel`` (tail1, via
``fused_tail_blocks`` and ``fused_tail_image``), with the host weight
math of ``_up2_phase_weights``/``tail2_phase_weights``/
``tail_phase_weights`` and the BT.601 4:2:0 constants of
``yuv420_matrix`` copied here. The kernels are in ``csrc/tail.cu``; its
note says what bounds them on the card and what the design does about
it. The interior crop and depth-to-space that follow the TPU kernels
(``tail3_image``, ``fused_tail_image``) are part of the last launch's
store here.

tail1 (``fused_tail1``) takes conv_up1's output a0 (B, 2h, 2w, 64) bf16,
which the dynamic-int8 path computes in PyTorch as the JAX package does
in XLA, and runs K2's last three launches on it: conv_up2, conv_hr and
conv_last, to (B, 4h, 4w, 3) bf16 RGB.

Output modes (``out_mode``), from the conv_body+skip features x
(B, h, w, 64) bf16:
  "bf16"      (B, 4h, 4w, 3) bf16 RGB
  "rgb_u8"    (B, 4h, 4w, 3) uint8, floor(clip(y, 0, 1) * 255 + 0.5)
  "yuv420_u8" (Y (B, 4h, 4w), U (B, 2h, 2w), V (B, 2h, 2w)) uint8,
              BT.601 limited or full range, 4:2:0
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.ops import _build
from framewright_tpu_torch.ops.fused_rrdb import wgmma_weights

NF = 64
OUT_MODES = {"bf16": 0, "rgb_u8": 1, "yuv420_u8": 2}
_LAST_PAD = 8   # conv_last's 3 outputs padded to one n8 wgmma block


@dataclass
class TailWeights:
    """The tail's convs as the plain versions take them, and ``*_k``, the
    chunk-major copies the kernels take (``phase_wgmma_weights``,
    ``fused_rrdb.wgmma_weights``)."""
    up1: torch.Tensor     # (4 phases, 64, 4 taps, 64) bf16
    up1_b: torch.Tensor   # (64,) f32
    up2: torch.Tensor
    up2_b: torch.Tensor
    hr: torch.Tensor      # (64, 3, 3, 64) bf16, OHWI
    hr_b: torch.Tensor
    last: torch.Tensor    # (8, 3, 3, 64) bf16, rows 3..7 zero
    last_b: torch.Tensor  # (8,) f32
    up1_k: torch.Tensor   # (4 phases, 4 chunks, 4 taps, 2, 64, 8) bf16
    up2_k: torch.Tensor
    hr_k: torch.Tensor    # (4 chunks, 9 taps, 2, 64, 8) bf16
    last_k: torch.Tensor  # (4 chunks, 9 taps, 2, 8, 8) bf16


def up2_phase_weights(w: torch.Tensor) -> torch.Tensor:
    """Conv after a nearest 2x upsample as four 2x2-tap phase convs
    (``fused_tail._up2_phase_weights``). w: OIHW (cout, cin, 3, 3) ->
    (4, cout, 4, cin) f32, phase p*2+q, tap u*2+v at input offset
    (p - 1 + u, q - 1 + v). Phase p=0 rows: (w0, w1+w2); p=1: (w0+w1, w2).
    Summed in f32 in the reference's order, before any bf16 rounding."""
    w = w.detach().float()
    groups = {0: ((0,), (1, 2)), 1: ((0, 1), (2,))}
    phases = []
    for p in (0, 1):
        for q in (0, 1):
            taps = []
            for dis in groups[p]:
                for djs in groups[q]:
                    acc = torch.zeros_like(w[:, :, 0, 0])
                    for di in dis:
                        for dj in djs:
                            acc = acc + w[:, :, di, dj]
                    taps.append(acc)
            phases.append(torch.stack(taps, dim=1))
    return torch.stack(phases, dim=0)


def phase_wgmma_weights(wp: torch.Tensor) -> torch.Tensor:
    """Phase weights (4, cout, 4 taps, cin) -> the phase convs' chunk-major
    copy (4 phases, cin / 16, 4 taps, 2, cout, 8): each phase's 2x2 taps
    as ``fused_rrdb.wgmma_weights`` lays out a conv's, phase after phase,
    so that pass p, chunk c of the kernel's loop is one contiguous copy
    (csrc/conv_wgmma.cuh, TapsUp2)."""
    ph, cout, _, cin = wp.shape
    return torch.stack([wgmma_weights(wp[i].reshape(cout, 2, 2, cin)) for i in range(ph)])


def _ohwi(conv: torch.nn.Conv2d) -> torch.Tensor:
    return (conv.weight.detach().float().permute(0, 2, 3, 1).contiguous()
            .to(torch.bfloat16))


def tail_weights(conv_up1: torch.nn.Conv2d, conv_up2: torch.nn.Conv2d,
                 conv_hr: torch.nn.Conv2d, conv_last: torch.nn.Conv2d
                 ) -> TailWeights:
    last = torch.zeros(_LAST_PAD, 3, 3, NF, device=conv_last.weight.device)
    last_b = torch.zeros(_LAST_PAD, device=conv_last.weight.device)
    n_out = conv_last.weight.shape[0]
    last[:n_out] = conv_last.weight.detach().float().permute(0, 2, 3, 1)
    last_b[:n_out] = conv_last.bias.detach().float()

    def bias(c):
        return c.bias.detach().float().contiguous()

    up1 = up2_phase_weights(conv_up1.weight).to(torch.bfloat16).contiguous()
    up2 = up2_phase_weights(conv_up2.weight).to(torch.bfloat16).contiguous()
    hr = _ohwi(conv_hr)
    last = last.to(torch.bfloat16).contiguous()
    return TailWeights(
        up1=up1, up1_b=bias(conv_up1), up2=up2, up2_b=bias(conv_up2),
        hr=hr, hr_b=bias(conv_hr), last=last, last_b=last_b.contiguous(),
        up1_k=phase_wgmma_weights(up1), up2_k=phase_wgmma_weights(up2),
        hr_k=wgmma_weights(hr), last_k=wgmma_weights(last))


def yuv420_coefficients(full_range: bool = False) -> np.ndarray:
    """The BT.601 constants of ``fused_tail.yuv420_matrix`` as 11 f32:
    wy[3], wu[3], wv[3] (chroma already x 0.25 for the 2x2 mean), the Y
    offset and the chroma offset, both with the +0.5 that makes floor()
    round like floor(x + 0.5)."""
    kr, kg, kb = 0.299, 0.587, 0.114
    fy = 219.0 if not full_range else 255.0
    fc = 224.0 if not full_range else 255.0
    ucoef = np.asarray([-kr, -kg, 1.0 - kb], np.float32) / (2.0 * (1.0 - kb))
    vcoef = np.asarray([1.0 - kr, -kg, -kb], np.float32) / (2.0 * (1.0 - kr))
    wy = np.asarray([kr, kg, kb], np.float32) * fy
    return np.concatenate([
        wy, 0.25 * fc * ucoef, 0.25 * fc * vcoef,
        np.asarray([16.5 if not full_range else 0.5, 128.5], np.float32),
    ]).astype(np.float32)


def _lrelu(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, v, 0.2 * v)


def _phase_conv_plain(x: torch.Tensor, wp: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """bf16(lrelu(conv(nearest2(x)) + b)) from the phase weights:
    NHWC bf16 (B, H, W, 64) -> (B, 2H, 2W, 64)."""
    xf = x.permute(0, 3, 1, 2).float()
    bsz, _, h, w = xf.shape
    xp = F.pad(xf, (1, 1, 1, 1))
    cout = wp.shape[1]
    out = torch.empty(bsz, cout, 2 * h, 2 * w, device=x.device)
    for p in (0, 1):
        for q in (0, 1):
            k = wp[p * 2 + q].float().reshape(cout, 2, 2, -1).permute(0, 3, 1, 2)
            out[:, :, p::2, q::2] = F.conv2d(xp[:, :, p:p + h + 1, q:q + w + 1], k)
    out = _lrelu(out + b.view(1, -1, 1, 1))
    return out.permute(0, 2, 3, 1).to(torch.bfloat16)


def _conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """NHWC bf16 x, OHWI w -> NCHW f32 conv + bias."""
    return (F.conv2d(x.permute(0, 3, 1, 2).float(),
                     w.permute(0, 3, 1, 2).float(), padding=1)
            + b.view(1, -1, 1, 1))


def epilogue_plain(y: torch.Tensor, out_mode: str, full_range: bool):
    """The kernel's output epilogue on f32 RGB y (B, H, W, 3)."""
    if out_mode == "bf16":
        return y.to(torch.bfloat16)
    c = y.clamp(0.0, 1.0)
    if out_mode == "rgb_u8":
        return torch.floor(c * 255.0 + 0.5).to(torch.uint8)
    k = torch.from_numpy(yuv420_coefficients(full_range)).to(y.device)
    yy = torch.floor(c @ k[0:3] + k[9]).clamp(0, 255).to(torch.uint8)
    b, h, w, _ = c.shape

    def chroma(coef):
        s = (c @ coef).reshape(b, h // 2, 2, w // 2, 2).sum(dim=(2, 4))
        return torch.floor(s + k[10]).clamp(0, 255).to(torch.uint8)

    return yy, chroma(k[3:6]), chroma(k[6:9])


def _up2_hr_last_plain(a0: torch.Tensor, wts: TailWeights) -> torch.Tensor:
    """conv_up2 (on the nearest 2x upsample), conv_hr, each rounded to
    bf16 after bias and lrelu, then conv_last + bias in f32: a0
    (B, H, W, 64) bf16 -> (B, 2H, 2W, 3) f32."""
    a = _phase_conv_plain(a0, wts.up2, wts.up2_b)
    c = _lrelu(_conv3x3_plain(a, wts.hr, wts.hr_b)).to(torch.bfloat16)
    y = _conv3x3_plain(c.permute(0, 2, 3, 1), wts.last, wts.last_b)[:, :3]
    return y.permute(0, 2, 3, 1)


def fused_tail_plain(x: torch.Tensor, wts: TailWeights,
                     out_mode: str = "bf16", full_range: bool = False):
    """Plain PyTorch version of K2 with the kernel's rounding points:
    each of conv_up1, conv_up2 and conv_hr rounds to bf16 after bias and
    lrelu; conv_last stays f32 into the epilogue."""
    y = _up2_hr_last_plain(_phase_conv_plain(x, wts.up1, wts.up1_b), wts)
    return epilogue_plain(y, out_mode, full_range)


def fused_tail1_plain(a0: torch.Tensor, wts: TailWeights) -> torch.Tensor:
    """Plain PyTorch version of tail1 (``_tail_kernel``): conv_up2 and
    conv_hr as in K2, conv_last + bias rounded once to bf16."""
    return _up2_hr_last_plain(a0, wts).to(torch.bfloat16)


def _check_x(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[-1] != NF \
            or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous (B, h, w, 64) bf16, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _launch_up2_hr_last(a0: torch.Tensor, wts: TailWeights, out_mode: str,
                        full_range: bool, outs) -> None:
    """K2's last three launches from a0 (B, H, W, 64) bf16 into ``outs``
    at (B, 2H, 2W): conv_up2, conv_hr, conv_last with the epilogue."""
    b, h, w, _ = a0.shape
    a = torch.empty(b, 2 * h, 2 * w, NF, dtype=torch.bfloat16, device=a0.device)
    c = torch.empty_like(a)
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    coef = (ctypes.c_float * 11)(*yuv420_coefficients(full_range).tolist())
    lib = _build.library()
    stream = torch.cuda.current_stream(a0.device).cuda_stream
    _build.check(lib.fw_tail_up2(a0.data_ptr(), b, h, w, wts.up2_k.data_ptr(),
                                 wts.up2_b.data_ptr(), a.data_ptr(), stream),
                 "fw_tail_up2")
    _build.check(lib.fw_tail_hr(a.data_ptr(), b, 2 * h, 2 * w, wts.hr_k.data_ptr(),
                                wts.hr_b.data_ptr(), c.data_ptr(), stream),
                 "fw_tail_hr")
    _build.check(lib.fw_tail_last(c.data_ptr(), b, 2 * h, 2 * w, wts.last_k.data_ptr(),
                                  wts.last_b.data_ptr(), OUT_MODES[out_mode],
                                  ctypes.addressof(coef), *ptrs, stream),
                 "fw_tail_last")


def fused_tail(x: torch.Tensor, wts: TailWeights, out_mode: str = "bf16",
               full_range: bool = False):
    """K2 over the conv_body+skip features ``x`` (B, h, w, 64) bf16; see
    the module docstring for the outputs. On a CPU tensor this runs the
    plain version; on a CUDA tensor it launches the kernels (conv_up1,
    conv_up2, conv_hr, conv_last with the epilogue)."""
    if out_mode not in OUT_MODES:
        raise ValueError(f"fused_tail: out_mode must be one of {sorted(OUT_MODES)}")
    _check_x("fused_tail", x)
    if x.device.type == "cpu":
        return fused_tail_plain(x, wts, out_mode, full_range)
    b, h, w, _ = x.shape
    h4, w4 = 4 * h, 4 * w
    dev = x.device
    a0 = torch.empty(b, 2 * h, 2 * w, NF, dtype=torch.bfloat16, device=dev)
    if out_mode == "yuv420_u8":
        outs = (torch.empty(b, h4, w4, dtype=torch.uint8, device=dev),
                torch.empty(b, 2 * h, 2 * w, dtype=torch.uint8, device=dev),
                torch.empty(b, 2 * h, 2 * w, dtype=torch.uint8, device=dev))
    else:
        dtype = torch.bfloat16 if out_mode == "bf16" else torch.uint8
        outs = (torch.empty(b, h4, w4, 3, dtype=dtype, device=dev),)
    _build.check(_build.library().fw_tail_up2(
        x.data_ptr(), b, h, w, wts.up1_k.data_ptr(), wts.up1_b.data_ptr(), a0.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "fw_tail_up2")
    _launch_up2_hr_last(a0, wts, out_mode, full_range, outs)
    fused_tail.launches += 1
    return outs if out_mode == "yuv420_u8" else outs[0]


def fused_tail1(a0: torch.Tensor, wts: TailWeights) -> torch.Tensor:
    """tail1 over conv_up1's output ``a0`` (B, H, W, 64) bf16 -> bf16 RGB
    (B, 2H, 2W, 3). On a CPU tensor this runs the plain version; on a
    CUDA tensor it launches conv_up2, conv_hr and conv_last (bf16 out)."""
    _check_x("fused_tail1", a0)
    if a0.device.type == "cpu":
        return fused_tail1_plain(a0, wts)
    b, h, w, _ = a0.shape
    out = torch.empty(b, 2 * h, 2 * w, 3, dtype=torch.bfloat16, device=a0.device)
    _launch_up2_hr_last(a0, wts, "bf16", False, (out,))
    fused_tail1.launches += 1
    return out


fused_tail.launches = 0
fused_tail1.launches = 0
