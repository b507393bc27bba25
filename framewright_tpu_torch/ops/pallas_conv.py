"""The band conv (3x3 conv + bias + optional lrelu, bf16 out) and the
RRDB tail built from it (``FastTail``), with the plain version.

Replaces ``framewright_tpu/ops/pallas_conv.py`` (the module keeps its
name so that a reader finds the counterpart): ``_kernel`` (via
``band_conv3x3``), with ``conv_wide_weights`` and ``FastTail``. The
kernel is ``csrc/band_conv.cu``, on the wgmma conv main loop of
``csrc/conv_wgmma.cuh``; its note says what bounds it on the card and
what the design does about it. The TPU kernel's row bands, lane rolls and
double-buffered halo DMA have no counterpart: TMA reads each tile's halo
box straight from the NHWC image, zero outside it.

``FastTail`` is reached only through ``RRDBNet.apply_fast(fast_tail=...)``,
as in the JAX package, where no module, script or CLI flag passes it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from framewright_tpu_torch.ops import _build
from framewright_tpu_torch.ops.fused_rrdb import wgmma_weights

COUTS = (64, 8)   # the padded output counts the kernel takes
CIN_STEP = 16     # its input channels come in chunks of 16 (one wgmma k step)


@dataclass
class BandConvWeights:
    """One conv for the band-conv kernel: w (Cout', 3, 3, Cin) bf16 (OHWI),
    b (Cout',) f32, Cout' = Cout padded to a multiple of 8 with zero rows;
    ``cout`` the conv's own output count; wk = ``fused_rrdb.wgmma_weights(w)``,
    the chunk-major copy (Cin / 16, 9, 2, Cout', 8) the kernel reads (the
    plain version reads w)."""
    w: torch.Tensor
    b: torch.Tensor
    cout: int
    wk: torch.Tensor


def conv_wide_weights(conv: torch.nn.Conv2d) -> BandConvWeights:
    """A 3x3 conv -> the kernel's weights (counterpart of
    ``conv_wide_weights``): output channels padded to a multiple of 8,
    weights rounded once to bf16, bias in f32, and the kernel's copy of
    the weights. Cin must be a multiple of 16."""
    w = conv.weight.detach().float()
    cout, cin = w.shape[:2]
    if cin % CIN_STEP:
        raise ValueError(f"band conv: Cin must be a multiple of {CIN_STEP}, got {cin}")
    cpad = -(-cout // 8) * 8
    wp = torch.zeros(cpad, *w.shape[1:], device=w.device)
    wp[:cout] = w
    bp = torch.zeros(cpad, device=w.device)
    bp[:cout] = conv.bias.detach().float()
    w16 = wp.permute(0, 2, 3, 1).contiguous().to(torch.bfloat16)
    return BandConvWeights(w16, bp.contiguous(), cout, wgmma_weights(w16))


def _check(x: torch.Tensor, wts: BandConvWeights) -> None:
    """What the kernel takes, checked on every device, so that the CPU
    path refuses what the card would."""
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"band_conv3x3: x must be contiguous (B, H, W, Cin) bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if wts.w.shape[-1] != x.shape[-1] or wts.w.device != x.device:
        raise ValueError(f"band_conv3x3: weights {tuple(wts.w.shape)} on {wts.w.device} "
                         f"for x {tuple(x.shape)} on {x.device}")
    cin, cout = x.shape[-1], wts.w.shape[0]
    if cin % CIN_STEP or cout not in COUTS:
        raise ValueError(f"band_conv3x3: the kernel takes Cin a multiple of {CIN_STEP} and "
                         f"Cout' in {COUTS}, got {cin} -> {cout}")


def band_conv3x3_plain(x: torch.Tensor, wts: BandConvWeights,
                       act: bool = True) -> torch.Tensor:
    """Plain PyTorch version: bf16(act(conv(x) + b)) from the f32 sums of
    the bf16 operands."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), wts.w.permute(0, 3, 1, 2).float(),
                 padding=1) + wts.b.view(1, -1, 1, 1)
    if act:
        y = torch.where(y >= 0, y, 0.2 * y)
    return y.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


def band_conv3x3(x: torch.Tensor, wts: BandConvWeights, act: bool = True) -> torch.Tensor:
    """3x3 SAME conv + bias (+ lrelu when ``act``) with f32 accumulation
    and bf16 output: NHWC ``x`` (B, H, W, Cin) bf16 -> (B, H, W, Cout')
    bf16, Cout' the padded output count (the caller crops); Cin a multiple
    of 16 and Cout' 64 or 8 on any device. On a CPU tensor this runs the
    plain version; on a CUDA tensor it launches the kernel (one launch) on
    ``wts.wk``, and raises if the launch fails."""
    _check(x, wts)
    if x.device.type == "cpu":
        return band_conv3x3_plain(x, wts, act)
    if x.device.type != "cuda":
        raise ValueError(f"band_conv3x3: unsupported device {x.device}")
    b, h, w, cin = x.shape
    cout = wts.w.shape[0]
    out = torch.empty(b, h, w, cout, dtype=torch.bfloat16, device=x.device)
    _build.check(_build.library().fw_band_conv(
        x.data_ptr(), b, h, w, cin, wts.wk.data_ptr(), wts.b.data_ptr(), cout, int(act),
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream), "fw_band_conv")
    band_conv3x3.launches += 1
    return out


band_conv3x3.launches = 0


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of NHWC x, in one copy."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


class FastTail:
    """The RRDB tail through band convs (counterpart of ``FastTail``):
    f = feat + conv_body(body), a bf16 add; nearest 2x and conv_up1 +
    lrelu; nearest 2x and conv_up2 + lrelu; conv_hr + lrelu; conv_last
    (3 outputs padded to 8), cropped to 3 channels; every conv rounds to
    bf16. It takes the whole batch at once (the JAX package loops over
    its entries, with the same numbers) and frees each intermediate
    before the next conv. ``plain`` runs the plain band conv on any
    device (a reference for the kernel on the card)."""

    def __init__(self, model, plain: bool = False):
        self.conv = band_conv3x3_plain if plain else band_conv3x3
        self.body = conv_wide_weights(model.conv_body)
        self.up1 = conv_wide_weights(model.conv_up1)
        self.up2 = conv_wide_weights(model.conv_up2)
        self.hr = conv_wide_weights(model.conv_hr)
        self.last = conv_wide_weights(model.conv_last)

    def __call__(self, feat: torch.Tensor, body_out: torch.Tensor) -> torch.Tensor:
        """feat, body_out (B, H, W, 64) bf16 -> (B, 4H, 4W, 3) bf16."""
        conv = self.conv
        f = feat.to(torch.bfloat16) + conv(body_out.to(torch.bfloat16).contiguous(),
                                           self.body, act=False)
        f = conv(_up2(f), self.up1)
        f = conv(_up2(f), self.up2)
        f = conv(f, self.hr)
        out = conv(f, self.last, act=False)
        del f
        return out[..., :self.last.cout]
