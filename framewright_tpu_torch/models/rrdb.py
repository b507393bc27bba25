"""RRDBNet (Real-ESRGAN generator) as a torch ``nn.Module``.

The port of ``framewright_tpu/models/rrdb.py``. Public functions keep
the JAX package's layout: NHWC input in [0, 1]; output (B, sH, sW, 3),
or uint8 planes Y (B, sH, sW), U and V (B, sH/2, sW/2).

  apply       plain PyTorch forward (counterpart of ``rrdb.apply``),
              computed in the input's dtype like the JAX conv2d
  apply_fast  the kernel path (counterpart of ``rrdb.apply_fast``):
              conv_first, then the RDB kernel 69 times (23 blocks), bf16
              or int8 after the fast weights it holds; then, by FW_TAIL,
              K1 and K2 with the output epilogue (the tail3 path, the
              default unless the scales are dynamic), tail2 (conv_body +
              skip in PyTorch, K2) or tail1 (conv_body + skip and
              conv_up1 in PyTorch, the tail1 kernels), or with
              ``fast_tail`` the band-conv tail (``ops.pallas_conv.
              FastTail``); after the last three the output epilogue in
              PyTorch
  calibrate_act_scales  the int8 activation ranges from one bf16 pass
              (counterpart of ``rrdb.calibrate_act_scales``)

Parameter names follow the official basicsr state dict
(``conv_first``, ``body.{i}.rdb{1,2,3}.conv{1..5}``, ``conv_body``,
``conv_up1``, ``conv_up2``, ``conv_hr``, ``conv_last``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from framewright_tpu_torch.models.layers import (
    conv2d,
    lrelu,
    mul_weak,
    out_epilogue,
    pixel_unshuffle,
    upsample_nearest,
)


@dataclass(frozen=True)
class RRDBConfig:
    num_in_ch: int = 3
    num_out_ch: int = 3
    num_feat: int = 64
    num_block: int = 23
    num_grow_ch: int = 32
    scale: int = 4   # output = input * scale; the body runs at input / (4 / scale)


def _conv(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResidualDenseBlock(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.conv1 = _conv(nf, gc)
        self.conv2 = _conv(nf + gc, gc)
        self.conv3 = _conv(nf + 2 * gc, gc)
        self.conv4 = _conv(nf + 3 * gc, gc)
        self.conv5 = _conv(nf + 4 * gc, nf)

    def convs(self) -> List[nn.Conv2d]:
        return [self.conv1, self.conv2, self.conv3, self.conv4, self.conv5]

    def dense(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """-> ([x, x1, x2, x3, x4], x5)."""
        feats = [x]
        for conv in self.convs()[:4]:
            feats.append(lrelu(conv2d(torch.cat(feats, -1), conv.weight, conv.bias)))
        return feats, conv2d(torch.cat(feats, -1), self.conv5.weight, self.conv5.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, x5 = self.dense(x)
        return mul_weak(x5, 0.2) + x


class RRDB(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(nf, gc)
        self.rdb2 = ResidualDenseBlock(nf, gc)
        self.rdb3 = ResidualDenseBlock(nf, gc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.rdb3(self.rdb2(self.rdb1(x)))
        return mul_weak(out, 0.2) + x


@dataclass
class FastWeights:
    """The kernels' weight layouts, derived once from the module."""
    body: list     # [num_block][3] fused_rrdb.RDBWeights or RDBWeightsInt8
    cbody: object  # fused_tail3.ConvBodyWeights
    tail: object   # fused_tail.TailWeights
    int8_scheme: Optional[str] = None   # None (bf16 body), i32, f32acc, dynamic


class RRDBNet(nn.Module):
    def __init__(self, cfg: RRDBConfig = RRDBConfig()):
        super().__init__()
        self.cfg = cfg
        nf, gc = cfg.num_feat, cfg.num_grow_ch
        in_ch = cfg.num_in_ch * {2: 4, 1: 16}.get(cfg.scale, 1)
        self.conv_first = _conv(in_ch, nf)
        self.body = nn.ModuleList(RRDB(nf, gc) for _ in range(cfg.num_block))
        self.conv_body = _conv(nf, nf)
        self.conv_up1 = _conv(nf, nf)
        self.conv_up2 = _conv(nf, nf)
        self.conv_hr = _conv(nf, nf)
        self.conv_last = _conv(nf, cfg.num_out_ch)
        self._fast: Optional[FastWeights] = None        # bf16
        self._fast_int8: Optional[FastWeights] = None   # int8, once calibrated

    @classmethod
    def from_state_dict(cls, cfg: RRDBConfig, sd: Dict[str, torch.Tensor],
                        device: torch.device) -> "RRDBNet":
        """Build on the meta device (no throwaway init), then take the
        state dict's tensors as parameters and move them to ``device``."""
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(sd, assign=True)
        return model.to(device).eval().requires_grad_(False)

    # -- plain path ------------------------------------------------------
    def _head(self, x: torch.Tensor) -> torch.Tensor:
        s = self.cfg.scale
        feat = pixel_unshuffle(x, 2) if s == 2 else (
            pixel_unshuffle(x, 4) if s == 1 else x)
        return conv2d(feat, self.conv_first.weight, self.conv_first.bias)

    def _tail(self, feat: torch.Tensor, body_out: torch.Tensor) -> torch.Tensor:
        feat = feat + conv2d(body_out.to(feat.dtype), self.conv_body.weight,
                             self.conv_body.bias)
        for conv in (self.conv_up1, self.conv_up2):
            feat = lrelu(conv2d(upsample_nearest(feat, 2), conv.weight, conv.bias))
        feat = lrelu(conv2d(feat, self.conv_hr.weight, self.conv_hr.bias))
        return conv2d(feat, self.conv_last.weight, self.conv_last.bias)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Plain forward. x: (B, H, W, C) in [0, 1], computed in x's
        dtype; H and W even for scale 2, multiples of 4 for scale 1.
        Named after ``rrdb.apply``, it shadows ``nn.Module.apply(fn)``,
        which the port never calls."""
        feat = self._head(x)
        body = feat
        for blk in self.body:
            body = blk(body)
        return self._tail(feat, body)

    # -- kernel path -----------------------------------------------------
    def _tail_weights(self):
        from framewright_tpu_torch.ops import fused_tail, fused_tail3

        return (fused_tail3.conv_body_weights(self.conv_body),
                fused_tail.tail_weights(self.conv_up1, self.conv_up2,
                                        self.conv_hr, self.conv_last))

    def fast_weights(self) -> FastWeights:
        """The bf16 kernels' weights (rounded once from the module's
        parameters), built on first use on the module's device."""
        if self._fast is None:
            from framewright_tpu_torch.ops import fused_rrdb

            cbody, tail = self._tail_weights()
            self._fast = FastWeights(
                body=[[fused_rrdb.rdb_weights(r.convs())
                       for r in (blk.rdb1, blk.rdb2, blk.rdb3)]
                      for blk in self.body],
                cbody=cbody, tail=tail)
        return self._fast

    def fast_weights_int8(self, act_amax, int8_scheme: Optional[str] = None
                          ) -> FastWeights:
        """Build and hold the int8 fast weights (counterpart of
        ``rrdb.make_fast_params(compute_dtype="int8", act_amax=...)``):
        the body quantized with the static ranges ``act_amax``
        (num_block, 3, 5) from ``calibrate_act_scales``, in the scheme
        ``int8_scheme`` (default ``FW_INT8_SCHEME``, else "i32"; any
        other name is "f32acc", as in the JAX package). ``act_amax=None``
        gives the "dynamic" weights, whose kernel takes the ranges from
        each frame, whatever the scheme says. The tail weights stay
        bf16. The model holds them (``int8_weights``), and ``apply_fast``
        then runs the int8 body."""
        from framewright_tpu_torch.ops import fused_rrdb

        if act_amax is None:
            scheme = "dynamic"
        else:
            scheme = int8_scheme or os.environ.get("FW_INT8_SCHEME", "i32")
            scheme = "i32" if scheme == "i32" else "f32acc"
            amax = np.asarray(act_amax, np.float32)
            if amax.shape != (len(self.body), 3, 5):
                raise ValueError(f"act_amax must be ({len(self.body)}, 3, 5), "
                                 f"got {amax.shape}")

        def make(convs, i, j):
            if scheme == "dynamic":
                return fused_rrdb.rdb_weights_int8(convs)
            if scheme == "i32":
                return fused_rrdb.rdb_weights_int8_i32(convs, amax[i, j])
            return fused_rrdb.rdb_weights_int8(convs, amax[i, j])

        bf16 = self._fast
        cbody, tail = (bf16.cbody, bf16.tail) if bf16 is not None else self._tail_weights()
        self._fast_int8 = FastWeights(
            body=[[make(r.convs(), i, j)
                   for j, r in enumerate((blk.rdb1, blk.rdb2, blk.rdb3))]
                  for i, blk in enumerate(self.body)],
            cbody=cbody, tail=tail, int8_scheme=scheme)
        return self._fast_int8

    @property
    def int8_weights(self) -> Optional[FastWeights]:
        """The int8 fast weights the model holds, or None."""
        return self._fast_int8

    def tail1_input(self, feat: torch.Tensor, body: torch.Tensor) -> torch.Tensor:
        """The part of ``rrdb._tail_pallas`` that the JAX package runs in
        XLA, here in PyTorch with ``layers.conv2d`` in bf16: feat +
        conv_body(body), then lrelu(conv_up1(nearest2(.))). feat, body
        (B, h, w, 64) bf16 -> tail1's input (B, 2h, 2w, 64) bf16."""
        f = feat + conv2d(body, self.conv_body.weight, self.conv_body.bias)
        return lrelu(conv2d(upsample_nearest(f, 2), self.conv_up1.weight,
                            self.conv_up1.bias)).contiguous()

    def tail1(self, feat: torch.Tensor, body: torch.Tensor, tail,
              plain: bool = False) -> torch.Tensor:
        """The tail1 path's tail (counterpart of ``rrdb._tail_pallas``):
        ``tail1_input``, then the tail1 kernels (``plain``: their plain
        version). -> (B, 4h, 4w, 3) bf16 RGB."""
        from framewright_tpu_torch.ops import fused_tail

        run = fused_tail.fused_tail1_plain if plain else fused_tail.fused_tail1
        return run(self.tail1_input(feat, body), tail)

    def tail2(self, feat: torch.Tensor, body: torch.Tensor, tail,
              plain: bool = False) -> torch.Tensor:
        """The tail2 path's tail (counterpart of ``rrdb._tail_pallas2``):
        feat + conv_body(body) in PyTorch bf16 (``tail1_input``'s first
        line), then K2 (``fused_tail.fused_tail``, ``plain``: its plain
        version) with bf16 output. -> (B, 4h, 4w, 3) bf16 RGB."""
        from framewright_tpu_torch.ops import fused_tail

        f = (feat + conv2d(body, self.conv_body.weight, self.conv_body.bias)).contiguous()
        run = fused_tail.fused_tail_plain if plain else fused_tail.fused_tail
        return run(f, tail, "bf16")

    def apply_fast(self, x: torch.Tensor, out_mode: str = "bf16",
                   full_range: bool = False, weights: Optional[FastWeights] = None,
                   fast_tail=None, f32_head: bool = False):
        """Kernel forward. x: (B, H, W, 3) in [0, 1]. The body is bf16 or
        int8 after ``weights`` (default: the int8 weights when the model
        holds them, else the bf16 ones); the head and the tail are bf16.
        ``FW_TAIL`` picks the tail as the JAX package does: "auto" (the
        default) or "3" run the merge body with K1 and K2 unless the
        scales are dynamic or ``fast_tail`` is given; otherwise the body
        by ``FW_RDB_BODY`` (``fused_rrdb.rrdb_body_fast``), then
        ``fast_tail(feat, body)`` when given (an ``ops.pallas_conv.
        FastTail``), else tail2 (``tail2``) for "2" and tail1 (``tail1``)
        for any other value, each with the epilogue in PyTorch.
        Output per ``out_mode`` (see ops/fused_tail.py): bf16 RGB, rgb_u8,
        or the yuv420_u8 planes.
        ``f32_head`` (the float32 restore) runs the head in f32 on x in f32
        with the module's f32 weights, then rounds its output to bf16 where
        the body and K1's skip take it, as the JAX package's float32 mode
        does (``fused_rrdb.rrdb_body_merge_blocks``); otherwise x and the
        head are bf16."""
        from framewright_tpu_torch.ops import fused_rrdb, fused_tail, fused_tail3

        kind = os.environ.get("FW_TAIL", "auto")
        fw = weights or self._fast_int8 or self.fast_weights()
        head_in = x.float() if f32_head else x.to(torch.bfloat16)
        feat = self._head(head_in).to(torch.bfloat16).contiguous()
        if kind in ("3", "auto") and fw.int8_scheme != "dynamic" and fast_tail is None:
            if fw.int8_scheme is None:
                body = fused_rrdb.rrdb_body(feat, fw.body)
            else:
                body = fused_rrdb.rrdb_body_int8(feat, fw.body)
            skip = fused_tail3.conv_body_skip(body, feat, fw.cbody)
            del body, feat   # the tail's 4K intermediates may reuse this memory
            return fused_tail.fused_tail(skip, fw.tail, out_mode, full_range)
        body = fused_rrdb.rrdb_body_fast(feat, fw.body)
        if fast_tail is not None:
            img = fast_tail(feat, body)
        elif kind == "2":
            img = self.tail2(feat, body, fw.tail)
        else:
            img = self.tail1(feat, body, fw.tail)
        del body, feat
        return img if out_mode == "bf16" else out_epilogue(img, out_mode, full_range)


def calibrate_act_scales(model: RRDBNet, sample: torch.Tensor,
                         margin: float = 1.25) -> np.ndarray:
    """Per-RDB activation ranges for the int8 body (counterpart of
    ``rrdb.calibrate_act_scales``): the model's plain forward in bf16 on
    ``sample`` (B, H, W, 3) in [0, 1], recording max|.| of the five
    tensors each RDB's int8 kernel quantizes, [x, x1, x2, x3, x4], times
    ``margin``. -> (num_block, 3, 5) float32 numpy. Counted in
    ``calibrate_act_scales.calls``."""
    calibrate_act_scales.calls += 1
    dev = model.conv_first.weight.device
    with torch.no_grad():
        h = model._head(sample.to(dev).to(torch.bfloat16))
        stats = []
        for blk in model.body:
            out, row = h, []
            for rdb in (blk.rdb1, blk.rdb2, blk.rdb3):
                feats, x5 = rdb.dense(out)
                row.append(torch.stack([f.abs().amax() for f in feats]))
                out = mul_weak(x5, 0.2) + out
            stats.append(torch.stack(row))
            h = mul_weak(out, 0.2) + h
        amax = torch.stack(stats).float() * margin
    return amax.cpu().numpy()


calibrate_act_scales.calls = 0
