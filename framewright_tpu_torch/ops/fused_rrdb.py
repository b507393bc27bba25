"""The RRDB body: the ResidualDenseBlock kernel, its plain version, and
the 69-sweep body loop.

Replaces ``framewright_tpu/ops/fused_rrdb.py``: ``_rdb_kernel_merge`` and
``_rdb_kernel_merge_res`` (via ``fused_rdb_blocks_merge``) and the body
loop ``rrdb_body_merge_blocks``. The kernel is ``csrc/rdb.cu``; its
note says what bounds it on the card and what the design does about it.

Activations live in NHWC bf16 workspaces of 192 channels: 0:64 hold the
RDB input x, 64:192 receive x1..x4, so the dense concatenation is a
channel prefix. A CTA reads its tile's halo straight from device memory
(zero outside the frame), so the TPU path's block extraction, halo ring
refresh and assembly have no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from framewright_tpu_torch.ops import _build

NF, GC, WS_C = 64, 32, 192
BF16_0P2 = 0.2001953125   # bf16(0.2): JAX's weakly typed 0.2 against bf16


@dataclass
class RDBWeights:
    """One RDB's five convs: w[k] (cout, 3, 3, cin) bf16 (OHWI, input
    channels contiguous), b[k] (cout,) f32."""
    w: List[torch.Tensor]
    b: List[torch.Tensor]


def rdb_weights(convs: Sequence[torch.nn.Conv2d]) -> RDBWeights:
    """conv1..conv5 of a ResidualDenseBlock -> the kernel's layout."""
    return RDBWeights(
        w=[c.weight.detach().float().permute(0, 2, 3, 1).contiguous()
           .to(torch.bfloat16) for c in convs],
        b=[c.bias.detach().float().contiguous() for c in convs])


def _check(ws: torch.Tensor, dst: torch.Tensor,
           carry: Optional[torch.Tensor]) -> None:
    for name, t in (("ws", ws), ("dst", dst), ("carry", carry)):
        if t is None:
            continue
        if t.dtype != torch.bfloat16 or t.dim() != 4 or t.shape[-1] != WS_C:
            raise ValueError(f"fused_rdb: {name} must be (B, H, W, {WS_C}) "
                             f"bf16, got {tuple(t.shape)} {t.dtype}")
        if t.shape != ws.shape or t.device != ws.device:
            raise ValueError(f"fused_rdb: {name} shape/device differs from ws")
        if not t.is_contiguous():
            raise ValueError(f"fused_rdb: {name} must be contiguous")
    if dst.data_ptr() == ws.data_ptr():
        raise ValueError("fused_rdb: dst must not be ws (the last stage "
                         "reads ws's halo while it writes dst)")


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NHWC bf16 x (B, H, W, cin), OHWI w -> f32 NCHW conv + bias."""
    return (F.conv2d(x.permute(0, 3, 1, 2).float(),
                     w.permute(0, 3, 1, 2).float(), padding=1)
            + b.view(1, -1, 1, 1))


def _lrelu(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, v, 0.2 * v)


def fused_rdb_plain(ws: torch.Tensor, dst: torch.Tensor, wts: RDBWeights,
                    carry: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of the kernel, with its rounding points:
    stage k < 5: ws[..., 64+32(k-1):+32] = bf16(lrelu(conv + b));
    stage 5: o = bf16(bf16(0.2 (conv + b)) + x) into dst[..., :64], and
    with carry o = bf16(bf16(bf16(0.2) o) + carry[..., :64])."""
    for k in range(4):
        cin = NF + GC * k
        v = _lrelu(_conv(ws[..., :cin], wts.w[k], wts.b[k]))
        ws[..., cin:cin + GC] = v.permute(0, 2, 3, 1).to(torch.bfloat16)
    x5 = _conv(ws, wts.w[4], wts.b[4]).permute(0, 2, 3, 1)
    o = ((0.2 * x5).to(torch.bfloat16).float() + ws[..., :NF].float())
    o = o.to(torch.bfloat16)
    if carry is not None:
        o = ((BF16_0P2 * o.float()).to(torch.bfloat16).float()
             + carry[..., :NF].float()).to(torch.bfloat16)
    dst[..., :NF] = o


def fused_rdb(ws: torch.Tensor, dst: torch.Tensor, wts: RDBWeights,
              carry: Optional[torch.Tensor] = None) -> None:
    """One ResidualDenseBlock over the workspace ``ws`` (B, H, W, 192)
    bf16, whose channels 0:64 hold x: x1..x4 land in ws[..., 64:192],
    the output in dst[..., :64]. With ``carry`` (the RRDB input
    workspace, which may be ``dst``) the RRDB residual is applied too.
    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the kernel (five launches, one per dense stage)."""
    _check(ws, dst, carry)
    if ws.device.type == "cpu":
        fused_rdb_plain(ws, dst, wts, carry)
        return
    if ws.device.type != "cuda":
        raise ValueError(f"fused_rdb: unsupported device {ws.device}")
    lib = _build.library()
    stream = torch.cuda.current_stream(ws.device).cuda_stream
    b, h, w, _ = ws.shape
    for k in range(4):
        _build.check(lib.fw_rdb_dense(ws.data_ptr(), b, h, w, NF + GC * k,
                                      wts.w[k].data_ptr(), wts.b[k].data_ptr(),
                                      stream), "fw_rdb_dense")
    _build.check(lib.fw_rdb_final(
        ws.data_ptr(), b, h, w, wts.w[4].data_ptr(), wts.b[4].data_ptr(),
        dst.data_ptr(), None if carry is None else carry.data_ptr(), stream),
        "fw_rdb_final")
    fused_rdb.launches += 1


fused_rdb.launches = 0


def new_workspace(feat: torch.Tensor) -> torch.Tensor:
    """An RDB workspace whose channels 0:64 hold ``feat`` (B, H, W, 64)."""
    b, h, w, _ = feat.shape
    ws = torch.empty(b, h, w, WS_C, dtype=torch.bfloat16, device=feat.device)
    ws[..., :NF] = feat
    return ws


def rrdb_body(feat: torch.Tensor,
              body: Sequence[Sequence[RDBWeights]]) -> torch.Tensor:
    """The RRDB trunk: 3 RDBs per block (69 sweeps for 23 blocks), with
    the RRDB residual fused into each block's third RDB. ``feat``
    (B, H, W, 64) bf16 -> a workspace (B, H, W, 192) whose channels 0:64
    hold the body output (the counterpart of ``rrdb_body_merge``)."""
    w0 = new_workspace(feat)
    w1, w2 = torch.empty_like(w0), torch.empty_like(w0)
    for rdb1, rdb2, rdb3 in body:
        fused_rdb(w0, w1, rdb1)
        fused_rdb(w1, w2, rdb2)
        fused_rdb(w2, w0, rdb3, carry=w0)
    return w0
