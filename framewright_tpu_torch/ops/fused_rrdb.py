"""The RRDB body: the ResidualDenseBlock kernels (bf16 and int8), their
plain versions, the halo blocks of the resident body with their ring
refresh, and the 69-sweep body loops.

Replaces ``framewright_tpu/ops/fused_rrdb.py``: ``_rdb_kernel_merge`` and
``_rdb_kernel_merge_res`` (via ``fused_rdb_blocks_merge``), the int8
``_rdb_kernel_int8_i32_merge``/``_res`` (via
``fused_rdb_blocks_merge_int8_i32``) and ``_rdb_kernel_int8_static_merge``
(via ``fused_rdb_blocks_merge_int8``), the round-trip ``_rdb_kernel`` (via
``fused_rdb_blocks``), ``_rdb_kernel_int8_static`` and the dynamic-scale
``_rdb_kernel_int8`` (via ``fused_rdb_blocks_int8``), with their weight
quantization (``rdb_wide_weights_int8_i32``, ``rdb_wide_weights_int8``),
the halo ring refresh ``_make_refresh_kernel_hbm`` (via
``halo_refresh_hbm``), the block geometry (``_grid_dims``,
``_block_extents``, ``extract_blocks``, ``assemble_blocks``) and the body
loops ``rrdb_body_merge_blocks``, ``rrdb_body_fast_roundtrip``,
``rrdb_body_resident`` and ``rrdb_body_fast``. The kernels are
``csrc/rdb.cu``, ``csrc/rdb_int8.cu``, ``csrc/rdb_dyn.cu`` and
``csrc/halo.cu``; their notes say what bounds them on the card and what
the design does about it.

Activations live in NHWC bf16 workspaces of 192 channels: 0:64 hold the
RDB input x, 64:192 receive x1..x4, so the dense concatenation is a
channel prefix. On the merge and round-trip bodies a CTA reads its
tile's halo straight from device memory (zero outside the frame). The
resident body (``FW_RDB_BODY=resident``) runs the same kernels on halo
blocks (B*nh*nw, S, S, C) that it extracts once, with each block's valid
rectangle (``BlockExtents``), and rebuilds the rings between RDBs
(``halo_refresh``) instead of reading neighbours; it assembles once at
the end.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.ops import _build

NF, GC, WS_C = 64, 32, 192
BF16_0P2 = 0.2001953125   # bf16(0.2): JAX's weakly typed 0.2 against bf16

# Halo-block geometry of the resident body, from the JAX package's
# variables and defaults (fused_rrdb.py:63-73): S x S blocks whose HALO
# ring covers the five sequential convs, interior BH. At the 540x960 body
# S=112 gives a 6x10 grid of 96-pixel interiors.
S = int(os.environ.get("FW_RDB_S", "112"))
HALO = int(os.environ.get("FW_RDB_HALO", "8"))
BH = S - 2 * HALO
if HALO < 5 or BH <= 0:
    raise ValueError(f"FW_RDB_S={S}, FW_RDB_HALO={HALO}: the halo must be at least 5 "
                     f"(one ring per sequential conv) and S - 2 HALO positive")


# --- halo blocks (the resident body) -------------------------------------
#
# A frame (h, w) is cut into a grid of nh x nw interiors of BH x BH pixels,
# each grown by a HALO ring into an S x S block: NHWC (B*nh*nw, S, S, C) in
# frame-major order (b, i, j), block (i, j) covering frame rows
# i*BH - HALO .. i*BH + BH + HALO and the columns alike. Outside the frame
# (the frame-border ring and the grid's slack past h and w) blocks hold
# zeros. The layout is the port's (channels last, so that a bf16 block
# workspace keeps rdb.cu's 192-channel dense prefix); the values are those
# of the JAX package's channel-major blocks.


def grid_dims(h: int, w: int) -> tuple:
    """Interiors down and across a frame (``_grid_dims``)."""
    return -(-h // BH), -(-w // BH)


def block_extents(h: int, w: int) -> np.ndarray:
    """(nh*nw, 4) int32 valid rectangles [r0, r1, c0, c1) of one frame's
    blocks in block coordinates (``_block_extents``)."""
    nh, nw = grid_dims(h, w)
    return np.asarray([(HALO if i == 0 else 0, min(S, HALO + h - i * BH),
                        HALO if j == 0 else 0, min(S, HALO + w - j * BH))
                       for i in range(nh) for j in range(nw)], np.int32)


@dataclass(frozen=True)
class BlockExtents:
    """The valid rectangles of a batch's halo blocks: ``rects`` (nb, 4)
    int32 on the blocks' device, ``per_frame`` = nh * nw blocks a frame.
    The RDB kernels take ``rects`` as their ``ext`` (NULL for images)."""
    rects: torch.Tensor
    per_frame: int

    @classmethod
    def of(cls, b: int, h: int, w: int, device) -> "BlockExtents":
        ext = block_extents(h, w)
        return cls(torch.from_numpy(np.tile(ext, (b, 1))).to(device), len(ext))

    def valid(self) -> torch.Tensor:
        """(nb, S, S) bool: the pixels of each block inside the frame."""
        i = torch.arange(S, device=self.rects.device)
        r = self.rects.long()
        rows = (i >= r[:, 0:1]) & (i < r[:, 1:2])
        cols = (i >= r[:, 2:3]) & (i < r[:, 3:4])
        return rows[:, :, None] & cols[:, None, :]

    def inner(self) -> torch.Tensor:
        """(nb, S, S) bool: valid pixels of each block's interior, which
        tile the frame exactly once."""
        m = torch.zeros(S, S, dtype=torch.bool, device=self.rects.device)
        m[HALO:S - HALO, HALO:S - HALO] = True
        return self.valid() & m


RDB_TILE = 16   # output tile side of the RDB kernels (csrc/conv_wgmma.cuh, TS)


def tile_count(ext: BlockExtents, live: bool = False) -> int:
    """The 16x16 tiles the RDB kernels (bf16 and int8) walk over on
    ``ext``'s blocks; with ``live`` only those that meet their block's
    valid rectangle, the tiles that run products (the others store zeros,
    or x at stage 5)."""
    n = -(-S // RDB_TILE)
    if not live:
        return ext.rects.shape[0] * n * n
    r = ext.rects.long().cpu()
    t0 = torch.arange(n) * RDB_TILE
    rows = (t0[None] < r[:, 1:2]) & (t0[None] + RDB_TILE > r[:, 0:1])
    cols = (t0[None] < r[:, 3:4]) & (t0[None] + RDB_TILE > r[:, 2:3])
    return int((rows.sum(1) * cols.sum(1)).sum())


def _check_ext(ext: Optional[BlockExtents], t: torch.Tensor, name: str) -> None:
    if ext is None:
        return
    r = ext.rects
    if r.dtype != torch.int32 or tuple(r.shape) != (t.shape[0], 4) or not r.is_contiguous() \
            or r.device != t.device or tuple(t.shape[1:3]) != (S, S) \
            or t.shape[0] % ext.per_frame:
        raise ValueError(f"{name}: ext must be contiguous ({t.shape[0]}, 4) int32 "
                         f"rectangles of ({S}, {S}) blocks beside the tensor, got "
                         f"{tuple(r.shape)} {r.dtype} for {tuple(t.shape)}")


def _ext_ptr(ext: Optional[BlockExtents]):
    return None if ext is None else ext.rects.data_ptr()


def extract_blocks(feat: torch.Tensor, channels: Optional[int] = None) -> torch.Tensor:
    """(B, h, w, C) -> halo blocks (B*nh*nw, S, S, ``channels`` or C) with
    ``feat`` in channels 0:C (``extract_blocks``): zeros outside the frame;
    channels past C are left for the RDB stages to fill."""
    b, h, w, c = feat.shape
    nh, nw = grid_dims(h, w)
    xp = F.pad(feat, (0, 0, HALO, nw * BH - w + HALO, HALO, nh * BH - h + HALO))
    sb, sh, sw, sc = xp.stride()
    windows = xp.as_strided((b, nh, nw, S, S, c), (sb, BH * sh, BH * sw, sh, sw, sc))
    out = torch.empty(b, nh, nw, S, S, channels or c, dtype=feat.dtype, device=feat.device)
    out[..., :c] = windows
    return out.view(b * nh * nw, S, S, -1)


def assemble_blocks(blocks: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """Halo blocks (B*nh*nw, S, S, C >= 64) -> the frames (B, h, w, 64)
    from the interiors' channels 0:64 (``assemble_blocks``)."""
    nh, nw = grid_dims(h, w)
    x = blocks.view(b, nh, nw, S, S, -1)[:, :, :, HALO:S - HALO, HALO:S - HALO, :NF]
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, nh * BH, nw * BH, NF)[:, :h, :w].contiguous()


def _check_blocks(blocks: torch.Tensor, b: int, nh: int, nw: int) -> None:
    if blocks.dtype != torch.bfloat16 or blocks.dim() != 4 \
            or tuple(blocks.shape[:3]) != (b * nh * nw, S, S) \
            or blocks.shape[-1] not in (NF, WS_C) or not blocks.is_contiguous():
        raise ValueError(f"halo_refresh: blocks must be contiguous ({b * nh * nw}, {S}, {S}, "
                         f"64 or {WS_C}) bf16, got {tuple(blocks.shape)} {blocks.dtype}")


def halo_refresh_plain(blocks: torch.Tensor, b: int, nh: int, nw: int) -> torch.Tensor:
    """Plain PyTorch version of ``halo_refresh`` (``halo_refresh_xla``):
    the blocks rebuilt from their interiors with zeros outside the grid,
    written back over channels 0:64. -> ``blocks``."""
    _check_blocks(blocks, b, nh, nw)
    x = blocks.view(b, nh, nw, S, S, -1)
    ip = F.pad(x[:, :, :, HALO:S - HALO, HALO:S - HALO, :NF], (0, 0, 0, 0, 0, 0, 1, 1, 1, 1))
    cols = torch.cat([ip[:, :, :-2, :, BH - HALO:], ip[:, :, 1:-1],
                      ip[:, :, 2:, :, :HALO]], dim=4)
    x[..., :NF] = torch.cat([cols[:, :-2, :, BH - HALO:], cols[:, 1:-1],
                             cols[:, 2:, :, :HALO]], dim=3)
    return blocks


def halo_refresh(blocks: torch.Tensor, b: int, nh: int, nw: int) -> torch.Tensor:
    """Rebuild every block's HALO ring over channels 0:64 from its
    neighbours' interiors, in place (``halo_refresh_hbm``; the JAX
    package's ``halo_refresh`` and ``halo_refresh_xla`` give the same
    values): corners come from the diagonal neighbour, rings outside the
    grid become zero. ``blocks`` (b*nh*nw, S, S, 64 or 192) bf16. The JAX
    package's ``FW_RDB_REFRESH`` ("hbm", "dus", "concat") picks among its
    implementations of this one result; the port has one kernel, which it
    runs whatever that variable says. On a CPU tensor this runs the plain
    version; on a CUDA tensor it launches the kernel (one launch).
    -> ``blocks``."""
    _check_blocks(blocks, b, nh, nw)
    if blocks.device.type == "cpu":
        return halo_refresh_plain(blocks, b, nh, nw)
    if blocks.device.type != "cuda":
        raise ValueError(f"halo_refresh: unsupported device {blocks.device}")
    _build.check(_build.library().fw_halo_refresh(
        blocks.data_ptr(), blocks.shape[0], nh, nw, S, HALO, blocks.shape[-1],
        torch.cuda.current_stream(blocks.device).cuda_stream), "fw_halo_refresh")
    halo_refresh.launches += 1
    return blocks


halo_refresh.launches = 0


def wgmma_weights(w: torch.Tensor) -> torch.Tensor:
    """OHWI conv weights (cout, 3, 3, cin) -> the bf16 RDB and K1 kernels'
    chunk-major copy (cin / 16, 9, 2, cout, 8): a chunk of 16 input
    channels is one contiguous copy that lands, tap by tap, as wgmma's
    K-major B without swizzle (csrc/conv_wgmma.cuh, launch_conv3x3)."""
    cout, kh, kw, cin = w.shape
    return w.reshape(cout, kh * kw, cin // 16, 2, 8).permute(2, 1, 3, 0, 4).contiguous()


def wgmma_weights_s8(w: torch.Tensor) -> torch.Tensor:
    """OHWI int8 conv weights (cout, 3, 3, cin) -> the int8 RDB kernels'
    chunk-major copy (cin / 32, 9, 2, cout, 16): element (c, tap, k, n, e)
    is ``w[n, tap // 3, tap % 3, 32 c + 16 k + e]``. A chunk of 32 input
    channels is one contiguous copy that lands, tap by tap, as wgmma's
    K-major B without swizzle, the only layout 8-bit operands take; in
    bytes it is ``wgmma_weights``'s (csrc/conv_wgmma.cuh)."""
    cout, kh, kw, cin = w.shape
    return w.reshape(cout, kh * kw, cin // 32, 2, 16).permute(2, 1, 3, 0, 4).contiguous()


def wgmma_weights_s8_runs(w: torch.Tensor, run: int) -> torch.Tensor:
    """OHWI int8 conv weights (cout, 3, 3, cin) -> the pass-major copy
    (passes, cin / 32, run, 2, cout, 16) of a conv whose passes are runs of
    ``run`` taps in row-major order (csrc/conv_wgmma.cuh, TapsRuns; the
    int8 SRVGG chain's flush groups): element (p, c, s, k, n, e) is
    ``w[n, t // 3, t % 3, 32 c + 16 k + e]`` for tap t = run p + s < 9,
    else 0 (the last run's unused slots). Pass p, chunk c is one
    contiguous copy, laid out as ``wgmma_weights_s8``'s chunks."""
    cout, kh, kw, cin = w.shape
    npass = -(-kh * kw // run)
    slots = w.new_zeros(cout, npass * run, cin)
    slots[:, :kh * kw] = w.reshape(cout, kh * kw, cin)
    return (slots.reshape(cout, npass, run, cin // 32, 2, 16)
            .permute(1, 3, 2, 4, 0, 5).contiguous())


@dataclass
class RDBWeights:
    """One RDB's five convs: w[k] (cout, 3, 3, cin) bf16 (OHWI, input
    channels contiguous), b[k] (cout,) f32, and wk[k] = wgmma_weights(w[k])
    for the kernels."""
    w: List[torch.Tensor]
    b: List[torch.Tensor]
    wk: List[torch.Tensor]


def rdb_weights(convs: Sequence[torch.nn.Conv2d]) -> RDBWeights:
    """conv1..conv5 of a ResidualDenseBlock -> the kernel's layout."""
    w = [c.weight.detach().float().permute(0, 2, 3, 1).contiguous().to(torch.bfloat16)
         for c in convs]
    return RDBWeights(w=w, b=[c.bias.detach().float().contiguous() for c in convs],
                      wk=[wgmma_weights(t) for t in w])


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


def _masked(v: torch.Tensor, ext: Optional[BlockExtents]) -> torch.Tensor:
    """NCHW v with zeros outside the blocks' valid rectangles."""
    return v if ext is None else torch.where(ext.valid()[:, None], v, 0.0)


def fused_rdb_plain(ws: torch.Tensor, dst: torch.Tensor, wts: RDBWeights,
                    carry: Optional[torch.Tensor] = None,
                    ext: Optional[BlockExtents] = None) -> None:
    """Plain PyTorch version of the kernel, with its rounding points:
    stage k < 5: ws[..., 64+32(k-1):+32] = bf16(lrelu(conv + b));
    stage 5: o = bf16(bf16(0.2 (conv + b)) + x) into dst[..., :64], and
    with carry o = bf16(bf16(bf16(0.2) o) + carry[..., :64]). With ``ext``
    (halo blocks) x1..x4 and conv5 + b are 0 outside the valid rectangles."""
    for k in range(4):
        cin = NF + GC * k
        v = _masked(_lrelu(_conv(ws[..., :cin], wts.w[k], wts.b[k])), ext)
        ws[..., cin:cin + GC] = v.permute(0, 2, 3, 1).to(torch.bfloat16)
    x5 = _masked(_conv(ws, wts.w[4], wts.b[4]), ext).permute(0, 2, 3, 1)
    o = ((0.2 * x5).to(torch.bfloat16).float() + ws[..., :NF].float())
    o = o.to(torch.bfloat16)
    if carry is not None:
        o = ((BF16_0P2 * o.float()).to(torch.bfloat16).float()
             + carry[..., :NF].float()).to(torch.bfloat16)
    dst[..., :NF] = o


def fused_rdb(ws: torch.Tensor, dst: torch.Tensor, wts: RDBWeights,
              carry: Optional[torch.Tensor] = None,
              ext: Optional[BlockExtents] = None) -> None:
    """One ResidualDenseBlock over the workspace ``ws`` (B, H, W, 192)
    bf16, whose channels 0:64 hold x: x1..x4 land in ws[..., 64:192],
    the output in dst[..., :64]. With ``carry`` (the RRDB input
    workspace, which may be ``dst``) the RRDB residual is applied too.
    With ``ext`` the workspaces are halo blocks (nb, S, S, 192) and ext
    their valid rectangles. On a CPU tensor this runs the plain version;
    on a CUDA tensor it launches the kernel (five launches, one per dense
    stage)."""
    _check(ws, dst, carry)
    _check_ext(ext, ws, "fused_rdb")
    if ws.device.type == "cpu":
        fused_rdb_plain(ws, dst, wts, carry, ext)
        return
    if ws.device.type != "cuda":
        raise ValueError(f"fused_rdb: unsupported device {ws.device}")
    lib = _build.library()
    stream = torch.cuda.current_stream(ws.device).cuda_stream
    b, h, w, _ = ws.shape
    for k in range(4):
        _build.check(lib.fw_rdb_dense(ws.data_ptr(), b, h, w, NF + GC * k,
                                      wts.wk[k].data_ptr(), wts.b[k].data_ptr(),
                                      _ext_ptr(ext), stream), "fw_rdb_dense")
    _build.check(lib.fw_rdb_final(
        ws.data_ptr(), b, h, w, wts.wk[4].data_ptr(), wts.b[4].data_ptr(),
        dst.data_ptr(), None if carry is None else carry.data_ptr(), _ext_ptr(ext), stream),
        "fw_rdb_final")
    fused_rdb.launches += 1


fused_rdb.launches = 0


def new_workspace(feat: torch.Tensor) -> torch.Tensor:
    """An RDB workspace whose channels 0:64 hold ``feat`` (B, H, W, 64)."""
    b, h, w, _ = feat.shape
    ws = torch.empty(b, h, w, WS_C, dtype=torch.bfloat16, device=feat.device)
    ws[..., :NF] = feat
    return ws


def rrdb_body(feat: torch.Tensor, body: Sequence[Sequence[RDBWeights]],
              plain: bool = False) -> torch.Tensor:
    """The RRDB trunk: 3 RDBs per block (69 sweeps for 23 blocks), with
    the RRDB residual fused into each block's third RDB. ``feat``
    (B, H, W, 64) bf16 -> a workspace (B, H, W, 192) whose channels 0:64
    hold the body output (the counterpart of ``rrdb_body_merge``).
    ``plain`` runs the plain version on any device."""
    return rrdb_body_bands([feat], [body], plain=plain)[0]


def _current(device: torch.device) -> contextlib.AbstractContextManager:
    """``device`` current for a launch (the kernels launch on the current
    device's stream); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def rrdb_body_bands(feats: Sequence[torch.Tensor], bodies, bands=None,
                    plain: bool = False) -> List[torch.Tensor]:
    """The merge RRDB trunk on a frame's row bands: band i's features
    ``feats[i]`` (B, h_i, W, 64) bf16 on its device and its weights
    ``bodies[i]`` (bf16 ``RDBWeights`` or int8 ``RDBWeightsInt8``, the
    same values on every band). ``bands`` (``parallel.bands.Bands``, None
    for one band holding the whole frame) copies the halo rows from the
    band that owns them after every RDB: channels 0:64 of the bf16
    workspace, the int8 body's bf16 carry. Dynamic int8 bands quantize
    each source with the frame's range, reduced over the bands' own rows
    (``fused_rdb_dynamic_bands``). -> each band's workspace (bf16:
    (B, h_i, W, 192), the body output in channels 0:64) or carry (int8:
    (B, h_i, W, 64)). ``plain`` runs the plain versions on any device."""
    n = len(feats)
    scheme = getattr(bodies[0][0][0], "scheme", None)
    if scheme is None:
        w0 = [new_workspace(f) for f in feats]
        run = fused_rdb_plain if plain else fused_rdb
    else:
        w0 = [f.contiguous().clone() for f in feats]
        qs = [torch.empty(*w.shape[:3], WS_C, dtype=torch.int8, device=w.device) for w in w0]
        run = fused_rdb_int8_plain if plain else fused_rdb_int8
    w1 = [torch.empty_like(w) for w in w0]
    w2 = [torch.empty_like(w) for w in w0]
    owns = None if bands is None else [bands.own(i) for i in range(n)]
    for j in range(len(bodies[0])):
        for src, dst, r, carry in ((w0, w1, 0, None), (w1, w2, 1, None), (w2, w0, 2, w0)):
            wts = [body[j][r] for body in bodies]
            cs = carry or [None] * n
            if scheme == "dynamic" and n > 1:
                fused_rdb_dynamic_bands(src, qs, dst, wts, cs, owns, plain)
            else:
                for i in range(n):
                    with _current(src[i].device):
                        if scheme is None:
                            run(src[i], dst[i], wts[i], carry=cs[i])
                        else:
                            run(src[i], qs[i], dst[i], wts[i], carry=cs[i])
            if bands is not None:
                bands.exchange(dst, NF if scheme is None else None)
    return w0


# --- int8 ------------------------------------------------------------------
#
# The int8 body keeps bf16 carries (B, H, W, 64) between RDBs and one int8
# NHWC workspace Q (B, H, W, 192): channels 0:64 receive the codes of x,
# 64:192 those of x1..x4. Three schemes, as in the JAX package:
#   "i32"     static activation scales, int32 accumulation across all
#             sources with one output scale per target row
#             (rdb_wide_weights_int8_i32), the default;
#   "f32acc"  static activation scales, per-(row, source) weight scales,
#             each source's int32 sum dequantized into an f32 accumulator
#             (rdb_wide_weights_int8 with act_amax): any other
#             ``int8_scheme``;
#   "dynamic" f32acc's weights without activation ranges
#             (rdb_wide_weights_int8 without act_amax): the kernel takes
#             each source's range from the frame.
# The weight quantization below runs in numpy float32 with the JAX
# functions' operations in their order, so its results equal theirs bit
# for bit once rearranged to the wide (target-row x tap x channel) form.

INT8_SCHEMES = ("i32", "f32acc")      # the static schemes
_INV127 = float(np.float32(1.0 / 127.0))   # JAX's weakly typed 1.0 / 127.0 in f32
# (first channel, channels) of the sources x, x1..x4 in a conv's input
_SOURCES = ((0, NF),) + tuple((NF + GC * s, GC) for s in range(4))


@dataclass
class RDBWeightsInt8:
    """One RDB's five convs for the int8 kernels.

    scheme    "i32", "f32acc" or "dynamic"
    w[k]      (cout, 3, 3, cin) int8, OHWI
    scale[k]  i32: ``oscale`` (cout,); f32acc: (cout, 5) f32 of
              ws[row, src] * sa[src] per source (0 beyond conv k's);
              dynamic: (cout, 5) f32 of ws[row, src] (the kernel
              multiplies by the frame's sa[src])
    bias[k]   i32: ``obias`` (cout,); otherwise the conv bias (cout,)
    wscale[k] f32acc, dynamic: (cout, k + 1) per-(row, source) weight
              scales (``sx, s1..s4`` of the wide form); i32: None
    act_q     static: (10,) float32 numpy [sa_x, sa_1..sa_4, 1/sa_x, ..,
              1/sa_4]; dynamic: None
    wk[k]     ``wgmma_weights_s8(w[k])``, the kernels' copy (made from w
              unless given)
    """
    scheme: str
    w: List[torch.Tensor]
    scale: List[torch.Tensor]
    bias: List[torch.Tensor]
    wscale: List[Optional[torch.Tensor]]
    act_q: Optional[np.ndarray]
    wk: Optional[List[torch.Tensor]] = None

    def __post_init__(self) -> None:
        if self.wk is None:
            self.wk = [wgmma_weights_s8(t) for t in self.w]


def _conv_np(conv: torch.nn.Conv2d):
    """-> OHWI float32 weights and the float32 bias, as numpy."""
    w = conv.weight.detach().float().permute(0, 2, 3, 1).cpu().numpy()
    return np.ascontiguousarray(w), conv.bias.detach().float().cpu().numpy()


def _row_amax(w: np.ndarray, src: int) -> np.ndarray:
    """max |w| over the taps and the channels of source ``src``, per row."""
    off, n = _SOURCES[src]
    return np.abs(w[..., off:off + n]).reshape(w.shape[0], -1).max(axis=1)


def _act_scales(act_amax) -> tuple:
    amax = np.maximum(np.asarray(act_amax, np.float32), 1e-8)
    sa = amax / 127.0
    return sa, np.concatenate([sa, 1.0 / sa]).astype(np.float32)


def _quantize(w: np.ndarray, src: int, srow: np.ndarray, out: np.ndarray) -> None:
    off, n = _SOURCES[src]
    out[..., off:off + n] = np.clip(
        np.round(w[..., off:off + n] / srow[:, None, None, None]), -127, 127)


def rdb_weights_int8_i32(convs: Sequence[torch.nn.Conv2d],
                         act_amax) -> RDBWeightsInt8:
    """conv1..conv5 and the RDB's (5,) activation ranges -> the "i32"
    weights (``rdb_wide_weights_int8_i32``): the target row of conv k
    shares one scale s_t = max_src(sa_src max|w_src row| / 127) over its
    sources, W_src is quantized at s_t / sa_src, and the requant folds
    into oscale/obias (stage k < 5 in x_k's code domain)."""
    sa, act_q = _act_scales(act_amax)
    dev = convs[0].weight.device
    wq, scale, bias = [], [], []
    for k, conv in enumerate(convs):
        w, b = _conv_np(conv)
        s_t = np.zeros((w.shape[0],), np.float32)
        for src in range(k + 1):
            s_t = np.maximum(s_t, sa[src] * _row_amax(w, src) / 127.0)
        s_t = np.maximum(s_t, 1e-12)
        q = np.zeros(w.shape, np.float32)
        for src in range(k + 1):
            _quantize(w, src, s_t / sa[src], q)
        osc, ob = (s_t / sa[k + 1], b / sa[k + 1]) if k < 4 else (s_t, b)
        wq.append(torch.from_numpy(q.astype(np.int8)).to(dev))
        scale.append(torch.from_numpy(osc.astype(np.float32)).to(dev))
        bias.append(torch.from_numpy(ob.astype(np.float32)).to(dev))
    return RDBWeightsInt8("i32", wq, scale, bias, [None] * len(wq), act_q)


def rdb_weights_int8(convs: Sequence[torch.nn.Conv2d],
                     act_amax=None) -> RDBWeightsInt8:
    """conv1..conv5 and the RDB's (5,) activation ranges -> the "f32acc"
    weights (``rdb_wide_weights_int8`` with static scales): per target
    row and source, ws = max(max|w_src row|, 1e-12) / 127 and
    q = clip(round(w / ws)); the kernel dequantizes source src with
    ws * sa_src, a product formed here in float32 as the TPU kernel
    forms it. Without ``act_amax``: the "dynamic" weights (the same
    codes and ws; the kernel forms ws * sa_src from the frame's range)."""
    dynamic = act_amax is None
    sa, act_q = (None, None) if dynamic else _act_scales(act_amax)
    dev = convs[0].weight.device
    wq, scale, bias, wscale = [], [], [], []
    for k, conv in enumerate(convs):
        w, b = _conv_np(conv)
        q = np.zeros(w.shape, np.float32)
        ws = np.zeros((w.shape[0], k + 1), np.float32)
        dq = np.zeros((w.shape[0], 5), np.float32)
        for src in range(k + 1):
            ws[:, src] = np.maximum(_row_amax(w, src), 1e-12) / 127.0
            _quantize(w, src, ws[:, src], q)
            dq[:, src] = ws[:, src] if dynamic else ws[:, src] * sa[src]
        wq.append(torch.from_numpy(q.astype(np.int8)).to(dev))
        scale.append(torch.from_numpy(dq).to(dev))
        bias.append(torch.from_numpy(b.astype(np.float32)).to(dev))
        wscale.append(torch.from_numpy(ws).to(dev))
    return RDBWeightsInt8("dynamic" if dynamic else "f32acc", wq, scale, bias, wscale, act_q)


def _check_int8(x: torch.Tensor, q: torch.Tensor, dst: torch.Tensor,
                wts: RDBWeightsInt8, carry: Optional[torch.Tensor]) -> None:
    for name, t in (("x", x), ("dst", dst), ("carry", carry)):
        if t is None:
            continue
        if t.dtype != torch.bfloat16 or t.dim() != 4 or t.shape[-1] != NF:
            raise ValueError(f"fused_rdb_int8: {name} must be (B, H, W, {NF}) "
                             f"bf16, got {tuple(t.shape)} {t.dtype}")
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"fused_rdb_int8: {name} shape/device differs from x")
        if not t.is_contiguous():
            raise ValueError(f"fused_rdb_int8: {name} must be contiguous")
    if q.dtype != torch.int8 or tuple(q.shape) != (*x.shape[:3], WS_C) \
            or q.device != x.device or not q.is_contiguous():
        raise ValueError(f"fused_rdb_int8: q must be a contiguous (B, H, W, {WS_C}) "
                         f"int8 workspace beside x, got {tuple(q.shape)} {q.dtype}")
    if any(t.device != x.device for t in (*wts.w, *wts.wk, *wts.scale, *wts.bias)):
        raise ValueError("fused_rdb_int8: weights must lie on x's device")


def _conv_codes(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer 3x3 SAME conv of NHWC int8 codes with OHWI int8
    weights -> NCHW int32 (sums reach ~2.8e7, past float32's exact
    integers): the nine shifted copies of the zero-padded codes side by
    side, tap-major as the weights' layout, times the weights in one
    int8 x int8 -> int32 product."""
    b, h, wd, c = q.shape
    qp = F.pad(q, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([qp[:, u:u + h, v:v + wd] for u in range(3) for v in range(3)], dim=-1)
    acc = torch._int_mm(cols.reshape(b * h * wd, 9 * c), w.reshape(w.shape[0], 9 * c).t())
    return acc.view(b, h, wd, -1).permute(0, 3, 1, 2)


def _int8_preact(q: torch.Tensor, k: int, wts: RDBWeightsInt8,
                 sa: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Conv k's f32 pre-activation (NCHW) from the codes in q, with the
    kernel's float operations in its order. ``sa`` (B, 5): the dynamic
    scheme's activation scales per frame and source."""
    w, sc, b = wts.w[k], wts.scale[k], wts.bias[k]
    if wts.scheme == "i32":
        acc = _conv_codes(q[..., :w.shape[-1]], w).float()
        return acc * sc.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
    acc = None
    for src in range(k + 1):
        off, n = _SOURCES[src]
        part = _conv_codes(q[..., off:off + n], w[..., off:off + n]).float()
        if acc is None:
            acc = torch.zeros_like(part)
        s = sc[:, src].view(1, -1) if sa is None else sc[:, src] * sa[:, src:src + 1]
        acc = acc + part * s.view(s.shape[0], -1, 1, 1)
    return acc + b.view(1, -1, 1, 1)


def _codes(v: torch.Tensor) -> torch.Tensor:
    return torch.round(v).clamp(-127, 127).to(torch.int8)


def fused_rdb_int8_plain(x: torch.Tensor, q: torch.Tensor, dst: torch.Tensor,
                         wts: RDBWeightsInt8, carry: Optional[torch.Tensor] = None,
                         ext: Optional[BlockExtents] = None) -> None:
    """Plain PyTorch version of the int8 kernels (either scheme):
    q[..., :64] = clip(round(f32(x) inv_x)); stage k < 5 appends
    clip(round(lrelu(acc osc + ob))) (i32) or
    clip(round(lrelu(acc + b) inv_k)) (f32acc) to q; stage 5:
    o = bf16(bf16(0.2 x5) + x) into dst, and with carry
    o = bf16(bf16(bf16(0.2) o) + carry). With ``ext`` (halo blocks) the
    codes q1..q4 and x5 are 0 outside the valid rectangles. Dynamic
    weights run ``fused_rdb_dynamic_plain``."""
    if wts.scheme == "dynamic":
        fused_rdb_dynamic_plain(x, q, dst, wts, carry, ext)
        return
    inv = [float(v) for v in wts.act_q[5:]]
    q[..., :NF] = _codes(x.float() * inv[0])
    for k in range(4):
        v = _masked(_lrelu(_int8_preact(q, k, wts)), ext)
        if wts.scheme != "i32":
            v = v * inv[k + 1]
        cin = NF + GC * k
        q[..., cin:cin + GC] = _codes(v).permute(0, 2, 3, 1)
    _int8_out(_masked(_int8_preact(q, 4, wts), ext), x, dst, carry)


def _int8_out(x5: torch.Tensor, x: torch.Tensor, dst: torch.Tensor,
              carry: Optional[torch.Tensor]) -> None:
    """dst = bf16(bf16(0.2 x5) + x) from the NCHW f32 x5, then with carry
    bf16(bf16(bf16(0.2) dst) + carry)."""
    x5 = x5.permute(0, 2, 3, 1)
    o = ((0.2 * x5).to(torch.bfloat16).float() + x.float()).to(torch.bfloat16)
    if carry is not None:
        o = ((BF16_0P2 * o.float()).to(torch.bfloat16).float()
             + carry.float()).to(torch.bfloat16)
    dst.copy_(o)


def fused_rdb_dynamic_plain(x: torch.Tensor, q: torch.Tensor, dst: torch.Tensor,
                            wts: RDBWeightsInt8, carry: Optional[torch.Tensor] = None,
                            ext: Optional[BlockExtents] = None) -> torch.Tensor:
    """Plain PyTorch version of the dynamic-scale kernel, with the JAX
    kernel's operations (``_rdb_kernel_int8``) and ranges per frame: for
    each source s (a_0 = f32(x), a_k = lrelu(conv k + b) in f32) amax_s =
    max|a_s| over the frame, the codes clip(rint(a_s f32(127 / max(amax_s,
    1e-8)))) into q, and conv k dequantizes source s with f32(ws_row
    sa_s), sa_s = max(amax_s, 1e-8) f32(1/127); the output as
    ``fused_rdb_int8_plain``. With ``ext`` (halo blocks, ``per_frame`` to a
    frame) a_1..a_4 are 0 outside the valid rectangles and their ranges
    are taken over the valid interiors, which tile the frame once; the
    range of x over whole blocks, whose rings hold copies of interior
    pixels or zeros. -> amax (frames, 5) f32."""
    return _finish(_dynamic_plain_steps(x, q, dst, wts, carry, ext))


def _finish(steps):
    """Run a dynamic RDB's steps that ask for no range (``own`` None) ->
    their result."""
    try:
        next(steps)
    except StopIteration as done:
        return done.value
    raise RuntimeError("a dynamic RDB without own rows asked for a range")


def _dynamic_plain_steps(x, q, dst, wts, carry=None, ext=None, own=None):
    """``fused_rdb_dynamic_plain`` as a generator. With ``own`` = (a, b)
    (a row band of a frame, ``fused_rdb_dynamic_bands``) it yields each
    source's range over the tensor's rows [a, b) (frames,) before it
    quantizes that source, and quantizes with the range it is sent
    back (the frame's, over every band); the range of x over the whole
    tensor, whose rows are all the frame's."""
    per = 1 if ext is None else ext.per_frame
    inner = None if ext is None else ext.inner()
    amax = torch.zeros(x.shape[0] // per, 5, dtype=torch.float32, device=x.device)

    def quantize(a: torch.Tensor, src: int, rng: torch.Tensor) -> None:
        amax[:, src] = rng
        r = amax[:, src].clamp_min(1e-8)
        inv = torch.full_like(r, 127.0) / r     # IEEE division, as 127.0 / amax
        off, n = _SOURCES[src]
        q[..., off:off + n] = _codes(a * inv.repeat_interleave(per).view(-1, 1, 1, 1))

    def local(a: torch.Tensor, src: int) -> torch.Tensor:   # a: NHWC f32
        m = a.abs().amax(dim=3)
        if inner is not None and src > 0:
            m = torch.where(inner, m, 0.0)
        if own is not None and src > 0:
            m = m[:, own[0]:own[1]]
        return m.reshape(amax.shape[0], -1).amax(dim=1)

    def scales() -> torch.Tensor:   # (images or blocks, 5)
        return (amax.clamp_min(1e-8) * _INV127).repeat_interleave(per, dim=0)

    a = x.float()
    rng = local(a, 0)
    quantize(a, 0, rng if own is None else (yield rng))
    for k in range(4):
        v = _masked(_lrelu(_int8_preact(q, k, wts, scales())), ext).permute(0, 2, 3, 1)
        rng = local(v, k + 1)
        quantize(v, k + 1, rng if own is None else (yield rng))
    _int8_out(_masked(_int8_preact(q, 4, wts, scales()), ext), x, dst, carry)
    return amax


def _int8_rdb(x: torch.Tensor, q: torch.Tensor, dst: torch.Tensor,
              wts: RDBWeightsInt8, carry: Optional[torch.Tensor],
              ext: Optional[BlockExtents]) -> bool:
    """One int8 RDB; True when it launched the CUDA kernels (a CUDA
    tensor), False when it ran the plain version (a CPU tensor)."""
    _check_int8(x, q, dst, wts, carry)
    _check_ext(ext, x, "fused_rdb_int8")
    if x.device.type == "cpu":
        fused_rdb_int8_plain(x, q, dst, wts, carry, ext)
        return False
    if x.device.type != "cuda":
        raise ValueError(f"fused_rdb_int8: unsupported device {x.device}")
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    b, h, w, _ = x.shape
    f32acc = int(wts.scheme != "i32")
    inv = [float(v) for v in wts.act_q[5:]]
    _build.check(lib.fw_rdb_i8_quant(x.data_ptr(), q.data_ptr(), b * h * w, inv[0],
                                     stream), "fw_rdb_i8_quant")
    for k in range(4):
        _build.check(lib.fw_rdb_i8_dense(
            q.data_ptr(), b, h, w, NF + GC * k, wts.wk[k].data_ptr(),
            wts.scale[k].data_ptr(), wts.bias[k].data_ptr(), inv[k + 1], f32acc,
            _ext_ptr(ext), stream), "fw_rdb_i8_dense")
    _build.check(lib.fw_rdb_i8_final(
        q.data_ptr(), b, h, w, wts.wk[4].data_ptr(), wts.scale[4].data_ptr(),
        wts.bias[4].data_ptr(), f32acc, x.data_ptr(), dst.data_ptr(),
        None if carry is None else carry.data_ptr(), _ext_ptr(ext), stream), "fw_rdb_i8_final")
    return True


def fused_rdb_i32(x: torch.Tensor, q: torch.Tensor, dst: torch.Tensor,
                  wts: RDBWeightsInt8, carry: Optional[torch.Tensor] = None,
                  ext: Optional[BlockExtents] = None) -> None:
    """The "i32" int8 RDB (see ``fused_rdb_int8``)."""
    if wts.scheme != "i32":
        raise ValueError(f"fused_rdb_i32: weights of scheme {wts.scheme!r}")
    if _int8_rdb(x, q, dst, wts, carry, ext):
        fused_rdb_i32.launches += 1


def fused_rdb_f32acc(x: torch.Tensor, q: torch.Tensor, dst: torch.Tensor,
                     wts: RDBWeightsInt8, carry: Optional[torch.Tensor] = None,
                     ext: Optional[BlockExtents] = None) -> None:
    """The "f32acc" int8 RDB (see ``fused_rdb_int8``)."""
    if wts.scheme != "f32acc":
        raise ValueError(f"fused_rdb_f32acc: weights of scheme {wts.scheme!r}")
    if _int8_rdb(x, q, dst, wts, carry, ext):
        fused_rdb_f32acc.launches += 1


def fused_rdb_dynamic(x: torch.Tensor, q: torch.Tensor, dst: torch.Tensor,
                      wts: RDBWeightsInt8, carry: Optional[torch.Tensor] = None,
                      ext: Optional[BlockExtents] = None) -> torch.Tensor:
    """The dynamic-scale int8 RDB (see ``fused_rdb_int8``); returns the
    frames' ranges amax (frames, 5) f32 of [x, x1..x4], which its scales
    use as max(amax, 1e-8). On a CUDA tensor: a reduction of max|x| per
    frame, the codes of x, four dense stages (each writes its f32
    activation to a scratch and folds its range into amax on the device,
    then a launch quantizes the scratch) and stage 5: eleven launches.
    With ``ext`` a frame is ``ext.per_frame`` halo blocks, and the dense
    stages fold in only the valid interior pixels."""
    if wts.scheme != "dynamic":
        raise ValueError(f"fused_rdb_dynamic: weights of scheme {wts.scheme!r}")
    _check_int8(x, q, dst, wts, carry)
    _check_ext(ext, x, "fused_rdb_dynamic")
    if x.device.type == "cpu":
        return fused_rdb_dynamic_plain(x, q, dst, wts, carry, ext)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rdb_dynamic: unsupported device {x.device}")
    amax = _finish(_dynamic_launches(x, q, dst, wts, carry, ext))
    fused_rdb_dynamic.launches += 1
    return amax


def _dynamic_launches(x, q, dst, wts, carry=None, ext=None, own=None):
    """``fused_rdb_dynamic``'s launches as a generator; ``own`` as for
    ``_dynamic_plain_steps``: the range a dense stage folded into amax on
    the device (over the whole tensor) is replaced by the frame's before
    its quantize launch."""
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    b, h, w, _ = x.shape
    per, halo = (1, 0) if ext is None else (ext.per_frame, HALO)
    frames, pix_frame = b // per, per * h * w
    amax = torch.zeros(frames, 5, dtype=torch.float32, device=x.device)
    act = torch.empty(b, h, w, GC, dtype=torch.float32, device=x.device)
    _build.check(lib.fw_rdb_dyn_absmax(x.data_ptr(), frames, pix_frame, amax.data_ptr(),
                                       stream), "fw_rdb_dyn_absmax")
    if own is not None:
        amax[:, 0] = yield amax[:, 0].clone()
    _build.check(lib.fw_rdb_dyn_quant(x.data_ptr(), 0, NF, q.data_ptr(), 0, frames, pix_frame,
                                      amax.data_ptr(), 0, stream), "fw_rdb_dyn_quant")
    for k in range(4):
        cin = NF + GC * k
        _build.check(lib.fw_rdb_dyn_dense(
            q.data_ptr(), b, h, w, cin, wts.wk[k].data_ptr(), wts.scale[k].data_ptr(),
            wts.bias[k].data_ptr(), amax.data_ptr(), act.data_ptr(), _ext_ptr(ext), per,
            halo, stream), "fw_rdb_dyn_dense")
        if own is not None:
            amax[:, k + 1] = yield act[:, own[0]:own[1]].abs().amax(dim=(1, 2, 3))
        _build.check(lib.fw_rdb_dyn_quant(act.data_ptr(), 1, GC, q.data_ptr(), cin, frames,
                                          pix_frame, amax.data_ptr(), k + 1, stream),
                     "fw_rdb_dyn_quant")
    _build.check(lib.fw_rdb_dyn_final(
        q.data_ptr(), b, h, w, wts.wk[4].data_ptr(), wts.scale[4].data_ptr(),
        wts.bias[4].data_ptr(), amax.data_ptr(), x.data_ptr(), dst.data_ptr(),
        None if carry is None else carry.data_ptr(), _ext_ptr(ext), per, stream),
        "fw_rdb_dyn_final")
    return amax


def fused_rdb_dynamic_bands(xs, qs, dsts, wts, carries, owns, plain: bool = False) -> None:
    """One dynamic-scale RDB on a frame's row bands (``parallel.bands``):
    band i's x ``xs[i]``, its code workspace ``qs[i]``, output ``dsts[i]``,
    carry ``carries[i]`` (or None), weights ``wts[i]`` on its device and
    its own rows ``owns[i]``. The bands run in step: before each source is
    quantized, its range over each band's own rows is reduced (max) over
    the bands, so every band quantizes with the frame's range and its own
    rows equal the unsplit RDB's. A CUDA band launches its kernels and
    counts once on ``fused_rdb_dynamic`` when its last launch is made; a
    CPU band (or ``plain``) runs the plain version."""
    gens, devs, kernel = [], [], []
    for x, q, dst, w, carry, own in zip(xs, qs, dsts, wts, carries, owns):
        if w.scheme != "dynamic":
            raise ValueError(f"fused_rdb_dynamic_bands: weights of scheme {w.scheme!r}")
        _check_int8(x, q, dst, w, carry)
        cuda = x.device.type == "cuda" and not plain
        if x.device.type not in ("cuda", "cpu"):
            raise ValueError(f"fused_rdb_dynamic_bands: unsupported device {x.device}")
        gens.append((_dynamic_launches if cuda else _dynamic_plain_steps)(
            x, q, dst, w, carry, None, own))
        devs.append(x.device)
        kernel.append(cuda)

    def step(i, value=None):
        with _current(devs[i]):
            try:
                return gens[i].send(value)
            except StopIteration:
                if kernel[i]:
                    fused_rdb_dynamic.launches += 1
                return None

    ranges = [step(i) for i in range(len(gens))]
    while ranges[0] is not None:
        m = torch.stack([r.to(devs[0]) for r in ranges]).amax(dim=0)
        ranges = [step(i, m.to(devs[i])) for i in range(len(gens))]


fused_rdb_i32.launches = 0
fused_rdb_f32acc.launches = 0
fused_rdb_dynamic.launches = 0


def fused_rdb_int8(x: torch.Tensor, q: torch.Tensor, dst: torch.Tensor,
                   wts: RDBWeightsInt8, carry: Optional[torch.Tensor] = None,
                   ext: Optional[BlockExtents] = None) -> None:
    """One int8 ResidualDenseBlock: ``x`` (B, H, W, 64) bf16 in, the
    workspace ``q`` (B, H, W, 192) int8 for the codes of x and x1..x4, the
    output in ``dst`` (B, H, W, 64) bf16; with ``carry`` the RRDB residual
    too. ``dst`` may be ``x`` or ``carry``. On a CPU tensor this runs the
    plain version; on a CUDA tensor it launches the kernels of the
    weights' scheme (static: six launches, the codes of x and the five
    stages) and counts one call on ``fused_rdb_i32``, ``fused_rdb_f32acc``
    or ``fused_rdb_dynamic``. ``ext``: as for ``fused_rdb``."""
    {"i32": fused_rdb_i32, "f32acc": fused_rdb_f32acc,
     "dynamic": fused_rdb_dynamic}[wts.scheme](x, q, dst, wts, carry, ext)


def rrdb_body_int8(feat: torch.Tensor, body: Sequence[Sequence[RDBWeightsInt8]],
                   plain: bool = False) -> torch.Tensor:
    """The int8 RRDB trunk (the counterpart of ``rrdb_body_merge_blocks``
    on int8 fast params, and of ``rrdb_body_fast_roundtrip`` on f32acc
    and dynamic ones): 3 RDBs per block, the RRDB residual fused into
    each block's third RDB for every scheme (the JAX package fuses it
    into the "i32" kernel and applies it in XLA for the others, with the
    same rounding points). ``feat`` (B, H, W, 64) bf16 -> the body output,
    (B, H, W, 64) bf16. ``plain`` runs the plain versions on any device
    (a reference for the kernels on the card)."""
    return rrdb_body_bands([feat], [body], plain=plain)[0]


# --- body selection ------------------------------------------------------


def rrdb_body_roundtrip(feat: torch.Tensor, body, plain: bool = False) -> torch.Tensor:
    """The round-trip RRDB trunk (counterpart of ``rrdb_body_fast_roundtrip``)
    for bf16, f32acc and dynamic weights: ``feat`` (B, H, W, 64) bf16 ->
    the body output (B, H, W, 64) bf16.

    On the card it is the merge body's loop: the TPU's two bodies differ
    in how blocks reach VMEM (resident blocks with an in-kernel ring
    merge, against an extraction and assembly around every RDB) and in
    where the RRDB residual bf16(bf16(bf16(0.2) o) + carry) runs (in the
    kernel, or in XLA), and neither changes a rounding point, since the
    port's RDB reads its halo from device memory and its carry launch
    rounds as XLA's residual does. The bf16 RDB here is ``_rdb_kernel``'s
    math, the f32acc one ``_rdb_kernel_int8_static``'s, the dynamic one
    ``_rdb_kernel_int8``'s."""
    scheme = getattr(body[0][0], "scheme", None)
    if scheme == "i32":
        raise ValueError("rrdb_body_roundtrip: i32 weights run on the merge body only")
    if scheme is None:
        return rrdb_body(feat, body, plain)[..., :NF]
    return rrdb_body_int8(feat, body, plain)


def rrdb_body_resident(feat: torch.Tensor, body, plain: bool = False) -> torch.Tensor:
    """The RRDB trunk on resident halo blocks (counterpart of
    ``rrdb_body_resident``) for bf16, f32acc and dynamic weights: the
    frames are cut into halo blocks once (``extract_blocks``), each RDB
    runs on the blocks with their valid rectangles, ``halo_refresh``
    rebuilds the rings after every RDB (3 refreshes per RRDB, 69 for 23
    blocks), and the interiors are assembled once at the end. The RRDB
    residual bf16(bf16(bf16(0.2) o) + carry) runs in the third RDB's carry
    launch over whole blocks, as the JAX loop applies it in XLA. Each
    interior pixel sees the arithmetic of the merge body (bf16) or the
    round-trip body (f32acc, dynamic, whose ranges the interiors give per
    frame), so the result equals theirs. ``feat`` (B, H, W, 64) bf16 ->
    (B, H, W, 64) bf16; ``plain`` runs the plain versions on any device."""
    scheme = getattr(body[0][0], "scheme", None)
    if scheme == "i32":
        raise ValueError("rrdb_body_resident: i32 weights run on the merge body only")
    b, h, w, _ = feat.shape
    nh, nw = grid_dims(h, w)
    ext = BlockExtents.of(b, h, w, feat.device)
    if scheme is None:      # bf16: 192-channel block workspaces
        w0 = extract_blocks(feat, WS_C)
        run = fused_rdb_plain if plain else fused_rdb
    else:                   # int8: 64-channel bf16 carries and one code workspace
        w0 = extract_blocks(feat)
        q = torch.empty(*w0.shape[:3], WS_C, dtype=torch.int8, device=w0.device)
        run_int8 = fused_rdb_int8_plain if plain else fused_rdb_int8

        def run(x, dst, wts, carry=None, ext=None):
            run_int8(x, q, dst, wts, carry, ext)

    refresh = halo_refresh_plain if plain else halo_refresh
    w1, w2 = torch.empty_like(w0), torch.empty_like(w0)
    for rdb1, rdb2, rdb3 in body:
        run(w0, w1, rdb1, ext=ext)
        run(refresh(w1, b, nh, nw), w2, rdb2, ext=ext)
        run(refresh(w2, b, nh, nw), w0, rdb3, carry=w0, ext=ext)
        refresh(w0, b, nh, nw)
    return assemble_blocks(w0, b, h, w)


def resident_requested() -> bool:
    """Whether ``FW_RDB_BODY=resident`` (or ``FW_RDB_RESIDENT=1``) asks for
    the resident body."""
    return (os.environ.get("FW_RDB_BODY", "merge") == "resident"
            or os.environ.get("FW_RDB_RESIDENT", "0") == "1")


def rrdb_body_fast(feat: torch.Tensor, body, plain: bool = False) -> torch.Tensor:
    """The RRDB trunk by ``FW_RDB_BODY`` (counterpart of the JAX
    ``rrdb_body_fast``): "merge" (the default), "resident" (or
    ``FW_RDB_RESIDENT=1``: ``rrdb_body_resident``) or "roundtrip" (any
    other value, as in the JAX package); "i32" weights always run the
    merge body, and dynamic weights the round-trip body unless
    "resident" is asked for. -> (B, H, W, 64) bf16."""
    kind = "resident" if resident_requested() else os.environ.get("FW_RDB_BODY", "merge")
    scheme = getattr(body[0][0], "scheme", None)
    if scheme == "i32":
        kind = "merge"
    if kind == "resident":
        return rrdb_body_resident(feat, body, plain)
    if kind != "merge" or scheme == "dynamic":
        return rrdb_body_roundtrip(feat, body, plain)
    if scheme is None:
        return rrdb_body(feat, body, plain)[..., :NF]
    return rrdb_body_int8(feat, body, plain)
