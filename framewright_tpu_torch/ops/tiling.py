"""Overlap-tiled inference of an SR model over frames: the port of
``framewright_tpu.ops.tiling`` on NHWC tensors.

A frame is padded (bottom and right, reflect) to the model's body
divisor, then cut into a grid of fixed-size windows of ``tile + 2 *
halo`` pixels; the model runs on batches of ``plan.batch`` windows and
each window's interior is stitched back. JAX's geometry is kept: the
window's extent is aligned to the divisor and the halo taken from the
aligned extent (``o2 = (full - tile) // 2``); windows are clamped inside
the divisor-aligned canvas (near a border a window slides inward and its
interior offset moves with it), with no padding to the tile grid, so the
last band's interior is narrower; each window's interior is cropped on
its own. Border pixels then equal whole-frame inference, and interior
pixels equal it wherever the halo covers the receptive field. A frame
whose aligned extent cannot hold one window runs whole
(``whole_frame_apply``).

No kernel of its own: ``fn`` is the model's path (the RRDB kernels on
tiles in the SR processor).
"""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.nn.functional as F


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_mod(x: torch.Tensor, bottom: int, right: int) -> torch.Tensor:
    """Bottom/right alignment padding of NHWC ``x``, reflect mode (edge
    when the pad exceeds the reflectable extent)."""
    if bottom == 0 and right == 0:
        return x
    h, w = x.shape[1], x.shape[2]
    mode = "reflect" if bottom < h and right < w else "replicate"
    y = F.pad(x.permute(0, 3, 1, 2).float(), (0, right, 0, bottom), mode=mode)
    return y.to(x.dtype).permute(0, 2, 3, 1)


def _chunked(fn: Callable, x: torch.Tensor, chunk: int) -> torch.Tensor:
    """``fn`` over the leading axis in chunks of ``chunk`` (the last may
    hold fewer: no padding to a static shape is needed here), written into
    one output (no second copy of the outputs, as a concatenation makes)."""
    out = None
    for i in range(0, x.shape[0], chunk):
        y = fn(x[i:i + chunk].contiguous())
        if out is None:
            out = y.new_empty((x.shape[0],) + tuple(y.shape[1:]))
        out[i:i + len(y)] = y
        del y
    return out


def whole_frame_apply(fn: Callable, x: torch.Tensor, plan) -> torch.Tensor:
    """``fn`` over whole frames, ``plan.batch`` at a time, after padding
    to the model's body divisor."""
    b, h, w, c = x.shape
    s, u = plan.scale, plan.body_divisor
    xp = pad_mod(x, _ceil_to(h, u) - h, _ceil_to(w, u) - w)
    y = _chunked(fn, xp, max(plan.batch, 1))
    return y[:, : h * s, : w * s, :]


def _window_starts(extent: int, tile: int, overlap: int, n: int) -> List[int]:
    """Clamped start offsets of fixed-size windows along one axis."""
    full = tile + 2 * overlap
    return [max(0, min(i * tile - overlap, extent - full)) for i in range(n)]


def window_geometry(h: int, w: int, plan):
    """(full, row starts, col starts, canvas height, canvas width) of
    ``plan``'s windows over (h, w) frames, or None when a frame runs
    whole."""
    ts, o, u = plan.tile_size, plan.overlap, plan.body_divisor
    full = _ceil_to(ts + 2 * o, u)
    o2 = (full - ts) // 2
    hp, wp = _ceil_to(h, u), _ceil_to(w, u)
    if hp < full or wp < full:
        return None
    nh, nw = -(-hp // ts), -(-wp // ts)
    return full, _window_starts(hp, ts, o2, nh), _window_starts(wp, ts, o2, nw), hp, wp


def windows(x: torch.Tensor, plan) -> torch.Tensor:
    """The windows of frames x (B, H, W, C) by a tiled ``plan``, frame by
    frame and row by row: (B * tiles, full, full, C)."""
    b, h, w, c = x.shape
    full, row_starts, col_starts, hp, wp = window_geometry(h, w, plan)
    xp = pad_mod(x, hp - h, wp - w)
    return torch.stack([xp[:, r:r + full, q:q + full] for r in row_starts for q in col_starts],
                       dim=1).reshape(-1, full, full, c)


def tiled_apply(fn: Callable, x: torch.Tensor, plan) -> torch.Tensor:
    """An SR-like ``fn`` ((N, h, w, C) -> (N, h*s, w*s, C')) over frames
    x (B, H, W, C) by ``plan``: windows in batches of ``plan.batch``
    when ``plan.tiled``, else whole frames."""
    if not plan.tiled:
        return whole_frame_apply(fn, x, plan)
    b, h, w, c = x.shape
    geo = window_geometry(h, w, plan)
    if geo is None:
        return whole_frame_apply(fn, x, plan)
    full, row_starts, col_starts, hp, wp = geo
    s, ts = plan.scale, plan.tile_size
    nh, nw = len(row_starts), len(col_starts)
    out = _chunked(fn, windows(x, plan), max(plan.batch, 1))
    out = out.reshape(b, nh * nw, full * s, full * s, out.shape[-1])
    # band i covers canvas rows [i*ts, min((i+1)*ts, hp)) at offset
    # (i*ts - start) in its window; each interior is copied into its place
    y = out.new_empty((b, hp * s, wp * s, out.shape[-1]))
    for i in range(nh):
        bh = min((i + 1) * ts, hp) - i * ts
        oi = (i * ts - row_starts[i]) * s
        for j in range(nw):
            bw = min((j + 1) * ts, wp) - j * ts
            oj = (j * ts - col_starts[j]) * s
            y[:, i * ts * s:(i * ts + bh) * s, j * ts * s:(j * ts + bw) * s] = \
                out[:, i * nw + j, oi:oi + bh * s, oj:oj + bw * s]
    return y[:, : h * s, : w * s, :]


def receptive_overlap(family: str) -> int:
    """The default halo: large enough that trained weights' contributions
    from beyond it are below sight (Real-ESRGAN's own tile_pad is 10)."""
    return {"rrdb": 10, "srvgg": 10, "nafnet": 16, "restormer": 16}.get(family, 16)
