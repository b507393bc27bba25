#!/usr/bin/env python3
"""Per-part times of the quality gate's stats (the SR pass's
``device_stats``, framewright_tpu_torch/processors/super_resolution.py
``_frame_stats``) on one GPU.

    python3 scripts/torch_stats_stages.py [--iters N] [--profile]

Times with CUDA events, for one frame of each kind the restore scores: the
Y plane of a 1080p -> 4K x2 frame (RRDB: luma stats, the reference the
bicubic resize of the 1920x1080 input's luma) and the RGB image of a
960x540 -> 4K x4 frame (SRVGG), on seeded random data, each part of
``_frame_stats`` in its order: the input's luma (Y only), the bicubic
resize (``layers.resize_bicubic``: two f32 matrix products), the PSNR,
the SSIM (``ops.metrics.ssim_per_frame``), luma / std / finite; then the
whole call, and its peak device memory above what was allocated before
it. Beside them, variants that the package does not run: the resize as
a weighted sum of gathered taps (4 a pass when upsampling), alone and
inside the whole call as the package ran it before (the taps on the RGB
input, then the reference's luma), and the SSIM's two filter passes as
depthwise convolutions (``groups=5``) instead of a batch of
single-channel ones. All in f32 with TF32 off.
With ``--profile`` also torch.profiler's device time per kernel of the
whole call. Prints the card's name and power limit, then one JSON line.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from framewright_tpu_torch.hw import full_f32  # noqa: E402
from framewright_tpu_torch.models.layers import cubic_weights, resize_bicubic  # noqa: E402
from framewright_tpu_torch.ops import metrics  # noqa: E402
from framewright_tpu_torch.processors.super_resolution import _frame_stats  # noqa: E402


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def peak_mb(fn) -> float:
    """Device memory fn allocates at its peak above what was allocated
    before it (MB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


@functools.lru_cache(maxsize=8)
def _taps(n_in: int, n_out: int, device: torch.device):
    """``cubic_weights`` as taps: for each output, the K input indices
    from its first nonzero weight on and their f32 weights (0 past its
    last) -> ((K, n_out) int64, (K, n_out) f32) on ``device``, built once."""
    m = cubic_weights(n_in, n_out)
    nz = m != 0
    lo = np.where(nz.any(axis=1), nz.argmax(axis=1), 0)
    hi = np.where(nz.any(axis=1), n_in - 1 - nz[:, ::-1].argmax(axis=1), 0)
    idx = lo[None, :] + np.arange(int((hi - lo).max()) + 1)[:, None]
    w = np.where(idx <= hi[None, :], m[np.arange(n_out)[None, :], np.minimum(idx, n_in - 1)], 0.0)
    return (torch.from_numpy(np.minimum(idx, n_in - 1)).to(device),
            torch.from_numpy(w.astype(np.float32)).to(device))


def _taps_axis(x: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    idx, w = _taps(x.shape[dim], n_out, x.device)
    shape = [1] * x.dim()
    shape[dim] = n_out
    out = None
    for i, wi in zip(idx, w):
        term = x.index_select(dim, i).mul_(wi.view(shape))
        out = term if out is None else out.add_(term)
    return out


def taps_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """The resize as gathered taps (the variant), width pass first."""
    return _taps_axis(_taps_axis(x.float(), 2, out_hw[1]), 1, out_hw[0])


def stats_previous(yf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``_frame_stats`` as the package ran it before: the taps resize of
    the RGB input, then the reference's luma on the Y path."""
    ref = taps_resize(x, yf.shape[1:3])
    if yf.shape[-1] == 1:
        ref = luma(ref)
    y255 = yf * 255.0
    return torch.stack([metrics.psnr_per_frame(yf, ref)[0], metrics.ssim_per_frame(yf, ref)[0],
                        y255.mean(), y255.std(correction=0),
                        torch.isfinite(yf).all().float()])


def ssim_depthwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ssim_per_frame's plane math with the filter as depthwise convs."""
    g = metrics._gaussian_1d(a.device)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    out = []
    for k in range(a.shape[-1]):
        pa, pb = a[0, ..., k], b[0, ..., k]
        q = torch.stack([pa, pb, pa * pa, pb * pb, pa * pb])[None]     # (1, 5, H, W)
        q = F.conv2d(q, g.view(1, 1, 1, -1).expand(5, 1, 1, -1), groups=5)
        q = F.conv2d(q, g.view(1, 1, -1, 1).expand(5, 1, -1, 1), groups=5)[0]
        mu_a, mu_b, e_aa, e_bb, e_ab = q
        mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
        num = (2 * mu_ab + c1) * (2 * (e_ab - mu_ab) + c2)
        den = (mu_aa + mu_bb + c1) * ((e_aa - mu_aa) + (e_bb - mu_bb) + c2)
        out.append((num / den).mean())
    return torch.stack(out).mean()


def filter_passes(plane: torch.Tensor, iters: int) -> dict:
    """The SSIM filter's two passes alone on five planes the size of
    ``plane`` (H, W): conv2d (1 x 11) along rows and (11 x 1) along
    columns as the package runs them, with cuDNN's autotuner on
    (``benchmark``), and the row pass as conv1d on a batch of rows."""
    g = metrics._gaussian_1d(plane.device)
    q = plane.expand(5, 1, *plane.shape).contiguous()
    qr = F.conv2d(q, g.view(1, 1, 1, -1))
    out = {}
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        tag = " benchmark" if bench else ""
        out["rows (1x11)" + tag] = cuda_ms(lambda: F.conv2d(q, g.view(1, 1, 1, -1)), iters)
        out["columns (11x1)" + tag] = cuda_ms(lambda: F.conv2d(qr, g.view(1, 1, -1, 1)), iters)
    torch.backends.cudnn.benchmark = False
    h, w = plane.shape
    out["rows as conv1d"] = cuda_ms(
        lambda: F.conv1d(q.view(5 * h, 1, w), g.view(1, 1, -1)), iters)
    return out


def luma(ref: torch.Tensor) -> torch.Tensor:
    return (0.299 * ref[..., 0] + 0.587 * ref[..., 1] + 0.114 * ref[..., 2])[..., None]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--profile", action="store_true",
                    help="torch.profiler's device time per kernel of the whole call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stats_stages: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    res = {"device": torch.cuda.get_device_name(0), "iters": args.iters}
    for kind, (h, w, s, c) in {"rrdb_y_x2_1080p": (1080, 1920, 2, 1),
                               "srvgg_rgb_x4_540p": (540, 960, 4, 3)}.items():
        oh, ow = h * s, w * s
        x = torch.from_numpy(rng.random((1, h, w, 3), dtype=np.float32)).to(dev)
        x = x.to(torch.bfloat16)
        yf = torch.from_numpy(rng.random((1, oh, ow, c), dtype=np.float32)).to(dev)
        with full_f32(), torch.no_grad():
            xin = luma(x.float()) if c == 1 else x
            ref = resize_bicubic(xin, (oh, ow))
            parts = {
                "input luma": lambda: luma(x.float()),
                "resize": lambda: resize_bicubic(xin, (oh, ow)),
                "resize, gathered taps (variant)": lambda: taps_resize(xin, (oh, ow)),
                "psnr": lambda: metrics.psnr_per_frame(yf, ref),
                "ssim": lambda: metrics.ssim_per_frame(yf, ref),
                "ssim depthwise (variant)": lambda: ssim_depthwise(yf, ref),
                "luma, std, finite": lambda: torch.stack([
                    (yf * 255).mean(), (yf * 255).std(correction=0),
                    torch.isfinite(yf).all().float()]),
                "whole _frame_stats": lambda: _frame_stats(yf, x),
                "whole, as before (taps on RGB, then luma)": lambda: stats_previous(yf, x),
            }
            if c == 3:
                del parts["input luma"]
            taps_err = (taps_resize(xin, (oh, ow)) - ref).abs().max().item()
            prev_err = (_frame_stats(yf, x) - stats_previous(yf, x)).abs().max().item()
            dw_err = abs(ssim_depthwise(yf, ref).item() - metrics.ssim_per_frame(yf, ref).item())
            times = {name: cuda_ms(fn, args.iters) for name, fn in parts.items()}
            peaks = {"whole _frame_stats": peak_mb(lambda: _frame_stats(yf, x)),
                     "whole, as before": peak_mb(lambda: stats_previous(yf, x))}
            cin = xin.shape[-1]
            rec = {"shape_in": [1, h, w, 3], "shape_out": [1, oh, ow, c], "ms": times,
                   "peak_mb": peaks,
                   "ssim_filter_passes_ms": filter_passes(yf[0, ..., 0], args.iters),
                   "taps_vs_matmul_max_abs": taps_err, "before_vs_now_stats_max_abs": prev_err,
                   "depthwise_vs_batch_ssim_abs": dw_err,
                   "resize_gflop": 2 * (h * cin * w * ow + oh * h * cin * ow) / 1e9}
            if args.profile:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    _frame_stats(yf, x)
                    torch.cuda.synchronize()
                rec["profile_top_device_us"] = {
                    e.key[:80]: round(e.device_time_total, 1)
                    for e in sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:12]}
        res[kind] = rec
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
