#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (framewright_tpu_torch) on one GPU.

    python3 chip_smoke.py [--frames N] [--iters N]

Phases, one JSON object per line on stdout:
  1. device   the card (nvidia-smi name and power limit, torch's name)
  2. build    the kernels from a clean build directory (one nvcc per
              source, all at once, then one link)
  3. kernels  each kernel against its plain PyTorch version on the card,
              at the main-path shapes (RRDB body 540x960x64, tail out to
              2160x3840; SRVGG chain 540x960x64, g=8) and the chains also
              at a ragged 2x37x53x64, g=2: the bf16 RDB and its residual
              variant, both int8 RDBs (i32 and f32acc, codes x1..x4 and
              bf16 output, with and without the residual), K1, K2 in its
              three output modes, the bf16 SRVGG chain, and the int8 chain
              (every code and the bf16 output)
  4. model    one frame through each model's kernel path against the
              plain f32 ``apply``: RealESRGAN_x2plus (23 blocks, seeded
              random weights) and FW_fast6_x2 (trained) at 1080p,
              realesr-animevideov3 (16 convs, x4, seeded random weights)
              at 960x540 and FW_fastvgg_x2 (trained) at 1080p, all to 4K;
              their uint8 outputs against the epilogue of their own
              output; the int8 kernel paths (scales calibrated on the
              frame's centre crop) of the trained models against their
              bf16 kernel paths (PSNR) and of the random-weight models
              against their int8 plain paths; the SRVGG peaks against
              the planner's count
  5. restore  the user's entry point, ``python -m framewright_tpu_torch.cli
              restore``, on seeded synthetic 4:2:0 clips: 1080p with
              RealESRGAN_x2plus in bf16, in int8 (default scheme i32) and
              in int8 with FW_INT8_SCHEME=f32acc; 960x540 with
              realesr-animevideov3 in bf16 and in int8; each with every
              launch counter set to 0 just before and read just after;
              output size, frame count and every frame checked against
              the kernel path
  6. times    each kernel by CUDA events beside its plain version, its
              roofline bound and, for the bf16 RDB, K1 and the bf16
              chain, cuDNN's F.conv2d (PyTorch has no single int8 3x3
              convolution call)
Then nvidia-smi's line, the kernel summary line, and the result line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
the result line. Without a CUDA device, or without the package beside
this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 peak
PEAK_INT8_OPS = 1979e12       # H100 SXM dense int8 peak
PEAK_F32_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
INT8_PSNR_MIN = 38.0          # int8 vs bf16 kernel path (tests/test_int8_mode.py)
VGG_INT8_PSNR_MIN = 35.0      # SRVGG int8 vs bf16 (tests/test_fused_srvgg.py)
CODE_MAX_STEP, CODE_MAX_FRAC = 1, 1e-4
UINT8_MAX_LSB, UINT8_MAX_FRAC = 1, 0.02
MODEL_MAX_ABS, MODEL_MEAN_ABS = 0.05, 0.005
RDB_MAC_PER_PX = 9 * (64 * 32 + 96 * 32 + 128 * 32 + 160 * 32 + 192 * 64)
K1_MAC_PER_PX = 9 * 64 * 64
# per body pixel: conv_up1 (4 phases x 4 taps), conv_up2 (4 x that),
# conv_hr and conv_last at 16 output pixels
K2_MAC_PER_PX = 4 * 4 * 64 * 64 * 5 + 16 * 9 * 64 * 64 + 16 * 9 * 64 * 3
K2_WEIGHTS = 2 * (4 * 64 * 4 * 64) + 9 * 64 * 64 + 9 * 64 * 3
VGG_GROUP = 8                  # convs per chain call (fused_srvgg.GROUP)
VGG_MAC_PER_PX = VGG_GROUP * 9 * 64 * 64


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def synthetic_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """Smooth seeded texture panning 4 px per frame, plus fine grain."""
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((1, 3, h // 16 + 2, w // 16 + 8),
                                         dtype=np.float32))
    big = F.interpolate(coarse, size=(h, w + 4 * n), mode="bilinear",
                        align_corners=False)[0].permute(1, 2, 0).numpy()
    frames = np.stack([big[:, 4 * t:4 * t + w] for t in range(n)])
    frames = frames + rng.normal(0.0, 0.03, frames.shape).astype(np.float32)
    return np.clip(frames * 255.0 + 0.5, 0, 255).astype(np.uint8)


def read_y4m_planes(path: Path):
    """-> (width, height, [(Y, U, V), ...]) of a 4:2:0 Y4M file."""
    data = path.read_bytes()
    header, rest = data.split(b"\n", 1)
    w = int(re.search(rb" W(\d+)", header).group(1))
    h = int(re.search(rb" H(\d+)", header).group(1))
    require(b"C420" in header, f"restore output is not 4:2:0: {header!r}")
    ys, cs = w * h, (w // 2) * (h // 2)
    frames, off = [], 0
    while off < len(rest):
        nl = rest.index(b"\n", off)
        require(rest[off:nl].startswith(b"FRAME"), "corrupt Y4M frame marker")
        off = nl + 1
        buf = np.frombuffer(rest, np.uint8, count=ys + 2 * cs, offset=off)
        frames.append((buf[:ys].reshape(h, w), buf[ys:ys + cs].reshape(h // 2, w // 2),
                       buf[ys + cs:].reshape(h // 2, w // 2)))
        off += ys + 2 * cs
    return w, h, frames


def diff_stats(a, b) -> dict:
    d = (a.float() - b.float()).abs()
    return {"max_abs": d.max().item(), "mean_abs": d.mean().item(),
            "frac_differ": (d > 0).float().mean().item()}


def check_bf16(name: str, got, want, phase: str = "kernels") -> dict:
    """Kernel vs plain version of the same bf16 function: both round the
    same f32 sums to bf16 and differ only in the order of the f32 sums, so
    a value may sit one bf16 ulp apart (<= 2^-4 for |v| < 16)."""
    s = diff_stats(got, want)
    s.update(name=name, tol={"max_abs": 2.0 ** -4, "mean_abs": 1e-4})
    emit({"phase": phase, **s})
    require(s["max_abs"] <= 2.0 ** -4 and s["mean_abs"] <= 1e-4, f"{name}: {s}")
    return s


def check_u8(name: str, got, want, phase: str = "kernels",
             max_frac: float = UINT8_MAX_FRAC) -> dict:
    """uint8 outputs: at most 1 LSB apart, on fewer than ``max_frac`` of
    the values (no bound on the share when ``max_frac`` is None)."""
    s = diff_stats(got, want)
    s.update(name=name, tol={"max_lsb": UINT8_MAX_LSB, "frac_differ": max_frac})
    emit({"phase": phase, **s})
    require(s["max_abs"] <= UINT8_MAX_LSB
            and (max_frac is None or s["frac_differ"] < max_frac), f"{name}: {s}")
    return s


def check_codes(name: str, got, want, phase: str = "kernels") -> dict:
    """int8 codes of the kernel and its plain version: the same integer
    sums and the same f32 operations in the same order, so they agree
    except where a float operation genuinely differs; at most one step,
    on fewer than ``CODE_MAX_FRAC`` of the codes."""
    s = diff_stats(got, want)
    s.update(name=name, tol={"max_step": CODE_MAX_STEP, "frac_differ": CODE_MAX_FRAC})
    emit({"phase": phase, **s})
    require(s["max_abs"] <= CODE_MAX_STEP and s["frac_differ"] < CODE_MAX_FRAC, f"{name}: {s}")
    return s


def psnr(a, b) -> float:
    mse = (a.float() - b.float()).pow(2).mean().item()
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def centre_crop(x_u8: np.ndarray) -> np.ndarray:
    """The int8 calibration sample of the SR processor: the first frame's
    centre crop, at most 256x256 with sides a multiple of 8, u8 / 255."""
    _, h, w, _ = x_u8.shape
    ch, cw = min(h, 256) & ~7, min(w, 256) & ~7
    r0, c0 = (h - ch) // 2, (w - cw) // 2
    return x_u8[:1, r0:r0 + ch, c0:c0 + cw].astype(np.float32) / 255.0


def part_peak(fn):
    """-> (fn's result, peak device bytes allocated during fn above what
    was allocated before it)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def vgg_split_bounds(m, px: int, int8: bool) -> dict:
    """Least times (ms) of the SRVGG frame's parts for px input pixels:
    conv0 and PReLU, the chain (every group: the bf16 input read and the
    output written once), conv_last in f32 (at the f32 peak outside the
    tensor cores) with pixel_shuffle and the upsampled input, and the
    yuv420 epilogue (the f32 image read once, the planes written once)."""
    s2, nc = m.cfg.scale ** 2, m.cfg.num_conv
    groups = -(-nc // VGG_GROUP)
    return {
        "head": bound_ms(2 * 27 * 64 * px, 6 * px + 128 * px)[0],
        "chain": bound_ms(2 * 9 * 64 * 64 * nc * px, groups * 2 * 128 * px,
                          PEAK_INT8_OPS if int8 else PEAK_BF16_FLOPS)[0],
        "tail": bound_ms(2 * 9 * 64 * 3 * s2 * px, (128 + 6 + 12 * s2) * px, PEAK_F32_FLOPS)[0],
        "epilogue": bound_ms(0, (12 + 1.5) * s2 * px)[0],
    }


def head_group(group, g: int):
    """The first g convs of an SRVGG chain group (bf16 or int8 weights)."""
    from framewright_tpu_torch.ops import fused_srvgg

    if isinstance(group, fused_srvgg.ChainGroup):
        return fused_srvgg.ChainGroup(group.w[:g], group.b[:g], group.alpha[:g])
    n = len(group.alpha)
    return fused_srvgg.ChainGroupInt8(
        group.wq[:g], group.ws[:g], group.b[:g], group.alpha[:g],
        np.concatenate([group.aq[:g + 1], group.aq[n + 1:n + 2 + g]]), group.dq[:g])


def seeded_feat(dev, shape, seed: int):
    import torch

    g = np.random.default_rng(seed)
    return torch.from_numpy(g.uniform(-1, 1, (*shape, 64)).astype(np.float32)).to(
        dev).to(torch.bfloat16)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4, help="frames in the restore clip")
    ap.add_argument("--iters", type=int, default=10, help="timed launches per kernel")
    args = ap.parse_args(argv)
    t_all = time.perf_counter()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "framewright_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: framewright_tpu_torch is not beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    from framewright_tpu_torch import cli
    from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
    from framewright_tpu_torch import planner
    from framewright_tpu_torch.models import rrdb, srvgg
    from framewright_tpu_torch.models.layers import conv2d, out_epilogue, prelu
    from framewright_tpu_torch.models.registry import (
        MODEL_SPECS,
        bf16_masters,
        from_jax_params,
        init_params,
        packaged_weights_dir,
        read_npz,
    )
    from framewright_tpu_torch.ops import (
        _build,
        fused_rrdb,
        fused_srvgg,
        fused_tail,
        fused_tail3,
    )

    # f32 references run in full f32 (cuDNN would use TF32 by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device --------------------------------------------------------
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    shutil.rmtree(_build.BUILD_ROOT, ignore_errors=True)
    info = _build.build(verbose=False)
    emit({"phase": "build", "nvcc_seconds": round(info.seconds, 3),
          "seconds": round(time.perf_counter() - t0, 3), "library": str(info.path),
          "ptxas": info.ptxas})

    # 3. kernels vs plain at main-path shapes ---------------------------
    t0 = time.perf_counter()
    # masters rounded to bf16 once, as the restore's SR processor loads them
    spec = MODEL_SPECS["RealESRGAN_x2plus"]
    sd = bf16_masters(from_jax_params(init_params(spec.arch_config, seed=0), torch.float32))
    model = rrdb.RRDBNet.from_state_dict(spec.arch_config, sd, dev)
    fw = model.fast_weights()
    n_frames = max(1, args.frames)
    frames = synthetic_frames(n_frames, 1080, 1920, seed=7)
    x_u8 = torch.from_numpy(frames[:1]).to(dev)
    x32 = x_u8.float() / 255.0
    with torch.no_grad():
        feat = model._head(x32.to(torch.bfloat16)).contiguous()   # (1, 540, 960, 64)
    errs = {}
    ws = fused_rrdb.new_workspace(feat)
    ws_p = ws.clone()
    d_k, d_p = torch.empty_like(ws), torch.empty_like(ws)
    fused_rrdb.fused_rdb(ws, d_k, fw.body[0][0])
    fused_rrdb.fused_rdb_plain(ws_p, d_p, fw.body[0][0])
    torch.cuda.synchronize()
    errs["rdb"] = check_bf16("rdb", d_k[..., :64], d_p[..., :64])["max_abs"]
    check_bf16("rdb x1..x4", ws[..., 64:], ws_p[..., 64:])
    c_k, c_p = ws.clone(), ws.clone()
    fused_rrdb.fused_rdb(d_k, c_k, fw.body[0][2], carry=c_k)
    fused_rrdb.fused_rdb_plain(d_k.clone(), c_p, fw.body[0][2], carry=c_p)
    torch.cuda.synchronize()
    errs["rdb"] = max(errs["rdb"], check_bf16("rdb_res", c_k[..., :64], c_p[..., :64])["max_abs"])
    # both int8 RDBs, with scales calibrated on the frame's centre crop
    amax = rrdb.calibrate_act_scales(model, torch.from_numpy(centre_crop(frames[:1])))
    fw8 = {s: model.fast_weights_int8(amax, s) for s in fused_rrdb.INT8_SCHEMES}
    for scheme, w8 in fw8.items():
        wts = w8.body[0]
        q_k = torch.zeros(*feat.shape[:3], 192, dtype=torch.int8, device=dev)
        q_p = torch.zeros_like(q_k)
        o_k, o_p = torch.empty_like(feat), torch.empty_like(feat)
        fused_rrdb.fused_rdb_int8(feat, q_k, o_k, wts[0])
        fused_rrdb.fused_rdb_int8_plain(feat, q_p, o_p, wts[0])
        torch.cuda.synchronize()
        e = [check_codes(f"rdb_int8_{scheme} q0..q4", q_k, q_p)["max_abs"],
             check_bf16(f"rdb_int8_{scheme}", o_k, o_p)["max_abs"]]
        r_k, r_p = feat.clone(), feat.clone()
        fused_rrdb.fused_rdb_int8(o_k, q_k, r_k, wts[2], carry=r_k)
        fused_rrdb.fused_rdb_int8_plain(o_k, q_p, r_p, wts[2], carry=r_p)
        torch.cuda.synchronize()
        e += [check_codes(f"rdb_int8_{scheme}_res q0..q4", q_k, q_p)["max_abs"],
              check_bf16(f"rdb_int8_{scheme}_res", r_k, r_p)["max_abs"]]
        errs[f"rdb_int8_{scheme}"] = max(e)
        del q_k, q_p, o_k, o_p, r_k, r_p
    skip_k = fused_tail3.conv_body_skip(c_k, feat, fw.cbody)
    skip_p = fused_tail3.conv_body_skip_plain(c_k, feat, fw.cbody)
    torch.cuda.synchronize()
    errs["k1"] = check_bf16("k1", skip_k, skip_p)["max_abs"]
    errs["k2"] = 0.0
    for mode in ("bf16", "rgb_u8", "yuv420_u8"):
        got = fused_tail.fused_tail(skip_p, fw.tail, mode, False)
        want = fused_tail.fused_tail_plain(skip_p, fw.tail, mode, False)
        torch.cuda.synchronize()
        pairs = zip(got, want, "YUV") if mode == "yuv420_u8" else [(got, want, "")]
        for g, w, plane in pairs:
            name = f"k2 {mode} {plane}".strip()
            s = check_bf16(name, g, w) if mode == "bf16" else check_u8(name, g, w)
            errs["k2"] = max(errs["k2"], s["max_abs"])
        del got, want
    kernel_inputs = (ws, feat, skip_p)
    # the SRVGG chains: realesr-animevideov3 (seeded random weights) on a
    # 960x540 frame, whose body runs at 540x960 like x2plus's; the chain's
    # main-path input is conv0's PReLU output, a group of 8 convs
    vspec = MODEL_SPECS["realesr-animevideov3"]
    vgg = srvgg.SRVGGNet.from_state_dict(vspec.arch_config, bf16_masters(
        from_jax_params(init_params(vspec.arch_config, seed=0), torch.float32)), dev)
    vframes = synthetic_frames(n_frames, 540, 960, seed=11)
    xv = torch.from_numpy(vframes[:1]).to(dev).to(torch.bfloat16) / 255.0
    with torch.no_grad():
        c0 = vgg.convs[0]
        vfeat = prelu(conv2d(xv, c0.weight, c0.bias), vgg.acts[0].weight).contiguous()
    vfw = vgg.fast_weights()
    vfw8 = vgg.fast_weights_int8(srvgg.calibrate_act_scales(
        vgg, torch.from_numpy(centre_crop(vframes[:1]))))
    errs["vgg_chain"] = errs["vgg_chain_int8"] = 0.0
    for label, x_c, g in (("main", vfeat, VGG_GROUP),
                          ("ragged", seeded_feat(dev, (2, 37, 53), 3), 2)):
        o_k, o_p = torch.empty_like(x_c), torch.empty_like(x_c)
        wg = head_group(vfw.groups[0], g)
        fused_srvgg.fused_conv_chain(x_c, o_k, wg)
        fused_srvgg.fused_conv_chain_plain(x_c, o_p, wg)
        torch.cuda.synchronize()
        errs["vgg_chain"] = max(errs["vgg_chain"], check_bf16(
            f"vgg_chain {label} {tuple(x_c.shape)} g={g}", o_k, o_p)["max_abs"])
        wg8 = head_group(vfw8.groups[0], g)
        q_k, q_p = [], []
        fused_srvgg.fused_conv_chain_int8(x_c, o_k, wg8, q_k)
        fused_srvgg.fused_conv_chain_int8_plain(x_c, o_p, wg8, q_p)
        torch.cuda.synchronize()
        require(len(q_k) == len(q_p) == g, f"vgg_chain_int8: {len(q_k)}/{len(q_p)} code tensors")
        e = [check_codes(f"vgg_chain_int8 {label} codes", torch.stack(q_k), torch.stack(q_p))[
                 "max_abs"],
             check_bf16(f"vgg_chain_int8 {label} {tuple(x_c.shape)} g={g}", o_k, o_p)["max_abs"]]
        errs["vgg_chain_int8"] = max(errs["vgg_chain_int8"], *e)
        del o_k, o_p, q_k, q_p
    emit({"phase": "kernels", "seconds": round(time.perf_counter() - t0, 3)})

    # 4. one 1080p frame through the kernel path ------------------------
    # Two models on the same frame: the default RealESRGAN_x2plus with
    # seeded random weights, and FW_fast6_x2 with the repository's trained
    # weights (the same RRDB code path at 6 blocks). The tolerances (max
    # 0.05, mean 0.005) are the JAX package's, set for outputs in [0, 1]
    # (tests/test_fused_tail3.py). With random weights the 23-block output
    # spans tens of units and any bf16 path's error scales with it (the
    # JAX reference's own bf16 path included: tests/test_torch_rrdb.py,
    # test_random_23_block_error_scales_with_range), so that model's
    # errors are divided by its f32 output's range first; the trained
    # model is held to the tolerances as they stand.
    t0 = time.perf_counter()
    npz = packaged_weights_dir() / "FW_fast6_x2.npz"
    require(npz.is_file(), f"missing {npz}")
    fast6 = rrdb.RRDBNet.from_state_dict(
        MODEL_SPECS["FW_fast6_x2"].arch_config,
        bf16_masters(from_jax_params(read_npz(npz), torch.float32)), dev)
    xb = x32.to(torch.bfloat16)
    model_ms = {}
    with torch.no_grad():
        # The uint8 outputs (quantized from the f32 conv_last sums) are held
        # against the epilogue of the model's own bf16 output at 1 LSB. The
        # share of values 1 LSB apart is bounded (< 2%, as in
        # tests/test_fused_tail3.py) for the random-weight model, whose
        # outputs mostly clip; it is not bounded for the trained model,
        # whose outputs lie in [0, 1], where one bf16 step is up to 2^-8,
        # about one LSB, so half the values may round the other way.
        for name, m, relative, frac in (("RealESRGAN_x2plus", model, True, UINT8_MAX_FRAC),
                                        ("FW_fast6_x2", fast6, False, None)):
            ref = m.apply(x32)                                     # plain f32
            w16 = m.fast_weights()
            torch.cuda.reset_peak_memory_stats()
            fast = m.apply_fast(xb, "bf16", weights=w16)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            s = diff_stats(fast, ref)
            lo, hi = ref.min().item(), ref.max().item()
            scale = (hi - lo) if relative else 1.0
            s.update(max_scaled=s["max_abs"] / scale, mean_scaled=s["mean_abs"] / scale)
            emit({"phase": "model", "name": f"{name} apply_fast bf16 vs apply f32",
                  "shape": list(fast.shape), "ref_min": lo, "ref_max": hi,
                  "divided_by": scale, **s,
                  "tol": {"max_abs": MODEL_MAX_ABS, "mean_abs": MODEL_MEAN_ABS}})
            require(bool(torch.isfinite(fast.float()).all()), f"{name}: non-finite output")
            require(tuple(fast.shape) == (1, 2160, 3840, 3), f"{name}: shape {fast.shape}")
            require(s["max_scaled"] < MODEL_MAX_ABS and s["mean_scaled"] < MODEL_MEAN_ABS,
                    f"{name}: {s}")
            rgb = m.apply_fast(xb, "rgb_u8", weights=w16)
            check_u8(f"{name} rgb_u8 vs epilogue", rgb,
                     out_epilogue(fast, "rgb_u8", False), "model", frac)
            for full in (False, True):
                planes = m.apply_fast(xb, "yuv420_u8", full, weights=w16)
                want = out_epilogue(fast, "yuv420_u8", full)
                for g, w, plane in zip(planes, want, "YUV"):
                    check_u8(f"{name} yuv420_u8 full_range={full} {plane}", g, w,
                             "model", frac)
            model_ms[name] = cuda_ms(lambda: m.apply_fast(xb, "yuv420_u8", True, weights=w16),
                                     3, warmup=1)
            emit({"phase": "model", "name": name, "ms_per_frame_yuv420": model_ms[name],
                  "peak_mem_bytes": peak})
            del ref, rgb, planes, want

            # int8 (default scheme i32), scales calibrated on the frame's
            # centre crop as the SR processor takes them
            a8 = rrdb.calibrate_act_scales(m, torch.from_numpy(centre_crop(frames[:1])))
            w8 = m.fast_weights_int8(a8, "i32")
            torch.cuda.reset_peak_memory_stats()
            fast8 = m.apply_fast(xb, "bf16", weights=w8)
            torch.cuda.synchronize()
            peak8 = torch.cuda.max_memory_allocated()
            require(bool(torch.isfinite(fast8.float()).all()), f"{name}: non-finite int8 output")
            require(tuple(fast8.shape) == (1, 2160, 3840, 3), f"{name}: int8 shape {fast8.shape}")
            rec = {"phase": "model", "name": f"{name} int8 i32 kernel path",
                   "psnr_vs_bf16_kernel_path": psnr(fast8, fast), "peak_mem_bytes": peak8}
            if name == "FW_fast6_x2":
                # the trained model's image-like output: the JAX package's
                # int8 quality bound against its own bf16 path
                rec["tol"] = {"psnr_min": INT8_PSNR_MIN}
                emit(rec)
                require(rec["psnr_vs_bf16_kernel_path"] > INT8_PSNR_MIN, f"{name}: {rec}")
            else:
                # random weights: PSNR on a ±50 output is printed only; the
                # kernels are held to the int8 plain path on the same
                # frame, errors divided by its range as for bf16 above
                feat8 = m._head(xb).contiguous()
                body_p = fused_rrdb.rrdb_body_int8(feat8, w8.body, plain=True)
                ref8 = fused_tail.fused_tail_plain(
                    fused_tail3.conv_body_skip_plain(body_p, feat8, w8.cbody), w8.tail, "bf16")
                del feat8, body_p
                s8 = diff_stats(fast8, ref8)
                lo, hi = ref8.float().min().item(), ref8.float().max().item()
                s8.update(max_scaled=s8["max_abs"] / (hi - lo), mean_scaled=s8["mean_abs"] / (hi - lo))
                rec.update(name=f"{name} int8 i32 kernel path vs int8 plain path", ref_min=lo,
                           ref_max=hi, **s8,
                           tol={"max_scaled": MODEL_MAX_ABS, "mean_scaled": MODEL_MEAN_ABS})
                emit(rec)
                require(s8["max_scaled"] < MODEL_MAX_ABS and s8["mean_scaled"] < MODEL_MEAN_ABS,
                        f"{name} int8: {s8}")
                del ref8
            model_ms[f"{name} int8"] = cuda_ms(
                lambda: m.apply_fast(xb, "yuv420_u8", True, weights=w8), 3, warmup=1)
            emit({"phase": "model", "name": f"{name} int8", "ms_per_frame_yuv420":
                  model_ms[f"{name} int8"]})
            del fast, fast8
    del fast6
    plan_checks = []     # (name, peak, planner bytes), held after phase 6
    # SRVGG: realesr-animevideov3 (seeded random weights, x4) on the 960x540
    # frame, FW_fastvgg_x2 (trained weights, x2) on the 1080p frame, both
    # to 4K; held like the RRDB pair above (the random-weight model's
    # errors divided by its output's range). Their uint8 outputs come from
    # the same f32 image through the same epilogue, so they must equal the
    # epilogue of the f32 output (held to 1 LSB). The peak device memory
    # of the restore's yuv420 call, above what was allocated before it, is
    # held to the planner's count for the frame, once every phase has run.
    fvgg = packaged_weights_dir() / "FW_fastvgg_x2.npz"
    require(fvgg.is_file(), f"missing {fvgg}")
    fastvgg = srvgg.SRVGGNet.from_state_dict(
        MODEL_SPECS["FW_fastvgg_x2"].arch_config,
        bf16_masters(from_jax_params(read_npz(fvgg), torch.float32)), dev)
    with torch.no_grad():
        for name, m, x_u8_np, relative in (
                ("realesr-animevideov3", vgg, vframes[:1], True),
                ("FW_fastvgg_x2", fastvgg, frames[:1], False)):
            xf = torch.from_numpy(x_u8_np).to(dev).float() / 255.0
            xh = xf.to(torch.bfloat16)
            ref = m.apply(xf)
            w16 = m.fast_weights()
            fast = m.apply_fast(xh, "f32", weights=w16)
            torch.cuda.synchronize()
            s = diff_stats(fast, ref)
            lo, hi = ref.min().item(), ref.max().item()
            scale = (hi - lo) if relative else 1.0
            s.update(max_scaled=s["max_abs"] / scale, mean_scaled=s["mean_abs"] / scale)
            emit({"phase": "model", "name": f"{name} apply_fast bf16 vs apply f32",
                  "shape": list(fast.shape), "ref_min": lo, "ref_max": hi,
                  "divided_by": scale, **s,
                  "tol": {"max_abs": MODEL_MAX_ABS, "mean_abs": MODEL_MEAN_ABS}})
            require(bool(torch.isfinite(fast).all()), f"{name}: non-finite output")
            require(tuple(fast.shape) == (1, 2160, 3840, 3), f"{name}: shape {fast.shape}")
            require(s["max_scaled"] < MODEL_MAX_ABS and s["mean_scaled"] < MODEL_MEAN_ABS,
                    f"{name}: {s}")
            del ref
            check_u8(f"{name} rgb_u8 vs epilogue", m.apply_fast(xh, "rgb_u8", weights=w16),
                     out_epilogue(fast, "rgb_u8", False), "model", None)
            for full in (False, True):
                planes = m.apply_fast(xh, "yuv420_u8", full, weights=w16)
                for g, w, plane in zip(planes, out_epilogue(fast, "yuv420_u8", full), "YUV"):
                    check_u8(f"{name} yuv420_u8 full_range={full} {plane}", g, w, "model",
                             None)
                del planes
            a8 = srvgg.calibrate_act_scales(m, torch.from_numpy(centre_crop(x_u8_np)))
            w8 = m.fast_weights_int8(a8)
            fast8 = m.apply_fast(xh, "f32", weights=w8)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(fast8).all()), f"{name}: non-finite int8 output")
            rec = {"phase": "model", "name": f"{name} int8 kernel path",
                   "psnr_vs_bf16_kernel_path": psnr(fast8, fast)}
            if relative:
                # random weights: held to the int8 plain chain on the frame
                ref8 = m.tail(fused_srvgg.conv_chain(m.head(xh), w8.groups, plain=True), xh)
                s8 = diff_stats(fast8, ref8)
                lo, hi = ref8.min().item(), ref8.max().item()
                s8.update(max_scaled=s8["max_abs"] / (hi - lo),
                          mean_scaled=s8["mean_abs"] / (hi - lo))
                rec.update(name=f"{name} int8 kernel path vs int8 plain chain", ref_min=lo,
                           ref_max=hi, **s8,
                           tol={"max_scaled": MODEL_MAX_ABS, "mean_scaled": MODEL_MEAN_ABS})
                emit(rec)
                require(s8["max_scaled"] < MODEL_MAX_ABS and s8["mean_scaled"] < MODEL_MEAN_ABS,
                        f"{name} int8: {s8}")
                del ref8
            else:
                rec["tol"] = {"psnr_min": VGG_INT8_PSNR_MIN}
                emit(rec)
                require(rec["psnr_vs_bf16_kernel_path"] > VGG_INT8_PSNR_MIN, f"{name}: {rec}")
            del fast, fast8
            _, h, w, _ = x_u8_np.shape
            for dtype, wts in (("bfloat16", w16), ("int8", w8)):
                key = name if dtype == "bfloat16" else f"{name} int8"
                planes, peak = part_peak(
                    lambda: m.apply_fast(xh, "yuv420_u8", True, weights=wts))
                del planes
                model_ms[key] = cuda_ms(
                    lambda: m.apply_fast(xh, "yuv420_u8", True, weights=wts), 3, warmup=1)
                # the frame's parts, each timed and its peak taken alone
                head, p_head = part_peak(lambda: m.head(xh))
                chain, p_chain = part_peak(lambda: fused_srvgg.conv_chain(head, wts.groups))
                img, p_tail = part_peak(lambda: m.tail(chain, xh))
                planes, p_epi = part_peak(lambda: out_epilogue(img, "yuv420_u8", True))
                split_ms = {
                    "head": cuda_ms(lambda: m.head(xh), 3, 1),
                    "chain": cuda_ms(lambda: fused_srvgg.conv_chain(head, wts.groups), 3, 1),
                    "tail": cuda_ms(lambda: m.tail(chain, xh), 3, 1),
                    "epilogue": cuda_ms(lambda: out_epilogue(img, "yuv420_u8", True), 3, 1)}
                del head, chain, img, planes
                plan = planner.frame_bytes(h, w, m.cfg.scale, "srvgg", dtype)
                emit({"phase": "model", "name": key, "ms_per_frame_yuv420": model_ms[key],
                      "split_ms": split_ms,
                      "split_bound_ms": vgg_split_bounds(m, h * w, dtype == "int8"),
                      "peak_mem_bytes_above_base": peak,
                      "split_peak_bytes_above_base": {"head": p_head, "chain": p_chain,
                                                      "tail": p_tail, "epilogue": p_epi},
                      "planner_bytes": plan})
                plan_checks.append((key, peak, plan))
    del fastvgg
    emit({"phase": "model", "seconds": round(time.perf_counter() - t0, 3)})

    # 5. the main paths: cli restore on synthetic clips -----------------
    # Five runs of the user's entry point: RealESRGAN_x2plus on the 1080p
    # clip in bf16, int8 (default scheme i32) and int8 with
    # FW_INT8_SCHEME=f32acc, and realesr-animevideov3 on the 960x540 clip
    # in bf16 and int8. Every counter is set to 0 just before each run and
    # read just after it.
    t0 = time.perf_counter()
    counters = (fused_rrdb.fused_rdb, fused_rrdb.fused_rdb_i32, fused_rrdb.fused_rdb_f32acc,
                fused_tail3.conv_body_skip, fused_tail.fused_tail,
                fused_srvgg.fused_conv_chain, fused_srvgg.fused_conv_chain_int8)
    calibrations = {"rrdb_calibrations": rrdb.calibrate_act_scales,
                    "srvgg_calibrations": srvgg.calibrate_act_scales}
    runs = (("RealESRGAN_x2plus", "bfloat16", None), ("RealESRGAN_x2plus", "int8", None),
            ("RealESRGAN_x2plus", "int8", "f32acc"),
            ("realesr-animevideov3", "bfloat16", None), ("realesr-animevideov3", "int8", None))
    launches_by_run = {}
    with tempfile.TemporaryDirectory(prefix="fw_smoke_") as tmp:
        tmp = Path(tmp)
        clips = {}
        for model_name, clip in (("RealESRGAN_x2plus", frames), ("realesr-animevideov3", vframes)):
            src = tmp / f"{model_name}.y4m"
            with Y4MWriter(src, clip.shape[2], clip.shape[1], fps=24) as writer:
                for f in clip:
                    writer.write_frame(f)
            with Y4MReader(src) as reader:
                clips[model_name] = (src, np.stack(list(reader)))
        for model_name, dtype, scheme in runs:
            label = f"{model_name} {dtype}" + ("" if scheme is None
                                               else f" FW_INT8_SCHEME={scheme}")
            src, decoded = clips[model_name]
            vgg_run = model_name == "realesr-animevideov3"
            out = tmp / f"restored_{len(launches_by_run)}.y4m"
            if scheme is not None:
                os.environ["FW_INT8_SCHEME"] = scheme
            for fn in counters:
                fn.launches = 0
            for fn in calibrations.values():
                fn.calls = 0
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    # an empty weights dir: the restore draws the same
                    # seeded random weights as ``model`` and ``vgg`` above
                    rc = cli.main(["restore", str(src), "-o", str(out), "--device", "cuda",
                                   "--model", model_name, "--dtype", dtype,
                                   "--weights-dir", str(tmp / "no_weights"),
                                   "--project-dir", str(tmp / "proj")])
            finally:
                os.environ.pop("FW_INT8_SCHEME", None)
            launches = {fn.__name__: fn.launches for fn in counters}
            launches.update({k: fn.calls for k, fn in calibrations.items()})
            require(rc == 0, f"cli restore {label} exited {rc}")
            summary = json.loads(buf.getvalue())
            w, h, planes_out = read_y4m_planes(out)
            batches = summary["batches"]
            emit({"phase": "restore", "run": label, "summary": summary, "out_width": w,
                  "out_height": h, "frames_out": len(planes_out), "launches": launches})
            require((w, h) == (3840, 2160), f"restore output {w}x{h}")
            require(len(planes_out) == n_frames == summary["frames"],
                    f"restore wrote {len(planes_out)} of {n_frames} frames")
            want_counts = {k: 0 for k in launches}
            if vgg_run:
                # 16 chain convs: two groups of 8 per batch
                want_counts["fused_conv_chain" if dtype == "bfloat16"
                            else "fused_conv_chain_int8"] = 2 * batches
                want_counts["srvgg_calibrations"] = int(dtype == "int8")
            else:
                body_fn = ("fused_rdb" if dtype == "bfloat16" else
                           "fused_rdb_f32acc" if scheme == "f32acc" else "fused_rdb_i32")
                want_counts.update({body_fn: 69 * batches, "conv_body_skip": batches,
                                    "fused_tail": batches,
                                    "rrdb_calibrations": int(dtype == "int8")})
            require(batches > 0 and launches == want_counts,
                    f"{label}: launch counts {launches}, expected {want_counts}")
            launches_by_run[label] = launches
            # every written frame against the kernel path run directly on
            # the same decoded frames in the same batches, with the weights
            # the run used (int8: calibrated on the same crop of the same
            # first frame): the same deterministic kernels, so the planes
            # must match exactly (phase 4 holds the kernel paths against
            # their references)
            m = vgg if vgg_run else model
            if dtype == "bfloat16":
                weights = m.fast_weights()
            elif vgg_run:
                weights = m.fast_weights_int8(srvgg.calibrate_act_scales(
                    m, torch.from_numpy(centre_crop(decoded[:1]))))
            else:
                a8 = rrdb.calibrate_act_scales(m, torch.from_numpy(centre_crop(decoded[:1])))
                weights = m.fast_weights_int8(a8, scheme or "i32")
            bs = summary["batch_size"]
            worst = 0.0
            with torch.no_grad():
                for i in range(0, n_frames, bs):
                    xs = (torch.from_numpy(decoded[i:i + bs]).to(dev).to(torch.bfloat16)
                          / 255.0)
                    want = m.apply_fast(xs, "yuv420_u8", True, weights=weights)
                    for j in range(len(xs)):
                        for g, w_ in zip(planes_out[i + j], want):
                            worst = max(worst, diff_stats(torch.from_numpy(g.copy()),
                                                          w_[j].cpu())["max_abs"])
            emit({"phase": "restore", "run": label,
                  "name": "written planes vs kernel path on the decoded frames",
                  "max_abs": worst, "tol": {"max_abs": 0}})
            require(worst == 0, f"{label}: restore output differs from the kernel path "
                                f"by {worst}")
            del planes_out
    emit({"phase": "restore", "seconds": round(time.perf_counter() - t0, 3)})
    launches = launches_by_run["RealESRGAN_x2plus bfloat16"]

    # 6. times -------------------------------------------------------------
    t0 = time.perf_counter()
    ws, feat, skip = kernel_inputs
    b, h, w, _ = feat.shape
    px = b * h * w
    dst = torch.empty_like(ws)
    it = max(1, args.iters)
    rows = []

    # RDB: five dense convs per call; library = cuDNN's F.conv2d on the
    # same five convs (bf16, channels_last), summed
    rdb_w = fw.body[0][0]
    lib_in = [ws[..., :64 + 32 * k].permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last) for k in range(5)]
    lib_w = [wk.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
             for wk in rdb_w.w]
    lib_b = [bk.to(torch.bfloat16) for bk in rdb_w.b]
    rdb_ms = cuda_ms(lambda: fused_rrdb.fused_rdb(ws, dst, rdb_w), it)
    rdb_plain = cuda_ms(lambda: fused_rrdb.fused_rdb_plain(ws, dst, rdb_w), 3, 1)
    rdb_lib = sum(cuda_ms(lambda k=k: F.conv2d(lib_in[k], lib_w[k], lib_b[k], padding=1), it)
                  for k in range(5))
    bms, by = bound_ms(2 * RDB_MAC_PER_PX * px, 2 * 128 * px + 2 * RDB_MAC_PER_PX)
    rows.append(dict(name="rdb", route="cuda", source="framewright_tpu_torch/ops/csrc/rdb.cu",
                     replaces="framewright_tpu/ops/fused_rrdb.py:763",
                     launches=launches["fused_rdb"], max_abs_err=errs["rdb"], ms=rdb_ms,
                     plain_ms=rdb_plain, bound_ms=bms, bound_by=by, library_ms=rdb_lib))

    k1_lib_in = lib_in[0][:, :64]
    k1_w = fw.cbody.w.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    k1_b = fw.cbody.b.to(torch.bfloat16)
    k1_ms = cuda_ms(lambda: fused_tail3.conv_body_skip(ws, feat, fw.cbody), it)
    k1_plain = cuda_ms(lambda: fused_tail3.conv_body_skip_plain(ws, feat, fw.cbody), 3, 1)
    k1_lib = cuda_ms(lambda: F.conv2d(k1_lib_in, k1_w, k1_b, padding=1), it)
    bms, by = bound_ms(2 * K1_MAC_PER_PX * px, 3 * 128 * px + 2 * K1_MAC_PER_PX)
    rows.append(dict(name="conv_body_skip", route="cuda",
                     source="framewright_tpu_torch/ops/csrc/conv_body.cu",
                     replaces="framewright_tpu/ops/fused_tail3.py:70",
                     launches=launches["conv_body_skip"], max_abs_err=errs["k1"], ms=k1_ms,
                     plain_ms=k1_plain, bound_ms=bms, bound_by=by, library_ms=k1_lib))

    k2_ms = cuda_ms(lambda: fused_tail.fused_tail(skip, fw.tail, "yuv420_u8", True), it)
    k2_plain = cuda_ms(lambda: fused_tail.fused_tail_plain(skip, fw.tail, "yuv420_u8", True),
                       2, 1)
    # input read once, Y/U/V written once (1.5 B per 4K pixel, 16 per body pixel)
    bms, by = bound_ms(2 * K2_MAC_PER_PX * px, 128 * px + 24 * px + 2 * K2_WEIGHTS)
    rows.append(dict(name="tail", route="cuda", source="framewright_tpu_torch/ops/csrc/tail.cu",
                     replaces="framewright_tpu/ops/fused_tail.py:337",
                     launches=launches["fused_tail"], max_abs_err=errs["k2"], ms=k2_ms,
                     plain_ms=k2_plain, bound_ms=bms, bound_by=by, library_ms=None))
    # int8 RDBs: the bf16 RDB's operations at the int8 peak; bytes: x read
    # and the output written once (bf16), the int8 weights read once.
    # PyTorch has no single int8 3x3 convolution call (library_ms null).
    for scheme, run in (("i32", "int8"), ("f32acc", "int8 FW_INT8_SCHEME=f32acc")):
        wts = fw8[scheme].body[0][0]
        q8 = torch.empty(*feat.shape[:3], 192, dtype=torch.int8, device=dev)
        o8 = torch.empty_like(feat)
        ms8 = cuda_ms(lambda: fused_rrdb.fused_rdb_int8(feat, q8, o8, wts), it)
        plain8 = cuda_ms(lambda: fused_rrdb.fused_rdb_int8_plain(feat, q8, o8, wts), 1, 1)
        bms, by = bound_ms(2 * RDB_MAC_PER_PX * px, 2 * 128 * px + RDB_MAC_PER_PX,
                           PEAK_INT8_OPS)
        rows.append(dict(
            name=f"rdb_int8_{scheme}", route="cuda",
            source="framewright_tpu_torch/ops/csrc/rdb_int8.cu",
            replaces=("framewright_tpu/ops/fused_rrdb.py:828" if scheme == "i32"
                      else "framewright_tpu/ops/fused_rrdb.py:790"),
            launches=launches_by_run[f"RealESRGAN_x2plus {run}"][f"fused_rdb_{scheme}"],
            max_abs_err=errs[f"rdb_int8_{scheme}"], ms=ms8, plain_ms=plain8, bound_ms=bms,
            bound_by=by, library_ms=None))
        del q8, o8
    # SRVGG chains: a group of 8 convs on the 540x960 chain input; bytes:
    # the bf16 input read and the output written once, the weights read
    # once. Library: cuDNN's F.conv2d on the same eight bf16 convs
    # (channels_last), summed; PyTorch has no int8 3x3 convolution call.
    vg, vg8 = vfw.groups[0], vfw8.groups[0]
    vpx = vfeat.shape[0] * vfeat.shape[1] * vfeat.shape[2]
    vout = torch.empty_like(vfeat)
    chain_ms = cuda_ms(lambda: fused_srvgg.fused_conv_chain(vfeat, vout, vg), it)
    chain_plain = cuda_ms(lambda: fused_srvgg.fused_conv_chain_plain(vfeat, vout, vg), 3, 1)
    lib_x = vfeat.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    lib_vw = [vg.w[i].view(64, 3, 3, 64).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last) for i in range(VGG_GROUP)]
    lib_vb = [vg.b[i].view(64).to(torch.bfloat16) for i in range(VGG_GROUP)]
    chain_lib = sum(cuda_ms(lambda i=i: F.conv2d(lib_x, lib_vw[i], lib_vb[i], padding=1), it)
                    for i in range(VGG_GROUP))
    bms, by = bound_ms(2 * VGG_MAC_PER_PX * vpx, 2 * 128 * vpx + 2 * VGG_MAC_PER_PX)
    vgg_bf16_run, vgg_int8_run = ("realesr-animevideov3 bfloat16", "realesr-animevideov3 int8")
    rows.append(dict(name="vgg_chain", route="cuda",
                     source="framewright_tpu_torch/ops/csrc/srvgg.cu",
                     replaces="framewright_tpu/ops/fused_srvgg.py:192",
                     launches=launches_by_run[vgg_bf16_run]["fused_conv_chain"],
                     max_abs_err=errs["vgg_chain"], ms=chain_ms, plain_ms=chain_plain,
                     bound_ms=bms, bound_by=by, library_ms=chain_lib))
    chain8_ms = cuda_ms(lambda: fused_srvgg.fused_conv_chain_int8(vfeat, vout, vg8), it)
    chain8_plain = cuda_ms(
        lambda: fused_srvgg.fused_conv_chain_int8_plain(vfeat, vout, vg8), 1, 1)
    bms, by = bound_ms(2 * VGG_MAC_PER_PX * vpx, 2 * 128 * vpx + VGG_MAC_PER_PX,
                       PEAK_INT8_OPS)
    rows.append(dict(name="vgg_chain_int8", route="cuda",
                     source="framewright_tpu_torch/ops/csrc/srvgg.cu",
                     replaces="framewright_tpu/ops/fused_srvgg.py:221",
                     launches=launches_by_run[vgg_int8_run]["fused_conv_chain_int8"],
                     max_abs_err=errs["vgg_chain_int8"], ms=chain8_ms, plain_ms=chain8_plain,
                     bound_ms=bms, bound_by=by, library_ms=None))
    del vout, lib_x
    emit({"phase": "times", "shape_body": [b, h, w, 64], "iters": it,
          "shape_chain": list(vfeat.shape), "chain_bf16_beside_int8_ms": chain_ms,
          "rdb_cuda_launches_per_call": 5, "rdb_int8_cuda_launches_per_call": 6,
          "tail_cuda_launches_per_call": 4, "vgg_chain_cuda_launches_per_call": VGG_GROUP,
          "vgg_chain_int8_cuda_launches_per_call": VGG_GROUP + 1,
          "seconds": round(time.perf_counter() - t0, 3)})

    for key, peak, plan in plan_checks:
        require(peak <= plan, f"{key}: peak {peak} B above the planner's {plan} B")
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_all, 3),
          "model_ms_per_frame": model_ms})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
