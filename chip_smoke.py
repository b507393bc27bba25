#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (framewright_tpu_torch) on one GPU.

    python3 chip_smoke.py [--frames N] [--iters N]

Phases, one JSON object per line on stdout:
  1. device   the card (nvidia-smi name and power limit, torch's name)
  2. build    the kernels from a clean build directory (one nvcc per
              source, all at once, then one link); ptxas's registers and
              spills of every wgmma main-loop instance (the bf16 and int8
              RDBs, K1, the four launches of K2, the band conv's four
              instances and the bf16 SRVGG chain conv) and of the int8
              chain conv's own loop, none of which may spill or pass 168
              registers
  native      the native host codec built by g++ from the port's copy of
              fwcore.cpp into ops/_build (fails if it does not build or
              load); its 4:2:0 decode and encode at 1080p and 4K against
              the numpy copy (equal bytes) and both ms. Every restore
              below decodes and encodes with it (each CLI run's
              ``pre_sr.host_codec`` is checked)
  3. kernels  each kernel against its plain PyTorch version on the card,
              at the main-path shapes (RRDB body 540x960x64, tail out to
              2160x3840, tail1 in 1080x1920x64; SRVGG chain 540x960x64,
              g=8) and the chains also at a ragged 2x37x53x64, g=2: the
              bf16 RDB and its residual variant, the int8 RDBs (i32,
              f32acc and dynamic: codes x1..x4 and bf16 output, with and
              without the residual; dynamic: each frame's ranges too),
              K1, K2 in its three output modes, tail1, the bf16 SRVGG
              chain, and the int8 chain (every code and the bf16 output);
              the resident body's halo refresh on poisoned rings (against
              its plain version and a re-extraction, exactly) and the
              three RDB kernels on the 60 halo blocks of the body with
              their extents; the band conv at its FastTail shapes
              (64->64 without act at 540x960, with lrelu and 64->8 at
              2160x3840), each value at most one bf16 step from the plain
              version, and its lrelu instance bit-equal to K2's conv_hr
              launch
  4. model    one frame through each model's kernel path against the
              plain f32 ``apply``: RealESRGAN_x2plus (23 blocks, seeded
              random weights) and FW_fast6_x2 (trained) at 1080p,
              realesr-animevideov3 (16 convs, x4, seeded random weights)
              at 960x540 and FW_fastvgg_x2 (trained) at 1080p, all to 4K;
              their uint8 outputs against the epilogue of their own
              output; the int8 kernel paths (static scales calibrated on
              the frame's centre crop, and dynamic scales) of the trained
              models against their bf16 kernel paths (PSNR) and of the
              random-weight models against their int8 plain paths; the
              dynamic bodies against the bf16 bodies; FW_fast6_x2's
              round-trip bf16 and f32acc bodies with tail1 against their
              plain paths; the dynamic frame's split; the resident body
              against the merge body (x2plus, bf16) and the round-trip
              bodies (FW_fast6_x2, f32acc and dynamic); the resident body
              with tail2 and the band-conv tail (FastTail) against their
              plain paths (x2plus) and the f32 ``apply`` (FW_fast6_x2),
              with their splits; the SRVGG, dynamic and resident peaks
              against the planner's count
  stats       the SR processor's device pass on one frame without and
              with the quality gate's stats (x2plus bf16, int8 and
              float32 at 1080p, realesr-animevideov3 bf16 and float32 and
              RealESRGAN_x4plus bf16 at 960x540, all to 4K): ms, peaks
              against the planner's count, the planes unchanged by the
              stats, the stats against their plain version on the CPU
  5. restore  the user's entry points on seeded synthetic 4:2:0 clips:
              ``python -m framewright_tpu_torch.cli restore`` at 1080p
              with RealESRGAN_x2plus in bf16, in int8 (default scheme
              i32) and in int8 with FW_INT8_SCHEME=f32acc, with
              FW_fast6_x2 in bf16 and int8 f32acc with
              FW_RDB_BODY=roundtrip FW_TAIL=1, RealESRGAN_x2plus in bf16
              with FW_RDB_BODY=resident FW_TAIL=2, and at
              960x540 with realesr-animevideov3 in bf16 and in int8; then
              the SR processor (``SuperResolution``) at 1080p with
              RealESRGAN_x2plus in int8 with ``int8_scales="dynamic"``,
              and with FW_fast6_x2 so under FW_RDB_BODY=resident;
              each with every launch counter set to 0 just before and
              read just after; output size, frame count and every frame
              checked against the kernel path. Every CLI run has the
              default flags (checkpoint, per-frame stats, gate, QA
              report) and must report errors == 0, every frame scored,
              its peak within the planner's count; more CLI runs:
              x2plus and realesr-animevideov3 in float32, and
              RealESRGAN_x4plus in bf16 at 960x540; the default x2plus
              run's QA report against the plain stats of its planes, the
              same run with --no-validate (the same bytes), one stopped
              after its first batch and resumed (the bytes of a straight
              run), and two runs in a subprocess that never sets TF32
              (the CLI with realesr-animevideov3, the processor with
              x2plus dynamic int8), each equal to the kernel path
  pre_sr      the quality preset's pre-SR modules on one 7-frame 1080p
              window of seeded frames, each on the card against the same
              module on the CPU (uint8 within 1 LSB on at most 0.1% of the
              values): the temporal denoiser by method (temporal, nafnet,
              bilateral), the alignment flow (max abs px), cross-frame
              attention; ms by CUDA events of the flow net on 6 pairs,
              warp and blend (with the median), the median, NAFNet, the
              bilateral filter and the attention; host ms of the scene
              score, the noise profile of the 8-frame head, the interlace
              detector, yadif, the anchor pass, the drift correction and
              the flicker reducer; each part's peak against the planner's
              pre-SR row. The default restores of phase 5 deinterlace these
              grainy clips (the detector reads them as combed, as the JAX
              one does), so phase 5 holds their planes to the kernel path
              on the frames after the default pre-SR stream.
  pre_sr_restore  at 1080p -> 4K on seeded progressive clips (and one
              1080i-style clip): ``--preset quality`` (12 frames, a cut at
              frame 6), ``--denoise --denoise-method nafnet
              --temporal-consistency --temporal-model ema``, the default
              restore of the 1080i-style clip (yadif engaged), ``--preset
              fast``, a long-form restore through the API (anchors every 4
              frames), the quality preset stopped and resumed (byte-equal
              to straight) and run in a subprocess that never sets TF32
              (byte-equal to the in-process run); counters 69/1/1 a batch
              (2 chain calls for fast), errors 0, every plane equal to the
              pre-SR stream then the kernel path, peaks within the
              planner's count with the pre-SR row; wall time and ms a frame
  film        ``--deduplicate --defect-repair --grain match`` through the
              CLI: x2plus (random weights, 23 blocks, bf16) from 1080p to
              4K on a 16-frame clip at 18 fps padded to 24 (every fourth
              frame an exact repeat), with a bright scratch column and
              dust: counters 69/1/1 a batch, SR on the unique frames only
              (its mapping the CPU analysis'), every plane equal to the
              pre-SR stream then the kernel path in ``rgb_u8`` on the
              unique frames, repeated by the mapping, then the numpy grain
              with the same seed; the same restore through the API,
              straight and stopped after its first batch then resumed
              (byte-equal); its peak against the planner's count; card and
              host ms of its parts
  6. times    each kernel by CUDA events beside its plain version, its
              roofline bound and, for the bf16 RDB, K1, tail1, the bf16
              chain and the band conv, cuDNN's F.conv2d (PyTorch has no
              single int8 3x3 convolution call: the int8 RDBs are printed
              beside the bf16 RDB instead); K2's time split by launch,
              and one chain conv's: bf16, and int8 (the quantization of
              the group input, a conv to codes, the group's last conv to
              bf16), ms and TFLOP/s
  c5          ``scripts/torch_presr_times.py --frames 4 12 --profile`` in a
              process of its own: dispatch's enqueue ms (pinned staging,
              non-blocking upload), the quality restore's busy share and
              peaks (allocated and reserved: the pre-SR stream runs on a
              CUDA stream of its own), the film restore's parts
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
AMAX_MAX_REL = 1e-6
DYN_INT8_PSNR_MIN = 40.0      # dynamic int8 vs bf16 (tests/test_int8_mode.py:77-90)
DYN_BODY_MAX_REL, DYN_BODY_MEAN_REL = 0.06, 0.008   # tests/test_int8_mode.py:57-75
UINT8_MAX_LSB, UINT8_MAX_FRAC = 1, 0.02
MODEL_MAX_ABS, MODEL_MEAN_ABS = 0.05, 0.005
RDB_MAC_PER_PX = 9 * (64 * 32 + 96 * 32 + 128 * 32 + 160 * 32 + 192 * 64)
K1_MAC_PER_PX = 9 * 64 * 64
# per body pixel: conv_up1 (4 phases x 4 taps), conv_up2 (4 x that),
# conv_hr and conv_last at 16 output pixels
K2_MAC_PER_PX = 4 * 4 * 64 * 64 * 5 + 16 * 9 * 64 * 64 + 16 * 9 * 64 * 3
K2_WEIGHTS = 2 * (4 * 64 * 4 * 64) + 9 * 64 * 64 + 9 * 64 * 3
# tail1 per input pixel (conv_up1's output, 2x the body resolution):
# conv_up2 (4 phases x 4 taps), then conv_hr and conv_last at 4 output pixels
TAIL1_MAC_PER_PX = 4 * 4 * 64 * 64 + 4 * 9 * 64 * 64 + 4 * 9 * 64 * 3
TAIL1_WEIGHTS = 4 * 64 * 4 * 64 + 9 * 64 * 64 + 9 * 64 * 3
VGG_GROUP = 8                  # convs per chain call (fused_srvgg.GROUP)
VGG_MAC_PER_PX = VGG_GROUP * 9 * 64 * 64
BAND_MAC_PER_PX = 9 * 64 * 64  # one 64->64 band conv
STEP_FLOOR = 2.0 ** -6         # bf16 steps counted at max(|v|, 2^-6) (tests/test_torch_fast_tail.py)
STEP_FRAC = 1e-3               # share of values one bf16 step apart (same file)
MAX_REGS = 168                 # a wgmma main-loop thread's registers (384 threads a CTA)
# the band conv's conv3x3_kernel instances (band_conv.cu): 64 channels with
# lrelu (fw_tail_hr's own) and without, 8 channels with and without
BAND_EPIS = ("BiasActEpiILb0ELb1E", "BiasActEpiILb0ELb0E", "Bf16x8EpiILb0E", "Bf16x8EpiILb1E")


# The dynamic-scale int8 restore of a clip through the SR processor (no
# CLI flag reaches it), run in a process of its own: argv = clip, .npz out,
# weights dir.
SUBPROCESS_DYNAMIC = """
import sys
import numpy as np
from framewright_tpu_torch.io.y4m import Y4MReader
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution
src, out, weights = sys.argv[1:4]
with Y4MReader(src) as r:
    frames = np.stack(list(r))
sr = SuperResolution(SRConfig(model_name="RealESRGAN_x2plus", compute_dtype="int8",
                              int8_scales="dynamic", output_color="yuv420",
                              yuv_full_range=True, weights_dir=weights))
sr.setup(*frames.shape[1:3])
y, u, v = sr.materialize(sr.dispatch(frames))
np.savez(out, y=y, u=u, v=v, batch=sr.plan.batch)
"""


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


@contextlib.contextmanager
def with_env(env: dict):
    """Set the environment variables ``env`` for the block, then restore
    each to what it was."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def block_work(ext, h: int, w: int) -> tuple:
    """(valid, ring_read) pixels of a batch of h x w frames cut into halo
    blocks: ``valid`` lie inside the blocks' valid rectangles, the only
    pixels where an RDB on blocks convolves (outside, x1..x4 are 0 and
    its output is x); ``ring_read`` are the ring pixels whose frame
    position lies in the grid of interiors, the only ones the refresh
    reads from a neighbour (it writes zeros to the others)."""
    from framewright_tpu_torch.ops import fused_rrdb

    r = ext.rects.long()
    valid = int(((r[:, 1] - r[:, 0]) * (r[:, 3] - r[:, 2])).sum())
    s_blk, halo, bh = fused_rrdb.S, fused_rrdb.HALO, fused_rrdb.BH
    nh, nw = fused_rrdb.grid_dims(h, w)

    def span(n: int) -> int:      # in-grid rows (columns) summed over n blocks
        return sum(min(s_blk, (n - i) * bh + halo) - max(0, halo - i * bh) for i in range(n))

    frames = r.shape[0] // ext.per_frame
    return valid, frames * (span(nh) * span(nw) - nh * nw * bh * bh)


def ptxas_entries(lines, names) -> list:
    """ptxas's lines about the kernels whose names hold one of ``names``:
    each entry's register, stack and spill lines, and any note that names
    one."""
    out, entry = [], False
    for ln in lines:
        if "Compiling entry" in ln:
            entry = any(n in ln for n in names)
        if entry or any(n in ln for n in names):
            out.append(ln)
    return out


def entry_registers(lines) -> dict:
    """ptxas's register count of each kernel entry in ``lines`` (as
    ptxas_entries returns them), by mangled name."""
    out, name = {}, None
    for ln in lines:
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = int(m.group(1))
    return out


def tail_split(build, fused_tail, wts, x, iters: int) -> dict:
    """K2's launches one by one through their C entry points, from x
    (B, h, w, 64): conv_up1, conv_up2, conv_hr, conv_last with the
    yuv420_u8 epilogue (full range), ms each by CUDA events."""
    import ctypes

    import torch

    b, h, w, _ = x.shape
    dev = x.device
    a0 = torch.empty(b, 2 * h, 2 * w, 64, dtype=torch.bfloat16, device=dev)
    a = torch.empty(b, 4 * h, 4 * w, 64, dtype=torch.bfloat16, device=dev)
    c = torch.empty_like(a)
    planes = [torch.empty(b, 4 * h, 4 * w, dtype=torch.uint8, device=dev)] + [
        torch.empty(b, 2 * h, 2 * w, dtype=torch.uint8, device=dev) for _ in range(2)]
    coef = (ctypes.c_float * 11)(*fused_tail.yuv420_coefficients(True).tolist())
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = {
        "conv_up1": lambda: build.check(lib.fw_tail_up2(
            x.data_ptr(), b, h, w, wts.up1_k.data_ptr(), wts.up1_b.data_ptr(), a0.data_ptr(),
            stream), "fw_tail_up2"),
        "conv_up2": lambda: build.check(lib.fw_tail_up2(
            a0.data_ptr(), b, 2 * h, 2 * w, wts.up2_k.data_ptr(), wts.up2_b.data_ptr(),
            a.data_ptr(), stream), "fw_tail_up2"),
        "conv_hr": lambda: build.check(lib.fw_tail_hr(
            a.data_ptr(), b, 4 * h, 4 * w, wts.hr_k.data_ptr(), wts.hr_b.data_ptr(),
            c.data_ptr(), stream), "fw_tail_hr"),
        "conv_last_yuv420_u8": lambda: build.check(lib.fw_tail_last(
            c.data_ptr(), b, 4 * h, 4 * w, wts.last_k.data_ptr(), wts.last_b.data_ptr(),
            2, ctypes.addressof(coef), *[p.data_ptr() for p in planes], stream),
            "fw_tail_last"),
    }
    return {name: cuda_ms(fn, iters) for name, fn in calls.items()}


def chain_split(build, group, group8, x, iters: int) -> dict:
    """One chain conv's launches through their C entry points, on x
    (B, H, W, 64) with each group's first conv: the bf16 conv, and the
    int8 quantization of x, a conv to the next codes and the group's last
    conv to bf16; ms each by CUDA events, and the convs' TFLOP/s (TOP/s
    for int8)."""
    import torch

    b, h, w, _ = x.shape
    out = torch.empty_like(x)
    q, q2 = (torch.empty(x.shape, dtype=torch.int8, device=x.device) for _ in range(2))
    inv1 = float(group8.aq[len(group8.alpha) + 2])
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def i8_conv(qout, o):
        return lambda: build.check(lib.fw_vgg_i8_conv(
            q.data_ptr(), b, h, w, group8.wk[0].data_ptr(), group8.dq[0].data_ptr(),
            group8.b[0].data_ptr(), group8.alpha[0].data_ptr(), inv1, qout, o, stream),
            "fw_vgg_i8_conv")

    calls = {
        "bf16_conv": lambda: build.check(lib.fw_vgg_conv(
            x.data_ptr(), b, h, w, group.wk[0].data_ptr(), group.b[0].data_ptr(),
            group.alpha[0].data_ptr(), out.data_ptr(), stream), "fw_vgg_conv"),
        "int8_quant": lambda: build.check(lib.fw_vgg_i8_quant(
            x.data_ptr(), q.data_ptr(), b * h * w, float(group8.aq[len(group8.alpha) + 1]),
            stream), "fw_vgg_i8_quant"),
        "int8_conv_codes": i8_conv(q2.data_ptr(), None),
        "int8_conv_last": i8_conv(None, out.data_ptr()),
    }
    gop = 2 * 9 * 64 * 64 * b * h * w / 1e9
    res = {}
    for name, fn in calls.items():
        ms = cuda_ms(fn, iters)
        res[name] = {"ms": ms} if name == "int8_quant" else {"ms": ms, "tflops": gop / ms}
    return res


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def synthetic_frames(n: int, h: int, w: int, seed: int, grain: float = 0.03,
                     cell: int = 16) -> np.ndarray:
    """Smooth seeded texture (a random grid every ``cell`` px, bilinear)
    panning 4 px per frame, plus fine grain (std ``grain`` of the range).
    By default the interlace detector reads the 1080p frames, once through
    the 4:2:0 Y4M codec, as combed (score ~0.70 against its 0.55), so the
    default restore deinterlaces them, as the JAX restore does;
    ``PROGRESSIVE`` frames read as progressive (~0.44)."""
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((1, 3, h // cell + 2, w // cell + 8),
                                         dtype=np.float32))
    big = F.interpolate(coarse, size=(h, w + 4 * n), mode="bilinear",
                        align_corners=False)[0].permute(1, 2, 0).numpy()
    frames = np.stack([big[:, 4 * t:4 * t + w] for t in range(n)])
    frames = frames + rng.normal(0.0, grain, frames.shape).astype(np.float32)
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


def check_steps(name: str, got, want, phase: str = "kernels") -> dict:
    """Kernel vs plain version in bf16 steps of max(|v|, 2^-6): at most
    one step apart, on fewer than STEP_FRAC of the values (the band
    conv's rule, tests/test_torch_fast_tail.py)."""
    g, w = got.float(), want.float()
    mag = g.abs().maximum(w.abs()).clamp_min(STEP_FLOOR)
    st = (g - w).abs() / (mag.log2().floor() - 7).exp2()
    s = {"name": f"{name} in bf16 steps", "max_steps": st.max().item(),
         "share_one_step": (st > 0).float().mean().item(),
         "tol": {"max_steps": 1, "share_one_step": STEP_FRAC}}
    emit({"phase": phase, **s})
    require(s["max_steps"] <= 1 and s["share_one_step"] < STEP_FRAC, f"{name}: {s}")
    return s


def check_equal(name: str, got, want, phase: str, within=None) -> dict:
    """A pair expected bit-equal: prints whether it is, with the diff. A
    pair that is not equal fails unless ``within(stats)`` holds (the
    parity tolerance of that output); its record then shows the gap."""
    import torch

    s = diff_stats(got, want)
    s.update(name=name, equal=torch.equal(got, want))
    emit({"phase": phase, **s})
    require(s["equal"] or (within is not None and within(s)), f"{name}: {s}")
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


def check_amax(name: str, got, want, phase: str = "kernels") -> float:
    """Per-frame activation ranges (B, 5) of a dynamic kernel and its plain
    version: maxima of the same f32 values, within 1e-6 relative."""
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    emit({"phase": phase, "name": name, "max_rel": rel, "got": got.tolist(),
          "tol": {"max_rel": AMAX_MAX_REL}})
    require(rel <= AMAX_MAX_REL, f"{name}: {rel}")
    return rel


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


PRE_SR_U8_FRAC = 1e-3         # uint8 within 1 LSB on at most 0.1% (tests/test_torch_denoise.py)
FLOW_MAX_PX = 1e-3            # the alignment flow, card vs CPU, both f32 without TF32
PRE_SR_H, PRE_SR_W = 1080, 1920
# synthetic frames (grain, cell) the interlace detector reads as
# progressive after the 4:2:0 codec, grainy enough that the quality
# preset's noise profile picks the temporal denoiser
PROGRESSIVE = {"grain": 0.02, "cell": 8}


def clip_with_cut(n: int, cut: int, h: int, w: int, seed: int) -> np.ndarray:
    """Seeded ``PROGRESSIVE`` frames, then from frame ``cut`` on a darker
    shot of another texture (scene score ~0.73 at the cut, ~0.16 within a
    shot, against the 0.30 threshold)."""
    second = synthetic_frames(n - cut, h, w, seed + 1, **PROGRESSIVE).astype(np.float32)
    return np.concatenate([synthetic_frames(cut, h, w, seed, **PROGRESSIVE),
                           (second * 0.55 + 10.0).astype(np.uint8)])


def interlaced_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """1080i-style frames: the odd field taken one field later, when the
    texture has panned 4 px further."""
    f = synthetic_frames(n + 1, h, w, seed, **PROGRESSIVE)
    out = f[:n].copy()
    out[:, 1::2] = f[1:, 1::2]
    return out


def host_ms(fn, reps: int = 3) -> float:
    """Least host-clock ms of ``reps`` calls of a host-only ``fn``."""
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t)
    return best * 1e3


def planes_equal(label: str, expect, frames: np.ndarray, planes_out, bs: int, dev) -> None:
    """Every written frame's planes equal to ``expect`` (a kernel path on
    uint8 frames on the card) run on ``frames`` in the restore's batches."""
    import torch

    require(len(planes_out) == len(frames),
            f"{label}: {len(planes_out)} frames written, {len(frames)} expected")
    worst = 0
    with torch.no_grad():
        for i in range(0, len(frames), bs):
            want = [p.cpu().numpy() for p in expect(torch.from_numpy(frames[i:i + bs]).to(dev))]
            for j in range(len(want[0])):
                for g, w_ in zip(planes_out[i + j], want):
                    worst = max(worst, int(np.abs(g.astype(np.int16) - w_[j]).max()))
    emit({"phase": "pre_sr_restore", "run": label,
          "name": "written planes vs the pre-SR stream then the kernel path",
          "max_abs": worst, "tol": {"max_abs": 0}})
    require(worst == 0, f"{label}: restore output differs from its stages by {worst}")


def pre_sr_stream_of(cfg, src: Path, frames: np.ndarray):
    """The restore's pre-SR stream for ``cfg`` run alone on decoded
    ``frames`` (in full f32, as the restore runs it) -> (frames, info)."""
    from framewright_tpu_torch.hw import full_f32
    from framewright_tpu_torch.restorer import VideoRestorer

    info = {}
    data = {"source": src, "frames_in": len(frames), "height": frames.shape[1],
            "width": frames.shape[2]}
    with full_f32():
        stream, finish = VideoRestorer(cfg)._pre_sr_stream(data, iter(frames), info)
        out = np.stack(list(stream))
    finish()
    return out, info


def pre_sr_phase(dev, iters: int, plan_checks: list) -> dict:
    """The pre-SR stream's modules on one 7-frame 1080p window, each on the
    card against the same module on the CPU; each part's ms by CUDA
    events, the host parts' ms, and each part's peak against the planner's
    row. -> the times."""
    import torch

    from framewright_tpu_torch import planner
    from framewright_tpu_torch.engine.temporal import ColorConsistencyEnforcer, GlobalAnchors
    from framewright_tpu_torch.hw import full_f32
    from framewright_tpu_torch.ops.warp import flow_warp
    from framewright_tpu_torch.processors.format import InterlaceDetector, YadifDeinterlacer
    from framewright_tpu_torch.processors.noise_profiler import NoiseProfiler
    from framewright_tpu_torch.processors.scene_detection import frame_pair_scores
    from framewright_tpu_torch.processors.temporal_attention import (
        CFAConfig,
        CrossFrameAttention,
    )
    from framewright_tpu_torch.processors.temporal_denoise import (
        FlickerReducer,
        TemporalDenoiseConfig,
        TemporalDenoiser,
        nanmedian,
    )

    t0 = time.perf_counter()
    h, w = PRE_SR_H, PRE_SR_W
    win = synthetic_frames(8, h, w, seed=31)
    on_card = [torch.from_numpy(f).to(dev) for f in win[:7]]
    on_cpu = [torch.from_numpy(f) for f in win[:7]]
    card_ms, peaks, out = {}, {}, {}
    nets = {}
    with torch.no_grad(), full_f32():
        for method in ("temporal", "nafnet", "bilateral"):
            dn = TemporalDenoiser(TemporalDenoiseConfig(method=method))
            dn.setup(h, w)
            cpu = TemporalDenoiser(TemporalDenoiseConfig(method=method, device="cpu"))
            cpu.setup(h, w)
            nets[method] = (dn, cpu)
            got, peak = part_peak(lambda: dn.denoise_window(on_card, 3))
            # the same bytes on every run (a resumed restore relies on it)
            require(np.array_equal(got, dn.denoise_window(on_card, 3)),
                    f"denoise {method}: two runs on the card differ")
            t_cpu = time.perf_counter()
            want = cpu.denoise_window(on_cpu, 3)
            t_cpu = time.perf_counter() - t_cpu
            check_u8(f"denoise {method}, 7-frame 1080p window, card vs CPU",
                     torch.from_numpy(got), torch.from_numpy(want), "pre_sr", PRE_SR_U8_FRAC)
            plan = planner.pre_sr_bytes(h, w, method, None)
            peaks[method] = (peak, plan)
            plan_checks.append((f"pre_sr {method}", peak, plan))
            card_ms[f"{method} (a centre, to uint8 on the host)"] = cuda_ms(
                lambda: dn.denoise_window(on_card, 3), iters)
            emit({"phase": "pre_sr", "name": f"denoise {method}", "peak_bytes": peak,
                  "planner_bytes": plan, "cpu_seconds": round(t_cpu, 3)})
        # the parts, on the card
        dn, cpu = nets["nafnet"]
        c, nbs, n_real = dn._slots(on_card, 3)
        cc, nbs_c, _ = cpu._slots(on_cpu, 3)
        flow = dn.flow_net.estimate_flow(c.expand_as(nbs), nbs)
        flow_c = cpu.flow_net.estimate_flow(cc.expand_as(nbs_c), nbs_c)
        flow_err = (flow.cpu() - flow_c).abs().max().item()
        emit({"phase": "pre_sr", "name": "alignment flow (6 pairs at 1080p), card vs CPU",
              "max_abs_px": flow_err, "max_abs_flow_px": flow_c.abs().max().item(),
              "tol": {"max_abs_px": FLOW_MAX_PX}})
        require(flow_err <= FLOW_MAX_PX, f"alignment flow differs by {flow_err} px")
        warped = flow_warp(nbs, flow)
        diff = ((warped - c) ** 2).mean(-1, keepdim=True)
        card_ms["ifnet, 6 pairs"] = cuda_ms(
            lambda: dn.flow_net.estimate_flow(c.expand_as(nbs), nbs), iters)
        card_ms["warp and blend (with the median)"] = cuda_ms(
            lambda: dn.blend(c, flow_warp(nbs, flow), n_real), iters)
        card_ms["median of 6 x 1080 x 1920"] = cuda_ms(lambda: nanmedian(diff), iters)
        card_ms["nafnet FW_nafnet_dn"] = cuda_ms(lambda: dn.naf.apply_padded(c[None]), iters)
        card_ms["bilateral"] = cuda_ms(lambda: TemporalDenoiser.bilateral(c[None]), iters)
        cfa = CrossFrameAttention(CFAConfig(radius=1))
        cfa_cpu = CrossFrameAttention(CFAConfig(radius=1), device="cpu")
        got, peak = part_peak(lambda: cfa._filter(on_card[2:5]))
        require(np.array_equal(got, cfa._filter(on_card[2:5])),
                "cross-frame attention: two runs on the card differ")
        check_u8("cross-frame attention, 3-frame 1080p window, card vs CPU",
                 torch.from_numpy(got), torch.from_numpy(cfa_cpu._filter(on_cpu[2:5])),
                 "pre_sr", PRE_SR_U8_FRAC)
        plan = planner.pre_sr_bytes(h, w, None, "attention")
        peaks["attention"] = (peak, plan)
        plan_checks.append(("pre_sr attention", peak, plan))
        x3 = torch.stack(on_card[2:5])
        card_ms["cfa (on the card)"] = cuda_ms(lambda: cfa.run(x3), iters)
        card_ms["cfa (a frame, to uint8 on the host)"] = cuda_ms(
            lambda: cfa._filter(on_card[2:5]), iters)
        card_ms["upload of a uint8 frame"] = cuda_ms(lambda: torch.from_numpy(win[0]).to(dev),
                                                      iters)
    del nets, dn, cpu, flow, flow_c, warped, diff, x3
    torch.cuda.empty_cache()
    # the host parts (numpy)
    enforcer = ColorConsistencyEnforcer(GlobalAnchors.extract(iter(win[:1]), 1), 0.5)
    host = {
        "frame_pair_scores, a 1080p pair": host_ms(
            lambda: frame_pair_scores(win[0][None], win[1][None])),
        "NoiseProfiler, the 8-frame head": host_ms(
            lambda: NoiseProfiler(sample_frames=8).analyze_frames(list(win)), 1),
        "interlace detector, a sampled frame": host_ms(
            lambda: InterlaceDetector(sample_every=1).analyze(iter(win[:1]))),
        "yadif, a frame": host_ms(
            lambda: list(YadifDeinterlacer().process_stream(iter(win[:4]))), 1) / 4,
        "anchor pass, a sampled frame": host_ms(
            lambda: GlobalAnchors.extract(iter(win[:4]), sample_every=1), 1) / 4,
        "drift correction, a frame": host_ms(
            lambda: enforcer.correct(win[1], 3)),
        "flicker reducer (ema), a frame": host_ms(
            lambda: list(FlickerReducer().reduce_stream(iter(win))), 1) / len(win),
    }
    emit({"phase": "pre_sr", "card": torch.cuda.get_device_name(0), "card_ms": card_ms,
          "host_ms": host, "peaks_vs_planner": peaks,
          "seconds": round(time.perf_counter() - t0, 3)})
    return {"card_ms": card_ms, "host_ms": host}


def pre_sr_restores(tmp: Path, nw: str, dev, x: dict) -> dict:
    """The restores of this slice: ``--preset quality`` on a 12-frame 1080p
    clip with a cut at frame 6 (by default, on the card), ``--denoise
    --denoise-method nafnet --temporal-consistency --temporal-model ema``,
    the quality preset stopped and resumed, and in a subprocess that never
    sets TF32; the default restore of a 1080i-style clip (yadif engaged),
    a long-form restore through the API, and ``--preset fast``. Every
    counter is set to 0 just before a run and read just after; every
    written frame equals the pre-SR stream then the kernel path on the
    decoded frames; peaks within the planner's count. -> wall seconds and
    ms a frame of each run."""
    import torch

    from framewright_tpu_torch import planner
    from framewright_tpu_torch.config import Config, build_config
    from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
    from framewright_tpu_torch.models.registry import MODEL_SPECS, bf16_masters, load_weights
    from framewright_tpu_torch.models.srvgg import SRVGGNet
    from framewright_tpu_torch.restorer import VideoRestorer, pre_sr_reserve

    t0 = time.perf_counter()
    cli_run, reset, read = x["cli_run"], x["reset_counters"], x["read_counters"]
    model, kernel_path = x["model"], x["kernel_path"]
    # --preset fast's model, as the restore loads it (the packaged checkpoint)
    fastvgg = SRVGGNet.from_state_dict(MODEL_SPECS["FW_fastvgg_x2"].arch_config,
                                       bf16_masters(load_weights("FW_fastvgg_x2")[1]), dev)
    h, w = PRE_SR_H, PRE_SR_W
    clips = {}
    for name, frames in (("cut", clip_with_cut(12, 6, h, w, seed=41)),
                         ("interlaced", interlaced_frames(8, h, w, seed=43)),
                         ("long", synthetic_frames(8, h, w, 45, **PROGRESSIVE))):
        src = tmp / f"pre_sr_{name}.y4m"
        with Y4MWriter(src, w, h, fps=24) as writer:
            for f in frames:
                writer.write_frame(f)
        with Y4MReader(src) as reader:
            clips[name] = (src, np.stack(list(reader)))
    walls = {}

    def counts_ok(label, launches, batches, srvgg=False) -> None:
        want = {k: 0 for k in launches}
        if srvgg:
            want["fused_conv_chain"] = 2 * batches
        else:
            want.update(fused_rdb=69 * batches, conv_body_skip=batches, fused_tail=batches)
        require(batches > 0 and launches == want,
                f"{label}: launch counts {launches}, expected {want}")

    def cli_case(label, clip, argv, preset, overrides, expect, srvgg=False):
        src, decoded = clips[clip]
        out = tmp / f"pre_sr_{len(walls)}.y4m"
        proj = tmp / f"pre_sr_proj_{len(walls)}"
        t_run = time.perf_counter()
        reset()
        rc, summary, peak = cli_run(["restore", str(src), "-o", str(out), "--weights-dir", nw,
                                     "--project-dir", str(proj), *argv])
        launches = read()
        wall = time.perf_counter() - t_run
        require(rc == 0, f"{label}: exited {rc}")
        cfg = build_config(preset, {"weights_dir": nw, **overrides})
        plan = (summary["batch_size"] * planner.frame_bytes(
            h, w, 2, "srvgg" if srvgg else "rrdb", "bfloat16", stats=True)
            + pre_sr_reserve(cfg, h, w))
        report = json.loads((proj / "qa_report.json").read_text())
        walls[label] = {"wall_seconds": wall, "ms_per_frame": 1e3 * wall / len(decoded),
                        "batch_size": summary["batch_size"]}
        emit({"phase": "pre_sr_restore", "run": label, "summary": summary, "launches": launches,
              "wall_seconds": wall, "ms_per_frame": 1e3 * wall / len(decoded),
              "peak_mem_bytes_above_base": peak, "planner_bytes": plan,
              "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
              "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
              "qa_report_pre_sr": report["pre_sr"]})
        x["plan_checks"].append((f"pre_sr restore {label}", peak, plan))
        require(summary["errors"] == 0 and summary["frames"] == len(decoded)
                and summary["quality"]["samples"] == len(decoded), f"{label}: {summary}")
        counts_ok(label, launches, summary["batches"], srvgg)
        ow, oh, planes_out = read_y4m_planes(out)
        require((ow, oh) == (2 * w, 2 * h), f"{label}: output {ow}x{oh}")
        frames, info = pre_sr_stream_of(cfg, src, decoded)
        require(report["pre_sr"] == json.loads(json.dumps(summary["pre_sr"])),
                f"{label}: QA report's pre_sr {report['pre_sr']}")
        planes_equal(label, expect, frames, planes_out, summary["batch_size"], dev)
        return out, summary, info

    x2 = kernel_path(model, model.fast_weights())
    quality_out, summary, info = cli_case(
        "--preset quality (12 frames, cut at 6)", "cut", ["--preset", "quality"], "quality",
        {}, x2)
    dn = summary["pre_sr"]["denoise"]
    require(dn["frames"] == 12 and dn["scene_resets"] == 1 and dn["profile"] is not None
            and summary["pre_sr"]["temporal_consistency"] == "attention"
            and summary["pre_sr"]["deinterlace"]["mode"] == "off",
            f"quality preset's pre-SR stream: {summary['pre_sr']}")
    require(info["denoise"] == dn, f"the stream alone: {info['denoise']}, restore: {dn}")
    cli_case("--denoise --denoise-method nafnet --temporal-consistency --temporal-model ema",
             "cut", ["--denoise", "--denoise-method", "nafnet", "--temporal-consistency",
                     "--temporal-model", "ema"], "",
             {"denoise": True, "denoise_model": "nafnet", "temporal_consistency": True,
              "temporal_model": "ema"}, x2)
    _, summary, _ = cli_case("default restore of a 1080i-style clip", "interlaced", [], "",
                             {}, x2)
    require(summary["pre_sr"]["deinterlace"]["mode"] == "yadif",
            f"interlaced clip: {summary['pre_sr']}")
    _, summary, _ = cli_case("--preset fast", "long", ["--preset", "fast"], "fast", {},
                             kernel_path(fastvgg, fastvgg.fast_weights()), srvgg=True)

    # a long-form restore through the API, anchors every 4 frames
    t_run = time.perf_counter()
    src, decoded = clips["long"]
    cfg = Config(project_dir=tmp / "lf", weights_dir=nw, long_form="on", anchor_interval=4)
    reset()
    res = VideoRestorer(cfg).restore_video(src, tmp / "lf.y4m")
    launches = read()
    wall = time.perf_counter() - t_run
    walls["long-form (API, anchors every 4)"] = {"wall_seconds": wall,
                                                 "ms_per_frame": 1e3 * wall / len(decoded)}
    emit({"phase": "pre_sr_restore", "run": "long-form API", "pre_sr": res.pre_sr,
          "launches": launches, "errors": res.errors, "wall_seconds": wall})
    require(res.pre_sr["long_form"] == {"anchors": 2} and res.errors == 0
            and res.frames_out == len(decoded), f"long-form restore: {res}")
    counts_ok("long-form API", launches, res.batches)
    frames, _ = pre_sr_stream_of(cfg, src, decoded)
    require(not np.array_equal(frames, decoded), "drift correction left the frames as they were")
    planes_equal("long-form API", x2, frames, read_y4m_planes(tmp / "lf.y4m")[2],
                 res.batch_size, dev)

    # the quality preset stopped after its first batch, then resumed
    t_run = time.perf_counter()
    src, decoded = clips["cut"]

    def quality_cfg(proj: str) -> Config:
        return build_config("quality", {"project_dir": tmp / proj, "weights_dir": nw,
                                        "batch_size": 2})

    class Stop(Exception):
        pass

    def stop_after_first(done, total):
        if done >= 2:
            raise Stop(done)

    straight = VideoRestorer(quality_cfg("qs")).restore_video(src, tmp / "q_straight.y4m")
    resumed = tmp / "q_resumed.y4m"
    try:
        VideoRestorer(quality_cfg("qr"), stop_after_first).restore_video(src, resumed)
        require(False, "the stopped quality restore ran to its end")
    except Stop:
        pass
    res = VideoRestorer(quality_cfg("qr")).restore_video(src, resumed)
    same = resumed.read_bytes() == (tmp / "q_straight.y4m").read_bytes()
    rec = {"phase": "pre_sr_restore", "run": "--preset quality stopped and resumed",
           "resumed_from": res.resumed_from, "batches": res.batches,
           "straight_batches": straight.batches, "denoise_frames": res.pre_sr["denoise"]["frames"],
           "byte_equal_to_straight": same, "seconds": round(time.perf_counter() - t_run, 3)}
    emit(rec)
    require(same and res.resumed_from == 2 and res.errors == 0
            and res.batches == straight.batches - 1, f"quality resume: {rec}")

    # a process that never touches the TF32 flags: the same bytes
    t_run = time.perf_counter()
    sub_out = tmp / "q_sub.y4m"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "framewright_tpu_torch.cli", "restore", str(src), "-o",
         str(sub_out), "--preset", "quality", "--weights-dir", nw, "--project-dir",
         str(tmp / "q_sub")], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, f"subprocess quality restore: {proc.stderr[-2000:]}")
    sub_summary = json.loads(proc.stdout)
    same = sub_out.read_bytes() == quality_out.read_bytes()
    emit({"phase": "pre_sr_restore", "run": "--preset quality in a subprocess without TF32 "
          "settings", "summary": sub_summary, "byte_equal_to_in_process": same,
          "seconds": round(time.perf_counter() - t_run, 3)})
    require(same and sub_summary["errors"] == 0,
            "the quality restore in a subprocess differs from the in-process one")
    emit({"phase": "pre_sr_restore", "walls": walls,
          "seconds": round(time.perf_counter() - t0, 3)})
    return walls


FILM_H, FILM_W, FILM_FRAMES = 1080, 1920, 16
FILM_FLAGS = {"deduplicate": True, "defect_repair": True, "grain_mode": "match"}


def film_clip(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """Film at 18 fps padded to 24: ``PROGRESSIVE`` texture panning 48 px
    a unique frame, every fourth frame an exact repeat of the one before;
    a bright scratch (+60) down column 3w/8 + 1 of every frame and a 6x6
    dust speck (250) on every fourth frame from frame 1."""
    m = n - n // 4
    wide = synthetic_frames(1, h, w + 48 * (m - 1), seed, **PROGRESSIVE)[0]
    frames = np.stack([wide[:, 48 * u:48 * u + w] for u in
                       (t - (t + 1) // 4 for t in range(n))]).astype(np.int16)
    frames[:, :, w * 3 // 8 + 1] += 60
    for t in range(1, n, 4):
        y0, x0 = (h // 3 + 37 * t) % (h - 8), (w // 5 + 101 * t) % (w - 8)
        frames[t, y0:y0 + 6, x0:x0 + 6] = 250
    return np.clip(frames, 0, 255).astype(np.uint8)


def film_expect(rgb_path, frames: np.ndarray, mapping: dict, bs: int, seed: int,
                strength: float, full_range: bool) -> list:
    """A film restore's planes from its parts run alone on the pre-SR
    frames: in ring batches of ``bs``, SR (``rgb_path``) on the frames of
    a unique position not seen yet, each output repeated at every frame
    mapped to it, then the numpy grain (``GrainManager`` match with one
    ``default_rng(seed)``, the target measured once from the first
    batch's unique frames), then the 4:2:0 encode."""
    from framewright_tpu_torch import native
    from framewright_tpu_torch.processors.film import GrainManager, estimate_grain_level

    gm = GrainManager(mode="match", strength=strength, seed=seed)
    target, last_u, last_out, planes = 0.0, -1, None, []
    for i in range(0, len(frames), bs):
        batch = frames[i:i + bs]
        sel = []
        for p in range(len(batch)):
            if mapping[i + p] > last_u:
                sel.append(p)
                last_u = mapping[i + p]
        outs = rgb_path(batch[sel]) if sel else []
        tgt = target
        if tgt <= 0:
            tgt = 0.2               # a batch without a unique frame: not stored
            if sel:
                tgt = target = max(0.05, float(np.mean([estimate_grain_level(f)
                                                        for f in batch[sel][:2]])))
        k = 0
        for p in range(len(batch)):
            if k < len(sel) and sel[k] == p:
                last_out = outs[k]
                k += 1
            planes.append(native.rgb_to_yuv420(gm.process(last_out, target_level=tgt),
                                               full_range=full_range))
    return planes


def film_phase(tmp: Path, nw: str, dev, x: dict) -> dict:
    """``--deduplicate --defect-repair --grain match`` (x2plus, bf16) on a
    16-frame 1080p film clip through the CLI: counters 69/1/1 a batch
    over unique frames only, the mapping of the CPU analysis, every plane
    equal to ``film_expect`` on the pre-SR stream's frames with the kernel
    path in ``rgb_u8``; the same restore through the API straight and
    stopped after its first batch then resumed (byte-equal); its peak
    against the planner's count; card and host ms of its parts. -> times."""
    import torch

    from framewright_tpu_torch import planner
    from framewright_tpu_torch.config import build_config
    from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
    from framewright_tpu_torch.processors.deduplication import FrameDeduplicator
    from framewright_tpu_torch import native
    from framewright_tpu_torch.io import y4m as y4m_mod
    from framewright_tpu_torch.processors.film import (
        DefectRepairer,
        GrainManager,
        estimate_grain_level,
    )
    from framewright_tpu_torch.processors.super_resolution import HostStaging, SuperResolution
    from framewright_tpu_torch.quality.validators import QualityValidator
    from framewright_tpu_torch.restorer import VideoRestorer, pre_sr_reserve

    t0 = time.perf_counter()
    h, w, n = FILM_H, FILM_W, FILM_FRAMES
    src = tmp / "film.y4m"
    with Y4MWriter(src, w, h, fps=24) as writer:
        for f in film_clip(n, h, w, seed=47):
            writer.write_frame(f)
    with Y4MReader(src) as reader:
        decoded = np.stack(list(reader))
    analysis = FrameDeduplicator().analyze(iter(decoded), target_fps=24.0)
    model, fw = x["model"], x["model"].fast_weights()

    def rgb_path(xs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            xt = torch.from_numpy(np.ascontiguousarray(xs)).to(dev).to(torch.bfloat16) / 255.0
            return model.apply_fast(xt, "rgb_u8", True, weights=fw).cpu().numpy()

    sr_frames = [0]
    dispatch = SuperResolution.dispatch

    def counted(self, frames):
        sr_frames[0] += len(frames)
        return dispatch(self, frames)

    out = tmp / "film_cli.y4m"
    SuperResolution.dispatch = counted
    try:
        x["reset_counters"]()
        t_run = time.perf_counter()
        rc, summary, peak = x["cli_run"](
            ["restore", str(src), "-o", str(out), "--weights-dir", nw, "--project-dir",
             str(tmp / "film_proj"), "--deduplicate", "--defect-repair", "--grain", "match"])
        wall = time.perf_counter() - t_run
        launches = x["read_counters"]()
    finally:
        SuperResolution.dispatch = dispatch
    require(rc == 0, f"film restore exited {rc}")
    bs, batches = summary["batch_size"], summary["batches"]
    cfg = build_config("", {"weights_dir": nw, **FILM_FLAGS})
    plan = (bs * planner.frame_bytes(h, w, 2, "rrdb", "bfloat16", stats=False)
            + pre_sr_reserve(cfg, h, w))
    x["plan_checks"].append(("film restore", peak, plan))
    mapping = analysis.frame_mapping
    ring_batches = sum(1 for i in range(0, n, bs)
                       if any(mapping[j] > (mapping[i - 1] if i else -1)
                              for j in range(i, min(i + bs, n))))
    want = {k: 0 for k in launches}
    want.update(fused_rdb=69 * batches, conv_body_skip=batches, fused_tail=batches)
    emit({"phase": "film", "run": "cli --deduplicate --defect-repair --grain match",
          "summary": summary, "launches": launches, "sr_frames": sr_frames[0],
          "unique_frames": analysis.unique_frames, "wall_seconds": wall,
          "ms_per_frame": 1e3 * wall / n, "peak_mem_bytes_above_base": peak,
          "peak_reserved_bytes": torch.cuda.max_memory_reserved(), "planner_bytes": plan})
    require(summary["errors"] == 0 and summary["frames"] == n
            and summary["duplicates_removed"] == analysis.duplicates == n // 4,
            f"film restore: {summary}")
    require(summary["pre_sr"]["host_codec"] == {"decode": "native", "encode": "native"}
            and summary["pre_sr"]["deinterlace"]["mode"] == "off"
            and w * 3 // 8 + 1 in summary["pre_sr"]["defect_repair"]["scratch_columns"]
            and summary["post_sr"]["grain"]["mode"] == "match", f"film restore: {summary}")
    require(sr_frames[0] == analysis.unique_frames and batches == ring_batches
            and launches == want, f"film restore: SR on {sr_frames[0]} frames in {batches} "
            f"batches, launches {launches}; expected {analysis.unique_frames} frames, "
            f"{ring_batches} batches, {want}")
    # the planes from the parts run alone
    pre, _ = pre_sr_stream_of(cfg, src, decoded)
    with Y4MReader(out) as r:
        full_range = r.full_range
    expect = film_expect(rgb_path, pre, mapping, bs, cfg.seed, cfg.grain_strength, full_range)
    ow, oh, planes_out = read_y4m_planes(out)
    worst = max(int(np.abs(g.astype(np.int16) - e).max())
                for got, exp in zip(planes_out, expect) for g, e in zip(got, exp))
    emit({"phase": "film", "name": "written planes vs the pre-SR stream, the kernel path "
          "(rgb_u8) on the unique frames repeated by the CPU analysis' mapping, the numpy "
          "grain and the encode", "max_abs": worst, "tol": {"max_abs": 0}})
    require((ow, oh) == (2 * w, 2 * h) and len(planes_out) == n and worst == 0,
            f"film restore differs from its parts by {worst}")
    # through the API: the mapping, and stopped after its first batch then resumed

    class Stop(Exception):
        pass

    def stop_after_first(done, total):
        if done >= bs:
            raise Stop(done)

    def api_cfg(proj: str):
        return build_config("", {"project_dir": tmp / proj, "weights_dir": nw,
                                 "batch_size": bs, **FILM_FLAGS})

    straight = VideoRestorer(api_cfg("film_s")).restore_video(src, tmp / "film_s.y4m")
    resumed = tmp / "film_r.y4m"
    try:
        VideoRestorer(api_cfg("film_r"), stop_after_first).restore_video(src, resumed)
        require(False, "the stopped film restore ran to its end")
    except Stop:
        pass
    res = VideoRestorer(api_cfg("film_r")).restore_video(src, resumed)
    rec = {"phase": "film", "run": "API straight, and stopped after its first batch then "
           "resumed", "mapping_equals_cpu_analysis": straight.dedup.frame_mapping == mapping,
           "straight_equals_cli": (tmp / "film_s.y4m").read_bytes() == out.read_bytes(),
           "resumed_from": res.resumed_from, "resumed_batches": res.batches,
           "straight_batches": straight.batches, "post_sr": res.post_sr,
           "byte_equal_to_straight": resumed.read_bytes() == (tmp / "film_s.y4m").read_bytes()}
    emit(rec)
    require(rec["mapping_equals_cpu_analysis"] and rec["straight_equals_cli"]
            and rec["byte_equal_to_straight"] and res.resumed_from == bs
            and res.post_sr == straight.post_sr and res.errors == 0, f"film resume: {rec}")
    # the parts' times: card (CUDA events) and host (least of 3)
    one = decoded[:1]
    x1 = torch.from_numpy(one).to(dev).to(torch.bfloat16) / 255.0
    staging = HostStaging()
    with torch.no_grad():
        out4k = model.apply_fast(x1, "rgb_u8", True, weights=fw)
        card = {"SR rgb_u8 (a frame, kernel path)": cuda_ms(
                    lambda: model.apply_fast(x1, "rgb_u8", True, weights=fw), 3, 1),
                "D2H of a 4K RGB frame into a pinned output slot": cuda_ms(
                    lambda: staging.release(staging.download([out4k])[0]), 10)}
    frame4k = out4k[0].cpu().numpy()
    gm = GrainManager(mode="match", strength=0.3, seed=0)

    def gate_pair():
        v = QualityValidator()
        v.observe(one[0], frame4k)
        v.validate()

    host = {"dedup hash, a 1080p frame": host_ms(
                lambda: FrameDeduplicator().analyze(iter(decoded[:4]))) / 4,
            "defect repair, a 1080p frame (5-frame median)": host_ms(
                lambda: list(DefectRepairer().process_stream(iter(decoded[:5]))), 1) / 5,
            "grain match, a 4K frame (synthesize)": host_ms(
                lambda: gm.process(frame4k, target_level=0.9)),
            "grain level estimate, a 4K frame": host_ms(lambda: estimate_grain_level(frame4k)),
            "gate: observe and score one RGB pair": host_ms(gate_pair),
            "encode a 4K RGB frame (native)": host_ms(
                lambda: native.rgb_to_yuv420(frame4k, True)),
            "encode a 4K RGB frame (numpy)": host_ms(
                lambda: y4m_mod.rgb_to_yuv420(frame4k, True), 2)}
    del out4k, x1
    emit({"phase": "film", "card_ms": card, "host_ms": host,
          "seconds": round(time.perf_counter() - t0, 3)})
    return {"wall_seconds": wall, "ms_per_frame": 1e3 * wall / n, "card_ms": card,
            "host_ms": host}


def native_phase() -> dict:
    """The native host codec built from the port's source (never JAX's
    ``native/libfwcore.so``), its 4:2:0 decode and encode at 1080p and 4K
    against the numpy copy: equal bytes, ms (least of 5 native, 3 numpy)."""
    from framewright_tpu_torch import native
    from framewright_tpu_torch.io import y4m as y4m_mod

    t0 = time.perf_counter()
    lib = native.get_lib()
    build_s = time.perf_counter() - t0
    path = native.lib_path()
    require(lib is not None and path.is_file() and lib._name == str(path)
            and path.parent.parent == ROOT / "framewright_tpu_torch" / "ops" / "_build",
            f"the native host codec did not build from the port's source ({path})")
    rng = np.random.default_rng(5)
    rec = {"phase": "native", "source": "framewright_tpu_torch/native/fwcore.cpp",
           "library": str(path.relative_to(ROOT)), "build_seconds": build_s,
           "version": lib.fwcore_version(), "ms": {}, "equal": {}}
    for label, (h, w) in (("1080p", (1080, 1920)), ("4K", (2160, 3840))):
        rgb = rng.integers(0, 256, (h, w, 3), np.uint8)
        y, u, v = y4m_mod.rgb_to_yuv420(rgb, False)
        enc = native.rgb_to_yuv420(rgb, False)
        rec["equal"][label] = (all(np.array_equal(a, b) for a, b in zip(enc, (y, u, v)))
                               and np.array_equal(native.yuv420_to_rgb(y, u, v, False),
                                                  y4m_mod.yuv_to_rgb(y, u, v, False)))
        rec["ms"][label] = {
            "decode native": host_ms(lambda: native.yuv420_to_rgb(y, u, v, False), 5),
            "decode numpy": host_ms(lambda: y4m_mod.yuv_to_rgb(y, u, v, False)),
            "encode native": host_ms(lambda: native.rgb_to_yuv420(rgb, False), 5),
            "encode numpy": host_ms(lambda: y4m_mod.rgb_to_yuv420(rgb, False))}
    emit(rec)
    require(all(rec["equal"].values()), f"native codec differs from the numpy copy: {rec}")
    return rec["ms"]


def c5_times() -> dict:
    """``scripts/torch_presr_times.py --frames 4 12 --profile`` in a process
    of its own: dispatch's enqueue ms, the quality restore's busy share
    and peaks, and the film restore's parts."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_presr_times.py"),
                           "--frames", "4", "12", "--profile"], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    require(proc.returncode == 0, f"torch_presr_times.py: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    runs = out["runs"]
    rec = {"phase": "c5", "card": out["card"],
           "enqueue_ms_per_dispatch": {k: r["enqueue_ms_per_dispatch"] for k, r in runs.items()},
           "quality_busy_share": runs["quality 12 profiled"]["device_busy_share"],
           "quality_busy_share_unprofiled":
               runs["quality 12 profiled"]["device_busy_share_unprofiled"],
           "quality_peaks": {k: (r["peak_allocated_bytes"], r["peak_reserved_bytes"])
                             for k, r in runs.items() if k.startswith("quality")},
           "steady_ms_per_frame": out["steady_ms_per_frame"],
           "film_parts_ms": runs["film 12"]["parts_ms"],
           "seconds": round(time.perf_counter() - t0, 3)}
    emit(rec)
    return rec


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
        pallas_conv,
    )
    from framewright_tpu_torch.config import Config
    from framewright_tpu_torch.hw import full_f32
    from framewright_tpu_torch.processors.super_resolution import (
        SRConfig,
        SuperResolution,
        _frame_stats,
    )
    from framewright_tpu_torch.restorer import VideoRestorer

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
    # the wgmma main loop's kernels (bf16 and int8 RDB stages, K1):
    # registers, spills and ptxas's notes, and the dynamic shared memory
    # the bf16 ones launch with
    wg_lines = ptxas_entries(info.ptxas, ("conv3x3_kernel",))
    spilling = [ln for ln in wg_lines if "spill" in ln and " 0 bytes spill stores" not in ln]
    over = {k: r for k, r in entry_registers(wg_lines).items() if r > MAX_REGS}
    emit({"phase": "build", "conv3x3_wgmma": wg_lines, "spilling": spilling,
          "over_max_registers": over,
          "dynamic_smem_bytes": {f"N={n}": _build.library().fw_wgmma_smem_bytes(n)
                                 for n in (32, 64)}})
    for epi in ("BiasActEpiILb1ELb1E", "LastEpi") + BAND_EPIS:
        require(any("Compiling entry" in ln and epi in ln for ln in wg_lines),
                f"no wgmma main-loop instance with {epi} in ptxas's output")
    require(not spilling, f"wgmma main-loop instances spill: {spilling}")
    require(not over, f"wgmma main-loop instances above {MAX_REGS} registers: {over}")
    band_lines = ptxas_entries(wg_lines, BAND_EPIS)
    emit({"phase": "build", "band_conv_ptxas": band_lines,
          "band_conv_registers": entry_registers(band_lines)})
    # the SRVGG chain convs on their own: the bf16 one (PreluEpi, a
    # conv3x3_kernel instance) and the int8 one's own loop
    # (vgg_i8_conv_kernel, to codes and to bf16), none of which may spill
    vgg_lines = ptxas_entries(info.ptxas, ("PreluEpi", "vgg_i8_conv_kernel"))
    for name in ("PreluEpi", "vgg_i8_conv_kernelILb0", "vgg_i8_conv_kernelILb1"):
        require(any("Compiling entry" in ln and name in ln for ln in vgg_lines),
                f"no SRVGG chain instance {name} in ptxas's output")
    vgg_spills = [ln for ln in vgg_lines if "spill" in ln and " 0 bytes spill stores" not in ln]
    emit({"phase": "build", "srvgg_chain_ptxas": vgg_lines, "spilling": vgg_spills})
    require(not vgg_spills, f"SRVGG chain kernels spill: {vgg_spills}")

    # native: the host codec from the port's source, against its numpy copy
    native_ms = native_phase()

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
    # the dynamic-scale RDB: codes, per-frame ranges and output, with and
    # without the RRDB residual
    fwd = model.fast_weights_int8(None)
    e = []
    for label, x_in, k, carry in (("", feat, 0, None), ("_res", None, 2, feat)):
        x_in = o_k if x_in is None else x_in
        q_k = torch.zeros(*feat.shape[:3], 192, dtype=torch.int8, device=dev)
        q_p = torch.zeros_like(q_k)
        o_k = torch.empty_like(feat) if carry is None else carry.clone()
        o_p = torch.empty_like(feat) if carry is None else carry.clone()
        a_k = fused_rrdb.fused_rdb_dynamic(x_in, q_k, o_k, fwd.body[0][k],
                                           carry=None if carry is None else o_k)
        a_p = fused_rrdb.fused_rdb_dynamic_plain(x_in, q_p, o_p, fwd.body[0][k],
                                                 carry=None if carry is None else o_p)
        torch.cuda.synchronize()
        e += [check_codes(f"rdb_dynamic{label} q0..q4", q_k, q_p)["max_abs"],
              check_amax(f"rdb_dynamic{label} amax", a_k, a_p),
              check_bf16(f"rdb_dynamic{label}", o_k, o_p)["max_abs"]]
    errs["rdb_dynamic"] = max(e)
    del q_k, q_p, o_k, o_p
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
    # tail1 from conv_up1's output at the main-path shape (1080x1920 -> 4K)
    with torch.no_grad():
        a0 = model.tail1_input(feat, c_k[..., :64])
    t_k = fused_tail.fused_tail1(a0, fw.tail)
    t_p = fused_tail.fused_tail1_plain(a0, fw.tail)
    torch.cuda.synchronize()
    errs["tail1"] = check_bf16("tail1", t_k, t_p)["max_abs"]
    del t_k, t_p
    # the resident body's kernels on the main-path body: 1x540x960 cut into
    # 6x10 halo blocks of 112x112. The refresh rebuilds poisoned rings (every
    # ring, also outside the grid) of a 192-channel workspace and of a
    # 64-channel carry: equal to its plain version and to a re-extraction
    # of the assembled frame
    b1, h1, w1 = feat.shape[:3]
    nh, nw = fused_rrdb.grid_dims(h1, w1)
    ext = fused_rrdb.BlockExtents.of(b1, h1, w1, dev)
    s_blk, halo = fused_rrdb.S, fused_rrdb.HALO
    ring = torch.ones(s_blk, s_blk, dtype=torch.bool, device=dev)
    ring[halo:s_blk - halo, halo:s_blk - halo] = False
    errs["halo_refresh"] = 0.0
    for ch in (fused_rrdb.WS_C, 64):
        blk = fused_rrdb.extract_blocks(feat, ch)
        blk[..., 64:] = 0
        blk[:, ring, :64] = 7.0
        want = fused_rrdb.halo_refresh_plain(blk.clone(), b1, nh, nw)
        fused_rrdb.halo_refresh(blk, b1, nh, nw)
        torch.cuda.synchronize()
        again = fused_rrdb.extract_blocks(fused_rrdb.assemble_blocks(blk, b1, h1, w1), ch)
        for label, ref in (("plain", want[..., :64]), ("re-extraction", again[..., :64])):
            s_ = check_equal(f"halo_refresh {tuple(blk.shape)} vs {label}", blk[..., :64], ref,
                             "kernels")
            errs["halo_refresh"] = max(errs["halo_refresh"], s_["max_abs"])
        del want, again
    del blk
    refresh_ws = fused_rrdb.extract_blocks(feat, fused_rrdb.WS_C)
    # the three RDB kernels on the blocks with their extents, with the
    # RRDB residual (x = the body input, carry = the first RDB's output)
    x_blk = fused_rrdb.extract_blocks(feat)
    c_blk = fused_rrdb.extract_blocks(d_k[..., :64].contiguous())
    wsb, wsb_p = fused_rrdb.new_workspace(x_blk), fused_rrdb.new_workspace(x_blk)
    cb_k, cb_p = fused_rrdb.new_workspace(c_blk), fused_rrdb.new_workspace(c_blk)
    fused_rrdb.fused_rdb(wsb, cb_k, fw.body[0][2], carry=cb_k, ext=ext)
    fused_rrdb.fused_rdb_plain(wsb_p, cb_p, fw.body[0][2], carry=cb_p, ext=ext)
    torch.cuda.synchronize()
    errs["rdb_blocks"] = max(check_bf16("rdb blocks x1..x4", wsb[..., 64:], wsb_p[..., 64:])[
        "max_abs"], check_bf16("rdb_res blocks", cb_k[..., :64], cb_p[..., :64])["max_abs"])
    del wsb_p, cb_k, cb_p
    for label, wts in (("int8_f32acc", fw8["f32acc"].body[0][2]), ("dynamic", fwd.body[0][2])):
        q_k = torch.zeros(*x_blk.shape[:3], 192, dtype=torch.int8, device=dev)
        q_p = torch.zeros_like(q_k)
        o_k, o_p = c_blk.clone(), c_blk.clone()
        e = []
        if label == "dynamic":
            a_k = fused_rrdb.fused_rdb_dynamic(x_blk, q_k, o_k, wts, carry=o_k, ext=ext)
            a_p = fused_rrdb.fused_rdb_dynamic_plain(x_blk, q_p, o_p, wts, carry=o_p, ext=ext)
            torch.cuda.synchronize()
            e.append(check_amax("rdb_dynamic_res blocks amax", a_k, a_p))
        else:
            fused_rrdb.fused_rdb_int8(x_blk, q_k, o_k, wts, carry=o_k, ext=ext)
            fused_rrdb.fused_rdb_int8_plain(x_blk, q_p, o_p, wts, carry=o_p, ext=ext)
            torch.cuda.synchronize()
        e += [check_codes(f"rdb_{label}_res blocks q0..q4", q_k, q_p)["max_abs"],
              check_bf16(f"rdb_{label}_res blocks", o_k, o_p)["max_abs"]]
        errs[f"rdb_{label}_blocks"] = max(e)
        del q_k, q_p, o_k, o_p
    # the band conv at the FastTail's shapes: conv_body's 64->64 without
    # act on a seeded 1x540x960x64 input, conv_hr's 64->64 with lrelu and
    # conv_last's 64->3 padded to 8 on a seeded 1x2160x3840x64 input
    x4k = seeded_feat(dev, (1, 2160, 3840), 13)
    band_w = {"body": pallas_conv.conv_wide_weights(model.conv_body),
              "hr": pallas_conv.conv_wide_weights(model.conv_hr),
              "last": pallas_conv.conv_wide_weights(model.conv_last)}
    errs["band_conv"] = 0.0
    for key, act, x_b in (("body", False, seeded_feat(dev, (1, 540, 960), 14)),
                          ("hr", True, x4k), ("last", False, x4k)):
        got = pallas_conv.band_conv3x3(x_b, band_w[key], act)
        want = pallas_conv.band_conv3x3_plain(x_b, band_w[key], act)
        torch.cuda.synchronize()
        name = f"band_conv3x3 {key} 64->{got.shape[-1]} act={act} {tuple(x_b.shape)}"
        s_ = check_bf16(name, got, want)
        check_steps(name, got, want)
        errs["band_conv"] = max(errs["band_conv"], s_["max_abs"])
        del got, want
    # its lrelu instance is K2's conv_hr launch: the same bits from the
    # same input and weights (wk is TailWeights.hr_k)
    tail_w = fw.tail
    require(torch.equal(band_w["hr"].wk, tail_w.hr_k) and torch.equal(band_w["hr"].b, tail_w.hr_b),
            "band conv hr weights differ from K2's conv_hr weights")
    got = pallas_conv.band_conv3x3(x4k, band_w["hr"])
    want = torch.empty_like(x4k)
    _build.check(_build.library().fw_tail_hr(
        x4k.data_ptr(), 1, 2160, 3840, tail_w.hr_k.data_ptr(), tail_w.hr_b.data_ptr(),
        want.data_ptr(), torch.cuda.current_stream(dev).cuda_stream), "fw_tail_hr")
    torch.cuda.synchronize()
    check_equal(f"band_conv3x3 hr vs fw_tail_hr {tuple(x4k.shape)}", got, want, "kernels")
    del got, want
    kernel_inputs = (ws, feat, skip_p, a0, fwd, refresh_ws, wsb, x_blk, ext, x4k, band_w)
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
        wg = vfw.groups[0].head(g)
        fused_srvgg.fused_conv_chain(x_c, o_k, wg)
        fused_srvgg.fused_conv_chain_plain(x_c, o_p, wg)
        torch.cuda.synchronize()
        errs["vgg_chain"] = max(errs["vgg_chain"], check_bf16(
            f"vgg_chain {label} {tuple(x_c.shape)} g={g}", o_k, o_p)["max_abs"])
        wg8 = vfw8.groups[0].head(g)
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

    resident_tail2 = {"FW_RDB_BODY": "resident", "FW_TAIL": "2"}

    def resident_paths(name, m, relative, ref, featd, w16, a8, wd) -> None:
        """The paths of the resident body, tail2 and the band-conv tail on
        one 1080p frame. The resident body is expected bit-equal to the
        merge body (bf16) and the round-trip bodies (f32acc, dynamic): the
        kernels' arithmetic per pixel does not depend on the tile. The
        kernel paths of resident + tail2 and of the band-conv tail are held
        to their plain paths (x2plus, divided by the range) or to the f32
        ``apply`` (FW_fast6_x2), and timed, split by part, with their peaks."""
        if name == "RealESRGAN_x2plus":
            pairs = (("bf16", w16, "merge", fused_rrdb.rrdb_body(featd, w16.body)[..., :64]),)
        else:
            w_f = m.fast_weights_int8(a8, "f32acc")
            pairs = (("int8 f32acc", w_f, "round-trip",
                      fused_rrdb.rrdb_body_roundtrip(featd, w_f.body)),
                     ("int8 dynamic", wd, "round-trip",
                      fused_rrdb.rrdb_body_roundtrip(featd, wd.body)))
        for label, w, other, want in pairs:
            got = fused_rrdb.rrdb_body_resident(featd, w.body)
            scale = want.float().abs().max().item() + 1e-3
            check_equal(f"{name} {label} resident body vs {other} body", got, want, "model",
                        within=lambda st: st["max_abs"] / scale < MODEL_MAX_ABS
                        and st["mean_abs"] / scale < 5e-4)
            del got, want
        tail_k = pallas_conv.FastTail(m)
        with with_env(resident_tail2):
            t2 = m.apply_fast(xb, "bf16", weights=w16)
        pallas_conv.band_conv3x3.launches = 0
        ft = m.apply_fast(xb, "bf16", weights=w16, fast_tail=tail_k)
        fast_tail_launches[name] = pallas_conv.band_conv3x3.launches
        require(fast_tail_launches[name] == 5,
                f"{name} fast_tail: {fast_tail_launches[name]} band-conv launches, expected 5")
        plain = {
            "resident + tail2": lambda: m.tail2(featd, fused_rrdb.rrdb_body_resident(
                featd, w16.body, plain=True), w16.tail, plain=True),
            "fast_tail": lambda: pallas_conv.FastTail(m, plain=True)(
                featd, fused_rrdb.rrdb_body(featd, w16.body, plain=True)[..., :64])}
        for label, got in (("resident + tail2", t2), ("fast_tail", ft)):
            require(bool(torch.isfinite(got.float()).all()), f"{name} {label}: non-finite")
            require(tuple(got.shape) == (1, 2160, 3840, 3), f"{name} {label}: {got.shape}")
            want = plain[label]() if relative else ref
            s_ = diff_stats(got, want)
            scale = (want.float().max() - want.float().min()).item() if relative else 1.0
            s_.update(max_scaled=s_["max_abs"] / scale, mean_scaled=s_["mean_abs"] / scale)
            emit({"phase": "model", "name": f"{name} {label} kernel path vs "
                  + ("its plain path" if relative else "apply f32"), "divided_by": scale, **s_,
                  "tol": {"max_abs": MODEL_MAX_ABS, "mean_abs": MODEL_MEAN_ABS}})
            require(s_["max_scaled"] < MODEL_MAX_ABS and s_["mean_scaled"] < MODEL_MEAN_ABS,
                    f"{name} {label}: {s_}")
            del want
        del t2, ft
        # ms per frame (yuv420 out) and each part timed alone, with peaks
        body_r = fused_rrdb.rrdb_body_resident(featd, w16.body)
        skip2 = (featd + conv2d(body_r, m.conv_body.weight, m.conv_body.bias)).contiguous()
        img = fused_tail.fused_tail(skip2, w16.tail, "bf16")
        body_m = fused_rrdb.rrdb_body(featd, w16.body)[..., :64]
        with with_env({"FW_RDB_BODY": "resident"}):
            body_d = fused_rrdb.rrdb_body_fast(featd, wd.body)
        a0 = m.tail1_input(featd, body_d)
        runs = (
            ("resident + tail2", resident_tail2, w16, None, "bfloat16", {
                "body": lambda: fused_rrdb.rrdb_body_resident(featd, w16.body),
                "conv_body + skip (PyTorch)": lambda: featd + conv2d(
                    body_r, m.conv_body.weight, m.conv_body.bias),
                "k2": lambda: fused_tail.fused_tail(skip2, w16.tail, "bf16"),
                "epilogue": lambda: out_epilogue(img, "yuv420_u8", True)}),
            ("fast_tail", {}, w16, tail_k, None, {
                "body": lambda: fused_rrdb.rrdb_body(featd, w16.body),
                "fast_tail": lambda: tail_k(featd, body_m),
                "epilogue": lambda: out_epilogue(img, "yuv420_u8", True)}),
            ("int8 dynamic resident + tail1", {"FW_RDB_BODY": "resident"}, wd, None,
             "int8-dynamic", {
                 "body": lambda: fused_rrdb.rrdb_body_resident(featd, wd.body),
                 "tail1_input": lambda: m.tail1_input(featd, body_d),
                 "tail1": lambda: fused_tail.fused_tail1(a0, wd.tail),
                 "epilogue": lambda: out_epilogue(img, "yuv420_u8", True)}))
        for label, env, w, tail, dtype, parts in runs:
            key = f"{name} {label}"

            def frame(w=w, tail=tail):
                return m.apply_fast(xb, "yuv420_u8", True, weights=w, fast_tail=tail)

            with with_env(env):
                planes, peak = part_peak(frame)
                del planes
                model_ms[key] = cuda_ms(frame, 3, warmup=1)
            split_ms = {k: cuda_ms(fn, 1 if k == "body" else 3, 1) for k, fn in parts.items()}
            plan = planner.frame_bytes(1080, 1920, 2, "rrdb", dtype or "bfloat16")
            emit({"phase": "model", "name": key, "ms_per_frame_yuv420": model_ms[key],
                  "split_ms": split_ms, "peak_mem_bytes_above_base": peak,
                  "planner_bytes": plan, "planner_checked": dtype is not None})
            if dtype is not None:     # the paths a restore runs
                plan_checks.append((key, peak, plan))
        del body_r, skip2, img, body_m, body_d, a0

    fast_tail_launches = {}

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
    plan_checks = []     # (name, peak, planner bytes), held after phase 6
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
            del rgb, planes, want

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
            del fast8

            # int8 with dynamic scales: the round-trip body, then tail1
            # and the epilogue in PyTorch
            wd = m.fast_weights_int8(None)
            fastd = m.apply_fast(xb, "bf16", weights=wd)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(fastd.float()).all()), f"{name}: non-finite dynamic output")
            require(tuple(fastd.shape) == (1, 2160, 3840, 3), f"{name}: dynamic {fastd.shape}")
            featd = m._head(xb).contiguous()
            body_d = fused_rrdb.rrdb_body_fast(featd, wd.body)
            body_16 = fused_rrdb.rrdb_body(featd, w16.body)[..., :64]
            err = (body_d.float() - body_16.float()).abs()
            scale = body_16.float().abs().max().item() + 1e-3
            rec = {"phase": "model", "name": f"{name} int8 dynamic kernel path",
                   "psnr_vs_bf16_kernel_path": psnr(fastd, fast),
                   "body_vs_bf16_body": {"max_rel": err.max().item() / scale,
                                         "mean_rel": err.mean().item() / scale},
                   "tol": {"body_max_rel": DYN_BODY_MAX_REL,
                           "body_mean_rel": DYN_BODY_MEAN_REL}}
            del body_16, err
            if name == "FW_fast6_x2":
                rec["tol"]["psnr_min"] = DYN_INT8_PSNR_MIN
                require(rec["psnr_vs_bf16_kernel_path"] > DYN_INT8_PSNR_MIN, f"{name}: {rec}")
            else:
                # random weights: the kernels held to the plain dynamic
                # path on the same frame, errors divided by its range
                refd = m.tail1(featd, fused_rrdb.rrdb_body_fast(featd, wd.body, plain=True),
                               wd.tail, plain=True)
                sd = diff_stats(fastd, refd)
                lo, hi = refd.float().min().item(), refd.float().max().item()
                sd.update(max_scaled=sd["max_abs"] / (hi - lo), mean_scaled=sd["mean_abs"] / (hi - lo))
                rec["vs_plain_dynamic_path"] = {"ref_min": lo, "ref_max": hi, **sd}
                rec["tol"].update(max_scaled=MODEL_MAX_ABS, mean_scaled=MODEL_MEAN_ABS)
                require(sd["max_scaled"] < MODEL_MAX_ABS and sd["mean_scaled"] < MODEL_MEAN_ABS,
                        f"{name} dynamic: {sd}")
                del refd
            emit(rec)
            body_rel = rec["body_vs_bf16_body"]
            require(body_rel["max_rel"] < DYN_BODY_MAX_REL
                    and body_rel["mean_rel"] < DYN_BODY_MEAN_REL, f"{name} dynamic body: {rec}")
            key = f"{name} int8 dynamic"
            planes, peak = part_peak(lambda: m.apply_fast(xb, "yuv420_u8", True, weights=wd))
            del planes
            model_ms[key] = cuda_ms(lambda: m.apply_fast(xb, "yuv420_u8", True, weights=wd),
                                    3, warmup=1)
            # the frame's parts, each timed and its peak taken alone
            a0, p_xla = part_peak(lambda: m.tail1_input(featd, body_d))
            img, p_tail1 = part_peak(lambda: fused_tail.fused_tail1(a0, wd.tail))
            split_ms = {
                "body": cuda_ms(lambda: fused_rrdb.rrdb_body_fast(featd, wd.body), 1, 1),
                "tail1_input": cuda_ms(lambda: m.tail1_input(featd, body_d), 3, 1),
                "tail1": cuda_ms(lambda: fused_tail.fused_tail1(a0, wd.tail), 3, 1),
                "epilogue": cuda_ms(lambda: out_epilogue(img, "yuv420_u8", True), 3, 1)}
            plan = planner.frame_bytes(1080, 1920, 2, "rrdb", "int8-dynamic")
            emit({"phase": "model", "name": key, "ms_per_frame_yuv420": model_ms[key],
                  "split_ms": split_ms, "peak_mem_bytes_above_base": peak,
                  "split_peak_bytes_above_base": {"tail1_input": p_xla, "tail1": p_tail1},
                  "planner_bytes": plan})
            plan_checks.append((key, peak, plan))
            del a0, img, body_d

            if name == "FW_fast6_x2":
                # the round-trip bf16 and static f32acc bodies with tail1
                # (FW_RDB_BODY=roundtrip, FW_TAIL=1) against their plain
                # versions: the trained model, held to the absolute
                # tolerances
                with with_env({"FW_RDB_BODY": "roundtrip", "FW_TAIL": "1"}):
                    for label, w in (("bf16", w16), ("int8 f32acc",
                                                     m.fast_weights_int8(a8, "f32acc"))):
                        got = m.apply_fast(xb, "bf16", weights=w)
                        want = m.tail1(featd, fused_rrdb.rrdb_body_fast(featd, w.body, plain=True),
                                       w.tail, plain=True)
                        s_rt = diff_stats(got, want)
                        emit({"phase": "model", "name": f"{name} {label} round-trip + tail1 "
                              "kernel path vs plain", **s_rt,
                              "tol": {"max_abs": MODEL_MAX_ABS, "mean_abs": MODEL_MEAN_ABS}})
                        require(s_rt["max_abs"] < MODEL_MAX_ABS and s_rt["mean_abs"] < MODEL_MEAN_ABS,
                                f"{name} {label} round trip: {s_rt}")
                        del got, want
            resident_paths(name, m, relative, ref, featd, w16, a8, wd)
            del fast, fastd, featd, ref
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

    # 4b. the quality gate's stats in the SR pass -------------------------
    # The SR processor's device pass (``SuperResolution._run``, what every
    # restore batch runs) on one frame, without the gate's stats and with
    # them: ms per frame by CUDA events, and the peak above what was
    # allocated before it against the planner's count (held once every
    # phase has run). The planes must not change with the stats, and the
    # stats must match the plain stats of the same output computed on the
    # CPU (RRDB: its Y plane; SRVGG: its f32 RGB image) within the gate's
    # bounds (tests/test_torch_quality.py). Seeded random weights (seed 0),
    # as the restores draw them.
    t0 = time.perf_counter()
    stats_runs = (("RealESRGAN_x2plus", "bfloat16", frames),
                  ("RealESRGAN_x2plus", "int8", frames),
                  ("realesr-animevideov3", "bfloat16", vframes),
                  ("RealESRGAN_x2plus", "float32", frames),
                  ("realesr-animevideov3", "float32", vframes),
                  ("RealESRGAN_x4plus", "bfloat16", vframes))
    stats_ms = {}
    with tempfile.TemporaryDirectory(prefix="fw_smoke_w_") as nw, torch.no_grad():
        for name, dtype, clip in stats_runs:
            key = f"{name} {dtype}"
            proc = SuperResolution(SRConfig(
                model_name=name, compute_dtype=dtype, output_color="yuv420",
                yuv_full_range=True, batch_size=1, weights_dir=nw))
            _, h, w, _ = clip.shape
            proc.setup(h, w)
            if dtype == "int8":
                proc.materialize(proc.dispatch(clip[:1]))     # calibrates
            xt = torch.from_numpy(clip[:1]).to(dev)

            def run():
                with full_f32():
                    return proc._run(xt)

            (planes0, none), peak0 = part_peak(run)
            require(none is None, f"{key}: stats without device_stats")
            ms0 = cuda_ms(run, 3, warmup=1)
            proc.enable_device_stats()
            (planes1, st), peak1 = part_peak(run)
            ms1 = cuda_ms(run, 3, warmup=1)
            for a, b_, plane in zip(planes0, planes1, "YUV"):
                require(torch.equal(a, b_), f"{key}: the stats changed plane {plane}")
            # the plain stats of the same output, on the CPU
            x_in = torch.from_numpy(clip[:1]).to(
                torch.float32 if dtype == "float32" else torch.bfloat16) / 255.0
            if proc.family == "rrdb":
                yf = (planes1[0].cpu().float() / 255.0).clamp(0.0, 1.0)[..., None]
            else:
                with full_f32():
                    img = (proc.model.apply(x_in.to(dev)) if dtype == "float32"
                           else proc.model.apply_fast(x_in.to(dev), "f32"))
                yf = img.cpu().float().clamp(0.0, 1.0)
                del img
            cpu = _frame_stats(yf, x_in).numpy()
            dev_st = st[0].cpu().numpy()
            diff = np.abs(cpu - dev_st)
            plan0 = planner.frame_bytes(h, w, proc.scale, proc.family, dtype)
            plan1 = planner.frame_bytes(h, w, proc.scale, proc.family, dtype, stats=True)
            stats_ms[key] = {"without_stats": ms0, "with_stats": ms1, "stats_cost": ms1 - ms0}
            rec = {"phase": "stats", "name": key, "shape": list(clip[:1].shape),
                   "ms_per_frame": stats_ms[key],
                   "stats": dict(zip(("psnr", "ssim", "luma", "std", "finite"),
                                     dev_st.tolist())),
                   "cpu_stats": cpu.tolist(), "abs_diff": diff.tolist(),
                   "peak_mem_bytes_above_base": {"without_stats": peak0, "with_stats": peak1},
                   "planner_bytes": {"without_stats": plan0, "with_stats": plan1},
                   "tol": {"psnr": 0.05, "ssim": 2e-3, "luma": 0.05, "std": 0.05}}
            emit(rec)
            require(diff[0] <= 0.05 and diff[1] <= 2e-3 and diff[2] <= 0.05
                    and diff[3] <= 0.05 and cpu[4] == dev_st[4] == 1.0, f"{key} stats: {rec}")
            plan_checks += [(f"{key} SR pass", peak0, plan0),
                            (f"{key} SR pass with stats", peak1, plan1)]
            proc.teardown()
            del proc, planes0, planes1, st, xt
    emit({"phase": "stats", "seconds": round(time.perf_counter() - t0, 3)})

    # pre_sr: the quality preset's pre-SR modules, card vs CPU, and times
    pre_sr_times = pre_sr_phase(dev, max(1, args.iters // 2), plan_checks)

    # 5. the main paths: cli restore on synthetic clips -----------------
    # Eight runs of the user's entry point: RealESRGAN_x2plus on the 1080p
    # clip in bf16, int8 (default scheme i32) and int8 with
    # FW_INT8_SCHEME=f32acc, then FW_fast6_x2 on the same clip in bf16 and
    # int8 f32acc on the round-trip body with tail1 (FW_RDB_BODY=roundtrip
    # FW_TAIL=1), RealESRGAN_x2plus in bf16 on the resident body with tail2
    # (FW_RDB_BODY=resident FW_TAIL=2), and realesr-animevideov3 on the
    # 960x540 clip in bf16 and int8; then the dynamic-scale int8 restores
    # of the 1080p clip through the SR processor (SuperResolution with
    # int8_scales="dynamic": setup, dispatch, materialize), which no CLI
    # flag reaches, as in the JAX package: RealESRGAN_x2plus on the
    # round-trip body, and FW_fast6_x2 on the resident body
    # (FW_RDB_BODY=resident). Every counter is set to 0 just before each
    # run and read just after it. Every CLI run has the default flags, so
    # each checkpoints, scores every frame and writes the QA report, and
    # must report errors == 0 (a bicubic copy means a batch ran the card
    # out of memory; a kernel fault ends the restore); its peak device memory above what was allocated
    # before it is held to the planner's count for its batch (with the
    # stats). Then: float32 restores of x2plus (1080p) and
    # realesr-animevideov3 (960x540), and RealESRGAN_x4plus in bf16
    # (960x540); the default restore with --no-validate, whose planes must
    # equal the default's; the default's per-frame PSNR and SSIM (its QA
    # report) against the plain stats of its planes on the CPU; a restore
    # stopped after its first batch and resumed, byte-equal to a straight
    # one; and two restores in a subprocess that never touches the TF32
    # flags (the CLI with realesr-animevideov3, the SR processor with
    # x2plus dynamic int8), each equal to the in-process kernel path.
    t0 = time.perf_counter()
    counters = (fused_rrdb.fused_rdb, fused_rrdb.fused_rdb_i32, fused_rrdb.fused_rdb_f32acc,
                fused_rrdb.fused_rdb_dynamic, fused_tail3.conv_body_skip,
                fused_tail.fused_tail, fused_tail.fused_tail1, fused_rrdb.halo_refresh,
                pallas_conv.band_conv3x3,
                fused_srvgg.fused_conv_chain, fused_srvgg.fused_conv_chain_int8)
    calibrations = {"rrdb_calibrations": rrdb.calibrate_act_scales,
                    "srvgg_calibrations": srvgg.calibrate_act_scales}
    roundtrip = {"FW_RDB_BODY": "roundtrip", "FW_TAIL": "1"}
    f32acc = {"FW_INT8_SCHEME": "f32acc"}
    runs = (("RealESRGAN_x2plus", "bfloat16", {}), ("RealESRGAN_x2plus", "int8", {}),
            ("RealESRGAN_x2plus", "int8", f32acc),
            ("FW_fast6_x2", "bfloat16", roundtrip),
            ("FW_fast6_x2", "int8", {**f32acc, **roundtrip}),
            ("RealESRGAN_x2plus", "bfloat16", resident_tail2),
            ("realesr-animevideov3", "bfloat16", {}), ("realesr-animevideov3", "int8", {}),
            ("RealESRGAN_x2plus", "float32", {}), ("realesr-animevideov3", "float32", {}),
            ("RealESRGAN_x4plus", "bfloat16", {}))
    launches_by_run = {}

    def seeded_model(name: str, dtype: str):
        """The model a restore draws from an empty weights dir: seed 0,
        masters rounded to bf16 unless float32."""
        spec = MODEL_SPECS[name]
        sd = from_jax_params(init_params(spec.arch_config, seed=0), torch.float32)
        net = srvgg.SRVGGNet if spec.family == "srvgg" else rrdb.RRDBNet
        return net.from_state_dict(spec.arch_config,
                                   sd if dtype == "float32" else bf16_masters(sd), dev)

    def reset_counters():
        for fn in counters:
            fn.launches = 0
        for fn in calibrations.values():
            fn.calls = 0

    def read_counters() -> dict:
        out = {fn.__name__: fn.launches for fn in counters}
        out.update({k: fn.calls for k, fn in calibrations.items()})
        return out

    def kernel_path(m, weights=None, dtype: str = "bfloat16"):
        """-> the model's path on a uint8 batch on the card, as the SR
        processor runs it: yuv420 planes, full range."""
        def run(xs):
            if dtype != "float32":
                return m.apply_fast(xs.to(torch.bfloat16) / 255.0, "yuv420_u8", True,
                                    weights=weights)
            x = xs.float() / 255.0
            if isinstance(m, srvgg.SRVGGNet):
                return out_epilogue(m.apply(x), "yuv420_u8", True)
            return m.apply_fast(x, "yuv420_u8", True, f32_head=True)
        return run

    def planes_vs_kernel_path(label, expect, decoded, planes_out, bs) -> None:
        """Every written frame against ``expect`` (``kernel_path``) run
        directly on the same SR inputs (the decoded frames, after the
        restore's pre-SR stream for a restore) in the same batches, with the
        weights the run used: the same deterministic kernels, so the
        planes must match exactly (phase 4 holds the kernel paths against
        their references)."""
        worst = 0
        with torch.no_grad():
            for i in range(0, n_frames, bs):
                xs = torch.from_numpy(decoded[i:i + bs]).to(dev)
                want = [p.cpu().numpy() for p in expect(xs)]
                for j in range(len(xs)):
                    for g, w_ in zip(planes_out[i + j], want):
                        if not np.array_equal(g, w_[j]):
                            worst = max(worst, int(np.abs(g.astype(np.int16)
                                                          - w_[j].astype(np.int16)).max()))
        emit({"phase": "restore", "run": label,
              "name": "written planes vs kernel path on the SR's input frames",
              "max_abs": worst, "tol": {"max_abs": 0}})
        require(worst == 0, f"{label}: restore output differs from the kernel path by {worst}")

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
        clips["FW_fast6_x2"] = clips["RealESRGAN_x2plus"]
        clips["RealESRGAN_x4plus"] = clips["realesr-animevideov3"]
        # the SR's input in a default restore: the decoded frames after the
        # default pre-SR stream (these grainy clips read as interlaced, so
        # yadif, as in the JAX restore)
        inputs = {}
        for model_name in ("RealESRGAN_x2plus", "realesr-animevideov3"):
            inputs[model_name], info = pre_sr_stream_of(Config(), *clips[model_name])
            emit({"phase": "restore", "clip": model_name, "default_pre_sr": info})
        inputs["FW_fast6_x2"] = inputs["RealESRGAN_x2plus"]
        inputs["RealESRGAN_x4plus"] = inputs["realesr-animevideov3"]
        # the CLI draws x2plus's, x4plus's and animevideov3's seeded random
        # weights from an empty weights dir and reads FW_fast6_x2's checkpoint
        models = {("RealESRGAN_x2plus", False): model, ("FW_fast6_x2", False): fast6,
                  ("realesr-animevideov3", False): vgg}     # (name, f32 masters)
        nw = str(tmp / "no_weights")
        default_planes = None

        def cli_run(argv, env=None):
            """cli.main(argv) -> (rc, JSON summary, peak device bytes above
            what was allocated before it)."""
            buf = io.StringIO()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with with_env(env or {}), contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            return rc, (json.loads(buf.getvalue()) if rc == 0 else None), peak

        def gate_ok(label, summary) -> None:
            q = summary["quality"]
            require(summary["errors"] == 0, f"{label}: {summary['errors']} frames were "
                    "written as bicubic copies")
            require(q is not None and q["samples"] == n_frames,
                    f"{label}: quality {q}, expected {n_frames} scored frames")

        for model_name, dtype, env in runs:
            t_run = time.perf_counter()
            label = f"{model_name} {dtype}" + "".join(f" {k}={v}" for k, v in env.items())
            src, decoded = clips[model_name]
            sr_in = inputs[model_name]
            vgg_run = model_name == "realesr-animevideov3"
            mkey = (model_name, dtype == "float32")
            if mkey not in models:
                models[mkey] = seeded_model(model_name, dtype)
            m = models[mkey]
            out = tmp / f"restored_{len(launches_by_run)}.y4m"
            reset_counters()
            rc, summary, peak = cli_run(
                ["restore", str(src), "-o", str(out), "--device", "cuda", "--model", model_name,
                 "--dtype", dtype, "--weights-dir", nw, "--project-dir", str(tmp / "proj")], env)
            launches = read_counters()
            wall = time.perf_counter() - t_run
            require(rc == 0, f"cli restore {label} exited {rc}")
            w, h, planes_out = read_y4m_planes(out)
            batches = summary["batches"]
            _, ih, iw, _ = decoded.shape
            spec = MODEL_SPECS[model_name]
            plan = summary["batch_size"] * planner.frame_bytes(ih, iw, spec.scale, spec.family,
                                                               dtype, stats=True)
            emit({"phase": "restore", "run": label, "summary": summary, "out_width": w,
                  "out_height": h, "frames_out": len(planes_out), "launches": launches,
                  "wall_seconds": wall, "peak_mem_bytes_above_base": peak,
                  "planner_bytes": plan})
            plan_checks.append((f"restore {label}", peak, plan))
            require((w, h) == (3840, 2160), f"restore output {w}x{h}")
            require(len(planes_out) == n_frames == summary["frames"],
                    f"restore wrote {len(planes_out)} of {n_frames} frames")
            require(summary["pre_sr"]["host_codec"] == {"decode": "native", "encode": "native"},
                    f"{label}: host codec {summary['pre_sr']['host_codec']}")
            gate_ok(label, summary)
            want_counts = {k: 0 for k in launches}
            scheme = env.get("FW_INT8_SCHEME")
            if vgg_run:
                # 16 chain convs: two groups of 8 per batch; float32 runs
                # the plain f32 forward, as the JAX package does
                if dtype != "float32":
                    want_counts["fused_conv_chain" if dtype == "bfloat16"
                                else "fused_conv_chain_int8"] = 2 * batches
                want_counts["srvgg_calibrations"] = int(dtype == "int8")
            else:
                body_fn = ("fused_rdb" if dtype in ("bfloat16", "float32") else
                           "fused_rdb_f32acc" if scheme == "f32acc" else "fused_rdb_i32")
                rdbs = 3 * m.cfg.num_block * batches
                want_counts.update({body_fn: rdbs, "rrdb_calibrations": int(dtype == "int8")})
                if env.get("FW_RDB_BODY") == "resident":
                    want_counts["halo_refresh"] = rdbs
                if env.get("FW_TAIL") == "1":
                    want_counts["fused_tail1"] = batches
                elif env.get("FW_TAIL") == "2":
                    want_counts["fused_tail"] = batches
                else:
                    want_counts.update(conv_body_skip=batches, fused_tail=batches)
            require(batches > 0 and launches == want_counts,
                    f"{label}: launch counts {launches}, expected {want_counts}")
            launches_by_run[label] = launches
            # int8: calibrated on the same crop of the same first frame
            weights = None
            if dtype == "bfloat16":
                weights = m.fast_weights()
            elif vgg_run and dtype == "int8":
                weights = m.fast_weights_int8(srvgg.calibrate_act_scales(
                    m, torch.from_numpy(centre_crop(sr_in[:1]))))
            elif dtype == "int8":
                a8 = rrdb.calibrate_act_scales(m, torch.from_numpy(centre_crop(sr_in[:1])))
                weights = m.fast_weights_int8(a8, scheme or "i32")
            with with_env(env):
                planes_vs_kernel_path(label, kernel_path(m, weights, dtype), sr_in,
                                      planes_out, summary["batch_size"])
            if label == "RealESRGAN_x2plus bfloat16":
                default_planes = (out.read_bytes(), planes_out, summary, wall, json.loads(
                    (tmp / "proj" / "qa_report.json").read_text()))
            del planes_out
            emit({"phase": "restore", "run": label,
                  "seconds": round(time.perf_counter() - t_run, 3)})

        # the default restore: its QA report's per-frame scores against the
        # plain stats of its Y planes on the CPU (the reference from the
        # decoded frames in bf16, as the SR pass takes them), and the same
        # restore with --no-validate, whose planes must be the same
        t_run = time.perf_counter()
        out_bytes, planes_out, summary, wall, report = default_planes
        decoded = inputs["RealESRGAN_x2plus"]
        worst = [0.0, 0.0]
        for i, (yp, _, _) in enumerate(planes_out):
            yf = torch.from_numpy(yp.astype(np.float32) / 255.0)[None, ..., None]
            x_in = torch.from_numpy(decoded[i:i + 1]).to(torch.bfloat16) / 255.0
            cpu = _frame_stats(yf, x_in).numpy()
            worst[0] = max(worst[0], abs(float(cpu[0]) - report["per_frame"]["psnr"][i]))
            worst[1] = max(worst[1], abs(float(cpu[1]) - report["per_frame"]["ssim"][i]))
        rec = {"phase": "restore", "run": "RealESRGAN_x2plus bfloat16 (default config)",
               "name": "QA report per-frame PSNR/SSIM vs plain stats of the planes on the CPU",
               "quality": report["quality"], "per_frame": report["per_frame"],
               "max_abs_diff": {"psnr": worst[0], "ssim": worst[1]},
               "wall_seconds": wall, "restore_seconds": summary["seconds"],
               "tol": {"psnr": 0.05, "ssim": 2e-3}}
        emit(rec)
        require(len(report["per_frame"]["psnr"]) == n_frames and worst[0] <= 0.05
                and worst[1] <= 2e-3, f"default restore's stats: {rec}")
        nv_out = tmp / "no_validate.y4m"
        rc, nv_summary, _ = cli_run(["restore", str(clips["RealESRGAN_x2plus"][0]), "-o",
                                     str(nv_out), "--model", "RealESRGAN_x2plus",
                                     "--weights-dir", nw, "--project-dir", str(tmp / "nv"),
                                     "--no-validate"])
        require(rc == 0 and nv_summary["quality"] is None and nv_summary["errors"] == 0,
                f"--no-validate restore: rc {rc}, {nv_summary}")
        same = nv_out.read_bytes() == out_bytes
        emit({"phase": "restore", "run": "RealESRGAN_x2plus bfloat16 --no-validate",
              "summary": nv_summary, "equal_to_default_restore": same,
              "seconds": round(time.perf_counter() - t_run, 3)})
        require(same, "--no-validate restore differs from the default restore")

        # stopped after its first batch (an exception from the progress
        # callback), then rerun: byte-equal to a straight run
        t_run = time.perf_counter()
        src = clips["RealESRGAN_x2plus"][0]

        def x2_config(proj: str) -> Config:
            return Config(project_dir=tmp / proj, sr_model="RealESRGAN_x2plus",
                          weights_dir=nw, batch_size=2)

        class Stop(Exception):
            pass

        def stop_after_first(done, total):
            if done >= 2:
                raise Stop(done)

        straight = VideoRestorer(x2_config("ks")).restore_video(src, tmp / "straight2.y4m")
        resumed = tmp / "resumed.y4m"
        try:
            VideoRestorer(x2_config("kr"), stop_after_first).restore_video(src, resumed)
            require(False, "the stopped restore ran to its end")
        except Stop:
            pass
        ckpts = list((tmp / "kr" / "checkpoints").glob("ckpt_*.json"))
        require(len(ckpts) == 1, f"checkpoints after the stop: {ckpts}")
        at = json.loads(ckpts[0].read_text())["frames_done"]
        res = VideoRestorer(x2_config("kr")).restore_video(src, resumed)
        same = resumed.read_bytes() == (tmp / "straight2.y4m").read_bytes()
        left = list((tmp / "kr" / "checkpoints").glob("ckpt_*.json"))
        rec = {"phase": "restore", "run": "RealESRGAN_x2plus bfloat16 stopped and resumed",
               "checkpoint_at_stop": at, "resumed_batches": res.batches,
               "straight_batches": straight.batches, "errors": res.errors,
               "resumed_from": res.resumed_from,
               "scored_from": res.quality.first_frame if res.quality else None,
               "scored": res.quality.samples if res.quality else None,
               "byte_equal_to_straight": same, "checkpoints_left": len(left),
               "seconds": round(time.perf_counter() - t_run, 3)}
        emit(rec)
        require(at == {"enhance": 2} and same and not left and res.errors == 0
                and res.frames_out == n_frames and res.resumed_from == 2
                and rec["scored_from"] == 2 and rec["scored"] == n_frames - 2
                and res.batches == straight.batches - 1, f"resume: {rec}")

        # a process that never touches the TF32 flags: the restore's f32
        # convolutions (SRVGG's conv_last, the dynamic path's tail1_input)
        # must still give the in-process kernel path's planes exactly
        t_run = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        vsrc, vdecoded = clips["realesr-animevideov3"]
        sub_out = tmp / "sub_vgg.y4m"
        res = subprocess.run(
            [sys.executable, "-m", "framewright_tpu_torch.cli", "restore", str(vsrc), "-o",
             str(sub_out), "--model", "realesr-animevideov3", "--weights-dir", nw,
             "--project-dir", str(tmp / "sub")], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        require(res.returncode == 0, f"subprocess cli restore: {res.stderr[-2000:]}")
        sub_summary = json.loads(res.stdout)
        gate_ok("subprocess realesr-animevideov3", sub_summary)
        _, _, planes_out = read_y4m_planes(sub_out)
        planes_vs_kernel_path("subprocess cli realesr-animevideov3 bfloat16",
                              kernel_path(vgg, vgg.fast_weights()),
                              inputs["realesr-animevideov3"], planes_out,
                              sub_summary["batch_size"])
        dyn_out = tmp / "sub_dynamic.npz"
        res = subprocess.run(
            [sys.executable, "-c", SUBPROCESS_DYNAMIC, str(src), str(dyn_out), nw],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        require(res.returncode == 0, f"subprocess dynamic restore: {res.stderr[-2000:]}")
        with np.load(dyn_out) as z:
            planes, bs = [z[k] for k in ("y", "u", "v")], int(z["batch"])
        _, decoded = clips["RealESRGAN_x2plus"]
        planes_vs_kernel_path("subprocess processor RealESRGAN_x2plus int8 dynamic",
                              kernel_path(model, model.fast_weights_int8(None)), decoded,
                              [tuple(p[i] for p in planes) for i in range(n_frames)], bs)
        # what the repair guards against: the same kernel paths with cuDNN's
        # TF32 on, as a process that never sets it runs them (printed)
        tf32_differs = {}
        with torch.no_grad():
            for name, expect, clip in (
                    ("realesr-animevideov3", kernel_path(vgg, vgg.fast_weights()), vdecoded),
                    ("RealESRGAN_x2plus int8 dynamic",
                     kernel_path(model, model.fast_weights_int8(None)), decoded)):
                xs = torch.from_numpy(clip[:1]).to(dev)
                off = expect(xs)
                torch.backends.cudnn.allow_tf32 = True
                try:
                    on = expect(xs)
                finally:
                    torch.backends.cudnn.allow_tf32 = False
                tf32_differs[name] = not all(torch.equal(a, b_) for a, b_ in zip(off, on))
                del off, on
        emit({"phase": "restore", "run": "subprocesses without TF32 settings",
              "planes_differ_with_tf32_on_in_process": tf32_differs,
              "seconds": round(time.perf_counter() - t_run, 3)})

        def processor_run(model_name: str, m, env: dict) -> None:
            """The dynamic-scale int8 restore of the 1080p clip through the
            SR processor: the dynamic RDB 3 x num_block times and tail1 once
            per batch (and on the resident body as many refreshes), nothing
            else; every plane equals the kernel path's."""
            t_run = time.perf_counter()
            label = f"{model_name} int8 int8_scales=dynamic" + "".join(
                f" {k}={v}" for k, v in env.items())
            _, decoded = clips["RealESRGAN_x2plus"]
            with with_env(env):
                reset_counters()
                proc = SuperResolution(SRConfig(
                    model_name=model_name, compute_dtype="int8", int8_scales="dynamic",
                    output_color="yuv420", yuv_full_range=True,
                    weights_dir=nw))
                proc.setup(1080, 1920)
                planes = proc.materialize(proc.dispatch(decoded))
                launches = read_counters()
                bs = proc.plan.batch
                batches = -(-n_frames // bs)
                emit({"phase": "restore", "run": label, "batch_size": bs, "batches": batches,
                      "planes": [list(p.shape) for p in planes], "launches": launches})
                want_counts = {k: 0 for k in launches}
                rdbs = 3 * m.cfg.num_block * batches
                want_counts.update(fused_rdb_dynamic=rdbs, fused_tail1=batches)
                if env.get("FW_RDB_BODY") == "resident":
                    want_counts["halo_refresh"] = rdbs
                require(launches == want_counts,
                        f"{label}: launch counts {launches}, expected {want_counts}")
                require([p.shape for p in planes] == [(n_frames, 2160, 3840),
                                                      (n_frames, 1080, 1920),
                                                      (n_frames, 1080, 1920)],
                        f"{label}: planes {[p.shape for p in planes]}")
                launches_by_run[label] = launches
                planes_vs_kernel_path(label, kernel_path(m, m.fast_weights_int8(None)), decoded,
                                      [tuple(p[i] for p in planes) for i in range(n_frames)], bs)
                proc.teardown()
                del planes, proc
            emit({"phase": "restore", "run": label,
                  "seconds": round(time.perf_counter() - t_run, 3)})

        processor_run("RealESRGAN_x2plus", model, {})
        processor_run("FW_fast6_x2", fast6, {"FW_RDB_BODY": "resident"})
        pre_sr_walls = pre_sr_restores(tmp, nw, dev, {
            "cli_run": cli_run, "reset_counters": reset_counters,
            "read_counters": read_counters, "model": model, "kernel_path": kernel_path,
            "plan_checks": plan_checks})
        film_times = film_phase(tmp, nw, dev, {
            "cli_run": cli_run, "reset_counters": reset_counters,
            "read_counters": read_counters, "model": model, "plan_checks": plan_checks})
    emit({"phase": "restore", "seconds": round(time.perf_counter() - t0, 3)})
    launches = launches_by_run["RealESRGAN_x2plus bfloat16"]

    # 6. times -------------------------------------------------------------
    t0 = time.perf_counter()
    ws, feat, skip, a0, fwd, refresh_ws, wsb, x_blk, ext, x4k, band_w = kernel_inputs
    dyn_run = "RealESRGAN_x2plus int8 int8_scales=dynamic"
    rt_run = "FW_fast6_x2 {} FW_RDB_BODY=roundtrip FW_TAIL=1"
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
    # the round-trip body runs the same call (its rdb1/rdb2 launches carry
    # no residual, as the one timed above): launches from its own run
    rows.append(dict(rows[-1], name="rdb_roundtrip",
                     replaces="framewright_tpu/ops/fused_rrdb.py:412",
                     launches=launches_by_run[rt_run.format("bfloat16")]["fused_rdb"]))

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
    emit({"phase": "times", "k2_ms": k2_ms,
          "k2_split_ms": tail_split(_build, fused_tail, fw.tail, skip, it)})
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
    rows.append(dict(rows[-1], name="rdb_int8_f32acc_roundtrip",
                     replaces="framewright_tpu/ops/fused_rrdb.py:552",
                     launches=launches_by_run[rt_run.format("int8 FW_INT8_SCHEME=f32acc")][
                         "fused_rdb_f32acc"]))
    # the dynamic-scale RDB: the same function's operations and bytes (its
    # f32 scratch and the reductions are the kernel's own traffic)
    wts = fwd.body[0][0]
    q8 = torch.empty(*feat.shape[:3], 192, dtype=torch.int8, device=dev)
    o8 = torch.empty_like(feat)
    ms_d = cuda_ms(lambda: fused_rrdb.fused_rdb_dynamic(feat, q8, o8, wts), it)
    plain_d = cuda_ms(lambda: fused_rrdb.fused_rdb_dynamic_plain(feat, q8, o8, wts), 1, 1)
    bms, by = bound_ms(2 * RDB_MAC_PER_PX * px, 2 * 128 * px + RDB_MAC_PER_PX, PEAK_INT8_OPS)
    rows.append(dict(name="rdb_int8_dynamic", route="cuda",
                     source="framewright_tpu_torch/ops/csrc/rdb_dyn.cu",
                     replaces="framewright_tpu/ops/fused_rrdb.py:502",
                     launches=launches_by_run[dyn_run]["fused_rdb_dynamic"],
                     max_abs_err=errs["rdb_dynamic"], ms=ms_d, plain_ms=plain_d, bound_ms=bms,
                     bound_by=by, library_ms=None))
    del q8, o8
    # tail1 from conv_up1's output (1x1080x1920x64) to 4K bf16 RGB; bytes:
    # the input read once, the output written once (4 pixels x 3 x 2 B per
    # input pixel), the weights once. Library: cuDNN's F.conv2d (bf16,
    # channels_last) for conv_up2 on the nearest-upsampled input, conv_hr
    # and conv_last at 4K, summed (the upsample itself not counted).
    apx = a0.shape[0] * a0.shape[1] * a0.shape[2]
    t1_ms = cuda_ms(lambda: fused_tail.fused_tail1(a0, fw.tail), it)
    t1_plain = cuda_ms(lambda: fused_tail.fused_tail1_plain(a0, fw.tail), 2, 1)
    up = F.interpolate(a0.permute(0, 3, 1, 2), scale_factor=2, mode="nearest").contiguous(
        memory_format=torch.channels_last)
    lib_t = [(c.weight.to(torch.bfloat16).contiguous(memory_format=torch.channels_last),
              c.bias.to(torch.bfloat16)) for c in (model.conv_up2, model.conv_hr, model.conv_last)]
    t1_lib = sum(cuda_ms(lambda wk=wk, bk=bk: F.conv2d(up, wk, bk, padding=1), it)
                 for wk, bk in lib_t)
    del up
    bms, by = bound_ms(2 * TAIL1_MAC_PER_PX * apx, 128 * apx + 24 * apx + 2 * TAIL1_WEIGHTS)
    rows.append(dict(name="tail1", route="cuda", source="framewright_tpu_torch/ops/csrc/tail.cu",
                     replaces="framewright_tpu/ops/fused_tail.py:161",
                     launches=launches_by_run[dyn_run]["fused_tail1"], max_abs_err=errs["tail1"],
                     ms=t1_ms, plain_ms=t1_plain, bound_ms=bms, bound_by=by, library_ms=t1_lib))
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
    emit({"phase": "times", "shape_chain_split": list(vfeat.shape),
          "chain_split": chain_split(_build, vg, vg8, vfeat, it)})
    # the resident body: the halo refresh of the 60 blocks' 192-channel
    # workspace (bytes: every ring pixel's 64 channels written once, and
    # read once from its owner where it lies in the grid of interiors),
    # and the bf16 and dynamic RDBs on the blocks (operations on the
    # pixels inside the valid rectangles, 1.32x the frame's; bytes: x
    # read and the output written at every block pixel)
    res_run = "RealESRGAN_x2plus bfloat16 FW_RDB_BODY=resident FW_TAIL=2"
    dres_run = "FW_fast6_x2 int8 int8_scales=dynamic FW_RDB_BODY=resident"
    nb = refresh_ws.shape[0]
    s_blk, halo = fused_rrdb.S, fused_rrdb.HALO
    ring_px = s_blk * s_blk - (s_blk - 2 * halo) ** 2
    bh, bw = fused_rrdb.grid_dims(h, w)
    ref_ms = cuda_ms(lambda: fused_rrdb.halo_refresh(refresh_ws, b, bh, bw), it)
    ref_plain = cuda_ms(lambda: fused_rrdb.halo_refresh_plain(refresh_ws, b, bh, bw), 3, 1)
    valid_px, ring_read = block_work(ext, h, w)
    bms, by = bound_ms(0, (nb * ring_px + ring_read) * 128)
    rows.append(dict(name="halo_refresh", route="cuda",
                     source="framewright_tpu_torch/ops/csrc/halo.cu",
                     replaces="framewright_tpu/ops/fused_rrdb.py:1309",
                     launches=launches_by_run[res_run]["halo_refresh"],
                     max_abs_err=errs["halo_refresh"], ms=ref_ms, plain_ms=ref_plain,
                     bound_ms=bms, bound_by=by, library_ms=None))
    bpx = nb * s_blk * s_blk
    dst_b = torch.empty_like(wsb)
    rdbb_ms = cuda_ms(lambda: fused_rrdb.fused_rdb(wsb, dst_b, rdb_w, ext=ext), it)
    rdbb_plain = cuda_ms(lambda: fused_rrdb.fused_rdb_plain(wsb, dst_b, rdb_w, ext=ext), 3, 1)
    bms, by = bound_ms(2 * RDB_MAC_PER_PX * valid_px, 2 * 128 * bpx + 2 * RDB_MAC_PER_PX)
    # library: cuDNN's F.conv2d on the same five convs of the blocks'
    # workspace (bf16, channels_last), summed as for the image RDB
    libb_in = [wsb[..., :64 + 32 * k].permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last) for k in range(5)]
    rdbb_lib = sum(cuda_ms(lambda k=k: F.conv2d(libb_in[k], lib_w[k], lib_b[k], padding=1), it)
                   for k in range(5))
    del libb_in
    rows.append(dict(name="rdb_blocks", route="cuda", source="framewright_tpu_torch/ops/csrc/rdb.cu",
                     replaces="framewright_tpu/ops/fused_rrdb.py:412",
                     launches=launches_by_run[res_run]["fused_rdb"],
                     max_abs_err=errs["rdb_blocks"], ms=rdbb_ms, plain_ms=rdbb_plain,
                     bound_ms=bms, bound_by=by, library_ms=rdbb_lib))
    del dst_b
    q8 = torch.empty(*x_blk.shape[:3], 192, dtype=torch.int8, device=dev)
    o8 = torch.empty_like(x_blk)
    wts = fwd.body[0][0]
    ms_db = cuda_ms(lambda: fused_rrdb.fused_rdb_dynamic(x_blk, q8, o8, wts, ext=ext), it)
    plain_db = cuda_ms(lambda: fused_rrdb.fused_rdb_dynamic_plain(x_blk, q8, o8, wts, ext=ext),
                       1, 1)
    bms, by = bound_ms(2 * RDB_MAC_PER_PX * valid_px, 2 * 128 * bpx + RDB_MAC_PER_PX,
                       PEAK_INT8_OPS)
    rows.append(dict(name="rdb_int8_dynamic_blocks", route="cuda",
                     source="framewright_tpu_torch/ops/csrc/rdb_dyn.cu",
                     replaces="framewright_tpu/ops/fused_rrdb.py:502",
                     launches=launches_by_run[dres_run]["fused_rdb_dynamic"],
                     max_abs_err=errs["rdb_dynamic_blocks"], ms=ms_db, plain_ms=plain_db,
                     bound_ms=bms, bound_by=by, library_ms=None))
    del q8, o8
    # the band conv (band_conv.cu on conv_wgmma.cuh's main loop): conv_hr's
    # 64->64 with lrelu at 2160x3840 (bytes: the bf16 input read and output
    # written once, the weights once); library: cuDNN's F.conv2d on the
    # same bf16 input (channels_last) with the bias
    px4 = x4k.shape[0] * x4k.shape[1] * x4k.shape[2]
    band_ms = cuda_ms(lambda: pallas_conv.band_conv3x3(x4k, band_w["hr"]), it)
    band_plain = cuda_ms(lambda: pallas_conv.band_conv3x3_plain(x4k, band_w["hr"]), 2, 1)
    lib_x4 = x4k.permute(0, 3, 1, 2)           # NHWC memory: channels_last already
    lib_w4 = band_w["hr"].w.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    lib_b4 = band_w["hr"].b.to(torch.bfloat16)
    band_lib = cuda_ms(lambda: F.conv2d(lib_x4, lib_w4, lib_b4, padding=1), it)
    bms, by = bound_ms(2 * BAND_MAC_PER_PX * px4, 2 * 128 * px4 + 2 * BAND_MAC_PER_PX)
    rows.append(dict(name="band_conv3x3", route="cuda",
                     source="framewright_tpu_torch/ops/csrc/band_conv.cu",
                     replaces="framewright_tpu/ops/pallas_conv.py:45",
                     launches=fast_tail_launches["RealESRGAN_x2plus"],
                     max_abs_err=errs["band_conv"], ms=band_ms, plain_ms=band_plain,
                     bound_ms=bms, bound_by=by, library_ms=band_lib))
    emit({"phase": "times", "shape_blocks": list(wsb.shape), "shape_band_conv": list(x4k.shape),
          "block_pixels": bpx, "valid_block_pixels": valid_px,
          "block_tiles": fused_rrdb.tile_count(ext), "live_block_tiles": fused_rrdb.tile_count(ext, True),
          "ring_pixels": nb * ring_px, "ring_pixels_read": ring_read,
          "rdb_blocks_over_rdb": rdbb_ms / rdb_ms,
          "halo_refresh_cuda_launches_per_call": 1, "band_conv_cuda_launches_per_call": 1})
    # the int8 RDBs have no library call; the yardstick they must beat is
    # the bf16 RDB on the same input
    int8_ms = {r["name"]: r["ms"] for r in rows if r["name"].startswith("rdb_int8")}
    emit({"phase": "times", "int8_rdb_beside_bf16_rdb_ms": {
        "rdb (bf16)": rdb_ms, "rdb_blocks (bf16)": rdbb_ms, **int8_ms}})
    emit({"phase": "times", "shape_body": [b, h, w, 64], "iters": it,
          "shape_chain": list(vfeat.shape), "chain_bf16_beside_int8_ms": chain_ms,
          "rdb_cuda_launches_per_call": 5, "rdb_int8_cuda_launches_per_call": 6,
          "rdb_dynamic_cuda_launches_per_call": 11, "tail_cuda_launches_per_call": 4,
          "tail1_cuda_launches_per_call": 3, "vgg_chain_cuda_launches_per_call": VGG_GROUP,
          "vgg_chain_int8_cuda_launches_per_call": VGG_GROUP + 1,
          "seconds": round(time.perf_counter() - t0, 3)})

    # each row's share of its bound: the least time the card could take
    # over the time it took
    emit({"phase": "times", "bound_share": {r["name"]: r["bound_ms"] / r["ms"] for r in rows}})

    # c5: the uploads that do not block, in restores of their own
    c5 = c5_times()

    for key, peak, plan in plan_checks:
        require(peak <= plan, f"{key}: peak {peak} B above the planner's {plan} B")
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_all, 3),
          "model_ms_per_frame": model_ms, "sr_pass_ms_per_frame": stats_ms,
          "pre_sr": pre_sr_times, "pre_sr_restores": pre_sr_walls, "native_ms": native_ms,
          "film": film_times, "c5": {k: c5[k] for k in ("enqueue_ms_per_dispatch",
                                                        "quality_busy_share",
                                                        "quality_busy_share_unprofiled",
                                                        "steady_ms_per_frame")}})
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
