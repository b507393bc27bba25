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
              4K on an 8-frame clip at 18 fps padded to 24 (every fourth
              frame an exact repeat), with a bright scratch column and
              dust: counters 69/1/1 a batch, SR on the unique frames only
              (its mapping the CPU analysis'), every plane equal to the
              pre-SR stream then the kernel path in ``rgb_u8`` on the
              unique frames, repeated by the mapping, then the numpy grain
              with the same seed; the same restore through the API
              stopped after its first batch then resumed (byte-equal to the
              CLI's); its peak against the planner's count; card and
              host ms of its parts
  tools       whether Pillow and ffmpeg/ffprobe are there (and ffmpeg's
              encoders): an absent one is printed, not a failure
  formats     the default restore (x2plus) of 4 frames at 960x540 from and
              to a PNG frame directory when Pillow is there (counters
              69/1/1 a batch, every frame the kernel path's ``rgb_u8``),
              and from an mkv to an mp4 when ffmpeg is there (frames, size
              and rate through ffprobe)
  archive     ``--preset archive`` through the CLI: RealESRGAN_x4plus
              (random weights, bf16) from 960x540 to 4K on an 8-frame film
              clip at 18 fps padded to 24 with a skin-coloured moving
              patch, with seeded weights at the published widths written
              for IFNet (rife-v4.6), GFPGANv1.4 and RetinaFace_mnet025:
              counters 69/1/1 a batch of unique frames, K2 in ``rgb_u8``;
              11 frames at 36 fps, as the CPU dedup analysis gives; faces
              restored; a step of 4K IFNet pairs, a GFPGAN crop and
              RetinaFace on a 4K frame on the card against the same
              modules on the CPU (uint8 within 1 LSB on <= 0.1%, boxes
              within 1 px); the same restore through the API killed inside
              the interpolate stage and resumed there (no SR run again),
              byte-equal to the CLI's; the peaks against the planner's
              rows (enhance with the face row, the interpolation step);
              card ms of IFNet, GFPGAN and RetinaFace, host ms of the skin
              detector, a frame's face restore and the 4K scene score, the
              stages' walls
  engine      the restore engine (slice 10) on x2plus 1080p, 4 progressive
              frames: a restore tiled at 256 (counters 69/1/1 a tile batch,
              K2 in bf16; planes equal to tiled_apply over the kernel path;
              one tile batch against its plain path; peak against the
              planner's tiled estimate), ms a frame tiled and whole; a
              restore whose planner must tile and one whose OOM at batch 1
              downshifts into tiles (errors 0); a writer's disk error retried
              by the engine (2 attempts, byte-equal to a straight run); a
              preflight blocker and --dry-run (no card bytes, nothing
              written); --min-vmaf 1 (RGB path) and the VMAF proxy on two 4K
              pairs, card vs CPU; CodeFormer at its published widths on a
              512x512 crop, card vs CPU, its ms and peak, then --preset
              archive --face-model codeformer on the archive clip
  models      the other SR and flow models (slice 11) on seeded weights:
              HAT_SRx4, BasicVSR, TVSR_x4 and RAFT at their published
              widths, Restormer at the JAX denoiser's RestormerConfig()
              (dim 16, blocks 1/1/1/2), each on the card against the port's
              CPU run on a crop (uint8 within 1 LSB on at most 0.1%, the
              flow within 1e-3 px); their ms (HAT 2 frames of 960x540 to
              4K, BasicVSR and TVSR 10 frames of 960x540 in windows of
              chunk 8 and overlap 2, Restormer on a 1080p frame, RAFT on a
              1080p step of pairs) and peaks against the planner, with
              HAT also tiled (4 tiles of 128, 400 attention windows) and
              Restormer also at its published widths (dim 48, blocks
              4/6/6/8, peak only); a BasicVSR
              restore against the video SR processor alone, then stopped
              after its first chunk and resumed (byte-equal); 1080p x2plus
              restores with ``--denoise-method restormer`` and ``--flow-model
              raft``, the ensemble ``--ensemble FW_fast6_x2,FW_fastvgg_x2``
              in each strategy, ``outscale=3`` with ``max_enhancement_strength
              =0.5`` through the API and ``--prompt`` (these on a 960x540
              frame), each with its counters
              and its planes against its parts run alone
  color_gap   colorization and gap filling (slice 13) on seeded DDColor
              (large_config) and ECCV16 (width 1.0) checkpoints: each card
              part against the CPU on a 128x192 crop (a DDColor and an
              ECCV16 keyframe, the key-4 propagation flow and frame, the
              key-5 midpoint), their card ms and peaks at 1080p against
              the planner's rows, host ms of colorize's numpy; the CLI
              restore ``--colorize --colorize-method ddcolor
              --fill-missing-frames --batch 2`` of a grey 1080p clip with
              a dropped frame (one frame more written, counters 69/1/1 a
              batch, planes equal to the pre-SR stream alone then the
              kernel path, its peak, stopped and resumed byte-equal), and
              ``extend --direction both`` against ``FrameExtender`` alone
  av_scaleout  subtitles, format tools and audio, the farm, the frames
              split and the streaming restore (slice 14): the ``audio``
              verb (``ai``, ``--separate``) on a seeded 30 s 48 kHz stereo
              WAV on the card against the same verb on the CPU (16-bit PCM
              within 1 LSB on <= 0.1% of the samples), ``--dialog``, the
              mask net's gains on the clip's band power card vs CPU
              (1e-5), ``audio-sync`` finding a 0.25 s offset within 0.02
              s, card ms of the STFT path and the mask net per minute of
              audio; ``subtitles --no-ocr`` on a 960x540 clip with a
              burnt-in caption band, then ``--sync --enhance`` of its
              SRT, each equal to the processors run directly, and whether
              tesseract is on PATH; ``farm run`` with two ``farm work
              --device cuda`` processes on the one card, chunks of 2
              frames, with the farm's defaults (realesr-animevideov3 x4,
              960x540, 6 frames) and with RealESRGAN_x2plus x2 (1080p, 6
              frames): every chunk ok with errors 0, the merged output
              byte-equal to the in-process restore of the clip (its
              counters read: 2 chain calls, or 69/1/1, a batch), each
              worker's peak against its planner count and the two peaks
              against the card; ``StreamingRestorer`` on a progressive
              1080p clip of 6 frames (default ``Config``) in chunks of 2
              (counters 69/1/1 a chunk), byte-equal to the straight
              restore, and again after its last segment is deleted (that
              chunk alone restored, one callback, byte-equal); a
              world-size-1 NCCL group on tcp://127.0.0.1 (all_reduce,
              barrier, destroy); the frames split: the restore's SR on the
              default mesh (one card: the one-device processor) and
              ``ShardedSR`` over a mesh of one card, each 69/1/1 and its
              dispatch-to-materialize ms within 5% of the processor built
              with ``sharding_strategy="none"`` in the same run, and
              ``ShardedSR`` over two entries for the one card (parts of 1
              and 1, 138/2/2, planes equal to the unsplit processor's)
  train       on-device training (slice 15, A16): the FW_fast6_x2 and
              FW_fastvgg_x2 students (batch 8, 128-pixel HR patches) from
              ``jax_init`` for 3 steps twice on the card (the same bytes)
              and once on the CPU (each step's loss within 1e-4 relative,
              the parameters' mean |delta| <= 0.01 lr k, max <= 2 lr k);
              3 distillation steps from a seeded RealESRGAN_x2plus teacher;
              each student warm-started from its packaged checkpoint for 20
              steps, written with ``save_npz``, above bicubic + 0.5 dB on
              JAX's gate, then restored by the CLI (2 frames of 1080p,
              ``--weights-dir``): 18/1/1 or 2 chain calls a batch, the
              planes equal to the kernel path on the trained weights;
              ``train_diffusion``, ``finetune_sampler`` (DiffusionSR_x4's
              arch) and ``train_denoiser`` (FW_nafnet_dn's) twice on the
              card and once on the CPU, held alike; ``train_mask_net``'s
              300 steps on the card through JAX's SNR gates (mix + 3 dB,
              Wiener + 1 dB); ``train_separator`` 40 steps card vs CPU
              (its losses within 1e-3 relative). Each trainer's ms a step beside its
              bound (3x the forward's f32 FLOPs over 67 TFLOP/s; the audio
              nets: the host's data time) and its peak
  surfaces    A12's first surfaces: ``check`` (the card, status ok),
              ``presets`` (all four, no downshift), ``warmup`` at 1080p then
              a restore of that geometry with the builds stubbed to fail,
              ``batch submit`` x2 + ``run`` + ``list`` (each output equal
              to the CLI restore of its clip), ``watch --cycles 2`` over a
              folder with one clip, ``probe``, ``models list``
              (FW_fast6_x2 packaged), and a restore under
              ``FRAMEWRIGHT_BATCH_SIZE=2`` over ``--config-file`` (batch 2,
              FW_fast6_x2 from the file: 18 RDB calls)
  frontends   the rest of A12 on 1080p clips of 2 frames: ``recipe
              vhs_family_video`` byte-equal to its pre-stages then the
              restore run by hand, ``quick`` to ``restore --preset fast``
              (2 chain calls a batch), ``archive`` (the archive phase's
              seeded checkpoints, x4plus) to ``restore --preset archive``,
              ``do`` (its dry-run config equal to ``build_config_from_text``,
              its restore to the CLI restore of that config), ``auto`` (the
              selector's preset printed), the REST API's default job (its
              SSE completion within 120 s, the output byte-equal to the CLI
              restore, ``/api/frame`` equal to the output's frame 0, health,
              hardware, the job log), a preview of frame 1 equal to frame 1
              of the whole restore at batch 1 (the segment's), ``proxy
              create --height 360`` then
              ``apply`` byte-equal to the CLI restore, ``compare`` of the
              restore with itself (PSNR 99, SSIM 1), ``interpolate --factor
              2`` equal to ``FrameInterpolator`` alone, ``comparison_grid``
              card vs CPU within 1 LSB; 69/1/1 a batch for every x2plus
              restore; ``report estimate`` of x2plus and FW_fastvgg_x2
              beside their steady restore fps here (the wall difference of
              26- and 2-frame restores)
  6. times    each kernel by CUDA events beside its plain version, its
              roofline bound and, for the bf16 RDB, K1, tail1, the bf16
              chain and the band conv, cuDNN's F.conv2d (PyTorch has no
              single int8 3x3 convolution call: the int8 RDBs are printed
              beside the bf16 RDB instead); K2's time split by launch,
              and one chain conv's: bf16, and int8 (the quantization of
              the group input, a conv to codes, the group's last conv to
              bf16), ms and TFLOP/s
  c5          ``scripts/torch_presr_times.py --frames 2 4 --profile --presets
              quality`` in a process of its own: dispatch's enqueue
              ms (pinned staging, non-blocking upload), the quality
              restore's busy share and peaks (allocated and reserved: the
              pre-SR stream runs on a CUDA stream of its own)
Then nvidia-smi's line, the kernel summary line, and the result line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
the result line. Without a CUDA device, or without the package beside
this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
        card_ms["nafnet FW_nafnet_dn"] = cuda_ms(lambda: dn.refiner(c[None]), iters)
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
        cfg = build_config(preset, cli_overrides={"weights_dir": nw, **overrides})
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
        return build_config("quality", cli_overrides={"project_dir": tmp / proj, "weights_dir": nw,
                                        "batch_size": 2})

    class Stop(Exception):
        pass

    def stop_after_first(info):
        if info.frames_done >= 2:
            raise Stop(info.frames_done)

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


FILM_H, FILM_W, FILM_FRAMES = 1080, 1920, 8
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
    ``FILM_FRAMES``-frame 1080p film clip through the CLI: counters 69/1/1 a batch
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
    cfg = build_config("", cli_overrides={"weights_dir": nw, **FILM_FLAGS})
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

    def stop_after_first(info):
        if info.frames_done >= bs:
            raise Stop(info.frames_done)

    def api_cfg(proj: str):
        return build_config("", cli_overrides={"project_dir": tmp / proj, "weights_dir": nw,
                                 "batch_size": bs, **FILM_FLAGS})

    # (the straight run is the CLI's above: an API straight run, which
    # equalled it, is left out for the smoke's time)
    resumed = tmp / "film_r.y4m"
    try:
        VideoRestorer(api_cfg("film_r"), stop_after_first).restore_video(src, resumed)
        require(False, "the stopped film restore ran to its end")
    except Stop:
        pass
    res = VideoRestorer(api_cfg("film_r")).restore_video(src, resumed)
    rec = {"phase": "film", "run": "API stopped after its first batch then resumed",
           "mapping_equals_cpu_analysis": res.dedup.frame_mapping == mapping,
           "resumed_from": res.resumed_from, "resumed_batches": res.batches,
           "straight_batches": batches, "post_sr": res.post_sr,
           "byte_equal_to_straight": resumed.read_bytes() == out.read_bytes()}
    emit(rec)
    require(rec["mapping_equals_cpu_analysis"] and rec["byte_equal_to_straight"]
            and res.resumed_from == bs
            and json.loads(json.dumps(res.post_sr)) == summary["post_sr"]
            and res.errors == 0, f"film resume: {rec}")
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



ARCHIVE_H, ARCHIVE_W, ARCHIVE_FRAMES = 540, 960, 8
SKIN = (205, 150, 125)
FACE_LSB_SHARE = 1e-3         # uint8 card vs CPU: 1 LSB on <= 0.1% (tests/test_torch_faces.py)


def tools_phase() -> dict:
    """Which optional tools the machine has: Pillow (PNG frame
    directories) and ffmpeg/ffprobe (mp4, mkv). An absent one is printed,
    not a failure: neither is on the main path."""
    from framewright_tpu_torch.io import ffmpeg as ff
    from framewright_tpu_torch.io import png_seq

    rec = {"phase": "tools", "pillow": png_seq.pillow_available(),
           "ffmpeg": ff.ffmpeg_available(), "ffmpeg_path": shutil.which("ffmpeg"),
           "ffprobe_path": shutil.which("ffprobe"),
           # the restore's sleep inhibitor (safeguards.KeepAwake): none is a no-op
           "systemd_inhibit_path": shutil.which("systemd-inhibit"),
           "caffeinate_path": shutil.which("caffeinate")}
    if rec["pillow"]:
        import PIL

        rec["pillow_version"] = PIL.__version__
    if rec["ffmpeg"]:
        proc = subprocess.run(["ffmpeg", "-hide_banner", "-encoders"], capture_output=True,
                              text=True, timeout=60)
        rec["encoders"] = [e for e in ("libx264", "libx265", "mpeg4", "ffv1")
                           if f" {e} " in proc.stdout]
    emit(rec)
    return rec


def archive_clip(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """``film_clip`` (18 fps padded to 24, a scratch, dust) with a
    textured skin-coloured patch (120x90 at 960x540) moving w / 60 px a
    unique frame (a repeat stays an exact repeat)."""
    frames = film_clip(n, h, w, seed).astype(np.int16)
    ph, pw = h * 2 // 9, w * 3 // 32
    patch = np.array(SKIN) + np.random.default_rng(seed + 1).integers(-10, 10, (ph, pw, 3))
    for t in range(n):
        u = t - (t + 1) // 4
        y0, x0 = h // 4, w // 4 + w // 60 * u
        frames[t, y0:y0 + ph, x0:x0 + pw] = patch
    return np.clip(frames, 0, 255).astype(np.uint8)


def write_archive_weights(wdir: Path) -> dict:
    """Seeded numpy weights at the published widths, in the JAX package's
    .npz layout: rife-v4.6 (IFNetConfig()), GFPGANv1.4 (GFPGANConfig(),
    177.6 M parameters) and RetinaFace_mnet025 -> {file: MB}."""
    from framewright_tpu_torch.models import gfpgan, ifnet, registry, retinaface

    wdir.mkdir(parents=True, exist_ok=True)
    registry.write_npz(ifnet.init_params(ifnet.IFNetConfig(), seed=11), wdir / "rife-v4.6.npz")
    registry.write_npz(gfpgan.init_params(gfpgan.GFPGANConfig(), seed=12),
                       wdir / "GFPGANv1.4.npz")
    registry.write_npz(retinaface.init_params(seed=13), wdir / "RetinaFace_mnet025.npz")
    return {p.name: p.stat().st_size / 1e6 for p in sorted(wdir.glob("*.npz"))}


def within_one_lsb(label: str, got: np.ndarray, want: np.ndarray, phase: str = "archive") -> dict:
    d = np.abs(np.asarray(got, np.int16) - np.asarray(want, np.int16))
    rec = {"phase": phase, "name": label, "max_abs": int(d.max()),
           "frac_differ": float((d > 0).mean()),
           "tol": {"max_abs": 1, "frac_differ": FACE_LSB_SHARE}}
    emit(rec)
    require(got.shape == want.shape and rec["max_abs"] <= 1
            and rec["frac_differ"] <= FACE_LSB_SHARE, f"{label}: {rec}")
    return rec


def archive_phase(tmp: Path, dev, x: dict) -> dict:
    """``--preset archive`` (RealESRGAN_x4plus, seeded random weights)
    through the CLI on an 8-frame 960x540 film clip at 18 fps padded to 24
    with a skin-coloured moving patch, with seeded weights at the
    published widths for IFNet, GFPGAN and RetinaFace: counters 69/1/1 a
    batch of unique frames and K2 in ``rgb_u8``; the frames and rate the
    CPU analysis gives (6 unique, factor 2: 11 frames at 36 fps); faces
    restored; a 4K IFNet step of pairs, a GFPGAN crop and RetinaFace on a
    4K frame on the card against the same modules on the CPU; the same
    restore through the API killed inside the interpolate stage, then
    resumed there (no SR run again), byte-equal to the CLI's; the peak
    against the planner; card and host ms of the parts. -> times."""
    import torch

    from framewright_tpu_torch import planner
    from framewright_tpu_torch.config import build_config
    from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
    from framewright_tpu_torch.models.gfpgan import GFPGAN
    from framewright_tpu_torch.models.ifnet import IFNet
    from framewright_tpu_torch.models.registry import load_aux
    from framewright_tpu_torch.models.rrdb import RRDBNet
    from framewright_tpu_torch.processors.deduplication import FrameDeduplicator
    from framewright_tpu_torch.processors.faces import (
        FaceDetector,
        FaceRestoreConfig,
        FaceRestorer,
        RetinaFaceDetector,
    )
    from framewright_tpu_torch.processors.interpolation import interpolation_factor
    from framewright_tpu_torch.processors.scene_detection import frame_pair_scores
    from framewright_tpu_torch.restorer import VideoRestorer, face_reserve, pre_sr_reserve

    t0 = time.perf_counter()
    h, w, n = ARCHIVE_H, ARCHIVE_W, ARCHIVE_FRAMES
    wdir = tmp / "archive_weights"
    t_w = time.perf_counter()
    sizes = write_archive_weights(wdir)
    emit({"phase": "archive", "weights_mb": sizes,
          "write_seconds": time.perf_counter() - t_w})
    src = tmp / "archive.y4m"
    with Y4MWriter(src, w, h, fps=24) as writer:
        for f in archive_clip(n, h, w, seed=61):
            writer.write_frame(f)
    with Y4MReader(src) as reader:
        decoded = np.stack(list(reader))
    analysis = FrameDeduplicator().analyze(iter(decoded), target_fps=24.0)
    factor = interpolation_factor(analysis.estimated_source_fps, 0.0)
    want_frames = (analysis.unique_frames - 1) * factor + 1
    want_fps = analysis.estimated_source_fps * factor
    modes = []
    apply_fast = RRDBNet.apply_fast

    def recorded(self, x_in, out_mode="bf16", *a, **k):
        modes.append(out_mode)            # K2's epilogue (its launch counts itself)
        return apply_fast(self, x_in, out_mode, *a, **k)

    out = tmp / "archive_cli.y4m"
    proj = tmp / "archive_proj"
    RRDBNet.apply_fast = recorded
    try:
        x["reset_counters"]()
        t_run = time.perf_counter()
        rc, summary, peak = x["cli_run"](
            ["restore", str(src), "-o", str(out), "--preset", "archive", "--weights-dir",
             str(wdir), "--project-dir", str(proj)])
        wall = time.perf_counter() - t_run
        launches = x["read_counters"]()
    finally:
        RRDBNet.apply_fast = apply_fast
    require(rc == 0, f"archive restore exited {rc}")
    batches, bs = summary["batches"], summary["batch_size"]
    stages = {s["name"]: s["duration_s"]
              for s in json.loads((proj / "qa_report.json").read_text())["stages"]}
    pairs = summary["interpolation"]["pairs_per_step"]
    cfg = build_config("archive", cli_overrides={"weights_dir": str(wdir)})
    enhance_plan = (bs * planner.frame_bytes(h, w, 4, "rrdb", "bfloat16", stats=False)
                    + pre_sr_reserve(cfg, h, w) + face_reserve(cfg, 4 * h, 4 * w))
    interp_plan = planner.interpolation_bytes(4 * h, 4 * w, pairs)
    x["plan_checks"].append(("archive restore", peak, max(enhance_plan, interp_plan)))
    want = {k: 0 for k in launches}
    want.update(fused_rdb=69 * batches, conv_body_skip=batches, fused_tail=batches)
    emit({"phase": "archive", "run": "cli --preset archive", "summary": summary,
          "launches": launches, "tail_modes": sorted(set(modes)),
          "unique_frames": analysis.unique_frames,
          "estimated_source_fps": analysis.estimated_source_fps, "wall_seconds": wall,
          "stage_seconds": stages, "peak_mem_bytes_above_base": peak,
          "planner_bytes": {"enhance": enhance_plan, "interpolate": interp_plan}})
    require(summary["errors"] == 0 and summary["frames"] == want_frames
            and summary["output_fps"] == want_fps and summary["interpolation"]["factor"] == 2
            and summary["duplicates_removed"] == analysis.duplicates,
            f"archive restore: {summary}; expected {want_frames} frames at {want_fps} fps")
    require(summary["faces_restored"] > 0, f"archive restore restored no face: {summary}")
    require(launches == want and set(modes) == {"rgb_u8"} and len(modes) == batches,
            f"archive restore: launches {launches}, tail modes {modes}; expected {want}")
    require(summary["pre_sr"]["host_codec"] == {"decode": "native", "encode": "native"}
            and summary["pre_sr"]["denoise"]["method"]
            and summary["pre_sr"]["temporal_consistency"] == "attention", f"archive: {summary}")
    ow, oh, planes_out = read_y4m_planes(out)
    require((ow, oh) == (4 * w, 4 * h) and len(planes_out) == want_frames,
            f"archive output {ow}x{oh}, {len(planes_out)} frames")

    # the new models on the card against their plain CPU forward
    with Y4MReader(out) as r:
        frames4k = [f for _, f in zip(range(3), r)]
    a, b = frames4k[0], frames4k[2]          # two source frames of the output
    spec, sd, _ = load_aux("rife-v4.6", wdir)
    net_gpu = IFNet.from_state_dict(spec.arch_config, sd, dev)
    net_cpu = IFNet.from_state_dict(spec.arch_config, sd, "cpu")
    pa = torch.from_numpy(np.stack([a] * pairs)).to(dev).float() / 255.0
    pb = torch.from_numpy(np.stack([b] * pairs)).to(dev).float() / 255.0
    with torch.no_grad():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mid = net_gpu.interpolate_padded(pa, pb, 0.5)
        torch.cuda.synchronize()
        ifnet_peak = torch.cuda.max_memory_allocated() - base
        got = torch.clamp(mid[0] * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()
        del mid
        cpu_mid = net_cpu.interpolate_padded(pa[:1].cpu(), pb[:1].cpu(), 0.5)
        want_mid = torch.clamp(cpu_mid[0] * 255.0 + 0.5, 0, 255).to(torch.uint8).numpy()
        ifnet_ms = cuda_ms(lambda: net_gpu.interpolate_padded(pa, pb, 0.5), 3, 1)
    within_one_lsb("IFNet 4K pair, card vs CPU (uint8)", got, want_mid)
    x["plan_checks"].append(("IFNet 4K step", ifnet_peak, interp_plan))
    del pa, pb, net_gpu
    kw = dict(backend="gfpgan", weights_dir=str(wdir))
    fr_gpu = FaceRestorer(FaceRestoreConfig(**kw, device="cuda"))
    fr_gpu.setup(4 * h, 4 * w)
    fr_cpu = FaceRestorer(FaceRestoreConfig(**kw, device="cpu"))
    fr_cpu.setup(4 * h, 4 * w)
    crop = a[4 * h // 4:4 * h // 4 + 480, 4 * w // 4:4 * w // 4 + 360]
    within_one_lsb("GFPGAN crop 480x360 via 512x512, card vs CPU (uint8)",
                   fr_gpu._enhance_crop(crop), fr_cpu._enhance_crop(crop))
    det_gpu = RetinaFaceDetector(weights_dir=str(wdir), device="cuda")
    det_cpu = RetinaFaceDetector(weights_dir=str(wdir), device="cpu")
    boxes_gpu, boxes_cpu = det_gpu.detect(a), det_cpu.detect(a)
    off = max([max(abs(p.x0 - q.x0), abs(p.y0 - q.y0), abs(p.x1 - q.x1), abs(p.y1 - q.y1))
               for p, q in zip(boxes_gpu, boxes_cpu)], default=0)
    emit({"phase": "archive", "name": "RetinaFace on a 4K frame, card vs CPU",
          "boxes": [len(boxes_gpu), len(boxes_cpu)], "max_px_off": off,
          "tol": {"max_px_off": 1}})
    require(len(boxes_gpu) == len(boxes_cpu) and off <= 1, "RetinaFace card vs CPU differs")

    # through the API: killed inside the interpolate stage, resumed there
    class Stop(Exception):
        pass

    unit = factor * pairs
    api = VideoRestorer(build_config("archive", cli_overrides={"weights_dir": str(wdir),
                                                 "project_dir": tmp / "archive_api"}))

    def stop_in_interpolate(info):
        if info.stage == "interpolate" and info.frames_done > unit:
            raise Stop(info.frames_done)

    api.progress_callback = stop_in_interpolate
    resumed = tmp / "archive_api.y4m"
    try:
        api.restore_video(src, resumed)
        require(False, "the killed archive restore ran to its end")
    except Stop:
        pass
    res = VideoRestorer(build_config("archive", cli_overrides={"weights_dir": str(wdir),
                                                 "project_dir": tmp / "archive_api"}))\
        .restore_video(src, resumed)
    rec = {"phase": "archive", "run": "API killed inside the interpolate stage, then resumed",
           "resumed_batches": res.batches, "interpolation": res.interpolation,
           # the enhance stage restored as completed by the engine, not run
           "enhance": [s for s in res.stage_summary["stages"] if s["name"] == "enhance"][0],
           "byte_equal_to_cli": resumed.read_bytes() == out.read_bytes(),
           # the enhance stage's gate, errors and faces, kept in the checkpoint
           "reports_equal_to_cli": (res.quality is not None
                                    and res.quality.to_dict() == summary["quality"]
                                    and res.errors == summary["errors"]
                                    and res.faces_restored == summary["faces_restored"])}
    emit(rec)
    require(rec["byte_equal_to_cli"] and rec["reports_equal_to_cli"] and res.batches == 0
            and (rec["enhance"]["status"], rec["enhance"]["attempts"]) == ("completed", 0)
            and res.interpolation["resumed_from"] == unit, f"archive resume: {rec}")

    # the parts' times: card (CUDA events) and host (least of 3); the face
    # models' own peaks (a crop, a 4K frame) beside the planner's face row
    cs = fr_gpu.config.crop_size
    xcrop = torch.rand(1, cs, cs, 3, device=dev)
    x4k = torch.from_numpy(np.pad(a, ((0, -a.shape[0] % 32), (0, 0), (0, 0)))[None]).to(
        dev).float() / 255.0
    with torch.no_grad():
        face_peaks = {"GFPGANv1.4 crop": part_peak(lambda: fr_gpu._run(xcrop))[1],
                      "RetinaFace 4K frame": part_peak(lambda: det_gpu.model.apply(x4k))[1],
                      "GFPGANv1.4 weights": sum(p.numel() * 4 for p in
                                                fr_gpu.model.parameters())}
        card = {f"IFNet, a step of {pairs} 4K pairs (f32)": ifnet_ms,
                "IFNet, a synthesized 4K frame": ifnet_ms / pairs,
                f"GFPGANv1.4, a {cs}x{cs} crop (f32)": cuda_ms(lambda: fr_gpu._run(xcrop), 5, 1),
                "RetinaFace, a 4K frame (f32)": cuda_ms(lambda: det_gpu.model.apply(x4k), 5, 1)}
    host = {"skin detector, a 4K frame": host_ms(lambda: FaceDetector().detect(a)),
            "RetinaFace detect, a 4K frame (upload, card, NMS)": host_ms(
                lambda: det_gpu.detect(a)),
            "face restore, a 4K frame (detect, crops, paste)": host_ms(
                lambda: fr_gpu.restore_frame(a), 2),
            "scene score, a 4K pair": host_ms(lambda: frame_pair_scores(a[None], b[None]))}
    del fr_gpu, fr_cpu, det_gpu, det_cpu, xcrop, x4k
    rec = {"phase": "archive", "card_ms": card, "host_ms": host, "face_peak_bytes": face_peaks,
           "face_planner_bytes": planner.face_bytes("gfpgan", 4 * h, 4 * w, retinaface=True),
           "ifnet_peak_bytes_per_px_pair": ifnet_peak / pairs / (-(-4 * h // 32) * 32 * 4 * w),
           "ms_per_output_frame": 1e3 * wall / want_frames,
           "seconds": round(time.perf_counter() - t0, 3)}
    emit(rec)
    return {"wall_seconds": wall, "stage_seconds": stages, "card_ms": card, "host_ms": host,
            "peak": peak, "ifnet_peak": ifnet_peak}


ENGINE_H, ENGINE_W, ENGINE_FRAMES, ENGINE_TILE = 1080, 1920, 4, 256
VMAF_MAX_DIFF = 0.01          # the VMAF proxy, card vs CPU (tests/test_torch_vmaf.py)


def engine_phase(tmp: Path, dev, x: dict, archive_src: Path, archive_wdir: Path) -> dict:
    """The restore engine of slice 10 on x2plus 1080p (seeded random
    weights, an empty weights dir, 4 progressive frames) and the archive
    clip. -> times.

    - tiling: a restore with ``tile_size=256`` (YUV writer): counters
      69/1/1 a tile batch, K2 in its bf16 mode; its planes equal
      ``tiled_apply`` over the kernel path of the same frames, and are held
      to ``tiled_apply`` over the plain path (the kernels' plain versions,
      bf16); one tile batch's kernel path against its plain path at the
      tile shape (divided by the range); its peak against the planner's
      tiled estimate; ms a frame through the SR processor, tiled and whole;
    - a planner that must tile (a utilization that leaves no room for a
      whole frame) and a mocked out-of-memory at batch 1 that downshifts
      into tiles: both restores with errors 0 and the kernel path's planes;
    - a writer's disk error (a TransientError) once in the enhance stage:
      the stage runs twice and the output equals a straight run's bytes;
    - a preflight blocker (no free disk) and ``--dry-run``: no card memory
      taken, nothing written;
    - ``--min-vmaf 1`` through the CLI (RGB path, K2 in rgb_u8) and the
      VMAF proxy on two 4K pairs, card against CPU;
    - CodeFormer at its published widths on seeded weights: a 512x512
      crop card against CPU, ms a crop and its peak; then ``--preset
      archive --face-model codeformer`` on the archive clip."""
    import torch

    from framewright_tpu_torch import planner, safeguards
    from framewright_tpu_torch.config import Config, build_config
    from framewright_tpu_torch.errors import DiskSpaceError, InputError
    from framewright_tpu_torch.events import EventBus
    from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
    from framewright_tpu_torch.models import codeformer
    from framewright_tpu_torch.models.layers import out_epilogue
    from framewright_tpu_torch.models.registry import write_npz
    from framewright_tpu_torch.models.rrdb import RRDBNet
    from framewright_tpu_torch.ops import fused_rrdb, fused_tail, fused_tail3, tiling
    from framewright_tpu_torch.processors.deduplication import FrameDeduplicator
    from framewright_tpu_torch.processors.faces import FaceRestoreConfig, FaceRestorer
    from framewright_tpu_torch.processors.interpolation import interpolation_factor
    from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution
    from framewright_tpu_torch.quality.vmaf import VMAFProxy
    from framewright_tpu_torch.restorer import VideoRestorer, face_reserve, pre_sr_reserve

    t0 = time.perf_counter()
    h, w, n = ENGINE_H, ENGINE_W, ENGINE_FRAMES
    nw, model = x["nw"], x["model"]
    fw = model.fast_weights()
    times: dict = {}
    src = tmp / "engine.y4m"
    with Y4MWriter(src, w, h, fps=24) as writer:
        for f in synthetic_frames(n, h, w, seed=71, **PROGRESSIVE):
            writer.write_frame(f)
    with Y4MReader(src) as reader:
        decoded = np.stack(list(reader))
    sr_in, info = pre_sr_stream_of(Config(), src, decoded)
    emit({"phase": "engine", "clip": [n, h, w], "default_pre_sr": info})
    modes = []
    apply_fast = RRDBNet.apply_fast

    def recorded(self, x_in, out_mode="bf16", *a, **k):
        modes.append(out_mode)
        return apply_fast(self, x_in, out_mode, *a, **k)

    def api_restore(label: str, cfg_kw: dict, out: Path, events=None):
        """An API restore of the engine clip with the counters set to 0
        just before and read just after -> (result, restorer, launches,
        peak bytes above base, wall seconds)."""
        cfg = Config(weights_dir=nw, project_dir=tmp / f"engine_{label}", **cfg_kw)
        r = VideoRestorer(cfg, events=events)
        modes.clear()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        x["reset_counters"]()
        t_run = time.perf_counter()
        RRDBNet.apply_fast = recorded
        try:
            res = r.restore_video(src, out)
        finally:
            RRDBNet.apply_fast = apply_fast
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        return res, r, x["read_counters"](), torch.cuda.max_memory_allocated() - base, wall

    def tiled_expect(plan, fn=None):
        """The planes of ``tiled_apply`` by ``plan`` over ``fn`` (the kernel
        path's float output) on the SR's inputs, full range, frame by frame."""
        fn = fn or (lambda t: model.apply_fast(t, "bf16", weights=fw))
        planes = []
        with torch.no_grad():
            for i in range(0, n, plan.frames):
                xs = torch.from_numpy(sr_in[i:i + plan.frames]).to(dev).to(torch.bfloat16) / 255.0
                img = tiling.tiled_apply(fn, xs, plan)
                for j in range(len(img)):
                    planes.append([p[0].cpu().numpy()
                                   for p in out_epilogue(img[j:j + 1], "yuv420_u8", True)])
                del img
        return planes

    def planes_equal(label: str, out: Path, want) -> None:
        _, _, got = read_y4m_planes(out)
        worst = max(int(np.abs(g.astype(np.int16) - e.astype(np.int16)).max())
                    for gf, wf in zip(got, want) for g, e in zip(gf, wf))
        emit({"phase": "engine", "run": label, "name": "planes vs tiled_apply over the "
              "kernel path", "frames": [len(got), len(want)], "max_abs": worst,
              "tol": {"max_abs": 0}})
        require(len(got) == len(want) == n and worst == 0, f"{label}: planes differ by {worst}")

    def tile_counts(plan, launches, label: str) -> int:
        batches = sum(-(-min(plan.frames, n - i) * plan.tiles_per_frame // plan.batch)
                      for i in range(0, n, plan.frames))
        want = {k: 0 for k in launches}
        want.update(fused_rdb=69 * batches, conv_body_skip=batches, fused_tail=batches)
        require(launches == want and set(modes) == {"bf16"},
                f"{label}: launches {launches}, K2 modes {set(modes)}; expected {want} "
                f"({batches} tile batches) in bf16")
        return batches

    # -- a tiled restore -------------------------------------------------------
    out_t = tmp / "engine_tiled.y4m"
    res, r, launches, peak, wall = api_restore("tiled", {"tile_size": ENGINE_TILE}, out_t)
    plan = r.sr.plan
    batches = tile_counts(plan, launches, "tiled restore")
    emit({"phase": "engine", "run": "tiled restore (tile_size=256)", "plan": repr(plan),
          "tile_extent": plan.tile_extent(), "tile_body": plan.tile_extent() // 2,
          "tiles_per_frame": plan.tiles_per_frame, "tile_batches": batches,
          "launches": launches, "k2_modes": sorted(set(modes)), "errors": res.errors,
          "quality": res.quality.to_dict() if res.quality else None,
          "peak_mem_bytes_above_base": peak, "planner_bytes": plan.est_bytes,
          "wall_seconds": wall})
    require(plan.tiled and res.errors == 0 and res.frames_out == n, f"tiled restore: {plan}")
    x["plan_checks"].append(("engine tiled restore", peak, plan.est_bytes))
    planes_equal("tiled restore", out_t, tiled_expect(plan))
    # the plain path on frame 0's tiles: one tile batch against the kernel
    # path at the tile shape, and the frame's planes against the restore's
    xs0 = torch.from_numpy(sr_in[:1]).to(dev).to(torch.bfloat16) / 255.0
    xs2 = torch.from_numpy(sr_in[:2]).to(dev).to(torch.bfloat16) / 255.0
    tiles = tiling.windows(xs2, plan)         # 80: a whole batch of 64 from frames 0-1
    del xs2

    def plain_path(t):
        feat = model._head(t.to(torch.bfloat16)).to(torch.bfloat16).contiguous()
        body = fused_rrdb.rrdb_body(feat, fw.body, plain=True)
        skip = fused_tail3.conv_body_skip_plain(body, feat, fw.cbody)
        return fused_tail.fused_tail_plain(skip, fw.tail, "bf16")

    with torch.no_grad():
        tb = tiles[:plan.batch].contiguous()
        x["reset_counters"]()
        got = model.apply_fast(tb, "bf16", weights=fw)
        one = x["read_counters"]()
        want = plain_path(tb)
        s_ = diff_stats(got, want)
        scale = (want.float().max() - want.float().min()).item()
        s_.update(max_scaled=s_["max_abs"] / scale, mean_scaled=s_["mean_abs"] / scale)
        emit({"phase": "engine", "name": f"one tile batch {list(tb.shape)}: kernel path vs "
              "its plain path (bf16 out)", "launches": one, "divided_by": scale, **s_,
              "tol": {"max_abs": MODEL_MAX_ABS, "mean_abs": MODEL_MEAN_ABS}})
        require(s_["max_scaled"] < MODEL_MAX_ABS and s_["mean_scaled"] < MODEL_MEAN_ABS
                and (one["fused_rdb"], one["conv_body_skip"], one["fused_tail"]) == (69, 1, 1),
                f"tile batch kernel vs plain: {s_}, launches {one}")
        del got, want, tb
        img = tiling.tiled_apply(plain_path, xs0, plan)
        plain_planes = [p[0].cpu().numpy() for p in out_epilogue(img, "yuv420_u8", True)]
        del img
    _, _, got_planes = read_y4m_planes(out_t)
    d = [np.abs(g.astype(np.int16) - e.astype(np.int16)) for g, e in zip(got_planes[0],
                                                                          plain_planes)]
    rec = {"phase": "engine", "name": "tiled restore frame 0 vs tiled_apply over the plain "
           "path (uint8 planes)", "max_abs": max(int(v.max()) for v in d),
           "frac_differ": [float((v > 0).mean()) for v in d],
           "frac_over_1_lsb": [float((v > 1).mean()) for v in d],
           "tol": {"max_lsb": UINT8_MAX_LSB, "frac_differ": UINT8_MAX_FRAC},
           "note": "reported: with random weights the output spans ~100 units, so a "
                   "bf16 step may exceed 1 LSB; the float check above holds the path"}
    emit(rec)
    del tiles, xs0
    # ms a frame, tiled and whole, through the SR processor as the
    # restore runs it (yuv420, full range, the gate's stats)
    frames_dev = np.ascontiguousarray(sr_in)
    for label, tile in (("whole", 0), ("tiled 256", ENGINE_TILE)):
        sr = SuperResolution(SRConfig(model_name="RealESRGAN_x2plus", weights_dir=nw,
                                      output_color="yuv420", yuv_full_range=True,
                                      tile_size=tile, tile_overlap=8))
        sr.setup(h, w)
        sr.enable_device_stats()
        sr.materialize(sr.dispatch(frames_dev))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(2):
            sr.materialize(sr.dispatch(frames_dev))
        torch.cuda.synchronize()
        times[f"sr_ms_per_frame_{label}"] = 1e3 * (time.perf_counter() - t1) / (2 * n)
        emit({"phase": "engine", "name": f"SR pass {label}", "plan": repr(sr.plan),
              "ms_per_frame": times[f"sr_ms_per_frame_{label}"]})
        sr.teardown()
    # -- a planner that must tile, and an OOM at batch 1 ------------------------
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    util = round(3.0e9 / free, 6)
    out_p = tmp / "engine_must_tile.y4m"
    res, r, launches, peak, wall = api_restore("must_tile", {"hbm_utilization": util}, out_p)
    plan = r.sr.plan
    emit({"phase": "engine", "run": f"hbm_utilization={util} (3.0 GB of {free} free)",
          "plan": repr(plan), "launches": launches, "errors": res.errors,
          "peak_mem_bytes_above_base": peak, "planner_bytes": plan.est_bytes,
          "whole_frame_bytes": planner.frame_bytes(h, w, 2, stats=True), "wall_seconds": wall})
    require(plan.tiled and res.errors == 0 and res.frames_out == n, f"must tile: {plan}")
    tile_counts(plan, launches, "must-tile restore")
    x["plan_checks"].append(("engine must-tile restore", peak, plan.est_bytes))
    planes_equal("must-tile restore", out_p, tiled_expect(plan))
    real_run = SuperResolution._run
    ooms = []

    def oom_once(self, x_u8):
        if not self._plan.tiled and not ooms:
            ooms.append(self._plan.batch)
            raise torch.cuda.OutOfMemoryError("injected: CUDA out of memory at batch 1")
        return real_run(self, x_u8)

    SuperResolution._run = oom_once
    try:
        out_o = tmp / "engine_oom.y4m"
        res, r, launches, peak, wall = api_restore("oom", {"batch_size": 1}, out_o)
    finally:
        SuperResolution._run = real_run
    plan = r.sr.plan
    emit({"phase": "engine", "run": "an OOM at batch 1, downshifted into tiles",
          "ooms_at_batch": ooms, "plan_after": repr(plan), "errors": res.errors,
          "launches": launches, "wall_seconds": wall})
    require(ooms == [1] and plan.tiled and res.errors == 0 and res.frames_out == n,
            f"OOM downshift: {ooms}, {plan}, errors {res.errors}")
    # frame 1 was dispatched whole while frame 0's OOM was still in flight
    # (one batch ahead); frame 0 reran in tiles, and every frame after it
    want = tiled_expect(plan)
    with torch.no_grad():
        x1 = torch.from_numpy(sr_in[1:2]).to(dev).to(torch.bfloat16) / 255.0
        want[1] = [p_[0].cpu().numpy() for p_ in model.apply_fast(x1, "yuv420_u8", True,
                                                                  weights=fw)]
    planes_equal("OOM-downshifted restore", out_o, want)
    # -- a TransientError once in the enhance stage ----------------------------
    straight = tmp / "engine_straight.y4m"
    api_restore("straight", {"batch_size": 2}, straight)
    real_write, calls = Y4MWriter.write_yuv_frame, []

    def disk_error_once(self, *planes):
        calls.append(1)
        if len(calls) == 3:
            raise DiskSpaceError("injected: no space left on device")
        return real_write(self, *planes)

    bus = EventBus()
    Y4MWriter.write_yuv_frame = disk_error_once
    try:
        out_r = tmp / "engine_retried.y4m"
        res, r, launches, peak, wall = api_restore("retried", {"batch_size": 2}, out_r, bus)
    finally:
        Y4MWriter.write_yuv_frame = real_write
    enh = [s_ for s_ in res.stage_summary["stages"] if s_["name"] == "enhance"][0]
    rec = {"phase": "engine", "run": "a disk error once in the enhance stage, retried",
           "enhance": enh, "resumed_from": res.resumed_from, "launches": launches,
           "events": [e.type.value for e in bus.history()
                      if e.type.value.startswith(("stage", "job"))],
           "byte_equal_to_straight": out_r.read_bytes() == straight.read_bytes()}
    emit(rec)
    require(enh["attempts"] == 2 and enh["status"] == "completed" and res.errors == 0
            and rec["byte_equal_to_straight"], f"retried enhance stage: {rec}")
    # -- a preflight blocker and a dry run: no card memory, nothing written -----
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    real_usage = safeguards.shutil.disk_usage
    safeguards.shutil.disk_usage = lambda p_: real_usage(p_)._replace(free=2**20)
    try:
        blocked_out = tmp / "engine_blocked.y4m"
        try:
            VideoRestorer(Config(weights_dir=nw, project_dir=tmp / "engine_blocked")
                          ).restore_video(src, blocked_out)
            blocked = None
        except InputError as exc:
            blocked = str(exc)
    finally:
        safeguards.shutil.disk_usage = real_usage
    torch.cuda.synchronize()
    blocked_peak = torch.cuda.max_memory_allocated() - base
    rc, dry, dry_peak = x["cli_run"](["restore", str(src), "-o", str(tmp / "engine_dry.y4m"),
                                      "--weights-dir", nw, "--project-dir",
                                      str(tmp / "engine_dry"), "--dry-run"])
    rec = {"phase": "engine", "name": "preflight blocker and dry run", "blocked": blocked,
           "dry_run_rc": rc, "dry_run": dry,
           "card_bytes_taken": max(blocked_peak, dry_peak),
           "written": [str(p_) for p_ in (blocked_out, tmp / "engine_blocked",
                                         tmp / "engine_dry.y4m", tmp / "engine_dry")
                       if p_.exists()]}
    emit(rec)
    require(blocked is not None and blocked.startswith("preflight blocked: insufficient disk")
            and rc == 0 and dry["dry_run"]["preflight"]["ok"]
            and rec["card_bytes_taken"] == 0 and not rec["written"],
            f"preflight / dry run: {rec}")
    # -- the VMAF gate -----------------------------------------------------------
    modes.clear()
    x["reset_counters"]()
    RRDBNet.apply_fast = recorded
    try:
        t_run = time.perf_counter()
        rc, summary, peak = x["cli_run"](
            ["restore", str(src), "-o", str(tmp / "engine_vmaf.y4m"), "--weights-dir", nw,
             "--project-dir", str(tmp / "engine_vmaf"), "--min-vmaf", "1"])
        wall = time.perf_counter() - t_run
    finally:
        RRDBNet.apply_fast = apply_fast
    launches = x["read_counters"]()
    require(rc == 0, f"--min-vmaf restore exited {rc}")
    want = {k: 0 for k in launches}
    b_ = summary["batches"]
    want.update(fused_rdb=69 * b_, conv_body_skip=b_, fused_tail=b_)
    emit({"phase": "engine", "run": "cli --min-vmaf 1", "summary": summary,
          "launches": launches, "k2_modes": sorted(set(modes)), "wall_seconds": wall})
    require(summary["errors"] == 0 and summary["quality"].get("vmaf_proxy", 0) > 0
            and launches == want and set(modes) == {"rgb_u8"},
            f"--min-vmaf restore: {summary}, launches {launches}, modes {set(modes)}")
    refs = synthetic_frames(2, 2160, 3840, seed=73, **PROGRESSIVE)
    dis = np.clip(refs.astype(np.int16) + np.random.default_rng(74).integers(
        -12, 13, refs.shape), 0, 255).astype(np.uint8)
    card, cpu = VMAFProxy("cuda"), VMAFProxy("cpu")
    s_card, s_cpu = card.score(refs, dis), cpu.score(refs, dis)
    t1 = time.perf_counter()
    card.score(refs, dis)
    host_pair_ms = 1e3 * (time.perf_counter() - t1) / 2
    r_, d_ = (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for v in (refs @ np.float32([0.299, 0.587, 0.114]),
                        dis @ np.float32([0.299, 0.587, 0.114])))
    with torch.no_grad():
        times["vmaf_card_ms_per_4k_pair"] = cuda_ms(
            lambda: card._features(r_, d_, r_), 5, 1) / 2
    times["vmaf_score_ms_per_4k_pair"] = host_pair_ms
    rec = {"phase": "engine", "name": "VMAF proxy, two 4K pairs, card vs CPU",
           "card": s_card.to_dict(), "cpu": s_cpu.to_dict(),
           "diff": abs(s_card.score - s_cpu.score),
           "per_frame_diff": float(np.abs(np.subtract(s_card.per_frame, s_cpu.per_frame)).max()),
           "card_ms_per_pair": times["vmaf_card_ms_per_4k_pair"],
           "score_ms_per_pair_with_host": host_pair_ms, "tol": {"score": VMAF_MAX_DIFF}}
    emit(rec)
    require(rec["diff"] <= VMAF_MAX_DIFF and rec["per_frame_diff"] <= VMAF_MAX_DIFF,
            f"VMAF card vs CPU: {rec}")
    del r_, d_
    # -- CodeFormer at its published widths ---------------------------------------
    t_w = time.perf_counter()
    write_npz(codeformer.init_params(codeformer.CodeFormerConfig(), seed=14),
              archive_wdir / "CodeFormer.npz")
    emit({"phase": "engine", "codeformer_npz_mb": (archive_wdir / "CodeFormer.npz").stat().st_size
          / 1e6, "write_seconds": time.perf_counter() - t_w})
    kw = dict(backend="codeformer", weights_dir=str(archive_wdir), fidelity_weight=0.5)
    fr_gpu = FaceRestorer(FaceRestoreConfig(**kw, device="cuda"))
    fr_gpu.setup(4 * ARCHIVE_H, 4 * ARCHIVE_W)
    fr_cpu = FaceRestorer(FaceRestoreConfig(**kw, device="cpu"))
    fr_cpu.setup(4 * ARCHIVE_H, 4 * ARCHIVE_W)
    crop = synthetic_frames(1, 512, 512, seed=75)[0]
    crop[128:384, 160:352] = np.clip(np.array(SKIN) + np.random.default_rng(76).integers(
        -10, 10, (256, 192, 3)), 0, 255)
    within_one_lsb("CodeFormer 512x512 crop, card vs CPU (uint8)",
                   fr_gpu._enhance_crop(crop), fr_cpu._enhance_crop(crop), phase="engine")
    xcrop = torch.from_numpy(crop[None]).to(dev).float() / 255.0
    with torch.no_grad():
        _, cf_peak = part_peak(lambda: fr_gpu._run(xcrop))
        times["codeformer_ms_per_crop"] = cuda_ms(lambda: fr_gpu._run(xcrop), 5, 1)
    cf_weights = sum(p_.numel() * 4 for p_ in fr_gpu.model.parameters())
    emit({"phase": "engine", "name": "CodeFormer a 512x512 crop (f32)",
          "ms": times["codeformer_ms_per_crop"], "peak_bytes": cf_peak,
          "weights_bytes": cf_weights,
          "planner_bytes": planner.face_bytes("codeformer", 4 * ARCHIVE_H, 4 * ARCHIVE_W)})
    x["plan_checks"].append(("CodeFormer crop + weights", cf_peak + cf_weights,
                             planner.face_bytes("codeformer", 4 * ARCHIVE_H, 4 * ARCHIVE_W)))
    del fr_gpu, fr_cpu, xcrop
    with Y4MReader(archive_src) as reader:
        adecoded = np.stack(list(reader))
    analysis = FrameDeduplicator().analyze(iter(adecoded), target_fps=24.0)
    factor = interpolation_factor(analysis.estimated_source_fps, 0.0)
    want_frames = (analysis.unique_frames - 1) * factor + 1
    out_a = tmp / "engine_archive_codeformer.y4m"
    proj = tmp / "engine_archive_proj"
    x["reset_counters"]()
    t_run = time.perf_counter()
    rc, summary, peak = x["cli_run"](
        ["restore", str(archive_src), "-o", str(out_a), "--preset", "archive",
         "--face-model", "codeformer", "--weights-dir", str(archive_wdir),
         "--project-dir", str(proj)])
    wall = time.perf_counter() - t_run
    launches = x["read_counters"]()
    require(rc == 0, f"archive codeformer restore exited {rc}")
    b_ = summary["batches"]
    want = {k: 0 for k in launches}
    want.update(fused_rdb=69 * b_, conv_body_skip=b_, fused_tail=b_)
    cfg = build_config("archive", cli_overrides={"weights_dir": str(archive_wdir), "face_model": "codeformer"})
    ah, aw = ARCHIVE_H, ARCHIVE_W
    enhance_plan = (summary["batch_size"] * planner.frame_bytes(ah, aw, 4, "rrdb", "bfloat16")
                    + pre_sr_reserve(cfg, ah, aw) + face_reserve(cfg, 4 * ah, 4 * aw))
    interp_plan = planner.interpolation_bytes(4 * ah, 4 * aw,
                                              summary["interpolation"]["pairs_per_step"])
    x["plan_checks"].append(("archive codeformer restore", peak, max(enhance_plan, interp_plan)))
    emit({"phase": "engine", "run": "cli --preset archive --face-model codeformer",
          "summary": summary, "launches": launches, "wall_seconds": wall,
          "ms_per_output_frame": 1e3 * wall / want_frames, "peak_mem_bytes_above_base": peak,
          "planner_bytes": max(enhance_plan, interp_plan)})
    require(summary["errors"] == 0 and summary["frames"] == want_frames
            and summary["faces_restored"] > 0 and launches == want,
            f"archive codeformer restore: {summary}, launches {launches}, expected {want}")
    times["archive_codeformer_wall_seconds"] = wall
    times["seconds"] = round(time.perf_counter() - t0, 3)
    emit({"phase": "engine", **times})
    return times


MODELS_H, MODELS_W = 540, 960  # the video SR and HAT inputs (to 4K)
MODELS_X2_H, MODELS_X2_W = 1080, 1920  # the x2plus restores and the denoisers' inputs
MODEL_U8_FRAC = 1e-3           # uint8 card vs CPU: 1 LSB on <= 0.1% (tests/test_torch_hat.py)
ENSEMBLE = "FW_fast6_x2,FW_fastvgg_x2"
GUIDED_PROMPT = "sharp warm cinematic grain"


def write_model_weights(wdir: Path) -> dict:
    """Seeded stand-ins: the denoiser's Restormer at JAX's
    RestormerConfig() (dim 16, not the published 48) and RAFT
    (raft-things) at its published widths, which read user weights only,
    and BasicVSR: the registry's own seeded draw with its
    residual blocks' convs scaled by 0.1, as mmediting initialises
    ResidualBlockNoBN (the unscaled draw's recurrence grows to ~1e22 over
    10 frames, in both packages, so its uint8 output says nothing).
    HAT_SRx4 and TVSR_x4 take the registry's seeded draw."""
    from framewright_tpu_torch.models import raft, restormer, vsr
    from framewright_tpu_torch.models.registry import MODEL_SPECS, write_npz

    write_npz(restormer.init_params(restormer.RestormerConfig(), 81), wdir / "restormer.npz")
    write_npz(raft.init_params(raft.RAFTConfig(), 82), wdir / "raft-things.npz")
    bv = vsr.init_params(MODEL_SPECS["BasicVSR"].arch_config, 0)
    for direction in ("backward", "forward"):
        for conv in ("conv1", "conv2"):
            for k in ("w", "b"):
                bv[direction][conv][k] *= np.float32(0.1)
    write_npz(bv, wdir / "BasicVSR.npz")
    return {"restormer": "init_params(RestormerConfig(), 81)",
            "raft-things": "init_params(RAFTConfig(), 82)",
            "BasicVSR": "init_params(BasicVSRConfig(), 0), residual convs x 0.1"}


def models_phase(tmp: Path, dev, x: dict) -> dict:
    """The other SR and flow models (slice 11) on seeded weights, at their
    published widths but Restormer's (JAX's RestormerConfig()). -> times.

    - each model on the card against the port's CPU run on a crop, both in
      f32 without TF32: HAT_SRx4 (48x64), BasicVSR and TVSR_x4 (a window of
      10 frames of 64x64), Restormer (128x128): uint8 within 1 LSB on at
      most 0.1% of the values; RAFT (iters 8, a 128x128 pair): the flow
      within 1e-3 px;
    - their times on the card (CUDA events) and peaks against the
      planner: HAT_SRx4 through the SR processor on 2 frames of 960x540 to
      4K (bf16), and tiled at 128 on a 192x256 frame (4 tiles, 400
      attention windows: below a full chunk of 512), BasicVSR and TVSR_x4
      through the video SR processor on 10 frames of 960x540 (chunk 8,
      overlap 2), Restormer on a 1080p frame at RestormerConfig() and at
      the published widths (dim 48, blocks 4/6/6/8, refinement 4; peak
      against the row its config plans) and RAFT on the pairs a 1080p step
      holds (f32);
    - restores, every counter set to 0 just before and read just after:
      a BasicVSR restore of the 10 frames against the processor run alone
      on the pre-SR stream, then stopped after its first chunk and resumed
      (byte-equal to straight); ``--denoise --denoise-method restormer``
      and ``--denoise --flow-model raft`` on 4 and 3 frames of 1080p x2plus
      (69/1/1 a batch; planes equal to the pre-SR stream then the kernel
      path); on one 960x540 frame the ensemble ``--model RealESRGAN_x2plus --ensemble
      FW_fast6_x2,FW_fastvgg_x2`` in each strategy (rows 1-3 for both RRDB
      members, K2 in rgb_u8, row 10 for the chain; the output equal to the
      vote of the members run alone); ``outscale=3`` with
      ``max_enhancement_strength=0.5`` through the API (the float path, K2
      in bf16; equal to the cap and the bicubic resize computed alone); and
      ``--prompt`` (equal to the backend on the kernel path's frames)."""
    import torch

    from framewright_tpu_torch import planner
    from framewright_tpu_torch.config import Config
    from framewright_tpu_torch.hw import full_f32
    from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
    from framewright_tpu_torch.models import hat, raft, restormer, tvsr, vsr
    from framewright_tpu_torch.models.layers import (
        mul_weak,
        out_epilogue,
        resize_bicubic,
        resize_bilinear,
        tree_to_torch,
    )
    from framewright_tpu_torch.models.registry import MODEL_SPECS, load_aux, load_params
    from framewright_tpu_torch.processors.base import to_uint8
    from framewright_tpu_torch.processors.guided import GuidedConfig, make_backend
    from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution
    from framewright_tpu_torch.processors.video_sr import VideoSuperResolution, VSRConfig
    from framewright_tpu_torch.restorer import VideoRestorer, pre_sr_reserve
    from framewright_tpu_torch.testing import EnsembleSR

    t_phase = time.perf_counter()
    cli_run, reset, read, model = x["cli_run"], x["reset_counters"], x["read_counters"], x["model"]
    cpu = torch.device("cpu")
    wdir = tmp / "model_weights"
    emit({"phase": "models", "weights": write_model_weights(wdir)})
    times: dict = {}

    def u8(t):
        return to_uint8(t.float().clamp(0.0, 1.0))

    def card_vs_cpu(label, fn, inputs, flow=False):
        """fn(device, *inputs on it) in f32 on the card and on the CPU."""
        with full_f32(), torch.no_grad():
            got = fn(dev, *[t.to(dev) for t in inputs]).cpu()
            want = fn(cpu, *inputs)
        if flow:
            d = (got - want).abs()
            s = {"name": f"{label} flow, card vs CPU", "max_abs_px": d.max().item(),
                 "mean_abs_px": d.mean().item(), "tol": {"max_abs_px": FLOW_MAX_PX}}
            emit({"phase": "models", **s})
            require(s["max_abs_px"] <= FLOW_MAX_PX, f"{label}: {s}")
        else:
            check_u8(f"{label} uint8, card vs CPU", u8(got), u8(want), "models", MODEL_U8_FRAC)

    def crop(n, h, w, seed):
        return torch.from_numpy(synthetic_frames(n, h, w, seed, **PROGRESSIVE)).float() / 255.0

    # -- each model, card vs CPU on a crop ------------------------------------
    t0 = time.perf_counter()
    trees = {}
    for name in ("HAT_SRx4", "BasicVSR", "TVSR_x4"):
        spec, trees[name], src = load_params(name, wdir)
        emit({"phase": "models", "model": name, "weights": src,
              "arch": dataclasses.asdict(spec.arch_config)})
    for name in ("restormer", "raft-things"):
        spec, trees[name], src = load_aux(name, wdir)
        emit({"phase": "models", "model": name, "weights": src,
              "arch": dataclasses.asdict(spec.arch_config)})
    rcfg = restormer.config_from_params(trees["restormer"])
    fcfg = raft.RAFTConfig(iters=8)

    def on(name, device):
        return tree_to_torch(trees[name], device)

    card_vs_cpu("HAT_SRx4", lambda d, v: hat.apply(on("HAT_SRx4", d), v,
                                                   MODEL_SPECS["HAT_SRx4"].arch_config),
                [crop(1, 48, 64, 71)])
    for name, mod in (("BasicVSR", vsr), ("TVSR_x4", tvsr)):
        card_vs_cpu(name, lambda d, v, name=name, mod=mod: mod.apply(
            on(name, d), v[None], MODEL_SPECS[name].arch_config)[0], [crop(10, 64, 64, 72)])
    card_vs_cpu("restormer", lambda d, v: restormer.apply_padded(on("restormer", d), v, rcfg),
                [crop(1, 128, 128, 73)])
    pair = crop(2, 128, 128, 74)
    card_vs_cpu("raft", lambda d, a, b: raft.estimate_flow(on("raft-things", d), a, b, fcfg),
                [pair[:1], pair[1:]], flow=True)
    emit({"phase": "models", "name": "card vs CPU crops",
          "seconds": round(time.perf_counter() - t0, 3)})

    # -- times and peaks at the restore sizes ------------------------------------
    h, w = MODELS_H, MODELS_W
    frames540 = synthetic_frames(10, h, w, 75, **PROGRESSIVE)
    sr = SuperResolution(SRConfig(model_name="HAT_SRx4", weights_dir=str(wdir)))
    sr.setup(h, w)
    with torch.no_grad():
        out, peak = part_peak(lambda: sr.materialize(sr.dispatch(frames540[:2])))
        ms = cuda_ms(lambda: sr.materialize(sr.dispatch(frames540[:2])), 1, 0) / 2
    require(out.shape == (2, 4 * h, 4 * w, 3), f"HAT_SRx4 output {out.shape}")
    plan = sr.plan.with_batch(2).est_bytes
    times["HAT_SRx4"] = {"ms_per_frame": ms, "plan": dataclasses.asdict(sr.plan),
                         "planner_bytes_2_frames": plan, "peak_mem_bytes": peak}
    emit({"phase": "models", "model": "HAT_SRx4 bf16 960x540 -> 4K", **times["HAT_SRx4"]})
    x["plan_checks"].append(("models HAT_SRx4", peak, plan))
    sr.teardown()
    del sr, out
    # tiled below a full attention chunk: 4 tiles of 128 + 2 x 16 halo,
    # 100 windows each
    sr = SuperResolution(SRConfig(model_name="HAT_SRx4", weights_dir=str(wdir), tile_size=128))
    sr.setup(192, 256)
    with torch.no_grad():
        out, peak = part_peak(lambda: sr.materialize(sr.dispatch(
            np.ascontiguousarray(frames540[:1, :192, :256]))))
    require(sr.plan.tiled and sr.plan.tiles_per_frame == 4 and out.shape == (1, 768, 1024, 3)
            and np.isfinite(out).all(), f"tiled HAT_SRx4: {sr.plan}, {out.shape}")
    plan = sr.plan.with_batch(4).est_bytes
    times["HAT_SRx4 tiled"] = {"plan": dataclasses.asdict(sr.plan),
                               "windows": 4 * (sr.plan.tile_extent() // 16) ** 2,
                               "planner_bytes_4_tiles": plan, "peak_mem_bytes": peak}
    emit({"phase": "models", "model": "HAT_SRx4 bf16 192x256 tiled at 128",
          **times["HAT_SRx4 tiled"]})
    x["plan_checks"].append(("models HAT_SRx4 tiled", peak, plan))
    sr.teardown()
    del sr, out
    for name in ("BasicVSR", "TVSR_x4"):
        proc = VideoSuperResolution(VSRConfig(model_name=name, weights_dir=str(wdir)))
        proc.setup(h, w)

        def run(proc=proc):
            proc.reset_context()
            return [proc.materialize(proc.dispatch(frames540[i:i + 8])) for i in (0, 8)]

        outs, peak = part_peak(run)
        ms = cuda_ms(run, 1, 0) / 10
        require([o.shape for o in outs] == [(8, 4 * h, 4 * w, 3), (2, 4 * h, 4 * w, 3)],
                f"{name} outputs {[o.shape for o in outs]}")
        require(all(np.isfinite(o).all() for o in outs), f"{name}: non-finite output")
        times[name] = {"ms_per_frame": ms, "planner_bytes": proc.plan.est_bytes,
                       "peak_mem_bytes": peak}
        emit({"phase": "models", "model": f"{name} bf16 10 frames 960x540 -> 4K",
              **times[name]})
        x["plan_checks"].append((f"models {name}", peak, proc.plan.est_bytes))
        proc.teardown()
        del proc, outs
    hx, wx = MODELS_X2_H, MODELS_X2_W
    big = torch.from_numpy(synthetic_frames(2, hx, wx, 76, **PROGRESSIVE)).to(dev).float() / 255
    rp = on("restormer", dev)
    with full_f32(), torch.no_grad():
        _, peak = part_peak(lambda: restormer.apply_padded(rp, big[:1], rcfg))
        ms = cuda_ms(lambda: restormer.apply_padded(rp, big[:1], rcfg), 1, 1)
    plan = planner.pre_sr_bytes(hx, wx, "restormer", restormer=rcfg)
    times["restormer"] = {"ms_per_frame": ms, "peak_mem_bytes": peak, "planner_bytes": plan}
    emit({"phase": "models", "model": "restormer f32 1080p RestormerConfig()",
          **times["restormer"]})
    x["plan_checks"].append(("models restormer", peak, plan))
    del rp
    pub = restormer.RestormerConfig(dim=48, num_blocks=(4, 6, 6, 8), num_refinement=4)
    rp = tree_to_torch(restormer.init_params(pub, 83), dev)
    with full_f32(), torch.no_grad():
        _, peak = part_peak(lambda: restormer.apply_padded(rp, big[:1], pub))
        ms = cuda_ms(lambda: restormer.apply_padded(rp, big[:1], pub), 1, 0)
    plan = planner.pre_sr_bytes(hx, wx, "restormer", restormer=pub)
    times["restormer published"] = {"ms_per_frame": ms, "peak_mem_bytes": peak,
                                    "planner_bytes": plan}
    emit({"phase": "models", "model": "restormer f32 1080p dim 48 blocks 4/6/6/8",
          **times["restormer published"]})
    x["plan_checks"].append(("models restormer published", peak, plan))
    fp = on("raft-things", dev)
    torch.cuda.empty_cache()
    pairs = planner.raft_pairs(hx, wx, torch.cuda.mem_get_info(dev)[0], max_pairs=6)
    a, b = big[:1].expand(pairs, -1, -1, -1), big[1:].expand(pairs, -1, -1, -1)
    with full_f32(), torch.no_grad():
        raft.estimate_flow(fp, a[:1], b[:1], fcfg)              # warm-up, one pair
        ms, peak = part_peak(lambda: cuda_ms(lambda: raft.estimate_flow(fp, a, b, fcfg), 1, 0))
        ms /= pairs
    plan = pairs * planner.raft_pair_bytes(hx, wx)
    times["raft"] = {"ms_per_pair": ms, "pairs": pairs, "peak_mem_bytes": peak,
                     "planner_bytes": plan}
    emit({"phase": "models", "model": "raft f32 1080p", **times["raft"]})
    x["plan_checks"].append(("models raft", peak, plan))
    del big, rp, fp, a, b
    torch.cuda.empty_cache()

    # -- restores -------------------------------------------------------------------
    def clip(name, frames):
        src = tmp / f"models_{name}.y4m"
        with Y4MWriter(src, frames.shape[2], frames.shape[1], fps=24) as writer:
            for f in frames:
                writer.write_frame(f)
        with Y4MReader(src) as reader:
            return src, np.stack(list(reader))

    def planes_of(rgb_frames, path):
        with Y4MWriter(path, rgb_frames.shape[2], rgb_frames.shape[1], fps=24) as writer:
            for f in rgb_frames:
                writer.write_frame(f)
        return read_y4m_planes(path)[2]

    def same_planes(label, got_path, want_planes):
        got = read_y4m_planes(got_path)[2]
        worst = max(int(np.abs(g.astype(np.int16) - w_).max())
                    for a, b in zip(got, want_planes) for g, w_ in zip(a, b))
        emit({"phase": "models", "run": label, "name": "written planes vs the parts alone",
              "frames": [len(got), len(want_planes)], "max_abs": worst, "tol": {"max_abs": 0}})
        require(len(got) == len(want_planes) and worst == 0,
                f"{label}: output differs from its parts by {worst}")

    def counts(label, launches, want_nonzero):
        want = {k: 0 for k in launches}
        want.update(want_nonzero)
        require(launches == want, f"{label}: launch counts {launches}, expected {want}")

    def run_cli(label, src, out, argv, n):
        # the previous runs' cached blocks back to the card: the SR plans
        # its batch from the card's free memory
        torch.cuda.empty_cache()
        reset()
        t_run = time.perf_counter()
        rc, summary, peak = cli_run(["restore", str(src), "-o", str(out),
                                     "--project-dir", str(tmp / f"proj_{out.stem}"), *argv])
        wall = time.perf_counter() - t_run
        launches = read()
        require(rc == 0, f"{label}: exited {rc}")
        require(summary["errors"] == 0 and summary["frames"] == n,
                f"{label}: {summary['errors']} errors, {summary['frames']} frames")
        times[label] = {"wall_seconds": wall, "ms_per_frame": 1e3 * wall / n,
                        "batch_size": summary["batch_size"], "peak_mem_bytes": peak}
        emit({"phase": "models", "run": label, "summary": summary, "launches": launches,
              **times[label]})
        return summary, launches, peak

    # BasicVSR: straight, against the processor alone, then stopped and resumed
    src, decoded = clip("vsr", frames540)
    cfg = Config(sr_model="BasicVSR", scale_factor=4, weights_dir=wdir,
                 project_dir=tmp / "proj_vsr_api")
    sr_in, _ = pre_sr_stream_of(cfg, src, decoded)
    summary, launches, peak = run_cli("BasicVSR restore", src, tmp / "vsr_straight.y4m",
                                      ["--model", "BasicVSR", "--weights-dir", str(wdir)], 10)
    counts("BasicVSR restore", launches, {})
    plan = planner.vsr_bytes(h, w, 10, "basicvsr")
    x["plan_checks"].append(("models BasicVSR restore", peak, plan))
    proc = VideoSuperResolution(VSRConfig(weights_dir=str(wdir)))
    proc.setup(h, w)
    want = np.concatenate([proc.process_batch(sr_in[i:i + 8]) for i in (0, 8)])
    proc.teardown()
    same_planes("BasicVSR restore", tmp / "vsr_straight.y4m",
                planes_of(want, tmp / "vsr_want.y4m"))
    del want

    class Stop(Exception):
        pass

    def stop(info):
        if info.frames_done >= 8:
            raise Stop()

    out = tmp / "vsr_resumed.y4m"
    resumed_cfg = Config(sr_model="BasicVSR", scale_factor=4, weights_dir=wdir,
                         project_dir=tmp / "proj_vsr_resumed")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            VideoRestorer(resumed_cfg, stop).restore_video(src, out)
        require(False, "the BasicVSR restore was not stopped")
    except Stop:
        pass
    summary, _, _ = run_cli("BasicVSR resumed", src, out,
                            ["--model", "BasicVSR", "--weights-dir", str(wdir)], 10)
    same = out.read_bytes() == (tmp / "vsr_straight.y4m").read_bytes()
    emit({"phase": "models", "run": "BasicVSR resumed", "resumed_from": summary["resumed_from"],
          "equal_to_straight": same})
    require(summary["resumed_from"] == 8 and same,
            f"BasicVSR resumed at {summary['resumed_from']}, equal to straight: {same}")

    # x2plus 1080p: the denoisers (4 frames; RAFT's 3, 6 pairs)
    h, w = hx, wx
    frames1080 = synthetic_frames(4, h, w, 77, **PROGRESSIVE)
    nw_args = ["--model", "RealESRGAN_x2plus", "--weights-dir", str(wdir)]
    kernel = x["kernel_path"](model, model.fast_weights())
    for label, argv, overrides, n in (
            ("denoise restormer", ["--denoise", "--denoise-method", "restormer"],
             {"denoise": True, "denoise_model": "restormer"}, 4),
            ("denoise temporal raft", ["--denoise", "--denoise-method", "temporal",
                                       "--flow-model", "raft"],
             {"denoise": True, "denoise_model": "temporal", "flow_model": "raft"}, 3)):
        src, decoded = clip(f"x2_{n}", frames1080[:n])
        out = tmp / f"models_{label.replace(' ', '_')}.y4m"
        summary, launches, peak = run_cli(label, src, out, nw_args + argv, n)
        bs = summary["batch_size"]
        batches = summary["batches"]
        counts(label, launches, {"fused_rdb": 69 * batches, "conv_body_skip": batches,
                                 "fused_tail": batches})
        cfg = Config(weights_dir=wdir, **overrides)
        pairs = summary["pre_sr"]["denoise"].get("flow_pairs", 0)
        plan = bs * planner.frame_bytes(h, w, 2, "rrdb", "bfloat16", stats=True) \
            + pre_sr_reserve(cfg, h, w, pairs)
        x["plan_checks"].append((f"models {label}", peak, plan))
        require(summary["pre_sr"]["denoise"]["method"] == overrides["denoise_model"],
                f"{label}: {summary['pre_sr']['denoise']}")
        sr_in, _ = pre_sr_stream_of(cfg, src, decoded)
        planes_equal(label, kernel, sr_in, read_y4m_planes(out)[2], bs, dev)

    # the ensemble, the cap with outscale and guided on one 960x540 frame
    # (from 1080p the host's vote, bicubic and guided filters at 4K and
    # 5760x3240 set those runs' pace)
    n = 1
    h, w = MODELS_H, MODELS_W
    src, decoded = clip("x2_540", synthetic_frames(n, h, w, 78, **PROGRESSIVE))
    sr_in, _ = pre_sr_stream_of(Config(), src, decoded)
    for strategy in ("weighted", "median", "max_sharpness"):
        label = f"ensemble {strategy}"
        out = tmp / f"models_ens_{strategy}.y4m"
        summary, launches, peak = run_cli(
            label, src, out, nw_args + ["--ensemble", ENSEMBLE, "--ensemble-strategy", strategy],
            n)
        batches = summary["batches"]
        counts(label, launches, {"fused_rdb": (69 + 18) * batches,
                                 "conv_body_skip": 2 * batches, "fused_tail": 2 * batches,
                                 "fused_conv_chain": 2 * batches})
        ens = EnsembleSR(["RealESRGAN_x2plus"] + ENSEMBLE.split(","), strategy=strategy,
                         weights_dir=str(wdir), compute_dtype="bfloat16")
        ens.setup(h, w)
        bs = summary["batch_size"]
        x["plan_checks"].append((f"models {label}", peak, ens.plan.est_bytes))
        members = [np.concatenate([m.materialize(m.dispatch(sr_in[i:i + bs]))
                                   for i in range(0, n, bs)]) for m in ens.members]
        ens.teardown()
        want = ens.vote(np.stack(members).astype(np.float32))
        same_planes(label, out, planes_of(want, tmp / "ens_want.y4m"))
        del members, want, ens

    label = "outscale 3 cap 0.5"
    cfg = Config(sr_model="RealESRGAN_x2plus", outscale=3.0, max_enhancement_strength=0.5,
                 weights_dir=wdir, project_dir=tmp / "proj_outscale")
    out = tmp / "models_outscale.y4m"
    torch.cuda.empty_cache()
    reset()
    t_run = time.perf_counter()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(io.StringIO()):
        res = VideoRestorer(cfg).restore_video(src, out)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base_mem
    wall = time.perf_counter() - t_run
    launches = read()
    counts(label, launches, {"fused_rdb": 69 * res.batches, "conv_body_skip": res.batches,
                             "fused_tail": res.batches})
    require(res.errors == 0 and res.frames_out == n, f"{label}: {res.errors} errors")
    times[label] = {"wall_seconds": wall, "ms_per_frame": 1e3 * wall / n,
                    "batch_size": res.batch_size, "peak_mem_bytes": peak}
    emit({"phase": "models", "run": label, "launches": launches, **times[label]})
    plan = res.batch_size * planner.frame_bytes(h, w, 2, "rrdb", "bfloat16")
    x["plan_checks"].append((f"models {label}", peak, plan))
    wants = []
    with torch.no_grad():
        for i in range(0, n, res.batch_size):
            xs = torch.from_numpy(sr_in[i:i + res.batch_size]).to(dev).to(torch.bfloat16) / 255.0
            img = model.apply_fast(xs, "bf16", weights=model.fast_weights())
            base = resize_bilinear(xs.float(), img.shape[1:3]).to(img.dtype)
            u = out_epilogue(base + mul_weak(img - base, 0.5), "rgb_u8", False)
            wants.append(to_uint8(resize_bicubic(u.float() / 255.0, (3 * h, 3 * w))).cpu().numpy())
    require(read_y4m_planes(out)[:2] == (3 * w, 3 * h), f"{label}: output size")
    same_planes(label, out, planes_of(np.concatenate(wants), tmp / "outscale_want.y4m"))
    del wants

    label = "prompt"
    out = tmp / "models_prompt.y4m"
    summary, launches, peak = run_cli(label, src, out, nw_args + ["--prompt", GUIDED_PROMPT], n)
    batches = summary["batches"]
    counts(label, launches, {"fused_rdb": 69 * batches, "conv_body_skip": batches,
                             "fused_tail": batches})
    bs = summary["batch_size"]
    x["plan_checks"].append((f"models {label}", peak,
                             bs * planner.frame_bytes(h, w, 2, "rrdb", "bfloat16")))
    backend = make_backend(GuidedConfig(prompt=GUIDED_PROMPT))
    wants = []
    with torch.no_grad():
        for i in range(0, n, bs):
            xs = torch.from_numpy(sr_in[i:i + bs]).to(dev).to(torch.bfloat16) / 255.0
            u = model.apply_fast(xs, "rgb_u8", weights=model.fast_weights()).cpu().numpy()
            wants += [backend.enhance(f) for f in u]
    same_planes(label, out, planes_of(np.stack(wants), tmp / "prompt_want.y4m"))
    times["seconds"] = round(time.perf_counter() - t_phase, 3)
    emit({"phase": "models", "seconds": times["seconds"]})
    return times


# -- slice 12: the diffusion SR (A8) and the stream stages (A10b) ---------------

DIFF_H, DIFF_W = 540, 960       # 960x540 -> 3840x2160
DIFF_CROP = (96, 128)           # card vs CPU crop (f32, 8 steps -> 384x512)
DIFF_TILED = (320, 480)         # the tiled run's input, tiles of 256
STREAM_H, STREAM_W, STREAM_N = 1080, 1920, 3    # 4 before slice 13 (the smoke's budget)
STREAM_CROP = (128, 192)        # LaMa and the heat fill, card vs CPU
STREAM_OVERRIDES = {"vhs_restore": True, "stabilize": True, "qp_removal": True,
                    "temporal_consistency": True, "temporal_model": "latent",
                    "scene_adaptive": True, "hdr_output": "hdr10plus",
                    "watermark_removal": True, "inpaint_model": "diffusion", "batch_size": 2}
DIFF_MAC_PER_OUT_PX = 127_000   # the UNet's multiply-adds an output pixel (DiffusionSR_x4)
# the bf16 forward, card vs CPU (uint8): set from two readings, the card
# against the port's CPU (max 1, mean 0.089 on an H100) and the port's CPU
# against JAX's (max 2, mean 0.14-0.19, tests/test_torch_diffusion.py)
DIFF_BF16_MAX_LSB, DIFF_BF16_MEAN_LSB = 2, 0.2


def _u8_stats(got: np.ndarray, want: np.ndarray) -> dict:
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return {"max_abs": int(d.max()), "mean_abs": float(d.mean()),
            "frac_differ": float((d > 0).mean())}


def diffusion_phase(tmp: Path, dev, x: dict) -> dict:
    """DiffusionSR_x4 from the packaged checkpoint (slice 12). -> times.

    - the noise: ``jax.random.normal(PRNGKey(0), (1, 540, 960, 3))``'s
      draw on the card against the CPU's: the threefry bits and the
      uniforms equal, the normals within a few f32 ulps (XLA's erfinv
      polynomial on each device's log1p);
    - the forward on the card against the port's CPU forward on a 96x128
      crop (8 steps, the same noise tensor passed in): f32 without TF32,
      uint8 within 1 LSB on at most 0.1% of the values; bf16 (its bf16
      roundings follow each device's f32 sums) within 2 LSB, mean under
      0.2;
    - the SR processor in bf16 on two 960x540 frames to 4K at the default 8
      steps and at ``diffusion_steps=1`` (ms a frame, CUDA events; peak
      against the planner's row), and tiled at 256 on a 320x480 frame;
    - a CLI restore ``--model DiffusionSR_x4`` of 4 frames of 960x540: no
      kernel launched (the family has none; counters 0), errors 0, its
      planes equal to the processor run alone on the pre-SR stream's frames
      in the restore's batches; stopped after its first batch and resumed,
      byte-equal to the straight run;
    - the guided diffusion backend on a 256x256 frame (x4 out, finite)."""
    import torch

    from framewright_tpu_torch.config import Config
    from framewright_tpu_torch.hw import full_f32
    from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
    from framewright_tpu_torch.models import diffusion_sr
    from framewright_tpu_torch.models.layers import tree_to_torch
    from framewright_tpu_torch.models.registry import load_params
    from framewright_tpu_torch.ops import jax_random
    from framewright_tpu_torch.processors.guided import GuidedConfig, make_backend
    from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution
    from framewright_tpu_torch.restorer import VideoRestorer

    t_phase = time.perf_counter()
    cli_run, reset, read = x["cli_run"], x["reset_counters"], x["read_counters"]
    cpu = torch.device("cpu")
    times: dict = {}
    spec, tree, src = load_params("DiffusionSR_x4")
    emit({"phase": "diffusion", "weights": src, "arch": dataclasses.asdict(spec.arch_config)})

    # -- the noise, card vs CPU ------------------------------------------------------
    shape = (1, DIFF_H, DIFF_W, 3)
    bits_card = jax_random.random_bits(0, shape, dev).cpu()
    bits_cpu = jax_random.random_bits(0, shape, cpu)
    u_card, u_cpu = jax_random.uniform(0, shape, dev).cpu(), jax_random.uniform(0, shape, cpu)
    n_card, n_cpu = jax_random.normal(0, shape, dev).cpu(), jax_random.normal(0, shape, cpu)
    ulp = (n_card.view(torch.int32).long() - n_cpu.view(torch.int32).long()).abs()
    s = {"name": "PRNGKey(0) normal (1, 540, 960, 3), card vs CPU",
         "bits_equal": bool(torch.equal(bits_card, bits_cpu)),
         "uniform_equal": bool(torch.equal(u_card, u_cpu)),
         "normal_max_ulp": int(ulp.max()), "normal_frac_differ": float((ulp > 0).float().mean())}
    emit({"phase": "diffusion", **s, "tol": {"bits_equal": True, "uniform_equal": True,
                                             "normal_max_ulp": 4}})
    require(s["bits_equal"] and s["uniform_equal"] and s["normal_max_ulp"] <= 4, str(s))
    times["noise_ms_two_4k_frames"] = cuda_ms(
        lambda: jax_random.normal(0, (2, 4 * DIFF_H, 4 * DIFF_W, 3), dev), 3, 1)
    emit({"phase": "diffusion", "run": "PRNGKey(0) normal (2, 2160, 3840, 3) on the card",
          "ms": times["noise_ms_two_4k_frames"]})

    # -- the forward, card vs CPU on a crop ------------------------------------------
    ch, cw = DIFF_CROP
    lr = torch.from_numpy(synthetic_frames(1, ch, cw, 91, **PROGRESSIVE)).float() / 255.0
    noise = jax_random.normal(0, (1, 4 * ch, 4 * cw, 3), cpu)
    arch8 = dataclasses.replace(spec.arch_config, steps=8)
    for dt in (torch.float32, torch.bfloat16):
        with full_f32(), torch.no_grad():
            got = diffusion_sr.ddim_sample(tree_to_torch(tree, dev, dt), lr.to(dev).to(dt), arch8,
                                           noise=noise.to(dev)).float().cpu()
            want = diffusion_sr.ddim_sample(tree_to_torch(tree, cpu, dt), lr.to(dt), arch8,
                                            noise=noise).float()
        u = [np.clip(np.floor(t.numpy() * 255.0 + 0.5), 0, 255) for t in (got, want)]
        st = _u8_stats(*u)
        name = f"ddim 8 steps {str(dt)[6:]} {ch}x{cw}, card vs CPU (uint8)"
        if dt == torch.float32:
            tol = {"max_lsb": 1, "frac_differ": MODEL_U8_FRAC}
            ok = st["max_abs"] <= 1 and st["frac_differ"] <= MODEL_U8_FRAC
        else:
            tol = {"max_lsb": DIFF_BF16_MAX_LSB, "mean_lsb": DIFF_BF16_MEAN_LSB}
            ok = st["max_abs"] <= DIFF_BF16_MAX_LSB and st["mean_abs"] <= DIFF_BF16_MEAN_LSB
        emit({"phase": "diffusion", "name": name, **st, "tol": tol})
        require(ok, f"{name}: {st}")
        require(bool(torch.isfinite(got).all()), f"{name}: non-finite")

    # -- the SR processor: 2 frames of 960x540 to 4K, 8 and 1 steps; tiled -------------
    frames = synthetic_frames(2, DIFF_H, DIFF_W, 92, **PROGRESSIVE)
    for steps in (8, 1):
        torch.cuda.empty_cache()
        proc = SuperResolution(SRConfig(model_name="DiffusionSR_x4", batch_size=2,
                                        diffusion_steps=steps))
        proc.setup(DIFF_H, DIFF_W)
        with torch.no_grad():
            out = proc.materialize(proc.dispatch(frames))          # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (out, peak) = part_peak(lambda: proc.materialize(proc.dispatch(frames)))
            wall = time.perf_counter() - t0
        require(out.shape == (2, 4 * DIFF_H, 4 * DIFF_W, 3), f"diffusion out {out.shape}")
        macs = DIFF_MAC_PER_OUT_PX * 16 * DIFF_H * DIFF_W * steps
        rec = {"ms_per_frame": 1e3 * wall / 2, "batch": proc.plan.batch,
               "peak_mem_bytes": peak, "planner_bytes": proc.plan.est_bytes,
               "tflop_per_frame": 2 * macs / 1e12,
               "bound_ms_per_frame": bound_ms(2 * macs, 0, PEAK_BF16_FLOPS)[0]}
        times[f"whole_{steps}_steps"] = rec
        emit({"phase": "diffusion", "run": f"SR processor bf16 {steps} steps, 2 frames "
              "960x540 -> 3840x2160", **rec})
        x["plan_checks"].append((f"diffusion {steps} steps", peak, proc.plan.est_bytes))
        proc.teardown()
        del out
    th, tw = DIFF_TILED
    tiled_in = synthetic_frames(1, th, tw, 93, **PROGRESSIVE)
    torch.cuda.empty_cache()
    proc = SuperResolution(SRConfig(model_name="DiffusionSR_x4", tile_size=256, batch_size=4,
                                    diffusion_steps=8))
    proc.setup(th, tw)
    require(proc.plan.tiled, f"diffusion tiled plan {proc.plan}")
    with torch.no_grad():
        t0 = time.perf_counter()
        out, peak = part_peak(lambda: proc.materialize(proc.dispatch(tiled_in)))
        wall = time.perf_counter() - t0
    require(out.shape == (1, 4 * th, 4 * tw, 3), f"tiled out {out.shape}")
    times["tiled_256"] = {"ms_per_frame": 1e3 * wall, "tiles": proc.plan.tiles_per_frame,
                          "tile_batch": proc.plan.batch, "peak_mem_bytes": peak,
                          "planner_bytes": proc.plan.est_bytes}
    emit({"phase": "diffusion", "run": f"SR processor bf16 8 steps tiled at 256, {th}x{tw}",
          **times["tiled_256"]})
    x["plan_checks"].append(("diffusion tiled 256", peak, proc.plan.est_bytes))
    proc.teardown()

    # -- the CLI restore, its parts alone, stopped and resumed ---------------------------
    n = 4
    src = tmp / "diffusion_src.y4m"
    with Y4MWriter(src, DIFF_W, DIFF_H, fps=24) as writer:
        for f in synthetic_frames(n, DIFF_H, DIFF_W, 94, **PROGRESSIVE):
            writer.write_frame(f)
    with Y4MReader(src) as reader:
        decoded = np.stack(list(reader))
    nw = x["nw"]
    argv = ["--model", "DiffusionSR_x4", "--weights-dir", nw]
    out = tmp / "diffusion_straight.y4m"
    torch.cuda.empty_cache()
    reset()
    t0 = time.perf_counter()
    rc, summary, peak = cli_run(["restore", str(src), "-o", str(out), "--project-dir",
                                 str(tmp / "proj_diff"), *argv])
    wall = time.perf_counter() - t0
    launches = read()
    require(rc == 0 and summary["errors"] == 0 and summary["frames"] == n,
            f"diffusion restore: rc {rc} {summary}")
    require(all(v == 0 for v in launches.values()), f"diffusion restore launched {launches}")
    bs = summary["batch_size"]
    times["restore"] = {"wall_seconds": wall, "ms_per_frame": 1e3 * wall / n,
                        "batch_size": bs, "peak_mem_bytes": peak}
    emit({"phase": "diffusion", "run": "cli --model DiffusionSR_x4", "summary": summary,
          "launches": launches, **times["restore"]})
    cfg = Config(sr_model="DiffusionSR_x4", scale_factor=4, weights_dir=nw,
                 project_dir=tmp / "proj_diff_parts")
    sr_in, _ = pre_sr_stream_of(cfg, src, decoded)
    with Y4MReader(out) as r:
        full_range = r.full_range
    proc = SuperResolution(SRConfig(model_name="DiffusionSR_x4", batch_size=bs,
                                    output_color="yuv420", yuv_full_range=full_range,
                                    diffusion_steps=cfg.diffusion_steps))
    proc.setup(DIFF_H, DIFF_W)
    with full_f32(), torch.no_grad():
        want = []
        for i in range(0, n, bs):
            planes = proc.materialize(proc.dispatch(sr_in[i:i + bs]))
            want += [tuple(p[j] for p in planes) for j in range(len(planes[0]))]
    proc.teardown()
    got = read_y4m_planes(out)[2]
    worst = max(int(np.abs(g.astype(np.int16) - w_).max())
                for a, b in zip(got, want) for g, w_ in zip(a, b))
    emit({"phase": "diffusion", "run": "cli --model DiffusionSR_x4",
          "name": "written planes vs the parts alone", "max_abs": worst, "tol": {"max_abs": 0}})
    require(len(got) == n and worst == 0, f"diffusion restore differs from its parts by {worst}")

    # stopped after its first batch of 2 and resumed, against a straight run at
    # batch 2 (a frame's noise is its slice of its batch's draw)
    class Stop(Exception):
        pass

    def stop(info):
        if info.frames_done >= 2:
            raise Stop()

    def api_restore(proj, path, callback=None):
        c = Config(sr_model="DiffusionSR_x4", scale_factor=4, weights_dir=nw, batch_size=2,
                   project_dir=proj)
        with contextlib.redirect_stdout(io.StringIO()):
            return VideoRestorer(c, callback).restore_video(src, path)

    straight2 = tmp / "diffusion_straight_b2.y4m"
    api_restore(tmp / "proj_diff_b2", straight2)
    resumed = tmp / "diffusion_resumed.y4m"
    try:
        api_restore(tmp / "proj_diff_resumed", resumed, stop)
        require(False, "the diffusion restore was not stopped")
    except Stop:
        pass
    res = api_restore(tmp / "proj_diff_resumed", resumed)
    same = resumed.read_bytes() == straight2.read_bytes()
    emit({"phase": "diffusion", "run": "DiffusionSR_x4 batch 2 stopped and resumed",
          "resumed_from": res.resumed_from, "equal_to_straight": same})
    require(res.resumed_from == 2 and same and res.errors == 0,
            f"diffusion resumed at {res.resumed_from}, equal to straight: {same}")

    # -- the guided diffusion backend ------------------------------------------------
    frame = synthetic_frames(1, 256, 256, 95, **PROGRESSIVE)[0]
    backend = make_backend(GuidedConfig(prompt=GUIDED_PROMPT, backend="diffusion"))
    backend.enhance(frame)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = backend.enhance(frame)
    times["guided_ms"] = 1e3 * (time.perf_counter() - t0)
    emit({"phase": "diffusion", "run": "guided diffusion backend 256x256",
          "shape": list(g.shape), "ms": times["guided_ms"]})
    require(g.shape == (1024, 1024, 3) and g.dtype == np.uint8, f"guided {g.shape}")
    times["seconds"] = round(time.perf_counter() - t_phase, 3)
    emit({"phase": "diffusion", "seconds": times["seconds"]})
    return times


def stream_phase(tmp: Path, dev, x: dict) -> dict:
    """The stream stages of A10b on x2plus 1080p (slice 12). -> times.

    - each card part against its CPU run (uint8 within 1 LSB on at most
      0.1% of the values): LaMa (seeded ``big-lama.npz`` at Big-LaMa's
      widths: ngf 64, 3 downs, 18 blocks, global ratio 0.75) and the heat
      fill on a 128x192 crop with a hole, the DCT threshold on a batch of
      4 1080p frames, the latent chunk (eigh) on 16 256x448 frames;
    - each stage's ms a 1080p frame (host clock; the card parts with CUDA
      events), the HDR expansion on a 4K output frame;
    - each card part's peak at 1080p as the restore runs it (LaMa with its
      weights; the DCT threshold on a batch of 8 frames, the latent chunk
      on 16) against the planner's pre-SR row; LaMa's bytes equal on two
      runs;
    - a restore of 3 frames at batch 2 with the stages of ``--vhs --stabilize
      --qp-removal --temporal-model latent --scene-adaptive --hdr
      hdr10plus`` and the heat-fill watermark removal (``Config``; the
      flags' parsing is the CPU tests'): counters 69/1/1 a batch, errors
      0, every written plane equal to the pre-SR stream run alone, then the
      kernel path in ``rgb_u8``, then the HDR expansion, its
      ``.hdr10plus.json`` sidecar equal to the collector's; stopped after
      its first batch and resumed, byte-equal with the same sidecar;
    - a restore inpainting with LaMa from that ``big-lama.npz`` (3 frames
      at batch 2): every written plane equal to its pre-SR stream run alone
      (LaMa on the main thread) then the kernel path; stopped after its
      first batch and resumed, byte-equal."""
    import torch

    from framewright_tpu_torch import planner
    from framewright_tpu_torch.config import Config
    from framewright_tpu_torch.hw import full_f32
    from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
    from framewright_tpu_torch.models import lama
    from framewright_tpu_torch.models.registry import write_npz
    from framewright_tpu_torch.processors import inpaint as inp
    from framewright_tpu_torch.processors.hdr import HDRConfig, HDRConverter
    from framewright_tpu_torch.processors.latent_temporal import (
        LatentTemporalConfig,
        LatentTemporalSmoother,
        smooth_chunk,
    )
    from framewright_tpu_torch.processors.qp_removal import (
        QPArtifactRemover,
        QPRemovalConfig,
        dct_filter,
    )
    from framewright_tpu_torch.processors.scene_intelligence import (
        SceneAdaptiveFilter,
        SceneIntelligence,
    )
    from framewright_tpu_torch.processors.stabilization import VideoStabilizer
    from framewright_tpu_torch.processors.vhs import VHSProcessor
    from framewright_tpu_torch.restorer import VideoRestorer

    t_phase = time.perf_counter()
    cli_run, reset, read, model = x["cli_run"], x["reset_counters"], x["read_counters"], x["model"]
    cpu = torch.device("cpu")
    times: dict = {}
    wdir = tmp / "stream_weights"
    lcfg = lama.LamaConfig(ngf=64, n_down=3, n_blocks=18, global_ratio=0.75)
    write_npz(lama.init_params(lcfg, seed=31), wdir / inp.LAMA_NPZ)
    emit({"phase": "stream", "weights": str(wdir / inp.LAMA_NPZ),
          "arch": dataclasses.asdict(lcfg)})

    def card_vs_cpu(name, got, want):
        st = _u8_stats(got, want)
        emit({"phase": "stream", "name": name + ", card vs CPU", **st,
              "tol": {"max_lsb": 1, "frac_differ": MODEL_U8_FRAC}})
        require(st["max_abs"] <= 1 and st["frac_differ"] <= MODEL_U8_FRAC, f"{name}: {st}")

    # -- card parts against the CPU ------------------------------------------------------
    ch, cw = STREAM_CROP
    crop = synthetic_frames(1, ch, cw, 96, **PROGRESSIVE)[0]
    hole = np.zeros((ch, cw), bool)
    hole[40:70, 30:120] = True
    on_card, on_cpu = (inp.WatermarkRemover(inp.InpaintConfig(weights_dir=str(wdir),
                                                              device=str(d)))
                       for d in (dev, cpu))
    held = torch.cuda.memory_allocated()
    on_card.setup()
    lama_weights = torch.cuda.memory_allocated() - held
    on_cpu.setup()
    with full_f32():
        card_vs_cpu("LaMa 128x192", on_card.lama_fill(crop, hole), on_cpu.lama_fill(crop, hole))
        card_vs_cpu("heat fill 128x192", on_card.diffusion_fill(crop, hole),
                    on_cpu.diffusion_fill(crop, hole))
        qp_in = synthetic_frames(4, STREAM_H, STREAM_W, 97, **PROGRESSIVE)
        card_vs_cpu("DCT threshold 4x1080p", dct_filter(torch.from_numpy(qp_in).to(dev), 3.0, 4)
                    .cpu().numpy(), dct_filter(torch.from_numpy(qp_in), 3.0, 4).numpy())
        lt = synthetic_frames(16, 256, 448, 98, **PROGRESSIVE)
        lcfg_t = LatentTemporalConfig()
        card_vs_cpu("latent chunk 16x256x448", smooth_chunk(torch.from_numpy(lt).to(dev), lcfg_t)
                    .cpu().numpy(), smooth_chunk(torch.from_numpy(lt), lcfg_t).numpy())
        # card times at 1080p
        big_hole = np.zeros((STREAM_H, STREAM_W), bool)
        big_hole[900:980, 200:1700] = True
        f1080 = qp_in[0]
        times["lama_ms"] = cuda_ms(lambda: on_card.lama_fill(f1080, big_hole), 2, 1)
        times["heat_ms"] = cuda_ms(lambda: on_card.diffusion_fill(f1080, big_hole), 3, 1)
        xq = torch.from_numpy(qp_in).to(dev)
        times["dct_ms_per_frame"] = cuda_ms(lambda: dct_filter(xq, 3.0, 4), 3, 1) / len(qp_in)
        l16 = synthetic_frames(16, STREAM_H, STREAM_W, 99, **PROGRESSIVE)
        xl = torch.from_numpy(l16).to(dev)
        times["latent_ms_per_frame"] = cuda_ms(lambda: smooth_chunk(xl, lcfg_t), 3, 1) / 16
        del xq, xl
        # peaks at 1080p against the planner's pre-SR rows; LaMa's with its
        # weights, which the stage loads beside the SR batch
        torch.cuda.empty_cache()
        px = STREAM_H * STREAM_W
        filled, lama_peak = part_peak(lambda: on_card.lama_fill(f1080, big_hole))
        require(np.array_equal(filled, on_card.lama_fill(f1080, big_hole)),
                "LaMa 1080p: two runs on the card differ")
        qp8 = np.concatenate([qp_in, qp_in[::-1]])
        qp_card = QPArtifactRemover(QPRemovalConfig(strength=3.0))
        peaks = {"lama": lama_peak + lama_weights,
                 "heat": part_peak(lambda: on_card.diffusion_fill(f1080, big_hole))[1],
                 "qp": part_peak(lambda: qp_card.process_batch(qp8))[1],
                 "latent": part_peak(lambda: LatentTemporalSmoother()._run(l16))[1]}
        for part, peak in peaks.items():
            plan = (planner.pre_sr_bytes(STREAM_H, STREAM_W, None, "latent") if part == "latent"
                    else planner.pre_sr_bytes(STREAM_H, STREAM_W, None, None, stages=(part,)))
            emit({"phase": "stream", "part": part, "peak_bytes": peak,
                  "peak_bytes_per_px": peak / px, "planner_bytes": plan,
                  **({"weights_bytes": lama_weights} if part == "lama" else {})})
            x["plan_checks"].append((f"stream {part} 1080p", peak, plan))
        times["peaks_bytes_per_px"] = {k: v / px for k, v in peaks.items()}
    # host stages a 1080p frame (the VHS window of 5, the stabilizer's estimate
    # and warp, the scene analysis and filter, the HDR expansion of a 4K frame)
    frames8 = [f for f in synthetic_frames(STREAM_N, STREAM_H, STREAM_W, 100, **PROGRESSIVE)]
    times["vhs_host_ms"] = host_ms(lambda: list(VHSProcessor().process_stream(iter(frames8))),
                                   1) / STREAM_N
    times["stabilize_host_ms"] = host_ms(
        lambda: list(VideoStabilizer().process_stream(iter(frames8))), 1) / STREAM_N
    si = SceneIntelligence(sample_every=1, device=str(dev))
    times["scene_analysis_host_ms"] = host_ms(lambda: si.analyze_video(iter(frames8[:2])), 1) / 2
    pmap = {0: si.get_adaptive_settings(si.analyze_frame(frames8[0]))}
    pmap[0].sharpening = 0.6
    times["scene_filter_host_ms"] = host_ms(
        lambda: list(SceneAdaptiveFilter(pmap).process_stream(iter(frames8[:2]))), 1) / 2
    up = np.repeat(np.repeat(frames8[0], 2, 0), 2, 1)
    hdr = HDRConverter(HDRConfig(target="hdr10plus"))
    times["hdr_host_ms_4k"] = host_ms(lambda: hdr.expand_frame(up), 1)
    emit({"phase": "stream", "card": "ms a 1080p frame", **times})

    # -- the restores ------------------------------------------------------------------
    n = STREAM_N
    src = tmp / "stream_src.y4m"
    clip = synthetic_frames(n, STREAM_H, STREAM_W, 101, **PROGRESSIVE).astype(np.int16)
    clip[:, 980:1010, 300:1600] = 235           # a static overlay for the mask
    with Y4MWriter(src, STREAM_W, STREAM_H, fps=24) as writer:
        for f in clip.astype(np.uint8):
            writer.write_frame(f)
    with Y4MReader(src) as reader:
        decoded = np.stack(list(reader))
    fw = model.fast_weights()

    def restore(label, proj, out, overrides, callback=None):
        cfg = Config(weights_dir=wdir, project_dir=proj, **overrides)
        torch.cuda.empty_cache()
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = VideoRestorer(cfg, callback).restore_video(src, out)
        wall = time.perf_counter() - t0
        launches = read()
        rec = {"wall_seconds": wall, "ms_per_frame": 1e3 * wall / STREAM_N,
               "batches": res.batches, "batch_size": res.batch_size, "errors": res.errors,
               "resumed_from": res.resumed_from}
        emit({"phase": "stream", "run": label, "pre_sr": res.pre_sr, "post_sr": res.post_sr,
              "launches": launches, **rec})
        require(res.errors == 0 and res.frames_out == STREAM_N, f"{label}: {rec}")
        want = {k: 0 for k in launches}
        want.update(fused_rdb=69 * res.batches, conv_body_skip=res.batches,
                    fused_tail=res.batches)
        require(launches == want, f"{label}: launch counts {launches}, expected {want}")
        return cfg, res, rec

    def parts(cfg, res, hdr_on):
        sr_in, _ = pre_sr_stream_of(cfg, src, decoded)
        bs, n = res.batch_size, len(decoded)
        conv = HDRConverter(HDRConfig(mode="expand", target="hdr10plus")) if hdr_on else None
        outs = []
        with torch.no_grad():
            for i in range(0, n, bs):
                xs = torch.from_numpy(sr_in[i:i + bs]).to(dev).to(torch.bfloat16) / 255.0
                u = model.apply_fast(xs, "rgb_u8", weights=fw).cpu().numpy()
                outs += [conv.expand_frame(f) if conv is not None else f for f in u]
        return np.stack(outs), conv

    def same_planes(label, got_path, rgb):
        want_path = tmp / f"{got_path.stem}_want.y4m"
        with Y4MWriter(want_path, rgb.shape[2], rgb.shape[1], fps=24) as writer:
            for f in rgb:
                writer.write_frame(f)
        got, want = read_y4m_planes(got_path)[2], read_y4m_planes(want_path)[2]
        worst = max(int(np.abs(g.astype(np.int16) - w_).max())
                    for a, b in zip(got, want) for g, w_ in zip(a, b))
        emit({"phase": "stream", "run": label, "name": "written planes vs the parts alone",
              "max_abs": worst, "tol": {"max_abs": 0}})
        require(len(got) == len(want) == n and worst == 0,
                f"{label}: output differs from its parts by {worst}")

    out = tmp / "stream_straight.y4m"
    label = "stages + heat-fill watermark removal"
    cfg, res, times["stream_restore"] = restore(label, tmp / "proj_stream", out, STREAM_OVERRIDES)
    rgb, conv = parts(cfg, res, True)
    same_planes(label, out, rgb)
    sidecar = Path(str(out) + ".hdr10plus.json")
    require(sidecar.is_file() and sidecar.read_text() == conv.collector.to_json(),
            f"{label}: the HDR10+ sidecar is missing or differs")
    bs = res.batch_size

    class Stop(Exception):
        pass

    def stop(info):
        if info.frames_done >= bs:
            raise Stop()

    resumed = tmp / "stream_resumed.y4m"
    try:
        restore(label + " (stopped)", tmp / "proj_stream_resumed", resumed, STREAM_OVERRIDES,
                stop)
        require(False, "the stream restore was not stopped")
    except Stop:
        pass
    _, res2, _ = restore(label + " resumed", tmp / "proj_stream_resumed", resumed,
                         STREAM_OVERRIDES)
    same = (resumed.read_bytes() == out.read_bytes()
            and Path(str(resumed) + ".hdr10plus.json").read_text() == sidecar.read_text())
    emit({"phase": "stream", "run": label + " resumed", "resumed_from": res2.resumed_from,
          "equal_to_straight": same})
    require(res2.resumed_from == bs and same,
            f"stream resumed at {res2.resumed_from}, equal to straight: {same}")

    # LaMa at batch 2: no post-SR work, so the YUV-direct writer path; the
    # restore runs LaMa in the ring's producer thread on a stream of its
    # own, its parts alone run it here
    lama_over = {"watermark_removal": True, "inpaint_model": "lama", "batch_size": 2}
    label = "LaMa watermark removal"
    lama_out = tmp / "stream_lama.y4m"
    cfg, res, times["lama_restore"] = restore(label, tmp / "proj_lama", lama_out, lama_over)
    sr_in, info = pre_sr_stream_of(cfg, src, decoded)
    require(info["inpaint"]["mask_fraction"] > 0, f"LaMa restore: no mask {info}")
    planes_equal(label, x["kernel_path"](model, fw), sr_in, read_y4m_planes(lama_out)[2],
                 res.batch_size, dev)
    bs = res.batch_size
    resumed = tmp / "stream_lama_resumed.y4m"
    try:
        restore(label + " (stopped)", tmp / "proj_lama_resumed", resumed, lama_over, stop)
        require(False, "the LaMa restore was not stopped")
    except Stop:
        pass
    _, res2, _ = restore(label + " resumed", tmp / "proj_lama_resumed", resumed, lama_over)
    same = resumed.read_bytes() == lama_out.read_bytes()
    emit({"phase": "stream", "run": label + " resumed", "resumed_from": res2.resumed_from,
          "equal_to_straight": same})
    require(res2.resumed_from == bs and same,
            f"LaMa resumed at {res2.resumed_from}, equal to straight: {same}")
    times["seconds"] = round(time.perf_counter() - t_phase, 3)
    emit({"phase": "stream", "seconds": times["seconds"]})
    return times


COLOR_H, COLOR_W = 1080, 1920
COLOR_SOURCE = 5                 # source frames of the dropped-frame clip (one more written)
COLOR_CROP = (128, 192)          # the colorize and gap-fill parts, card vs CPU
COLOR_OVERRIDES = {"colorize": True, "colorize_model": "ddcolor",
                   "fill_missing_frames": True, "batch_size": 2}


def gap_clip(n: int, drop: int, h: int, w: int, seed: int) -> np.ndarray:
    """Grey frames of a smooth seeded texture (a random grid every 32 px,
    bilinear, no grain) panning 2 px a frame, frame ``drop`` left out: the
    step across the drop scores ~1.96x its neighbours' (the gap filler's
    ratio is 1.8), and the interlace detector reads the frames as
    progressive."""
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((1, 1, h // 32 + 2, w // 32 + 8), dtype=np.float32))
    big = F.interpolate(coarse, size=(h, w + 2 * n), mode="bilinear",
                        align_corners=False)[0, 0].numpy()
    grey = np.stack([big[:, 2 * t:2 * t + w] for t in range(n) if t != drop])
    grey = np.clip(grey * 200.0 + 28.5, 0, 255).astype(np.uint8)
    return np.repeat(grey[..., None], 3, -1)


def color_gap_phase(tmp: Path, dev, x: dict) -> dict:
    """Colorization and gap filling (slice 13, A10b-1) on x2plus 1080p, and
    the ``extend`` verb. -> times.

    - seeded checkpoints at the published widths, from the port's own
      inits, in a weights directory of the phase: DDColor at
      ``large_config()`` (``ddcolor.npz``) and ECCV16 at width 1.0
      (``eccv16.npz``);
    - each part on the card against the port's CPU run on a 128x192 crop
      (uint8 within 1 LSB on at most 0.1%, the flow within 1e-3 px): a
      DDColor and an ECCV16 keyframe, the key-4 propagation flow and the
      propagated frame (a palette keyframe warped), the key-5 midpoint;
    - card ms a 1080p frame (CUDA events) of a DDColor and an ECCV16
      keyframe, the propagation (flow and warp) and the synthesis; host ms
      of colorize's numpy a frame; each part's peak at 1080p against the
      planner's pre-SR rows (a net keyframe with its weights);
    - a CLI restore ``--colorize --colorize-method ddcolor
      --fill-missing-frames --batch 2`` of a grey 1080p clip of
      ``COLOR_SOURCE`` frames with one dropped: one frame more written,
      counters 69/1/1 a batch, errors 0, every frame scored, every written
      plane equal to the pre-SR stream run alone then the kernel path, its
      peak within the planner's count with the new rows; stopped after its
      first batch and resumed, byte-equal;
    - ``extend --direction both --frames 2`` on 3 frames of that clip: 7
      frames, byte-equal to ``FrameExtender`` run alone then the Y4M
      writer."""
    import torch

    from framewright_tpu_torch import cli, planner
    from framewright_tpu_torch.config import Config
    from framewright_tpu_torch.hw import full_f32
    from framewright_tpu_torch.io.video import probe
    from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
    from framewright_tpu_torch.models import colorizer_net, ddcolor
    from framewright_tpu_torch.models.registry import write_npz
    from framewright_tpu_torch.processors import colorize as col
    from framewright_tpu_torch.processors.base import to_float
    from framewright_tpu_torch.processors.frame_generation import FrameExtender, GapFiller
    from framewright_tpu_torch.processors.scene_detection import frame_pair_scores
    from framewright_tpu_torch.restorer import VideoRestorer, pre_sr_reserve

    t_phase = time.perf_counter()
    cli_run, reset, read, model = x["cli_run"], x["reset_counters"], x["read_counters"], x["model"]
    cpu = torch.device("cpu")
    times: dict = {}
    wdir = tmp / "color_weights"
    write_npz(ddcolor.init_params(ddcolor.large_config(), seed=41), wdir / "ddcolor.npz")
    write_npz(colorizer_net.init_params(colorizer_net.ECCV16Config(), seed=42),
              wdir / "eccv16.npz")
    emit({"phase": "color_gap", "weights": sorted(p.name for p in wdir.iterdir()),
          "ddcolor": dataclasses.asdict(ddcolor.large_config()), "eccv16_width": 1.0})

    def card_vs_cpu(name, got, want):
        st = _u8_stats(got, want)
        emit({"phase": "color_gap", "name": name + ", card vs CPU", **st,
              "tol": {"max_lsb": 1, "frac_differ": MODEL_U8_FRAC}})
        require(st["max_abs"] <= 1 and st["frac_differ"] <= MODEL_U8_FRAC, f"{name}: {st}")

    def colorizer(method, d):
        c = col.Colorizer(col.ColorizeConfig(method=method, weights_dir=str(wdir), device=str(d)))
        c.setup()
        return c

    # -- card parts against the CPU ------------------------------------------------------
    n = COLOR_SOURCE
    clip = gap_clip(n + 1, 3, COLOR_H, COLOR_W, seed=61)
    ch, cw = COLOR_CROP
    crop = clip[:2, :ch, :cw]
    card, weights = {}, {}
    for method in ("palette", "ddcolor", "eccv16"):     # the nets' bytes beside the flow net's
        held = torch.cuda.memory_allocated()
        card[method] = colorizer(method, dev)
        weights[method] = torch.cuda.memory_allocated() - held
    filler = {str(d): GapFiller(device=str(d)) for d in (dev, cpu)}
    for f in filler.values():
        f.setup()
    for method in ("ddcolor", "eccv16"):
        card_vs_cpu(f"{method} keyframe 128x192", card[method]._colorize_keyframe(crop[0]),
                    colorizer(method, cpu)._colorize_keyframe(crop[0]))
    on_cpu = colorizer("palette", cpu)
    up = [torch.from_numpy(np.ascontiguousarray(f))[None] for f in crop]
    with torch.no_grad(), full_f32():
        flows = [c.flow_net.estimate_flow(to_float(up[1].to(d)), to_float(up[0].to(d))).cpu()
                 for c, d in ((card["palette"], dev), (on_cpu, cpu))]
    flow_err = float((flows[0] - flows[1]).abs().max())
    emit({"phase": "color_gap", "name": "key-4 propagation flow 128x192, card vs CPU",
          "max_abs_px": flow_err, "tol": {"max_abs_px": FLOW_MAX_PX}})
    require(flow_err <= FLOW_MAX_PX, f"key-4 flow: {flow_err} px")
    key = on_cpu._colorize_keyframe(crop[0])
    card_vs_cpu("propagated frame 128x192", card["palette"]._propagate(key, crop[0], crop[1]),
                on_cpu._propagate(key, crop[0], crop[1]))
    card_vs_cpu("key-5 midpoint 128x192", filler[str(dev)]._synth(crop[0], crop[1]),
                filler["cpu"]._synth(crop[0], crop[1]))

    # -- card and host times, peaks at 1080p --------------------------------------------------
    f0, f1 = clip[0], clip[1]
    px = COLOR_H * COLOR_W
    torch.cuda.empty_cache()
    for method in ("ddcolor", "eccv16"):
        times[f"{method}_keyframe_ms"] = cuda_ms(
            lambda m=method: card[m]._colorize_keyframe(f0), 3, 1)
    pal = card["palette"]
    times["propagation_ms"] = cuda_ms(lambda: pal._warp_previous(f0, f0, f1), 3, 1)
    times["synthesis_ms"] = cuda_ms(lambda: filler[str(dev)]._synth(f0, f1), 3, 1)
    warped = pal._warp_previous(f0, f0, f1)

    def ycbcr_host():
        y, _, _ = col.rgb_to_ycbcr(f1.astype(np.float32))
        _, cb, cr = col.rgb_to_ycbcr(warped)
        return col.ycbcr_to_rgb(y, cb, cr).astype(np.uint8)

    times["colorize_numpy_host_ms"] = host_ms(ycbcr_host)
    times["palette_keyframe_host_ms"] = host_ms(lambda: pal._colorize_keyframe(f0))
    times["gap_score_host_ms"] = host_ms(lambda: frame_pair_scores(f0[None], f1[None]))
    peaks = {m: part_peak(lambda m=m: card[m]._colorize_keyframe(f0))[1] + weights[m]
             for m in ("ddcolor", "eccv16")}
    peaks.update({
        "colorize": part_peak(lambda: pal._warp_previous(f0, f0, f1))[1] + weights["palette"],
        "gapfill": part_peak(lambda: filler[str(dev)]._synth(f0, f1))[1]})
    # the nets alone on a 256x256 L: their activations, which the planner
    # keeps beside every part with their weights
    l256 = torch.full((1, 256, 256, 1), 50.0, device=dev)
    with torch.no_grad(), full_f32():
        net_peaks = {m: part_peak(lambda m=m: card[m]._net(l256))[1] for m in ("ddcolor", "eccv16")}
    emit({"phase": "color_gap", "name": "net activations at 256x256", "peak_bytes": net_peaks,
          "weights_bytes": weights})
    times["net_activation_bytes"] = net_peaks
    for part, peak in peaks.items():
        stages = ("colorize", part) if part in ("ddcolor", "eccv16") else (part,)
        plan = planner.pre_sr_bytes(COLOR_H, COLOR_W, None, None, stages=stages)
        emit({"phase": "color_gap", "part": part, "peak_bytes": peak,
              "peak_bytes_per_px": peak / px, "planner_bytes": plan,
              **({"weights_bytes": weights[part]} if part in weights else {})})
        x["plan_checks"].append((f"color_gap {part} 1080p", peak, plan))
    times["peaks_bytes_per_px"] = {k: v / px for k, v in peaks.items()}
    times["weights_bytes"] = weights
    emit({"phase": "color_gap", "card": "ms a 1080p frame", **times})
    del card, filler, on_cpu
    torch.cuda.empty_cache()

    # -- the CLI restore ---------------------------------------------------------------------
    src = tmp / "color_gap_src.y4m"
    with Y4MWriter(src, COLOR_W, COLOR_H, fps=24) as writer:
        for f in clip:
            writer.write_frame(f)
    with Y4MReader(src) as reader:
        decoded = np.stack(list(reader))
    flags = ["--colorize", "--colorize-method", "ddcolor", "--fill-missing-frames",
             "--batch", str(COLOR_OVERRIDES["batch_size"])]
    cfg = Config(weights_dir=wdir, **COLOR_OVERRIDES)
    fw = model.fast_weights()

    def restore(label, proj, out, callback=None):
        reset()
        t0 = time.perf_counter()
        argv = ["restore", str(src), "-o", str(out), "--device", "cuda", "--weights-dir",
                str(wdir), "--project-dir", str(proj)] + flags
        if callback is None:
            rc, summary, peak = cli_run(argv)
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                res = VideoRestorer(Config(weights_dir=wdir, project_dir=proj,
                                           **COLOR_OVERRIDES), callback).restore_video(src, out)
            rc, summary, peak = 0, {"frames": res.frames_out, "batches": res.batches,
                                    "batch_size": res.batch_size, "errors": res.errors,
                                    "resumed_from": res.resumed_from, "pre_sr": res.pre_sr,
                                    "quality": res.quality.to_dict()}, None
        wall = time.perf_counter() - t0
        launches = read()
        require(rc == 0, f"{label}: exited {rc}")
        rec = {"wall_seconds": wall, "ms_per_frame": 1e3 * wall / summary["frames"],
               "frames": summary["frames"], "batches": summary["batches"],
               "batch_size": summary["batch_size"], "errors": summary["errors"],
               "resumed_from": summary["resumed_from"]}
        emit({"phase": "color_gap", "run": label, "pre_sr": summary["pre_sr"],
              "launches": launches, "peak_bytes": peak, **rec})
        require(summary["errors"] == 0 and summary["frames"] == n + 1
                and summary["pre_sr"].get("fill_missing_frames", {}).get("frames_inserted") == 1,
                f"{label}: {rec}, {summary['pre_sr']}")
        require(summary["quality"]["samples"] == n + 1 - summary["resumed_from"],
                f"{label}: quality {summary['quality']}")
        want = {k: 0 for k in launches}
        want.update(fused_rdb=69 * summary["batches"], conv_body_skip=summary["batches"],
                    fused_tail=summary["batches"])
        require(launches == want, f"{label}: launch counts {launches}, expected {want}")
        return summary, peak, rec

    out = tmp / "color_gap_straight.y4m"
    label = "cli " + " ".join(flags)
    summary, peak, times["restore"] = restore(label, tmp / "proj_color", out)
    bs = summary["batch_size"]
    plan = (bs * planner.frame_bytes(COLOR_H, COLOR_W, 2, "rrdb", "bfloat16", stats=True)
            + pre_sr_reserve(cfg, COLOR_H, COLOR_W))
    x["plan_checks"].append(("color_gap restore", peak, plan))
    emit({"phase": "color_gap", "run": label, "peak_bytes": peak, "planner_bytes": plan})
    sr_in, info = pre_sr_stream_of(cfg, src, decoded)
    require(len(sr_in) == n + 1 and info["fill_missing_frames"]["frames_inserted"] == 1,
            f"the pre-SR stream alone: {len(sr_in)} frames, {info}")
    planes_equal(label, x["kernel_path"](model, fw), sr_in, read_y4m_planes(out)[2], bs, dev)

    class Stop(Exception):
        pass

    def stop(info):
        if info.frames_done >= bs:
            raise Stop()

    resumed = tmp / "color_gap_resumed.y4m"
    try:
        restore(label + " (stopped)", tmp / "proj_color_resumed", resumed, stop)
        require(False, "the colorize and gap-fill restore was not stopped")
    except Stop:
        pass
    res2, _, _ = restore(label + " resumed", tmp / "proj_color_resumed", resumed, lambda i: None)
    same = resumed.read_bytes() == out.read_bytes()
    emit({"phase": "color_gap", "run": label + " resumed", "resumed_from": res2["resumed_from"],
          "equal_to_straight": same})
    require(res2["resumed_from"] == bs and same,
            f"resumed at {res2['resumed_from']}, equal to straight: {same}")

    # -- the extend verb --------------------------------------------------------------------------
    short = tmp / "extend_src.y4m"
    with Y4MWriter(short, COLOR_W, COLOR_H, fps=24) as writer:
        for f in clip[:3]:
            writer.write_frame(f)
    with Y4MReader(short) as reader:
        frames3 = list(reader)
    ext_out = tmp / "extended.y4m"
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["extend", str(short), "-o", str(ext_out), "--frames", "2",
                            "--direction", "both", "--device", "cuda"])
    times["extend_wall_seconds"] = time.perf_counter() - t0
    require(rc == 0, f"extend exited {rc}")
    rep = json.loads(buf.getvalue())
    ext = FrameExtender(device="cuda")
    alone = [*ext.extend_backward(frames3, 2), *frames3, *ext.extend_forward(frames3, 2)]
    want_path = tmp / "extended_want.y4m"
    with Y4MWriter(want_path, COLOR_W, COLOR_H, fps=probe(short).fps) as writer:
        for f in alone:
            writer.write_frame(f)
    same = ext_out.read_bytes() == want_path.read_bytes()
    emit({"phase": "color_gap", "run": "extend --direction both --frames 2", "summary": rep,
          "equal_to_frame_extender_alone": same, "wall_seconds": times["extend_wall_seconds"]})
    require(rep["frames"] == 7 and rep["added_before"] == rep["added_after"] == 2 and same,
            f"extend: {rep}, equal to FrameExtender alone: {same}")
    times["seconds"] = round(time.perf_counter() - t_phase, 3)
    emit({"phase": "color_gap", "seconds": times["seconds"]})
    return times


AV_SR = 48000
AV_SECONDS = 30
AV_SYNC_OFFSET = 0.25            # seconds (tests/test_audio.py:102-115)
AV_GAIN_TOL = 1e-5               # mask-net gains, card vs CPU (tests/test_torch_audio.py)
AV_PCM_FRAC = 1e-3               # 16-bit PCM: 1 LSB on <= 0.1% of samples
SUB_H, SUB_W, SUB_N = 540, 960, 48
FARM_RUNS = (("realesr-animevideov3", 4, 540, 960), ("RealESRGAN_x2plus", 2, 1080, 1920))
FARM_N, FARM_CHUNK = 6, 2
STREAMING_HW = (1080, 1920)      # the streaming restore's and the mesh-of-one SR's frames
SPLIT_TOL = 0.05                 # the SR on a mesh against the one-device processor
SPLIT_REPS = 7


def av_signal(seconds: float, sr: int, seed: int) -> np.ndarray:
    """Seeded stereo speech-like audio in [-1, 1]: gliding harmonic
    stacks under syllable-rate envelopes, white noise, 50 Hz hum and a
    few clicks."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    out = np.zeros((n, 2), np.float32)
    for c in range(2):
        x = np.zeros(n)
        for _ in range(int(seconds * 2)):
            f0, start = rng.uniform(90, 280), rng.integers(0, n - sr // 2)
            dur = int(rng.uniform(0.15, 0.5) * sr)
            ts = t[:dur]
            env = np.hanning(dur) * rng.uniform(0.3, 1.0) * (0.6 + 0.4 * np.sin(2 * np.pi * 5 * ts))
            x[start:start + dur] += env * sum(np.sin(2 * np.pi * f0 * k * ts) / k for k in range(1, 6))
        x = 0.4 * x / (np.abs(x).max() + 1e-6) + 0.05 * rng.standard_normal(n)
        x += 0.05 * np.sin(2 * np.pi * 50 * t)
        x[rng.integers(0, n, 5)] += 0.6
        out[:, c] = np.clip(x, -1, 1)
    return out


def pcm_stats(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return {"max_lsb": int(d.max()), "frac_differ": float((d > 0).mean())}


def wav_pcm(path: Path) -> np.ndarray:
    import wave

    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def subtitle_clip(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """Seeded dim noise frames with a bright stroked caption block in the
    bottom band on frames 10-21 and 28-35."""
    rng = np.random.default_rng(seed)
    frames = (rng.random((n, h, w, 3)) * 90).astype(np.uint8)
    y0, hh = int(h * 0.84), max(2, h // 8)
    for t in list(range(10, 22)) + list(range(28, 36)):
        frames[t, y0:y0 + hh, w // 5:w * 4 // 5] = 245
        frames[t, y0 + 1:y0 + hh - 1, w // 5 + 1:w * 4 // 5 - 1:3] = 30
    return frames


def write_clip(path: Path, frames: np.ndarray, fps: float = 24) -> Path:
    from framewright_tpu_torch.io.y4m import Y4MWriter

    with Y4MWriter(path, frames.shape[2], frames.shape[1], fps=fps) as w:
        for f in frames:
            w.write_frame(f)
    return path


def av_scaleout_phase(tmp: Path, dev, x: dict) -> dict:
    """Slice 14 (A10b-2, A11, A15) on the card: the audio verbs, the
    subtitles verb, two farm runs with worker processes, the streaming
    restore, a one-process NCCL group and the SR frames split on the one
    card."""
    import torch
    import torch.distributed as dist

    from framewright_tpu_torch import cli
    from framewright_tpu_torch.audio import WienerMaskDenoiser, read_wav, write_wav
    from framewright_tpu_torch.config import Config
    from framewright_tpu_torch.hw import full_f32
    from framewright_tpu_torch.io.y4m import Y4MReader
    from framewright_tpu_torch.models import audio_net
    from framewright_tpu_torch.parallel import dcn
    from framewright_tpu_torch.parallel.distributor import ShardedSR
    from framewright_tpu_torch.parallel.mesh import build_mesh, frame_split
    from framewright_tpu_torch.processors.format import combing_score
    from framewright_tpu_torch.processors.ocr import find_tesseract
    from framewright_tpu_torch.processors.subtitles import (
        SubtitleEnhancer,
        SubtitleTimeSync,
        SubtitleTimingExtractor,
        export_srt,
        format_srt,
        parse_srt,
    )
    from framewright_tpu_torch.processors.super_resolution import SuperResolution
    from framewright_tpu_torch.restorer import VideoRestorer, build_sr, build_sr_config
    from framewright_tpu_torch.streaming import StreamingRestorer

    t_phase = time.perf_counter()
    reset, read, nw = x["reset_counters"], x["read_counters"], x["nw"]
    times: dict = {}

    def run_cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        require(rc == 0, f"cli {' '.join(argv[:2])} exited {rc}")
        return buf.getvalue()

    # -- audio: the verb on the card against the verb on the CPU ---------------------------
    t0 = time.perf_counter()
    wav = tmp / "av.wav"
    write_wav(wav, av_signal(AV_SECONDS, AV_SR, seed=71), AV_SR)
    x_in, _ = read_wav(wav)
    out = {}
    for d in ("cuda", "cpu"):
        t1 = time.perf_counter()
        run_cli(["audio", str(wav), str(tmp / f"ai_{d}.wav"), "--device", d])
        times[f"audio_ai_wall_s_{d}"] = time.perf_counter() - t1
        run_cli(["audio", str(wav), "--separate", str(tmp / f"stems_{d}"), "--device", d])
        out[d] = {"ai": wav_pcm(tmp / f"ai_{d}.wav"),
                  "vocals": wav_pcm(tmp / f"stems_{d}" / "vocals.wav"),
                  "background": wav_pcm(tmp / f"stems_{d}" / "background.wav")}
    for k in ("ai", "vocals", "background"):
        st = pcm_stats(out["cuda"][k], out["cpu"][k])
        emit({"phase": "av_scaleout", "name": f"audio {k} 16-bit PCM, card vs CPU",
              "samples": int(out["cpu"][k].size), **st,
              "tol": {"max_lsb": 1, "frac_differ": AV_PCM_FRAC}})
        require(out["cpu"][k].size == x_in.size, f"audio {k}: {out['cpu'][k].size} samples")
        require(st["max_lsb"] <= 1 and st["frac_differ"] <= AV_PCM_FRAC, f"audio {k}: {st}")
    run_cli(["audio", str(wav), str(tmp / "dialog.wav"), "--dialog"])
    require(wav_pcm(tmp / "dialog.wav").size == x_in.size, "dialog: sample count")
    # the mask net's gains on the clip's band power, card vs CPU
    params = audio_net.load_params()
    net_card = audio_net.MaskNet(params, dev)
    net_cpu = audio_net.MaskNet(params, "cpu")
    wiener = WienerMaskDenoiser(device=dev)
    ai = WienerMaskDenoiser(device=dev, mask_fn=net_card)
    with full_f32():
        consts = wiener.prepare(len(x_in))
        t_frames = len(consts[0])
        ch0 = torch.from_numpy(np.ascontiguousarray(x_in[:, 0])).to(dev)
        bp = wiener.spectral_pass(ch0, consts)[1]
        gain_err = float((net_card(bp).cpu() - net_cpu(bp.cpu())).abs().max())
        per_min = 60.0 / AV_SECONDS * 2         # two channels a clip
        times["stft_path_ms_per_min"] = cuda_ms(
            lambda: wiener.spectral_pass(ch0, consts), 5) * per_min
        times["stft_path_ai_ms_per_min"] = cuda_ms(
            lambda: ai.spectral_pass(ch0, consts), 3) * per_min
        times["mask_net_ms_per_min"] = cuda_ms(lambda: net_card(bp), 3) * per_min
    emit({"phase": "av_scaleout", "name": "mask-net gains on the clip's band power, card vs CPU",
          "frames": t_frames, "max_abs": gain_err, "tol": {"max_abs": AV_GAIN_TOL}})
    require(gain_err <= AV_GAIN_TOL, f"mask-net gains differ by {gain_err}")
    # audio-sync: a 0.25 s offset
    shift = int(AV_SYNC_OFFSET * AV_SR)
    write_wav(tmp / "late.wav",
              np.concatenate([np.zeros((shift, 2), np.float32), x_in])[:len(x_in)], AV_SR)
    sync = json.loads(run_cli(["audio-sync", str(wav), str(tmp / "late.wav")]))
    emit({"phase": "av_scaleout", "name": "audio-sync 0.25 s", **sync})
    require(abs(abs(sync["offset_s"]) - AV_SYNC_OFFSET) < 0.02, f"audio-sync {sync}")
    times["audio_seconds"] = time.perf_counter() - t0

    # -- subtitles: the verb against its processors ------------------------------------------
    t0 = time.perf_counter()
    clip = write_clip(tmp / "subs.y4m", subtitle_clip(SUB_N, SUB_H, SUB_W, seed=72))
    srt = tmp / "subs.srt"
    line = run_cli(["subtitles", str(clip), "-o", str(srt), "--no-ocr"]).strip()
    with Y4MReader(clip) as r:
        decoded = list(r)
    events = SubtitleTimingExtractor().analyze(iter(decoded))
    require(srt.read_text() == export_srt(events, 24.0), "subtitles: SRT differs")
    require(len(events) == 2 and line == f"2 subtitle events -> {srt}", f"subtitles: {line}")
    synced = tmp / "subs.synced.srt"
    run_cli(["subtitles", str(clip), "--sync", str(srt), "--enhance", str(srt), "-o",
             str(synced)])
    want = SubtitleEnhancer.enhance(SubtitleTimeSync.sync_to_events(
        parse_srt(srt.read_text()), events, 24.0))
    require(synced.read_text() == format_srt(want), "subtitles --sync --enhance: SRT differs")
    emit({"phase": "av_scaleout", "name": "subtitles", "line": line,
          "events": [(e.start_frame, e.end_frame) for e in events],
          "tesseract": find_tesseract(), "seconds": time.perf_counter() - t0})

    # -- the farm: two worker processes on the one card -----------------------------------
    t_card = torch.cuda.get_device_properties(0).total_memory
    env = dict(os.environ, PYTHONPATH=str(ROOT), FRAMEWRIGHT_WEIGHTS_DIR=nw)
    for model_name, scale, h, w in FARM_RUNS:
        t0 = time.perf_counter()
        label = f"farm {model_name} x{scale}"
        frames = synthetic_frames(FARM_N, h, w, seed=73, **PROGRESSIVE)
        src = write_clip(tmp / f"farm_{scale}.y4m", frames)
        with Y4MReader(src) as r:
            combing = [combing_score(fr) for fr in r]
        require(max(combing) < 0.55, f"{label}: a frame reads as interlaced ({combing})")
        farm = tmp / f"farm_{scale}"
        merged = tmp / f"farm_{scale}_out.y4m"
        argv = ["farm", "run", str(src), str(farm), "-o", str(merged),
                "--chunk-frames", str(FARM_CHUNK), "--timeout", "600"]
        if model_name != "realesr-animevideov3":
            argv += ["--model", model_name, "--scale", str(scale)]
        # the coordinator and two workers, each a process of its own
        procs = [subprocess.Popen([sys.executable, "-m", "framewright_tpu_torch.cli", *a],
                                  cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for a in [argv] + [["farm", "work", str(farm), "--worker-id", f"w{i}",
                                     "--device", "cuda"] for i in range(2)]]
        try:
            outs = [p.communicate(timeout=600) for p in procs[1:]]
            if any(p.returncode for p in procs[1:]):
                procs[0].kill()
            outs.insert(0, procs[0].communicate(timeout=120))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        require(all(p.returncode == 0 for p in procs),
                f"{label}: rcs {[p.returncode for p in procs]}: "
                f"{[e[-800:] for _, e in outs]}")
        line = outs[0][0].strip()
        outs = outs[1:]
        require(json.loads(line) == {"output": str(merged)}, f"{label}: farm run printed {line}")
        done = [json.loads(o.strip().splitlines()[-1])["worker_chunks_done"] for o, _ in outs]
        res = [json.loads((farm / "results" / f"chunk_{i}.json").read_text())
               for i in range(FARM_N // FARM_CHUNK)]
        peaks = {}
        for r_ in res:
            require(r_["ok"] and r_["errors"] == 0, f"{label}: chunk {r_}")
            peaks[r_["worker"]] = max(peaks.get(r_["worker"], 0), r_["peak_bytes"])
            x["plan_checks"].append((f"{label} chunk {r_['chunk']}", r_["peak_bytes"],
                                     r_["plan_bytes"]))
        # the in-process restore of the same clip and config, its counters read
        straight = tmp / f"farm_{scale}_straight.y4m"
        reset()
        t1 = time.perf_counter()
        with with_env({"FRAMEWRIGHT_WEIGHTS_DIR": nw}):
            result = VideoRestorer(Config(
                sr_model=model_name, compute_dtype="bfloat16", scale_factor=scale,
                checkpoint_enabled=False, validate_output=False,
                project_dir=tmp / f"farm_{scale}_proj")).restore_video(src, output=straight)
        straight_wall = time.perf_counter() - t1
        launches = read()
        want = {k: 0 for k in launches}
        if model_name == "realesr-animevideov3":
            want["fused_conv_chain"] = 2 * result.batches
        else:
            want.update(fused_rdb=69 * result.batches, conv_body_skip=result.batches,
                        fused_tail=result.batches)
        require(launches == want, f"{label}: in-process launches {launches}, expected {want}")
        require(result.errors == 0, f"{label}: in-process errors {result.errors}")
        _, _, pm = read_y4m_planes(merged)
        _, _, ps = read_y4m_planes(straight)
        require(len(pm) == len(ps) == FARM_N, f"{label}: {len(pm)} merged, {len(ps)} straight")
        require(all(np.array_equal(a, b) for fa, fb in zip(pm, ps) for a, b in zip(fa, fb)),
                f"{label}: merged output differs from the in-process restore")
        rec = {"phase": "av_scaleout", "name": label, "line": line, "chunks_done": done,
               "wall_seconds": wall, "straight_wall_seconds": straight_wall,
               "in_process_launches": launches, "batches": result.batches,
               "worker_peak_bytes": peaks,
               "planner_bytes": {r_["chunk"]: r_["plan_bytes"] for r_ in res},
               "two_peaks_over_card": sum(peaks.values()) / t_card,
               "merged_equals_in_process": True}
        emit(rec)
        require(sum(done) == FARM_N // FARM_CHUNK, f"{label}: chunks done {done}")
        require(sum(peaks.values()) < t_card, f"{label}: peaks {peaks} over the card")
        times[f"{label} wall_s"] = wall

    # -- the streaming restore ------------------------------------------------------------
    t0 = time.perf_counter()
    frames = synthetic_frames(FARM_N, *STREAMING_HW, seed=74, **PROGRESSIVE)
    src = write_clip(tmp / "stream_src.y4m", frames)
    cfg = Config(project_dir=tmp / "streaming", weights_dir=nw)
    straight = tmp / "stream_straight.y4m"
    VideoRestorer(cfg).restore_video(src, output=straight)
    ready = []
    scfg = cfg.with_overrides(keep_intermediates=True)
    reset()
    t1 = time.perf_counter()
    res1 = StreamingRestorer(scfg, on_chunk_ready=lambda i, p: ready.append(i),
                             chunk_frames=FARM_CHUNK).restore_video_streaming(
        src, tmp / "streamed.y4m")
    stream_wall = time.perf_counter() - t1
    launches = read()
    chunks = FARM_N // FARM_CHUNK
    want = {k: 0 for k in launches}
    want.update(fused_rdb=69 * chunks, conv_body_skip=chunks, fused_tail=chunks)
    require(launches == want, f"streaming: launches {launches}, expected {want}")
    require(ready == list(range(chunks)) and res1.frames_out == FARM_N,
            f"streaming: ready {ready}, frames {res1.frames_out}")
    require((tmp / "streamed.y4m").read_bytes() == straight.read_bytes(),
            "streaming: output differs from the straight restore")
    res1.chunk_paths[-1].unlink()
    again = []
    res2 = StreamingRestorer(scfg, on_chunk_ready=lambda i, p: again.append(i),
                             chunk_frames=FARM_CHUNK).restore_video_streaming(
        src, tmp / "streamed2.y4m")
    require(again == [chunks - 1] and res2.restored == [chunks - 1],
            f"streaming rerun: restored {res2.restored}, callbacks {again}")
    require((tmp / "streamed2.y4m").read_bytes() == straight.read_bytes(),
            "streaming rerun: output differs from the straight restore")
    emit({"phase": "av_scaleout", "name": "streaming x2plus 1080p, chunks of 2",
          "launches": launches, "chunks": res1.chunks, "wall_seconds": stream_wall,
          "rerun_restored": res2.restored, "equals_straight": True,
          "seconds": time.perf_counter() - t0})
    times["streaming_wall_s"] = stream_wall

    # -- the process group: NCCL, world size 1 ----------------------------------------------
    spec = dcn.DistributedSpec(f"127.0.0.1:{dcn.free_port()}", 1, 0)
    try:
        multi = dcn.ensure_distributed(spec, backend="nccl")
        t = torch.ones(4, device=dev)
        dist.all_reduce(t)
        dist.barrier()
        pg = {"backend": dist.get_backend(), "world_size": dist.get_world_size(),
              "rank": dist.get_rank(), "multi": multi, "all_reduce": float(t.sum())}
    finally:
        dcn.shutdown_distributed()
    emit({"phase": "av_scaleout", "name": "process group", "init_method": spec.init_method, **pg})
    require(pg["backend"] == "nccl" and pg["world_size"] == 1 and pg["all_reduce"] == 4.0
            and not dist.is_initialized(), f"process group {pg}")

    # -- the frames split -------------------------------------------------------------------
    # the restore's SR on the default mesh (one card: the one-device
    # processor), ShardedSR over a mesh of one card, and the one-device
    # processor asked for with sharding "none": each timed on the host
    # clock over dispatch and materialize (the split's own code inside the
    # window), the runs interleaved, least of SPLIT_REPS
    mesh = build_mesh()
    xs = synthetic_frames(1, *STREAMING_HW, seed=7)
    sr_kw = dict(sr_model="RealESRGAN_x2plus", batch_size=1, weights_dir=nw)
    procs = {"default mesh": build_sr(Config(**sr_kw)),
             "mesh of one card": ShardedSR(build_sr_config(Config(**sr_kw)), mesh),
             "sharding none": build_sr(Config(**sr_kw, sharding_strategy="none"))}
    require(type(procs["default mesh"]) is SuperResolution
            and type(procs["sharding none"]) is SuperResolution,
            f"one card: the restore's SR is {type(procs['default mesh']).__name__}")
    split_launches = {}
    for name, proc in procs.items():
        proc.setup(*STREAMING_HW)
        proc.set_output_color("yuv420", full_range=True)
        reset()
        proc.materialize(proc.dispatch(xs))
        split_launches[name] = read()
    want = {k: 0 for k in split_launches["sharding none"]}
    want.update(fused_rdb=69, conv_body_skip=1, fused_tail=1)
    walls = {name: [] for name in procs}
    for _ in range(SPLIT_REPS):
        for name, proc in procs.items():
            t1 = time.perf_counter()
            proc.materialize(proc.dispatch(xs))
            walls[name].append((time.perf_counter() - t1) * 1e3)
    split_ms = {name: min(v) for name, v in walls.items()}
    none_ms = split_ms["sharding none"]
    # two parts on the one card: a mesh of two entries for cuda:0, against
    # the one-device processor on the same two frames
    x2 = synthetic_frames(2, *STREAMING_HW, seed=8)
    want_planes = procs["sharding none"].materialize(procs["sharding none"].dispatch(x2))
    for proc in procs.values():
        proc.teardown()
    two = ShardedSR(build_sr_config(Config(**{**sr_kw, "batch_size": 2})),
                    build_mesh(devices=[torch.device("cuda", 0)] * 2))
    two.setup(*STREAMING_HW)
    two.set_output_color("yuv420", full_range=True)
    reset()
    h = two.dispatch(x2)
    got_planes = two.materialize(h)
    two_launches = read()
    two_parts = [b_ - a_ for _, a_, b_ in frame_split(len(x2), two.mesh)]
    two.teardown()
    want2 = {k: 2 * v for k, v in want.items()}
    ref = x.get("stats_ms", {}).get("RealESRGAN_x2plus bfloat16", {}).get("without_stats")
    rec = {"phase": "av_scaleout", "name": "SR frames split, 1080p x2plus, one card",
           "mesh": {"shape": mesh.shape, "devices": [str(d) for d in mesh.devices]},
           "launches": split_launches, "dispatch_materialize_ms": split_ms,
           "reps": SPLIT_REPS, "tol_rel": SPLIT_TOL,
           "two_parts_on_one_card": {"parts": two_parts, "launches": two_launches,
                                     "planes_equal_unsplit": all(
                                         np.array_equal(a_, b_)
                                         for a_, b_ in zip(got_planes, want_planes))},
           "stats_phase_kernel_ms_per_frame": ref}
    emit(rec)
    for name, got in split_launches.items():
        require(got == want, f"frames split, {name}: launches {got}, expected {want}")
    for name in ("default mesh", "mesh of one card"):
        require(abs(split_ms[name] - none_ms) <= SPLIT_TOL * none_ms,
                f"frames split, {name}: {split_ms[name]} ms against {none_ms} ms unsplit")
    require(two_parts == [1, 1] and two_launches == want2
            and rec["two_parts_on_one_card"]["planes_equal_unsplit"],
            f"frames split, two parts on one card: {rec['two_parts_on_one_card']}")
    times["frames_split_ms"] = split_ms
    times["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "av_scaleout", **times})
    return times


TRAIN_HR, TRAIN_BATCH = 128, 8      # the FW_fast6_x2 / FW_fastvgg_x2 students' recipe
TRAIN_STEPS = 3                     # card vs CPU, and card twice
WARM_STEPS = 20                     # the warm start from the packaged checkpoints
TRAIN_FRAMES, TRAIN_HW = 2, (1080, 1920)   # the trained students' restores
MASK_STEPS, SEP_STEPS = 300, 40     # JAX's mask-net recipe; the separator card vs CPU
PEAK_F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
LOSS_REL = 1e-4                     # a step's loss, card vs CPU (tests/test_torch_distill.py)
SEP_LOSS_REL = 1e-3                 # the separator's: its band features divide f32 ulps of
                                    # log by deviations near 1e-3 (tests/test_torch_audio_train.py)


def _tree_pairs(a, b, path=""):
    if isinstance(a, dict):
        for k in sorted(a):
            yield from _tree_pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (u, v) in enumerate(zip(a, b)):
            yield from _tree_pairs(u, v, f"{path}/{i}")
    elif a is not None:
        yield path, np.asarray(a, np.float32), np.asarray(b, np.float32)


def _torch_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _torch_leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _torch_leaves(v)]
    return [] if tree is None else [tree]


def trees_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for _, x, y in _tree_pairs(a, b))


def hold_training(name: str, card: tuple, cpu: tuple, lr: float, steps: int,
                  loss_rel: float = LOSS_REL) -> dict:
    """A trainer's card run against its CPU run: each step's loss within
    ``loss_rel``, the parameters' mean |delta| <= 0.01 lr k, max <= 2 lr k."""
    (pc, rc), (pp, rp) = card, cpu
    rel = [abs(a - b) / abs(b) for a, b in zip(rc["losses"], rp["losses"])]
    d = np.concatenate([np.abs(x - y).ravel() for _, x, y in _tree_pairs(pc, pp)])
    out = {"name": f"{name}: card vs CPU, {steps} steps", "loss_rel_max": max(rel),
           "param_mean_abs": float(d.mean()), "param_max_abs": float(d.max()),
           "tol": {"loss_rel": loss_rel, "param_mean": 0.01 * lr * steps,
                   "param_max": 2 * lr * steps},
           "losses_card": rc["losses"], "losses_cpu": rp["losses"]}
    emit({"phase": "train", **out})
    require(len(rel) == steps and max(rel) <= loss_rel,
            f"{name}: step losses card vs CPU differ by {max(rel)} relative")
    require(d.mean() <= 0.01 * lr * steps and d.max() <= 2 * lr * steps,
            f"{name}: parameters card vs CPU differ by mean {d.mean()}, max {d.max()}")
    return out


def train_phase(tmp: Path, dev, x: dict) -> dict:
    """Slice 15 (A16) on the card: every trainer of ``models/distill.py``
    and ``models/audio_net.py``, held against its CPU run, twice on the
    card byte for byte, and the trained students restored through the
    kernels."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from framewright_tpu_torch.audio import WienerMaskDenoiser
    from framewright_tpu_torch.hw import full_f32
    from framewright_tpu_torch.io.y4m import Y4MReader
    from framewright_tpu_torch.models import audio_net, diffusion_sr, distill, nafnet, registry
    from framewright_tpu_torch.models import rrdb, srvgg
    from framewright_tpu_torch.models.layers import tree_to_torch

    t_phase = time.perf_counter()
    reset, read, cli_run, nw = x["reset_counters"], x["read_counters"], x["cli_run"], x["nw"]
    times: dict = {}

    def card_ms(loss_fn, params) -> float:
        """The card's part of a step on a fixed batch (the loss forward and
        its backward in full f32), CUDA events over 5 steps: no host data."""
        for t in params:
            t.requires_grad_(True)

        def step():
            with full_f32():
                loss = loss_fn()
            for t in params:
                t.grad = None
            with full_f32():
                loss.backward()
        return cuda_ms(step, 5, 1)

    def timed(label, fn, n_steps, flops_fwd=None, host_bound_ms=None, **kw):
        """Run a trainer on ``kw['device']``; its ms a step (a synchronised
        wall over the steps), the bound, the peak above what was allocated
        before it -> (tree, report)."""
        report = {}
        card = kw.get("device") == "cuda"
        if card:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tree = fn(report=report, **kw)
        if card:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_steps
        row = {"trainer": label, "device": kw.get("device"), "steps": n_steps,
               "ms_per_step": ms, "nondeterministic_ops": report["nondeterministic_ops"]}
        if card:
            row["peak_bytes"] = torch.cuda.max_memory_allocated() - base
            if label in card_part:
                row["card_ms_per_step"] = card_part[label]
            if flops_fwd is not None:
                row["bound_ms_per_step"] = 3 * flops_fwd / PEAK_F32_FLOPS * 1e3
                row["bound_by"] = "f32 operations (forward + 2x for the backward)"
            else:
                row["bound_ms_per_step"] = host_bound_ms
                row["bound_by"] = "host data (make_batch)"
        emit({"phase": "train", **row})
        times[f"{label} {kw.get('device')}"] = row
        return tree, report

    def flops(fn, *args) -> int:
        with torch.no_grad(), full_f32(), FlopCounterMode(display=False) as fc:
            fn(*args)
        return fc.get_total_flops()

    def module(cfg, tree):
        net = rrdb.RRDBNet if isinstance(cfg, rrdb.RRDBConfig) else srvgg.SRVGGNet
        return net.from_state_dict(cfg, registry.from_jax_params(tree, torch.float32), dev)

    def twice_equal(label, run):
        """The same steps twice on the card: the same bytes."""
        a, b = run(), run()
        same = trees_equal(a[0], b[0]) and a[1]["losses"] == b[1]["losses"]
        worst = max(float(np.abs(u - v).max()) for _, u, v in _tree_pairs(a[0], b[0]))
        emit({"phase": "train", "name": f"{label}: two card runs", "byte_equal": same,
              "max_abs": worst, "nondeterministic_ops": a[1]["nondeterministic_ops"]})
        require(same, f"{label}: two card runs differ (max {worst}); ops without a "
                f"deterministic implementation: {a[1]['nondeterministic_ops']}")
        return a

    # -- the students: from jax_init 3 steps, card twice and CPU ---------------------------
    students = {"FW_fast6_x2": ("rrdb", registry.get_model("FW_fast6_x2").arch_config),
                "FW_fastvgg_x2": ("srvgg", registry.get_model("FW_fastvgg_x2").arch_config)}
    card_part: dict = {}
    lr_batch = torch.rand(TRAIN_BATCH, TRAIN_HR // 2, TRAIN_HR // 2, 3, device=dev,
                          generator=torch.Generator(dev).manual_seed(0))
    hr_batch = torch.rand(TRAIN_BATCH, TRAIN_HR, TRAIN_HR, 3, device=dev,
                          generator=torch.Generator(dev).manual_seed(1))
    for name, (arch, cfg) in students.items():
        start = (rrdb.stack_body(rrdb.jax_init(cfg, 0)) if arch == "rrdb"
                 else srvgg.jax_init(cfg, 0))
        net = module(cfg, start)
        f_fwd = flops(net.apply, lr_batch)
        card_part[f"{name} synthetic"] = card_ms(
            lambda: (net.apply(lr_batch) - hr_batch).abs().mean(), list(net.parameters()))
        kw = dict(student_cfg=cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, hr_size=TRAIN_HR,
                  arch=arch, seed=0)
        card = twice_equal(f"{name} synthetic", lambda: timed(
            f"{name} synthetic", distill.train_student, TRAIN_STEPS, f_fwd, device="cuda", **kw))
        cpu = timed(f"{name} synthetic", distill.train_student, TRAIN_STEPS, device="cpu", **kw)
        hold_training(f"{name} synthetic", card, cpu, 2e-4, TRAIN_STEPS)

    # distillation from a seeded RealESRGAN_x2plus teacher (23 blocks)
    t_cfg = registry.get_model("RealESRGAN_x2plus").arch_config
    teacher = registry.init_params(t_cfg, seed=0)
    cfg6 = students["FW_fast6_x2"][1]
    f_fwd = (flops(module(cfg6, rrdb.jax_init(cfg6, 0)).apply, lr_batch)
             + flops(module(t_cfg, teacher).apply, lr_batch) / 3)
    _, rep = timed("FW_fast6_x2 distill (x2plus teacher)", distill.train_student, TRAIN_STEPS,
                   f_fwd, device="cuda", student_cfg=cfg6, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                   hr_size=TRAIN_HR, mode="distill", teacher=(teacher, t_cfg))
    require(all(np.isfinite(rep["losses"])), f"distill losses {rep['losses']}")

    # -- warm starts from the packaged checkpoints, the gate, the restore ------------------
    wdir = tmp / "trained_weights"
    src = tmp / "train_clip.y4m"
    write_clip(src, synthetic_frames(TRAIN_FRAMES, *TRAIN_HW, seed=81, **PROGRESSIVE))
    with Y4MReader(src) as reader:
        decoded = np.stack(list(reader))
    for name, (arch, cfg) in students.items():
        packaged = registry.read_npz(registry.packaged_weights_dir() / f"{name}.npz")
        trained, rep = timed(f"{name} warm start", distill.train_student, WARM_STEPS,
                             flops(module(cfg, packaged).apply, lr_batch), device="cuda",
                             student_cfg=cfg, steps=WARM_STEPS, batch=TRAIN_BATCH,
                             hr_size=TRAIN_HR, arch=arch, params=packaged)
        distill.save_npz(trained, wdir / f"{name}.npz")
        back = registry.read_npz(wdir / f"{name}.npz")
        require(trees_equal(trained, back), f"{name}: save_npz did not read back equal")
        net = module(cfg, back)
        psnr_m, psnr_b = distill.eval_psnr(net.apply, cfg.scale, device="cuda")
        emit({"phase": "train", "name": f"{name} after {WARM_STEPS} warm steps: JAX's gate",
              "psnr_model": psnr_m, "psnr_bicubic": psnr_b, "tol": {"above_bicubic_db": 0.5},
              "losses": rep["losses"][:2] + rep["losses"][-2:]})
        require(psnr_m > psnr_b + 0.5, f"{name}: {psnr_m} dB, bicubic {psnr_b} dB")
        out = tmp / f"trained_{name}.y4m"
        reset()
        rc, summary, peak = cli_run(["restore", str(src), "-o", str(out), "--model", name,
                                     "--weights-dir", str(wdir), "--project-dir",
                                     str(tmp / f"proj_{name}")])
        launches = read()
        require(rc == 0 and summary["errors"] == 0, f"{name} trained restore: rc {rc}")
        bs = summary["batch_size"]
        want = {k: 0 for k in launches}
        if arch == "rrdb":
            want.update(fused_rdb=3 * cfg.num_block * summary["batches"],
                        conv_body_skip=summary["batches"], fused_tail=summary["batches"])
        else:
            want.update(fused_conv_chain=2 * summary["batches"])
        require(launches == want, f"{name} trained restore: launches {launches}, want {want}")
        _, _, planes = read_y4m_planes(out)
        sd = registry.bf16_masters(registry.from_jax_params(back, torch.float32))
        m = (rrdb.RRDBNet if arch == "rrdb" else srvgg.SRVGGNet).from_state_dict(cfg, sd, dev)
        planes_equal(f"trained {name}", x["kernel_path"](m), decoded, planes, bs, dev)
        emit({"phase": "train", "name": f"{name} trained restore", "launches": launches,
              "batches": summary["batches"], "batch_size": bs, "peak_bytes": peak,
              "seconds": summary["seconds"]})
        del m, net

    # -- the diffusion SR, its sampler, the denoiser: card vs CPU --------------------------
    dcfg = registry.get_model("DiffusionSR_x4").arch_config
    dtree = tree_to_torch(diffusion_sr.jax_init(dcfg, 0), dev)
    hr = 64
    xz = torch.zeros(TRAIN_BATCH, hr, hr, 3, device=dev)
    lz = torch.zeros(TRAIN_BATCH, hr // dcfg.scale, hr // dcfg.scale, 3, device=dev)
    tf = torch.zeros(TRAIN_BATCH, device=dev)
    f_den = flops(lambda: diffusion_sr.denoise(dtree, xz, xz, tf, dcfg))
    f_smp = flops(lambda: diffusion_sr.ddim_sample(dtree, lz, dcfg, seed=0))
    leaves = [t for t in _torch_leaves(dtree) if t.is_floating_point()]
    card_part["train_diffusion"] = card_ms(
        lambda: (diffusion_sr.denoise(dtree, xz, xz, tf, dcfg) - xz).abs().mean(), leaves)
    card_part["finetune_sampler"] = card_ms(
        lambda: ((diffusion_sr.ddim_sample(dtree, lz, dcfg, seed=0) - xz) ** 2).mean(), leaves)
    for label, fn, f_fwd, lr in (("train_diffusion", distill.train_diffusion, f_den, 3e-4),
                                 ("finetune_sampler", distill.finetune_sampler, f_smp, 1e-4)):
        kw = dict(cfg=dcfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, hr_size=hr, seed=0)
        card = twice_equal(label, lambda: timed(label, fn, TRAIN_STEPS, f_fwd, device="cuda",
                                                **kw))
        hold_training(label, card, timed(label, fn, TRAIN_STEPS, device="cpu", **kw), lr,
                      TRAIN_STEPS)
    ncfg = registry.AUX_SPECS["FW_nafnet_dn"].arch_config
    nnet = nafnet.NAFNet.from_state_dict(ncfg, registry.from_jax_params(
        nafnet.jax_init(ncfg, 0), torch.float32), dev)
    f_naf = flops(nnet, torch.zeros(16, 3, 64, 64, device=dev))
    nz = torch.rand(16, 3, 64, 64, device=dev, generator=torch.Generator(dev).manual_seed(2))
    card_part["train_denoiser"] = card_ms(lambda: (nnet(nz) - nz).abs().mean(),
                                          list(nnet.parameters()))
    kw = dict(cfg=ncfg, steps=TRAIN_STEPS, seed=0)
    card = twice_equal("train_denoiser", lambda: timed(
        "train_denoiser", distill.train_denoiser, TRAIN_STEPS, f_naf, device="cuda", **kw))
    hold_training("train_denoiser", card, timed("train_denoiser", distill.train_denoiser,
                                                TRAIN_STEPS, device="cpu", **kw),
                  2e-4, TRAIN_STEPS)

    # -- the audio nets: the mask net's full recipe and JAX's gates; the separator --------
    t0 = time.perf_counter()
    for _ in range(5):
        audio_net.make_batch(np.random.default_rng(0))
    data_ms = (time.perf_counter() - t0) * 1e3 / 5
    mask, rep = timed("train_mask_net", audio_net.train_mask_net, MASK_STEPS,
                      host_bound_ms=data_ms, device="cuda", steps=MASK_STEPS)
    rng = np.random.default_rng(99)
    sr = 48000
    clean = audio_net.synth_clean(rng, 2 * sr, sr)
    noise = audio_net.synth_noise(rng, 2 * sr, sr)
    noise = noise * (np.sqrt(np.mean(clean ** 2)) / (np.sqrt(np.mean(noise ** 2)) + 1e-9)
                     ) * 10 ** (-5 / 20)
    mix = (clean + noise)[:, None]

    def snr(v):
        s = v[: len(clean), 0]
        return float(10 * np.log10(np.mean(clean ** 2) / (np.mean((s - clean) ** 2) + 1e-12)))

    ai = WienerMaskDenoiser(mask_fn=audio_net.make_mask_fn(mask, "cuda"),
                            device="cuda").process(mix, sr)
    wiener = WienerMaskDenoiser(device="cuda").process(mix, sr)
    gate = {"snr_ai": snr(ai), "snr_mix": snr(mix), "snr_wiener": snr(wiener)}
    emit({"phase": "train", "name": f"train_mask_net {MASK_STEPS} steps on the card: JAX's "
          "gates", **gate, "tol": {"above_mix_db": 3.0, "above_wiener_db": 1.0},
          "final_losses": rep["losses"][-3:]})
    require(gate["snr_ai"] > gate["snr_mix"] + 3.0 and gate["snr_ai"] > gate["snr_wiener"] + 1.0,
            f"the card-trained mask net misses JAX's gates: {gate}")
    t0 = time.perf_counter()
    for _ in range(5):
        audio_net.make_batch_sep(np.random.default_rng(0))
    sep_ms = (time.perf_counter() - t0) * 1e3 / 5
    card = timed("train_separator", audio_net.train_separator, SEP_STEPS,
                 host_bound_ms=sep_ms, device="cuda", steps=SEP_STEPS)
    cpu = timed("train_separator", audio_net.train_separator, SEP_STEPS, device="cpu",
                steps=SEP_STEPS)
    hold_training("train_separator", card, cpu, 2e-3, SEP_STEPS, SEP_LOSS_REL)
    times["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "train", "seconds": times["seconds"]})
    return times


SURF_FRAMES, SURF_HW = 2, (1080, 1920)


@contextlib.contextmanager
def in_dir(path: Path):
    """The block with ``path`` as the working directory (the batch queue's
    default config writes ``./framewright_project``)."""
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def surfaces_phase(tmp: Path, dev, x: dict) -> dict:
    """Slice 15 (A12) on the card: ``check``, ``presets``, ``warmup`` and a
    restore after it that builds nothing, the ``batch`` and ``watch``
    queues against the CLI restore, ``probe``, ``models list``, and a
    restore resolved from the environment and a config file."""
    import torch

    from framewright_tpu_torch import cli, native
    from framewright_tpu_torch.config import PRESETS, Config, build_config
    from framewright_tpu_torch.hw import HardwareTier, detect_hardware
    from framewright_tpu_torch.ops import _build
    from framewright_tpu_torch.presets import PresetRegistry

    t_phase = time.perf_counter()
    reset, read, cli_run, nw = x["reset_counters"], x["read_counters"], x["cli_run"], x["nw"]
    walls: dict = {}

    def text(argv, env=None):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with with_env({"FRAMEWRIGHT_WEIGHTS_DIR": nw, **(env or {})}), \
                contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        walls[" ".join(argv[:2])] = time.perf_counter() - t0
        require(rc == 0, f"cli {' '.join(argv)} exited {rc}")
        return buf.getvalue()

    rep = json.loads(text(["check"]))
    emit({"phase": "surfaces", "name": "check", **rep})
    require(rep["status"] == "ok" and rep["platform"] == "cuda"
            and rep["device_kind"] == torch.cuda.get_device_name(0), f"check: {rep}")
    lines = text(["presets"]).splitlines()
    reg = PresetRegistry(detect_hardware())
    shifted = [p for p in PRESETS if reg.adjust_for_hardware(build_config(p)).to_dict()
               != build_config(p).to_dict()]
    emit({"phase": "surfaces", "name": "presets", "lines": lines, "tier": reg.hardware.tier.value,
          "available": [p.name for p in reg.available()], "downshifted": shifted})
    require(len(lines) == 4 and len(reg.available()) == 4 and not shifted
            and reg.hardware.tier is HardwareTier.GPU_SINGLE, "presets: a downshift on the card")

    # warmup at 1080p, then a restore of that geometry with nothing to build
    frames = synthetic_frames(SURF_FRAMES, *SURF_HW, seed=91, **PROGRESSIVE)
    clip = write_clip(tmp / "surf.y4m", frames)
    out = text(["warmup", "--height", str(SURF_HW[0]), "--width", str(SURF_HW[1])])
    emit({"phase": "surfaces", "name": "warmup", "output": out.splitlines()[-1],
          "seconds": walls["warmup --height"]})
    require(out.splitlines()[-1].startswith(f"cache: {_build.BUILD_ROOT}"), f"warmup: {out}")

    def no_build(*a, **k):
        raise SmokeFailure("a restore after warmup started a build")

    saved = (_build.find_nvcc, native.build)
    _build.find_nvcc, native.build = no_build, no_build
    try:
        reset()
        with with_env({"FRAMEWRIGHT_WEIGHTS_DIR": nw}):
            rc, summary, _ = cli_run(["restore", str(clip), "-o", str(tmp / "after_warm.y4m"),
                                      "--project-dir", str(tmp / "pw")])
    finally:
        _build.find_nvcc, native.build = saved
    launches = read()
    require(rc == 0 and launches["fused_rdb"] == 69 * summary["batches"],
            f"restore after warmup: rc {rc}, launches {launches}")

    # the batch queue: two jobs, each equal to the CLI restore of its clip
    db = tmp / "jobs.db"
    clips = [clip, write_clip(tmp / "surf2.y4m", synthetic_frames(
        SURF_FRAMES, *SURF_HW, seed=92, **PROGRESSIVE))]
    with in_dir(tmp):
        ids = [text(["batch", "submit", str(c), "-o", str(tmp / f"job{i}.y4m"), "--db",
                     str(db)]).strip() for i, c in enumerate(clips)]
        reset()
        ran = text(["batch", "run", "--db", str(db)])
        launches = read()
        listed = text(["batch", "list", "--db", str(db)]).splitlines()
    require(ran.strip() == "processed 2 jobs", f"batch run: {ran}")
    require([ln.split()[:2] for ln in listed] == [[j, "completed"] for j in ids],
            f"batch list: {listed}")
    for i, c in enumerate(clips):
        ref = tmp / f"ref{i}.y4m"
        with with_env({"FRAMEWRIGHT_WEIGHTS_DIR": nw}):
            rc, _, _ = cli_run(["restore", str(c), "-o", str(ref), "--project-dir",
                                str(tmp / f"pref{i}")])
        require(rc == 0 and (tmp / f"job{i}.y4m").read_bytes() == ref.read_bytes(),
                f"batch job {i}: output differs from the CLI restore")
    emit({"phase": "surfaces", "name": "batch submit x2, run, list", "list": listed,
          "launches": launches, "seconds": walls["batch run"],
          "outputs_equal_cli_restore": True})

    # the watch folder: one clip dropped in, restored on the second poll
    wdir = tmp / "watch"
    wdir.mkdir()
    shutil.copyfile(clip, wdir / "w.y4m")
    with in_dir(tmp):
        text(["watch", str(wdir), "--db", str(tmp / "watch.db"), "--poll", "0.1", "--cycles",
              "2"])
    watched = wdir / "restored" / "w_restored.y4m"
    require(watched.is_file() and watched.read_bytes() == (tmp / "ref0.y4m").read_bytes(),
            "watch: the clip was not restored as the CLI restores it")

    probe = json.loads(text(["probe", str(clip)]))
    require((probe["height"], probe["width"], probe["frames"]) == (*SURF_HW, SURF_FRAMES),
            f"probe: {probe}")
    models = text(["models", "list"]).splitlines()
    fast6 = [ln for ln in models if ln.startswith("FW_fast6_x2 ")]
    require(len(fast6) == 1 and fast6[0].endswith("[packaged]"), f"models list: {fast6}")

    # FRAMEWRIGHT_BATCH_SIZE and a config file resolve as JAX's layers do
    cfg_file = tmp / "fw.json"
    Config(sr_model="FW_fast6_x2", crf=20, batch_size=5).save(cfg_file)
    env = {"FRAMEWRIGHT_BATCH_SIZE": "2", "FRAMEWRIGHT_WEIGHTS_DIR": nw}
    argv = ["restore", str(clip), "-o", str(tmp / "layered.y4m"), "--config-file",
            str(cfg_file), "--project-dir", str(tmp / "pl")]
    with with_env(env):
        resolved = cli._config_from_args(cli.build_parser().parse_args(argv))
        reset()
        rc, summary, _ = cli_run(argv)
    launches = read()
    require((resolved.sr_model, resolved.batch_size, resolved.crf) == ("FW_fast6_x2", 2, 20),
            f"layered config: {resolved.sr_model} {resolved.batch_size} {resolved.crf}")
    require(rc == 0 and summary["batch_size"] == 2 and launches["fused_rdb"] == 18,
            f"layered restore: rc {rc}, batch {summary and summary['batch_size']}, {launches}")
    emit({"phase": "surfaces", "name": "FRAMEWRIGHT_BATCH_SIZE=2 over --config-file",
          "sr_model": resolved.sr_model, "batch_size": summary["batch_size"],
          "launches": launches, "walls_s": walls})
    walls["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "surfaces", "seconds": walls["seconds"]})
    return walls


FRONT_FRAMES, FRONT_STEADY, FRONT_HW = 2, 26, (1080, 1920)
FRONT_ARCHIVE_HW = (540, 960)    # archive: x4plus to 4K (from 1080p to 8K a run took 48.4 s on an H100)
FRONT_WAIT_S = 120.0             # the API job's and the preview's cap


def frontends_phase(tmp: Path, dev, x: dict) -> dict:
    """Slice 16 (the rest of A12) on the card, on 1080p 4:2:0 clips of 2
    frames: ``recipe vhs_family_video`` against its pre-stages then the
    restore run by hand, ``quick`` against ``restore --preset fast``,
    ``archive`` (the archive phase's seeded checkpoints) against ``restore
    --preset archive``, ``do`` (its dry-run config against
    ``build_config_from_text``, its restore against the CLI restore of that
    config), ``auto``, the REST API's job (its SSE completion, its output,
    ``/api/frame``, health, hardware, the job log), a preview segment,
    ``proxy create`` and ``apply``, ``compare``, ``interpolate``,
    ``comparison_grid`` on the card against the CPU, and ``report
    estimate`` beside the steady restore fps measured here (26- and
    2-frame restores of RealESRGAN_x2plus and FW_fastvgg_x2, each after
    a restore of its model)."""
    import threading
    import urllib.request

    from PIL import Image

    from framewright_tpu_torch.api import APIServer
    from framewright_tpu_torch.config import Config
    from framewright_tpu_torch.export import comparison_grid
    from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
    from framewright_tpu_torch.nlp import build_config_from_text
    from framewright_tpu_torch.preview import PreviewServer
    from framewright_tpu_torch.processors.interpolation import (
        FrameInterpolator,
        InterpolationConfig,
    )
    from framewright_tpu_torch.recipes import RecipeExecutor, get_recipe, recipe_config
    from framewright_tpu_torch.restorer import VideoRestorer

    t_phase = time.perf_counter()
    reset, read, cli_run, nw = x["reset_counters"], x["read_counters"], x["cli_run"], x["nw"]
    walls: dict = {}
    wdir = tmp / "archive_weights"          # the archive phase's seeded checkpoints
    if not (wdir / "rife-v4.6.npz").is_file():
        write_archive_weights(wdir)
    clip = write_clip(tmp / "front.y4m",
                      synthetic_frames(FRONT_FRAMES, *FRONT_HW, seed=93, **PROGRESSIVE))
    long_clip = write_clip(tmp / "front_long.y4m",
                           synthetic_frames(FRONT_STEADY, *FRONT_HW, seed=94, **PROGRESSIVE))
    with Y4MReader(clip) as r:
        decoded = np.stack(list(r))

    def run(label, argv, weights=nw):
        """The CLI verb on the card -> (its JSON, the launch counts)."""
        reset()
        t0 = time.perf_counter()
        with with_env({"FRAMEWRIGHT_WEIGHTS_DIR": str(weights)}):
            rc, out, _ = cli_run(argv)
        walls[label] = time.perf_counter() - t0
        launches = read()
        require(rc == 0, f"frontends {label}: exited {rc}")
        return out, launches

    def same_bytes(label, a: Path, b: Path) -> None:
        ok = Path(a).read_bytes() == Path(b).read_bytes()
        emit({"phase": "frontends", "name": f"{label}: output byte-equal to {Path(b).name}",
              "equal": ok})
        require(ok, f"frontends {label}: {a} differs from {b}")

    def rrdb_counts(label, launches, batches) -> None:
        want = {k: 0 for k in launches}
        want.update(fused_rdb=69 * batches, conv_body_skip=batches, fused_tail=batches)
        require(batches > 0 and {k: launches[k] for k in want} == want,
                f"frontends {label}: launches {launches}, expected 69/1/1 x {batches}")

    # the CLI restore of the clip: the reference of the API, do, proxy and
    # preview runs; then the steady fps: the wall difference of a long and
    # a short restore, both after it
    ref = tmp / "front_ref.y4m"
    summary, launches = run("restore", ["restore", str(clip), "-o", str(ref),
                                        "--project-dir", str(tmp / "pf_ref")])
    batches = summary["batches"]
    rrdb_counts("restore", launches, batches)
    run("restore long", ["restore", str(long_clip), "-o", str(tmp / "front_ref_long.y4m"),
                         "--project-dir", str(tmp / "pf_refl")])
    run("restore short", ["restore", str(clip), "-o", str(tmp / "front_ref_short.y4m"),
                          "--project-dir", str(tmp / "pf_refs")])
    rrdb_fps = (FRONT_STEADY - FRONT_FRAMES) / (walls["restore long"] - walls["restore short"])

    # recipe vhs_family_video: the verb, then its two steps by hand
    name = "vhs_family_video"
    out, launches = run("recipe", ["recipe", name, str(clip), "-o", str(tmp / "front_rec.y4m"),
                                   "--project-dir", str(tmp / "pf_rec")])
    staged = RecipeExecutor(get_recipe(name), tmp / "pf_rec_hand", device="cuda").prestage(clip)
    with with_env({"FRAMEWRIGHT_WEIGHTS_DIR": nw}):
        hand = VideoRestorer(recipe_config(name, project_dir=tmp / "pf_rec_hand2",
                                           device_platform="cuda")).restore_video(
            staged, tmp / "front_rec_hand.y4m")
    same_bytes("recipe vhs_family_video", tmp / "front_rec.y4m", tmp / "front_rec_hand.y4m")
    rrdb_counts("recipe", launches, hand.batches)
    emit({"phase": "frontends", "name": f"recipe {name}", "launches": launches,
          "batches": hand.batches, "seconds": walls["recipe"]})

    # quick = restore --preset fast (FW_fastvgg_x2, two chain calls a batch)
    summary, launches = run("quick", ["quick", str(clip), "-o", str(tmp / "front_quick.y4m"),
                                      "--project-dir", str(tmp / "pf_q")])
    want = {k: 0 for k in launches}
    want["fused_conv_chain"] = 2 * summary["batches"]
    require(launches == want, f"frontends quick: launches {launches}, expected {want}")
    run("restore --preset fast", ["restore", str(clip), "-o", str(tmp / "front_fast.y4m"),
                                  "--preset", "fast", "--project-dir", str(tmp / "pf_f")])
    same_bytes("quick", tmp / "front_quick.y4m", tmp / "front_fast.y4m")
    run("restore --preset fast long",
        ["restore", str(long_clip), "-o", str(tmp / "front_fast_long.y4m"), "--preset", "fast",
         "--project-dir", str(tmp / "pf_fl")])
    srvgg_fps = (FRONT_STEADY - FRONT_FRAMES) / (walls["restore --preset fast long"]
                                                 - walls["restore --preset fast"])
    emit({"phase": "frontends", "name": "quick", "launches": launches,
          "batches": summary["batches"], "seconds": walls["quick"]})

    # archive = restore --preset archive (x4plus, faces, interpolation), on a
    # 960x540 clip as the archive phase's
    arc_clip = write_clip(tmp / "front_arc_src.y4m", synthetic_frames(
        FRONT_FRAMES, *FRONT_ARCHIVE_HW, seed=95, **PROGRESSIVE))
    common = ["--weights-dir", str(wdir)]
    summary, launches = run("archive", ["archive", str(arc_clip), "-o",
                                        str(tmp / "front_arc.y4m"), "--project-dir",
                                        str(tmp / "pf_a"), *common], wdir)
    n_sr = launches["fused_rdb"] // 69
    rrdb_counts("archive", launches, n_sr)
    run("restore --preset archive", ["restore", str(arc_clip), "-o",
                                     str(tmp / "front_arc_ref.y4m"),
                                     "--preset", "archive", "--project-dir", str(tmp / "pf_ar"),
                                     *common], wdir)
    same_bytes("archive", tmp / "front_arc.y4m", tmp / "front_arc_ref.y4m")
    emit({"phase": "frontends", "name": "archive", "launches": launches,
          "frames": summary["frames"], "faces_restored": summary["faces_restored"],
          "interpolation": summary["interpolation"], "seconds": walls["archive"]})

    # do: the dry-run config is build_config_from_text's; the restore is the
    # CLI restore of that config
    text = f"upscale {clip} 2x"
    dry, _ = run("do --dry-run", ["do", text, "--dry-run", "--project-dir", str(tmp / "pf_do")])
    want_cfg, _ = build_config_from_text(text, project_dir=str(tmp / "pf_do"),
                                         device_platform="auto")
    require(dry == json.loads(json.dumps(want_cfg.to_dict())),
            "frontends do: the dry-run config is not build_config_from_text's")
    _, launches = run("do", ["do", text, "-o", str(tmp / "front_do.y4m"), "--project-dir",
                             str(tmp / "pf_do")])
    rrdb_counts("do", launches, batches)
    want_cfg.save(tmp / "front_do.json")
    run("restore --config-file", ["restore", str(clip), "-o", str(tmp / "front_do_ref.y4m"),
                                  "--config-file", str(tmp / "front_do.json"),
                                  "--project-dir", str(tmp / "pf_do_ref")])
    same_bytes("do", tmp / "front_do.y4m", tmp / "front_do_ref.y4m")

    # auto: the selector's preset
    out, launches = run("auto", ["auto", str(clip), "-o", str(tmp / "front_auto.y4m"),
                                 "--project-dir", str(tmp / "pf_auto")], wdir)
    emit({"phase": "frontends", "name": "auto", "preset": out["preset"],
          "frames": out["frames"], "launches": launches, "seconds": walls["auto"]})

    # the REST API: a job with the default config, its SSE completion
    srv = APIServer(tmp / "front_api.db", port=0)
    try:
        srv.start()
        base = f"http://127.0.0.1:{srv.port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=30) as r:
                return r.status, r.headers["Content-Type"], r.read()

        api_out = tmp / "front_api.y4m"
        reset()
        t0 = time.perf_counter()
        with in_dir(tmp), with_env({"FRAMEWRIGHT_WEIGHTS_DIR": nw}):
            req = urllib.request.Request(base + "/api/jobs", data=json.dumps(
                {"source": str(clip), "output": str(api_out)}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                jid = json.loads(r.read())["job_id"]
            states, job = [], None
            with urllib.request.urlopen(base + "/api/events", timeout=FRONT_WAIT_S) as r:
                for line in r:
                    if time.perf_counter() - t0 > FRONT_WAIT_S:
                        break
                    if not line.startswith(b"data:"):
                        continue
                    job = next(j for j in json.loads(line[5:]) if j["job_id"] == jid)
                    if not states or states[-1] != job["state"]:
                        states.append(job["state"])
                    if job["state"] in ("completed", "failed", "cancelled"):
                        break
        walls["api job"] = time.perf_counter() - t0
        launches = read()
        require(job is not None and job["state"] == "completed",
                f"frontends API job: {job}, states {states}")
        same_bytes("API job", api_out, ref)
        rrdb_counts("API job", launches, batches)
        status, ctype, png = get(f"/api/frame?job={jid}&t=0")
        with Y4MReader(api_out) as r:
            frame0 = next(iter(r))
        step = max(1, (max(frame0.shape[:2]) + 639) // 640)
        got = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
        require(status == 200 and ctype == "image/png"
                and np.array_equal(got, frame0[::step, ::step]),
                f"frontends /api/frame: {status} {ctype} {got.shape}")
        health = json.loads(get("/api/health")[2])
        hardware = json.loads(get("/api/hardware")[2])
        log = json.loads(get(f"/api/jobs/{jid}/log")[2])
        require(health == {"status": "ok"} and hardware["platform"] == "cuda"
                and hardware["device_kind"] == torch_device_name() and log["lines"],
                f"frontends API: health {health}, hardware {hardware}, "
                f"{len(log['lines'])} log lines")
        emit({"phase": "frontends", "name": "API job", "sse_states": states,
              "launches": launches, "frame_png_shape": list(got.shape),
              "hardware": hardware["device_kind"], "log_lines": len(log["lines"]),
              "seconds": walls["api job"]})
    finally:
        srv.stop()

    # a preview segment: frame 1 alone, equal to frame 1 of the whole
    # restore at the segment's batch, 1 (cuDNN picks the head's conv
    # algorithm by the batch: frames of another batch round differently)
    ref1 = tmp / "front_ref_b1.y4m"
    _, launches = run("restore --batch 1", ["restore", str(clip), "-o", str(ref1), "--batch", "1",
                                            "--project-dir", str(tmp / "pf_b1")])
    rrdb_counts("restore --batch 1", launches, FRONT_FRAMES)
    ps = PreviewServer(clip, tmp / "front_preview")
    done = threading.Event()
    ps.queue.on_progress(lambda t: done.set() if t.status in ("done", "failed") else None)
    try:
        ps.start()
        t0 = time.perf_counter()
        with with_env({"FRAMEWRIGHT_WEIGHTS_DIR": nw}):
            task = ps.render_segment(1, 1, Config(project_dir=tmp / "pf_prev"))
            require(done.wait(FRONT_WAIT_S) and task.status == "done",
                    f"frontends preview: {task.status} {task.error}")
        walls["preview segment"] = time.perf_counter() - t0
    finally:
        ps.stop()
    seg = read_y4m_planes(Path(task.output))[2]
    whole = read_y4m_planes(ref1)[2]
    require(len(seg) == 1 and all(np.array_equal(a, b) for a, b in zip(seg[0], whole[1])),
            "frontends preview: the segment is not frame 1 of the whole restore at batch 1")
    emit({"phase": "frontends", "name": "preview render_segment(1, 1)",
          "equal_to_frame_1": True, "seconds": walls["preview segment"]})

    # proxy create at 360 lines, then apply: the restore of the original
    px = tmp / "front_proxy.y4m"
    created, _ = run("proxy create", ["proxy", "create", str(clip), "-o", str(px),
                                      "--height", "360"])
    _, launches = run("proxy apply", ["proxy", "apply", str(px), "-o",
                                      str(tmp / "front_proxy_apply.y4m"), "--project-dir",
                                      str(tmp / "pf_px")])
    same_bytes("proxy apply", tmp / "front_proxy_apply.y4m", ref)
    rrdb_counts("proxy apply", launches, batches)
    with Y4MReader(px) as r:
        require((r.height, r.width, r.count_frames()) == (360, 640, FRONT_FRAMES),
                f"frontends proxy: {created}")

    cmp_, _ = run("compare", ["compare", str(ref), str(ref)])
    require(cmp_["psnr_mean"] == 99.0 and cmp_["ssim_mean"] == 1.0, f"frontends compare: {cmp_}")

    # interpolate x2 with the seeded rife-v4.6 against the interpolator alone
    ip, _ = run("interpolate", ["interpolate", str(clip), "-o", str(tmp / "front_int.y4m"),
                                "--factor", "2"], wdir)
    interp = FrameInterpolator(InterpolationConfig(target_fps=48.0, weights_dir=str(wdir),
                                                   device="cuda"))
    interp.setup(*FRONT_HW)
    with Y4MReader(clip) as r, Y4MWriter(tmp / "front_int_direct.y4m", FRONT_HW[1],
                                         FRONT_HW[0], fps=48) as w:
        for f in interp.interpolate_to_fps(iter(r), 24.0):
            w.write_frame(f)
    same_bytes("interpolate", tmp / "front_int.y4m", tmp / "front_int_direct.y4m")
    interp.teardown()

    # comparison_grid: card against the CPU
    with Y4MReader(ref) as r:
        after = np.stack(list(r))
    grids = {d: comparison_grid(list(decoded), list(after), device=d) for d in ("cuda", "cpu")}
    gd = np.abs(grids["cuda"].astype(np.int16) - grids["cpu"].astype(np.int16))
    emit({"phase": "frontends", "name": "comparison_grid card vs CPU",
          "shape": list(grids["cuda"].shape), "max_abs": int(gd.max()),
          "tol": {"max_abs": 1}})
    require(gd.max() <= 1, f"frontends comparison_grid: card vs CPU {gd.max()}")

    # report estimate beside the steady fps measured above
    est = {}
    for model, measured in (("RealESRGAN_x2plus", rrdb_fps), ("FW_fastvgg_x2", srvgg_fps)):
        e, _ = run(f"estimate {model}", ["report", "estimate", str(clip), "--model", model])
        est[model] = {"est_fps_per_chip": e["est_fps_per_chip"], "steady_fps": measured,
                      "est_cost_usd": e["est_cost_usd"]}
    emit({"phase": "frontends", "name": "report estimate beside the steady restore fps",
          "nvidia_smi": nvidia_smi(), "models": est})
    walls["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "frontends", "walls_s": walls})
    return walls


def torch_device_name() -> str:
    import torch

    return torch.cuda.get_device_name(0)


def formats_phase(tmp: Path, nw: str, dev, x: dict, tools: dict) -> dict:
    """The default restore from and to a PNG frame directory (when Pillow
    is there): counters 69/1/1 a batch, every frame the kernel path's
    ``rgb_u8`` on the pre-SR stream's frames; and from an ffmpeg mkv
    (lossless ffv1) to an mp4 (when ffmpeg is there): frame count, size
    and rate through ffprobe."""
    import torch

    from framewright_tpu_torch.config import Config
    from framewright_tpu_torch.io import png_seq, video

    out = {}
    frames = synthetic_frames(4, ARCHIVE_H, ARCHIVE_W, seed=53, **PROGRESSIVE)
    model = x["model"]
    fw = model.fast_weights()
    if tools["pillow"]:
        src = tmp / "png_src"
        with png_seq.FrameDirWriter(src) as wr:
            for f in frames:
                wr.write_frame(f)
        x["reset_counters"]()
        t = time.perf_counter()
        rc, summary, peak = x["cli_run"](["restore", str(src), "-o", str(tmp / "png_out"),
                                          "--weights-dir", nw, "--project-dir",
                                          str(tmp / "png_proj")])
        wall = time.perf_counter() - t
        launches = x["read_counters"]()
        require(rc == 0, f"PNG-directory restore exited {rc}")
        batches = summary["batches"]
        want = {k: 0 for k in launches}
        want.update(fused_rdb=69 * batches, conv_body_skip=batches, fused_tail=batches)
        got = np.stack(list(png_seq.FrameDirReader(tmp / "png_out")))
        pre, _ = pre_sr_stream_of(Config(), src, frames)
        bs, worst = summary["batch_size"], 0
        with torch.no_grad():
            for i in range(0, len(pre), bs):
                xs = torch.from_numpy(pre[i:i + bs]).to(dev).to(torch.bfloat16) / 255.0
                exp = model.apply_fast(xs, "rgb_u8", True, weights=fw).cpu().numpy()
                worst = max(worst, int(np.abs(got[i:i + bs].astype(np.int16) - exp).max()))
        out["png"] = {"summary": summary, "launches": launches, "wall_seconds": wall,
                      "max_abs_vs_kernel_path": worst}
        emit({"phase": "formats", "run": "PNG directory in and out (default preset)", **out["png"]})
        require(launches == want and summary["errors"] == 0 and got.shape == (
            4, 2 * ARCHIVE_H, 2 * ARCHIVE_W, 3) and worst == 0, f"PNG restore: {out['png']}")
    else:
        emit({"phase": "formats", "png": "Pillow is absent: not run"})
    if tools["ffmpeg"] and tools.get("encoders"):
        from framewright_tpu_torch.io.ffmpeg import FFmpegPipeWriter

        src = tmp / "ff_src.mkv"
        lossless = "ffv1" if "ffv1" in tools["encoders"] else tools["encoders"][0]
        with FFmpegPipeWriter(src, ARCHIVE_W, ARCHIVE_H, fps=24, codec=lossless) as wr:
            for f in frames:
                wr.write_frame(f)
        enc = next(e for e in ("libx264", "libx265", "mpeg4", "ffv1")
                   if e in tools["encoders"])
        t = time.perf_counter()
        rc, summary, peak = x["cli_run"](["restore", str(src), "-o", str(tmp / "ff_out.mp4"),
                                          "--codec", enc, "--weights-dir", nw,
                                          "--project-dir", str(tmp / "ff_proj")])
        wall = time.perf_counter() - t
        require(rc == 0, f"ffmpeg restore exited {rc}")
        meta = video.probe(tmp / "ff_out.mp4")
        out["ffmpeg"] = {"summary": summary, "codec": enc, "wall_seconds": wall,
                         "probe": meta.__dict__}
        emit({"phase": "formats", "run": f"mkv ({lossless}) in, mp4 ({enc}) out", **out["ffmpeg"]})
        require(summary["frames"] == 4 and summary["errors"] == 0
                and (meta.width, meta.height) == (2 * ARCHIVE_W, 2 * ARCHIVE_H)
                and meta.nb_frames == 4, f"ffmpeg restore: {out['ffmpeg']}")
    else:
        emit({"phase": "formats", "ffmpeg": "ffmpeg is absent: not run"})
    return out


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
    """``scripts/torch_presr_times.py --frames 2 4 --profile --presets
    quality`` in a process of its own: dispatch's enqueue ms and the
    quality restore's busy share and peaks (the default and film restores
    are left out for the smoke's time: phase 5 and "film" time theirs)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_presr_times.py"),
                           "--frames", "2", "4", "--profile", "--presets", "quality"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    require(proc.returncode == 0, f"torch_presr_times.py: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    runs = out["runs"]
    rec = {"phase": "c5", "card": out["card"],
           "enqueue_ms_per_dispatch": {k: r["enqueue_ms_per_dispatch"] for k, r in runs.items()},
           "quality_busy_share": runs["quality 4 profiled"]["device_busy_share"],
           "quality_busy_share_unprofiled":
               runs["quality 4 profiled"]["device_busy_share_unprofiled"],
           "quality_peaks": {k: (r["peak_allocated_bytes"], r["peak_reserved_bytes"])
                             for k, r in runs.items() if k.startswith("quality")},
           "steady_ms_per_frame": out["steady_ms_per_frame"],
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

        def stop_after_first(info):
            if info.frames_done >= 2:
                raise Stop(info.frames_done)

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
        dyn_out = tmp / "sub_dynamic.npz"
        # the two processes run at once, each on the card
        procs = [subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for argv in (
            [sys.executable, "-m", "framewright_tpu_torch.cli", "restore", str(vsrc), "-o",
             str(sub_out), "--model", "realesr-animevideov3", "--weights-dir", nw,
             "--project-dir", str(tmp / "sub")],
            [sys.executable, "-c", SUBPROCESS_DYNAMIC, str(src), str(dyn_out), nw])]
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for what, p, (_, err) in zip(("cli", "dynamic"), procs, outs):
            require(p.returncode == 0, f"subprocess {what} restore: {err[-2000:]}")
        sub_summary = json.loads(outs[0][0])
        gate_ok("subprocess realesr-animevideov3", sub_summary)
        _, _, planes_out = read_y4m_planes(sub_out)
        planes_vs_kernel_path("subprocess cli realesr-animevideov3 bfloat16",
                              kernel_path(vgg, vgg.fast_weights()),
                              inputs["realesr-animevideov3"], planes_out,
                              sub_summary["batch_size"])
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
        tools = tools_phase()
        x = {"cli_run": cli_run, "reset_counters": reset_counters,
             "read_counters": read_counters, "model": model, "plan_checks": plan_checks}
        formats = formats_phase(tmp, nw, dev, x, tools)
        archive_times = archive_phase(tmp, dev, x)
        engine_times = engine_phase(tmp, dev, {**x, "nw": nw}, tmp / "archive.y4m",
                                    tmp / "archive_weights")
        models_times = models_phase(tmp, dev, {**x, "nw": nw, "kernel_path": kernel_path})
        diffusion_times = diffusion_phase(tmp, dev, {**x, "nw": nw})
        stream_times = stream_phase(tmp, dev, {**x, "kernel_path": kernel_path})
        color_gap_times = color_gap_phase(tmp, dev, {**x, "kernel_path": kernel_path})
        av_times = av_scaleout_phase(tmp, dev, {**x, "nw": nw, "stats_ms": stats_ms})
        train_times = train_phase(tmp, dev, {**x, "nw": nw, "kernel_path": kernel_path})
        surface_walls = surfaces_phase(tmp, dev, {**x, "nw": nw})
        front_walls = frontends_phase(tmp, dev, {**x, "nw": nw})
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
          "film": film_times, "tools": tools,
          "formats": {k: v["wall_seconds"] for k, v in formats.items()},
          "archive": archive_times, "engine": engine_times,
          "color_gap": {k: v for k, v in color_gap_times.items() if k != "seconds"},
          "av_scaleout": av_times, "train": train_times, "surfaces": surface_walls,
          "frontends": front_walls,
          "models": {k: v for k, v in models_times.items() if k != "seconds"}, "c5": {k: c5[k] for k in ("enqueue_ms_per_dispatch",
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
