"""Batch planner for the card's free memory.

The port's counterpart of ``framewright_tpu.planner``: the body runs at
input resolution / ``body_divisor`` (pixel_unshuffle for RRDB at scale
2 and 1; SRVGG always at input resolution), and the batch is
the largest number of whole frames whose peak device memory fits the
free card memory times the utilization. The TPU-only caps of the JAX
planner (compiler limits, measured best batches on v5e) have no
counterpart here.

Tiling (``framewright_tpu/planner.py:75-220``): a frame that does not fit
at batch 1 is cut into tiles (``ops.tiling``), the largest of JAX's
candidate sizes whose batch of tiles fits; ``tile_size_override`` pins
the size. A tile costs the model's bytes per body pixel at its padded
extent (the tile, its halo on each side, aligned to the body divisor),
times the batch of tiles, and each frame of a dispatch the stitched
output and the epilogue outside the model. ``Plan.downshift`` after a
device out-of-memory halves the batch, then moves a whole-frame plan to
tiles, then to smaller tiles, as JAX's ``TilePlan.downshift``; below the
smallest tile it raises ``HBMError``. A whole-frame plan keeps the halo
its tiles would take (the JAX whole-frame plan has overlap 0, so its
downshift into tiles runs them without a halo).

Beside the SR batch: the pre-SR stream's row (``pre_sr_bytes``) and the
face restorer's (``face_bytes``: its model's weights, one crop's
activations, and RetinaFace on a whole output frame when it detects).
The interpolate stage runs after the SR processor has released its
memory and plans its own pair batch (``interpolation_pairs``).

The models without a kernel: HAT (``hat``: bytes per input pixel, and
its attention chunk, which grows with the windows of a dispatch up to
512 and then stays; ``Plan.chunk_bytes``), the diffusion SR
(``diffusion``: bytes per input pixel; its batch of tiles at most
``max_batch``, as JAX's, since its noise is drawn per chunk), the video SR window
(``vsr_bytes``: BasicVSR or TVSR over ``window`` frames, which the video
SR processor holds against the free memory), the denoiser's Restormer (a
pre-SR row at the checkpoint's widths, ``restormer_bytes_per_px``) and
RAFT, whose correlation volume grows with the square of the pixels
(``raft_pair_bytes``; ``raft_pairs`` is the number of pairs a denoiser
step may hold, and ``pre_sr_bytes`` reserves them).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

from framewright_tpu_torch.errors import HBMError

# Peak device bytes per body-resolution pixel of one frame on the kernel
# path, with 10% headroom.
# RRDB (the output is always 16 pixels per body pixel):
#   bfloat16: three 192-channel bf16 RDB workspaces (1152), the head
#     output and K1's output (128 each), and the tail's intermediates at
#     2x and 4x the body resolution (512 + 2 x 2048): 6016 -> 6800
#   float32: as bfloat16 (the same kernels); the f32 head output (256)
#     is cast to bf16 and freed before the body: 6800
#   int8: three 64-channel bf16 carries (384) and one 192-channel int8
#     code workspace (192) in place of the workspaces, the rest as
#     bfloat16: 5440 -> 6000
#   int8-dynamic (the tail1 path), measured on an H100 with
#     ``max_memory_allocated`` (chip_smoke.py phase 4, x2plus at 1080p):
#     tail1's 4K bf16 intermediates (2 x 2048) and RGB output (96) beside
#     conv_up1's output (512), the features and the body output (256):
#     4993 -> 5500
_RRDB_PEAK_BYTES_PER_BODY_PX = {"bfloat16": 6800, "float32": 6800, "int8": 6000,
                                "int8-dynamic": 5500}
# SRVGG, per input pixel (scale s), the largest of the four parts of
# ``SRVGGNet.apply_fast``, each as measured alone on an H100 with
# ``max_memory_allocated`` (chip_smoke.py phase 4, at x4 and x2):
#   head: conv0's bf16 output (128), PReLU's mask (64), product (128) and
#     result (128): 448;
#   chain: a group's bf16 output (128) and two bf16 ping-pong buffers
#     (256), beside its input (128), or in int8 two 64-channel code
#     buffers (128) in place of the ping-pong buffers: 512 bfloat16, 384
#     int8; float32 runs the plain f32 forward (``SRVGGNet.apply``), whose
#     layer holds its f32 input (256), the conv's output (256), PReLU's
#     mask (64), product and result (2 x 256): 1088, and cuDNN's
#     workspace: 1280;
#   tail: the chain's bf16 output (128), its f32 copy (256), and conv_last
#     in f32: another 256 inside cuDNN's f32 convolution (measured, not a
#     buffer of the port's), its f32 output and the pixel-shuffled copy
#     (2 x 12 s^2): 640 + 24 s^2;
#   epilogue: the f32 image (12 s^2), its clamped copy (12 s^2), and Y, U,
#     V and two temporaries in f32 at s^2 (16 s^2): 40 s^2;
# then + 10% for the frame's uint8 and bf16 input and the planes.
_SRVGG_HEAD_BYTES = 448
_SRVGG_CHAIN_BYTES = {"bfloat16": 512, "float32": 1280, "int8": 384}
# The quality gate's stats (``SRConfig.device_stats``), computed one frame
# at a time once the batch's output is complete, per output pixel of that
# frame: the frame in f32 in [0, 1], the bicubic reference and its
# width-pass intermediate, and SSIM's maps of one channel (five filtered
# quantities, their row pass and the map's temporaries). RRDB's come from
# the Y plane ("luma", 1 channel), SRVGG's from the RGB image ("rgb"),
# beside the batch's f32 image (12 per output pixel a frame).
_STATS_BYTES_PER_OUT_PX = {"luma": 64, "rgb": 96}
# The SR's frames x space split (``plan(band_rows=...)``): beside its
# bands, the device that gathers them holds per output pixel of the whole
# frame the gathered output and what runs on it after the gather: SRVGG's
# (and the enhancement cap's) epilogue on the f32 image, 40 as in SRVGG's
# row; RRDB's uint8 planes or RGB and their gathered copy, at most 6.
_GATHERED_BYTES_PER_OUT_PX = 40
# Its bands on one device run in turn: the model's working set is one
# band's, and what every band keeps while the others run is, per body
# pixel of a band, RRDB's carried features and the head's skip (two bf16
# 64-channel maps) with the band's own output until the gather (6 B an
# output pixel, the bf16 RGB of the float path), and SRVGG's input band
# (bf16 RGB) with its f32 RGB output (it runs each band whole, no exchange).


def band_resident_bytes_per_body_px(family: str, scale: int) -> int:
    """Bytes a band keeps per body pixel while the device's other bands
    run (the comment above)."""
    out_px = (body_divisor(family, scale) * scale) ** 2
    if family == "rrdb":
        return 2 * 64 * 2 + 6 * out_px
    return 6 + 12 * out_px
_CPU_BUDGET = 8 * 2**30   # what to plan for when running on the CPU
# The pre-SR stream (the restorer's denoise and temporal-consistency
# stages, on the card in the ring's producer thread, beside the SR
# batch): peak device bytes per input pixel of each part, which run in
# turn, each alone with its uint8 window on the card. f32 frame = 12 B/px.
#   temporal: the flow net on the 2r = 6 slots at sizes padded to 32 (the
#     two padded images, the 12-channel level input, the 6-channel output
#     resized to the frame, the flow, the two warps and their grid: ~136
#     B/px a slot), then the warped slots, their differences and the
#     sort for the median: 180 a slot, 120 for the rest;
#   nafnet: the temporal blend, then FW_nafnet_dn (width 16, f32) on the
#     centre, less than the blend's peak;
#   bilateral: the centre, nine shifts and their weights, one at a time;
#   attention (CFA, radius 1): 18 shifted neighbours (216), their
#     products with the expanded weights (216) and the weights (76).
# Measured on an H100 with ``max_memory_allocated`` (chip_smoke.py phase
# pre_sr, one 1080p centre): temporal 1053 and nafnet 1052 B/px against
# the 1200 planned; bilateral 156-174 (two runs), attention 803 (guessed
# 100 and 700, now the larger reading + 12-15%).
_PRE_SR_BYTES_PER_PX = {"temporal_fixed": 120, "temporal_slot": 180, "bilateral": 200,
                        "attention": 900,
                        # the A10b stages, f32 on the card: the latent chunk of
                        # 16 frames (the centred frames, the basis and the
                        # reconstruction), a QP batch of 8 frames (the frames,
                        # the sum and one grid's rolled, blocked and
                        # transformed copies), LaMa (its maps at full, half,
                        # quarter and eighth resolution; its weights are
                        # _LAMA_WEIGHTS_BYTES beside every part), the heat
                        # fill (a frame's few f32 copies)
                        "latent": 1394, "qp": 913, "lama": 1325, "heat": 102,
                        # A10b-1, f32 on the card: the gap filler's IFNet
                        # midpoint (interpolate_padded at (96, 64)) and
                        # colorize (the propagation IFNet at (64, 48), the
                        # warp and a net keyframe's full-size Lab maths; the
                        # net's weights and 256x256 activations are
                        # _PRE_SR_FIXED_BYTES beside every part)
                        "gapfill": 214, "colorize": 214, "ddcolor": 214, "eccv16": 214}
# Measured on an H100 80GB HBM3 at 700 W with ``max_memory_allocated``
# (chip_smoke.py phase stream, 1080p, each part as the restore runs it),
# then + 15%: the
# latent chunk 1212 B a pixel, the QP batch 794, LaMa at Big-LaMa's widths
# 1151 (ngf 64, 3 downs, 18 blocks) beside its 206.8 MB of f32 weights,
# the heat fill 88 (planned before: 1500, 1200, 2000 with the weights,
# and 100).
_LAMA_WEIGHTS_BYTES = 238_000_000
# Colorize and the gap filler, measured the same way at 1080p (chip_smoke.py
# phase color_gap), then + 15%: the propagation (the key-4 flow and the
# warp) 186 B a pixel, the key-5 midpoint 186, a net keyframe's full-size
# Lab maths ~85 (planned before: 600 each).
#
# The card bytes a stage holds whatever the frame size: LaMa's weights, and
# a colorize net's weights with its activations on the 256x256 L, measured
# as above, then + 15%: DDColor at large_config() 134.3 MB + 72.3 MB,
# ECCV16 at its published widths 130.8 MB + 69.2 MB (f32).
_PRE_SR_FIXED_BYTES = {"lama": _LAMA_WEIGHTS_BYTES, "ddcolor": 238_000_000,
                       "eccv16": 230_000_000}
# Restormer (f32) on the blend, at the widths of the checkpoint
# (``restormer_bytes_per_px``): its peak is GDFN in the full-resolution
# blocks of 2 dim channels C (the decoder's level 0 and the refinement),
# where the block's input and its norm (2C) sit beside ffn_in's 2h-channel
# output, the depthwise pass and its NHWC copy (6h, h = int(C x
# ffn_expansion)), and the frame itself (3): 4 (2C + 6h + 3) B, + 15%.
# Measured on an H100 with ``max_memory_allocated`` (chip_smoke.py phase
# models, a 1080p frame): JAX's RestormerConfig() (dim 16, the JAX
# denoiser's widths once weighted) 2112 B a pixel, 2654 planned; the
# published widths (dim 48, blocks 4/6/6/8) 6336, 7935 planned.
#
# RAFT (RAFTConfig(), f32) a pair, at the frame size padded to 8, n8 =
# (H/8)(W/8) positions: the correlation volume (n8^2 f32) and its pooled
# levels (1/4 + 1/16 + 1/64 of it), beside the encoders' 64-channel maps
# at half resolution (two images: ~500 B an input pixel) and the update
# block at 1/8 (its convolutions as matrix products, models/raft.py); the
# largest is the volume: 4.2 GB a 1080p pair, 5.6 GB with the pyramid;
# 6.82 GB planned, 6.33 measured on an H100 (chip_smoke.py phase models,
# a step of 5 pairs: 31.6 GB).
_RAFT_PX_BYTES = 600
# HAT (HAT_SRx4 at hat.official_config(): 180 channels, 6 heads, window
# 16, OCAB's 24x24 key windows), per input pixel: the activations of a
# block (the input, the norm, the conv branch's 60- and 180-channel maps,
# the rolled and windowed copies, the attention output, the MLP's
# 360-channel hidden map), OCAB's projected k and v at full resolution,
# padded and unfolded (2C x 2.25 a pixel, twice), then the 4x tail and
# the epilogue; beside them the attention chunk (models/hat.py: at most
# 512 windows of the dispatch at a time), whose OCAB logits, their
# softmax (f32) and its bf16 cast are 6 x 256 x 576 x 10 B = 8.85 MB a
# window. Measured on an H100 with ``max_memory_allocated``
# (chip_smoke.py phase models, bf16): 2 frames of 960x540 (1,036,800
# pixels, 4080 windows: a full chunk of 512) 9.99 GB; 4 tiles of 160
# (128 and the 16-pixel halo: 102,400 pixels, 400 windows) 4.00 GB, 72 MB
# of it the stitched output. Both readings give 5,473 B a pixel and 8.42
# MB a window; planned + 15%: 6300 B a pixel in bf16 (float32 twice
# that, not measured) and 9.7 MB a window.
_HAT_BYTES_PER_PX = {"bfloat16": 6300, "float32": 12600}
# The diffusion SR (DiffusionSR_x4: a 32/64/128-channel UNet at the x4
# output resolution), per input pixel (16 output pixels): at the full
# resolution the f32 copy of a 3x3 conv's input (up to 64 channels, the
# last level's concatenation) and its f32 output, the bf16 skip, the
# block's input and the norm's and SiLU's temporaries, and the f32 DDIM
# state (x, the noise, the condition, x0, eps). Measured on an H100 with
# ``max_memory_allocated`` (chip_smoke.py phase diffusion, bf16, 2 frames
# of 960x540 to 4K): 22.79 GB, 21,977 B an input pixel; + 15%: 25,300.
# float32 (its activations twice the bf16 ones, the conv copies the
# same) planned at 35,000, not measured.
_DIFFUSION_BYTES_PER_PX = {"bfloat16": 25300, "float32": 35000}
_HAT_WINDOW = 16
_HAT_CHUNK_WINDOWS = 512
_HAT_WINDOW_BYTES = 9_700_000
# The video SR window (VideoSuperResolution), per input pixel:
#   BasicVSR: a frame's share (the two directions' 64-channel features,
#     their concatenation, the flows: ~560 B bf16) times the window, beside
#     SpyNet's level-0 maps for the window's pairs (~1.7 KB a pair) and the
#     4x tail of one frame (~6 KB);
#   TVSR: a frame's share (its 64-channel features, their copy and the
#     MLP's hidden map: ~1.5 KB bf16) times the window, the 4x tail of one
#     frame (~8 KB), and a chunk's f32 logits (256 windows x 4 heads x
#     (T 64)^2, a fixed 1.7 GB at T = 10, counted per pixel at 540p: 3.3 KB).
# float32 doubles them. Measured on an H100 (chip_smoke.py phase models,
# bf16, a window of 10 frames of 960x544): BasicVSR 5.17 GB (planned
# 10.91), TVSR 8.63 GB (planned 13.73). Keyed by the registry's family.
_VSR_BYTES_PER_PX = {"basicvsr": (560, 1700, 6000), "tvsr": (1500, 0, 11300)}


# The face restorer, beside the SR batch (f32, one crop at a time):
#   gfpgan: GFPGANv1.4's 177.6 M f32 parameters (710 MB) and one 512x512
#     crop's activations (the encoder's 64-channel 512x512 maps, the U-Net
#     skips and SFT conditions of every level, a 128-channel 512x512
#     upsampled decoder input and its modulated conv); measured on an
#     H100 with ``max_memory_allocated`` (chip_smoke.py phase archive):
#     715 MB a crop, 1.43 GB with the weights: 1.6e9 planned;
#   codeformer: CodeFormerConfig()'s 94 M f32 parameters (376 MB) and one
#     512x512 crop's activations (the encoder's and the generator's
#     64-channel 512x512 maps through GroupNorm and swish, ~6 of 64 MB,
#     and the skips at 32-256): ~0.9 GB, 1.2e9 planned until measured;
#   sr: realesr-general-x4v3 (1.2 M parameters) on a 128x128 crop to
#     512x512: 0.1e9;
# RetinaFace (when its weights are there) on a whole output frame padded
# to multiples of 32: the f32 frame and its BGR copy (24 B/px) and the
# backbone's first stages at 1/2 (8, then 16 channels); measured 501 MB
# on a 4K frame (60 B a pixel): 70 planned.
_FACE_MODEL_BYTES = {"gfpgan": 1_600_000_000, "codeformer": 1_200_000_000,
                     "sr": 100_000_000}
_RETINAFACE_BYTES_PER_PX = 70
# Frame interpolation (IFNet at IFNetConfig(), f32), per pixel of one
# pair at the frame size padded to multiples of 32: the two frames and
# the time map, the flow, mask and warps (17 channels), a level's
# 12-channel input and its resize, the block's output and its resize
# (6 + 6), the warp's grids, then the blend, and the full-resolution
# block's half- and quarter-resolution maps; measured on an H100 with
# ``max_memory_allocated`` (chip_smoke.py phase archive, a step of four
# 4K pairs): 368 B: 410 planned.
_IFNET_BYTES_PER_PX = 410

# Candidate tile interiors (JAX's, divisible by 4 for pixel_unshuffle at
# scale 1-2) and tile batches.
_TILE_CANDIDATES = (1024, 768, 512, 384, 256, 192, 128, 96, 64)
_TILE_BATCHES = (64, 32, 16, 8, 4, 2, 1)
# A tiled dispatch outside the model, per output pixel: of each of its
# frames, the windows' bf16 RGB outputs with their halos (~7 at a 256
# tile) and the stitched bf16 image (6): 13 -> 14; of the one frame in its
# epilogue at a time, its f32 clamped copy (12) and the epilogue's f32
# temporaries (Y, U, V and two differences: 20): 32 -> 36.
_TILED_HELD_BYTES_PER_OUT_PX = 14
_TILED_EPILOGUE_BYTES_PER_OUT_PX = 36


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class Plan:
    height: int
    width: int
    scale: int
    batch: int            # whole frames a device step, or tiles when tiled
    body_divisor: int     # input-res -> body-res factor
    est_bytes: int        # estimated peak device bytes at this batch
    tile_size: int = 0    # 0 = whole frames, else the tile's interior edge
    overlap: int = 0      # halo pixels each side (input resolution)
    frame_batch: int = 0  # frames a dispatch of a tiled plan
    px_bytes: int = 0     # the model's planned peak bytes per body pixel
    stats_bytes: int = 0  # the quality gate's stats of one frame (tiled)
    window_bytes: int = 0  # HAT's attention chunk a window (0: a kernel path)

    @property
    def tiled(self) -> bool:
        return self.tile_size > 0

    @property
    def grid(self) -> Tuple[int, int]:
        if not self.tiled:
            return (1, 1)
        ts = self.tile_size
        return (-(-self.height // ts), -(-self.width // ts))

    @property
    def tiles_per_frame(self) -> int:
        g = self.grid
        return g[0] * g[1]

    @property
    def frames(self) -> int:
        """Frames a dispatch of this plan holds."""
        return self.frame_batch if self.tiled else self.batch

    def chunk_bytes(self, batch: int) -> int:
        """HAT's attention chunk on ``batch`` frames (or tiles): its
        windows, at most ``_HAT_CHUNK_WINDOWS``, times ``window_bytes``."""
        if not self.window_bytes:
            return 0
        h, w = ((self.tile_extent(),) * 2 if self.tiled else (self.height, self.width))
        windows = batch * -(-h // _HAT_WINDOW) * -(-w // _HAT_WINDOW)
        return min(_HAT_CHUNK_WINDOWS, windows) * self.window_bytes

    def tile_extent(self) -> int:
        """A tile's padded edge: the interior and its halo on each side,
        aligned to the body divisor."""
        return _ceil_to(self.tile_size + 2 * self.overlap, self.body_divisor)

    def with_batch(self, batch: int) -> "Plan":
        """This plan at ``batch`` frames (or tiles) a step, with its
        planned peak bytes."""
        if self.tiled:
            return _with_tiled_est(replace(self, batch=batch))
        per_frame = (self.est_bytes - self.chunk_bytes(self.batch)) // self.batch
        return replace(self, batch=batch, est_bytes=per_frame * batch + self.chunk_bytes(batch))

    def downshift(self) -> "Plan":
        """The next-smaller plan after a device OOM: halve the batch, then
        tile a whole frame, then shrink the tiles (JAX's order)."""
        if self.batch > 1:
            return self.with_batch(max(1, self.batch // 2))
        if not self.tiled:
            ts = min(_TILE_CANDIDATES[0], _round8(max(self.height, self.width) // 2))
            return _with_tiled_est(replace(self, tile_size=max(64, ts), frame_batch=1))
        smaller = [t for t in _TILE_CANDIDATES if t < self.tile_size]
        if not smaller:
            raise HBMError(f"Cannot shrink below tile_size={self.tile_size}; frame "
                           f"{self.width}x{self.height} does not fit the device")
        return _with_tiled_est(replace(self, tile_size=smaller[0]))


def _round8(x: int) -> int:
    return max(8, (x // 8) * 8)


def _with_tiled_est(p: Plan) -> Plan:
    """``p`` with its planned peak bytes: its batch of tiles through the
    model (and HAT's attention chunk), its frames' stitched outputs, and
    one frame's epilogue and stats."""
    tile_px = (p.tile_extent() // p.body_divisor) ** 2
    out_px = p.height * p.width * p.scale ** 2
    return replace(p, est_bytes=p.batch * tile_px * p.px_bytes + p.chunk_bytes(p.batch)
                   + out_px * (p.frames * _TILED_HELD_BYTES_PER_OUT_PX
                               + _TILED_EPILOGUE_BYTES_PER_OUT_PX) + p.stats_bytes)


def body_divisor(family: str, scale: int) -> int:
    """RRDB runs its body at out_res / 4 through pixel_unshuffle."""
    if family == "rrdb":
        return {4: 1, 2: 2, 1: 4}.get(scale, 1)
    return 1


def peak_bytes_per_body_px(family: str, scale: int, dtype: str = "bfloat16",
                           stats: bool = False) -> int:
    """Planned peak device bytes per body pixel for (family, dtype), with
    the quality gate's stats when ``stats``."""
    if family == "rrdb":
        peak = _RRDB_PEAK_BYTES_PER_BODY_PX[dtype]
        if stats:   # 16 output pixels per body pixel
            peak = max(peak, 16 * _STATS_BYTES_PER_OUT_PX["luma"] * 11 // 10)
        return peak
    if family in ("hat", "diffusion"):
        table = _HAT_BYTES_PER_PX if family == "hat" else _DIFFUSION_BYTES_PER_PX
        peak = table["float32" if dtype == "float32" else "bfloat16"]
        if stats:
            peak = max(peak, (12 + _STATS_BYTES_PER_OUT_PX["rgb"]) * scale ** 2 * 11 // 10)
        return peak
    if family == "srvgg":
        s2 = scale ** 2
        peak = max(_SRVGG_HEAD_BYTES, _SRVGG_CHAIN_BYTES[dtype], 640 + 24 * s2, 40 * s2)
        if stats:
            peak = max(peak, (12 + _STATS_BYTES_PER_OUT_PX["rgb"]) * s2)
        return peak * 11 // 10
    raise ValueError(f"no memory plan for model family {family!r}")


def frame_bytes(height: int, width: int, scale: int, family: str = "rrdb",
                dtype: str = "bfloat16", stats: bool = False) -> int:
    u = body_divisor(family, scale)
    return (-(-height // u) * -(-width // u)
            * peak_bytes_per_body_px(family, scale, dtype, stats))


def pre_sr_bytes(height: int, width: int, denoise: str | None = None,
                 temporal: str | None = None, radius: int = 3, raft_pairs: int = 0,
                 restormer=None, stages: Tuple[str, ...] = ()) -> int:
    """Planned peak device bytes of the pre-SR stream on (height, width)
    frames: the largest of its parts. ``denoise``: the denoiser's method
    (``auto`` plans for the largest it may pick) or None; ``temporal``:
    ``attention`` or ``ema`` (on the host: nothing), or None;
    ``raft_pairs``: pairs a step of RAFT alignment holds (0: IFNet);
    ``restormer``: the Restormer's config (its ``dim`` and
    ``ffn_expansion``; None: JAX's ``RestormerConfig()`` widths);
    ``stages``: the other card stages that run (``qp``, ``lama``,
    ``heat``, ``gapfill``, ``colorize`` and its net, ``ddcolor`` or
    ``eccv16``; LaMa's and the colorize net's weights stay on the card
    beside every part)."""
    t = _PRE_SR_BYTES_PER_PX
    per_px = 0
    if denoise in ("temporal", "nafnet", "restormer", "auto"):
        per_px = t["temporal_fixed"] + 2 * radius * t["temporal_slot"]
    if denoise == "restormer":
        per_px = max(per_px, restormer_bytes_per_px(
            *((restormer.dim, restormer.ffn_expansion) if restormer is not None else ())))
    if denoise in ("bilateral", "auto"):
        per_px = max(per_px, t["bilateral"])
    if temporal in ("attention", "latent"):
        per_px = max(per_px, t[temporal])
    for stage in stages:
        per_px = max(per_px, t[stage])
    flow = 0
    if raft_pairs and denoise in ("temporal", "nafnet", "restormer", "auto"):
        flow = raft_pairs * raft_pair_bytes(height, width)
    weights = sum(_PRE_SR_FIXED_BYTES.get(stage, 0) for stage in stages)
    return max(height * width * per_px, flow) + weights


def restormer_bytes_per_px(dim: int = 16, ffn_expansion: float = 2.66) -> int:
    """Planned peak card bytes a pixel of Restormer (f32) at ``dim``
    channels and ``ffn_expansion``."""
    c = 2 * dim
    return 4 * (2 * c + 6 * int(c * ffn_expansion) + 3) * 115 // 100


def budget_bytes(free_bytes: int | None, utilization: float) -> int:
    """``free_bytes * utilization`` (the CPU budget when None)."""
    return int((_CPU_BUDGET if free_bytes is None else free_bytes) * utilization)


def raft_pair_bytes(height: int, width: int) -> int:
    """Planned card bytes of RAFT on one pair of (height, width) frames:
    the correlation pyramid (quadratic in the pixels) and the encoders."""
    n8 = -(-height // 8) * -(-width // 8)
    return n8 * n8 * 4 * 85 // 64 + height * width * _RAFT_PX_BYTES


def raft_pairs(height: int, width: int, free_bytes: int | None = None,
               utilization: float = 0.85, max_pairs: int = 6) -> int:
    """Pairs a step of RAFT alignment may hold: as many as half of
    ``free_bytes * utilization`` (the CPU budget when None) fits, at most
    ``max_pairs``; ``HBMError`` when not one does."""
    budget = budget_bytes(free_bytes, utilization) // 2
    per_pair = raft_pair_bytes(height, width)
    pairs = min(max_pairs, budget // per_pair)
    if pairs < 1:
        raise HBMError(f"one {width}x{height} RAFT pair needs ~{per_pair / 2**30:.1f} GiB, "
                       f"{budget / 2**30:.1f} GiB available to the pre-SR stream")
    return pairs


def vsr_bytes(height: int, width: int, window: int, family: str = "basicvsr",
              dtype: str = "bfloat16", band_rows: int = 0, bands_here: int = 1) -> int:
    """Planned peak card bytes of one video SR window of ``window`` frames
    at (height, width) padded to multiples of 32, for the registry's
    ``family`` (``basicvsr`` or ``tvsr``). ``band_rows`` > 0 plans the
    first card of the spatial split: ``bands_here`` bands of ``band_rows``
    rows (their own and the halo) each holding its frames' share, one
    transient working set (SpyNet's pairs on the whole frames, one frame's
    tail or attention chunk: the unsplit count), and what is gathered
    whole there: the window's frames and its 4x output, and for BasicVSR
    the two directions' flows and one carry of 64 channels."""
    per_frame, per_pair, fixed = _VSR_BYTES_PER_PX[family]
    wp = -(-width // 32) * 32
    px = -(-height // 32) * 32 * wp
    f = 2 if dtype == "float32" else 1
    if band_rows <= 0:
        return px * (per_frame * window + max(per_pair * (window - 1), fixed)) * f
    gathered = 51 * window + (4 * (window - 1) + 64 if family == "basicvsr" else 0)
    return (bands_here * band_rows * wp * per_frame * window * f
            + px * (max(per_pair * (window - 1), fixed) * f + gathered * 2 * f))


def plan(height: int, width: int, scale: int, family: str = "rrdb",
         free_bytes: int | None = None, utilization: float = 0.85,
         max_batch: int = 16, dtype: str = "bfloat16", stats: bool = False,
         reserved_bytes: int = 0, tile_size_override: int = 0, overlap: int = 8,
         band_rows: int = 0, bands_here: int = 1) -> Plan:
    """Largest whole-frame batch <= ``max_batch`` that fits
    ``free_bytes * utilization`` (the CPU budget when ``free_bytes`` is
    None) less ``reserved_bytes`` (the pre-SR stream's) at the peak bytes
    of ``dtype``'s kernel path (with the quality gate's stats when
    ``stats``). When no whole frame fits, or ``tile_size_override`` pins
    a tile: tiles of ``overlap`` halo pixels, the largest candidate (or
    the pinned size) with the largest batch of at most 64 tiles (the
    diffusion SR: ``max_batch``, as JAX) that fits beside one frame's
    output, and as many frames a dispatch (at most ``max_batch``) as fit
    beside them.
    ``band_rows`` > 0 plans a device of the SR's frames x space split:
    ``bands_here`` bands of ``band_rows`` input rows (their own and the
    halo) a frame, which run in turn: one band's working set at the
    model's peak and what each band keeps meanwhile
    (``band_resident_bytes_per_body_px``), beside the whole frame's
    gathered output and stats; a tiled plan runs whole frames, without
    bands."""
    budget = budget_bytes(free_bytes, utilization) - reserved_bytes
    u = body_divisor(family, scale)
    px_bytes = peak_bytes_per_body_px(family, scale, dtype)
    window_bytes = _HAT_WINDOW_BYTES if family == "hat" else 0
    if tile_size_override <= 0:
        per_frame = frame_bytes(height, width, scale, family, dtype, stats)
        if band_rows > 0:
            stats_px = ((_STATS_BYTES_PER_OUT_PX["luma"] if family == "rrdb" else
                         12 + _STATS_BYTES_PER_OUT_PX["rgb"]) * 11 // 10 if stats else 0)
            band_px = -(-band_rows // u) * -(-width // u)
            per_frame = (frame_bytes(band_rows, width, scale, family, dtype)
                         + bands_here * band_px * band_resident_bytes_per_body_px(family, scale)
                         + height * width * scale ** 2
                         * (_GATHERED_BYTES_PER_OUT_PX + stats_px))
        whole = Plan(height, width, scale, 1, u, 0, overlap=overlap, px_bytes=px_bytes,
                     window_bytes=window_bytes)
        batch = min(max_batch, budget // per_frame)
        while batch >= 1 and batch * per_frame + whole.chunk_bytes(batch) > budget:
            batch -= 1
        if batch >= 1:
            return replace(whole, batch=batch,
                           est_bytes=batch * per_frame + whole.chunk_bytes(batch))
    out_px = height * width * scale ** 2
    # the gate's stats of one frame from its float RGB image (as SRVGG's)
    stats_bytes = out_px * (12 + _STATS_BYTES_PER_OUT_PX["rgb"]) * 11 // 10 if stats else 0
    sizes = ((tile_size_override,) if tile_size_override > 0 else
             tuple(t for t in _TILE_CANDIDATES if t <= max(height, width)))
    for ts in sizes:
        base = Plan(height, width, scale, 1, u, 0, tile_size=ts, overlap=overlap,
                    frame_batch=1, px_bytes=px_bytes, stats_bytes=stats_bytes,
                    window_bytes=window_bytes)
        for b in _TILE_BATCHES:
            if family == "diffusion" and b > max_batch:
                # its noise is drawn per chunk of tiles: JAX's cap, so a
                # tile's draw is JAX's
                continue
            p = _with_tiled_est(replace(base, batch=b))
            if p.est_bytes <= budget:
                frames = min(max_batch, 1 + (budget - p.est_bytes)
                             // (out_px * _TILED_HELD_BYTES_PER_OUT_PX))
                return _with_tiled_est(replace(p, frame_batch=frames))
    if tile_size_override > 0:
        # a pinned tile runs at batch 1 even when the estimate says no
        # (as JAX's planner); an out-of-memory then downshifts it
        return _with_tiled_est(base)
    raise HBMError(
        f"{width}x{height} x{scale} does not fit: no tile of {_TILE_CANDIDATES[-1]}-"
        f"{_TILE_CANDIDATES[0]} px at batch 1 fits {budget / 2**30:.2f} GiB")


def face_bytes(backend: str, out_h: int, out_w: int, retinaface: bool = False) -> int:
    """Planned card bytes of the face restorer on (out_h, out_w) frames:
    its model and one crop, and RetinaFace's whole-frame pass when
    ``retinaface``."""
    det = 0
    if retinaface:
        det = -(-out_h // 32) * 32 * -(-out_w // 32) * 32 * _RETINAFACE_BYTES_PER_PX
    return _FACE_MODEL_BYTES.get(backend, 0) + det


def interpolation_bytes(height: int, width: int, pairs: int = 1) -> int:
    """Planned card bytes of one interpolator step of ``pairs`` pairs."""
    return pairs * -(-height // 32) * 32 * -(-width // 32) * 32 * _IFNET_BYTES_PER_PX


def interpolation_pairs(height: int, width: int, free_bytes: int | None = None,
                        utilization: float = 0.85, max_pairs: int = 4) -> int:
    """Frame pairs a step of the interpolator fits in ``free_bytes *
    utilization`` (the CPU budget when None), at most ``max_pairs``."""
    budget = budget_bytes(free_bytes, utilization)
    per_pair = interpolation_bytes(height, width)
    pairs = min(max_pairs, budget // per_pair)
    if pairs < 1:
        raise HBMError(f"one {width}x{height} interpolation pair needs "
                       f"~{per_pair / 2**30:.1f} GiB, {budget / 2**30:.1f} GiB available")
    return pairs
