"""Super-resolution processor: the restore path's hot stage.

The port of ``framewright_tpu/processors/super_resolution.py`` for the
RRDB family (RealESRGAN_x2plus, x4plus, FW_fast6_x2, ...) and the SRVGG
family (realesr-animevideov3, realesr-general-x4v3, FW_fastvgg_x2/x4)
in bf16, float32 and int8: weights from the registry, a whole-frame
batch from the planner, and the model's path with the uint8 RGB or
YUV420 output epilogue (fused into the tail kernel for RRDB, applied
after the tail for tail1 and SRVGG, as the JAX package does in XLA).

bf16 and int8 round every master weight and bias to bf16 once, as the
JAX processor loads them. RRDB runs its kernel path (``apply_fast``, the
JAX processor's ``use_fused_kernel=True`` path); float32 keeps the f32
masters, runs the head in f32 on u8 / 255 in f32 and the body and tail
on the same bf16 kernels with weights cast from those masters. SRVGG
runs the chain kernels in bf16 and int8 and, in float32, its plain f32
forward (``SRVGGNet.apply``), as the JAX processor does (``use_fused``
is false for SRVGG there). Every f32 convolution and matrix product of
a batch runs in full f32 (``hw.full_f32``), whatever the caller set.

int8 (``compute_dtype="int8"``), static scales (``int8_scales=
"static"``, the default): ``setup`` builds no int8 weights; the first
``dispatch`` calibrates the activation ranges on a centre crop of its
first frame (``_calibrate_int8``) and quantizes the body or the conv
chain once; later batches reuse those weights. Dynamic scales
(``int8_scales="dynamic"``, RRDB): ``setup`` quantizes the body's
weights once and nothing is calibrated; the kernels take each frame's
activation ranges, and the path runs tail1 (``RRDBNet.apply_fast``).
For SRVGG ``int8_scales`` is ignored, as in the JAX processor.

Quality-gate stats (``device_stats``, ``enable_device_stats``): in the
same device pass, per frame, PSNR, SSIM, mean luma, std and a finiteness
flag of the output against the bicubic upscale of the input, returned by
``materialize`` as ``handle["stats_np"]``. RRDB's come from the
dequantized Y plane against the BT.601 luma of the reference (the JAX
processor's fused u8 path), SRVGG's from the float RGB image before
quantization (its plain path); one frame at a time, after the batch's
output is complete.

``dispatch`` enqueues a batch on the card and returns without
synchronising: the batch is copied into one of two pinned staging
buffers (``HostStaging``; before a buffer is refilled the host waits on
the event of the copy that last read it) and uploaded with
``non_blocking=True``, then the model runs and its output and stats are
copied back into a pinned output slot, also without blocking, on the same
stream. ``materialize`` waits on the batch's CUDA event, the one place
the host waits for the card, and copies the result out of the slot.
Pinned memory is allocated once and reused (``HostStaging``): allocating
it waits for the card. The restorer dispatches batch N+1 before it
materializes batch N, so the card computes while the host writes. On the
CPU the batch is used in place and nothing is staged. A device
out-of-memory (``torch.cuda.OutOfMemoryError``) downshifts the plan
(``planner.Plan.downshift``: halve the batch, then tiles, then smaller
tiles) and reruns the batch.

Tiling (``plan.tiled``: ``tile_size`` pins the tile, or the planner
tiles a frame that does not fit at batch 1, or a downshift does): JAX's
tiled branch (``framewright_tpu/processors/super_resolution.py:263-265,
365-430``). ``ops.tiling.tiled_apply`` runs the model on batches of
``plan.batch`` tiles with its float output (RRDB: ``apply_fast(x,
"bf16")``, the RDB, K1 and K2 in its bf16 mode on tiles; SRVGG: its chain
path in f32), then each stitched frame is clipped and scaled in f32, its
stats taken from the float RGB image, and quantized to uint8 RGB or
converted to the BT.601 4:2:0 planes (``layers.out_epilogue``), on the
card. The whole-frame path keeps its fused epilogue.

HAT (``HAT_SRx4``, the ``hat`` family) has no kernel: its forward
(``models.hat.apply``) runs in PyTorch at the compute dtype (bf16, int8
as bf16 as in JAX, or float32) over the JAX parameter tree, on whole
frames or the planner's tiles, its float output through the SRVGG-style
epilogue (stats from the float image). So does the diffusion SR
(``DiffusionSR_x4``, the ``diffusion`` family: ``models.diffusion_sr.apply``,
DDIM from ``PRNGKey(0)``'s noise at ``diffusion_steps`` steps); its noise
is drawn per dispatch chunk of ``plan.batch`` frames (or tiles), so a
frame's bytes depend on its position in that chunk, as in JAX, whose
``_chunked_map`` draws per chunk too; split over the cards
(``ShardedSR``), each member samples its frames from their rows of the
draw one card with the member's plan makes (``dispatch_noise``,
``dispatch(noise=...)``), after an OOM downshift too. ``enhancement_cap`` < 1 (the
restore's ``max_enhancement_strength``) takes the float path for every
family (RRDB: ``apply_fast(x, "bf16")``, no fused epilogue) and lerps the
output toward the bilinear upscale of the input in the output's dtype
(``base + cap * (y - base)``, JAX ``super_resolution.py:285-295``; JAX
resizes with ``method="linear"`` there, not bicubic) before the clip.
Several cards (JAX ``super_resolution.py:194-217``): the restore wraps
one processor a position of the mesh's frames axis in
``parallel.distributor.ShardedSR``, which splits each dispatch's frames
over them (``SRConfig.sharding``). Under ``"2d"`` each such processor
also holds the devices of its ``space`` axis (``space_devices``) and runs
every whole-frame batch of the RRDB and SRVGG families on row bands of
its frames, one a device (``parallel.bands``): RRDB through
``RRDBNet.apply_fast(bands=...)`` (the halo exchanged after the head
and each RDB), SRVGG through its forward on each band with ``srvgg.band_halo``
input rows of halo and no exchange. The bands' own rows are gathered on
the processor's device before the stats and the copy back, so both equal
the unsplit processor's. Its plan is its device's: the bands there (their
rows and halo) beside the whole frame's gathered output, epilogue and
stats (``planner.plan(band_rows=...)``); a plan that tiles runs whole
frames tiled, without bands.
``outscale`` (RealESRGANer's) resizes the uint8 RGB output bicubically
to round(input side x outscale) on the card (u8 / 255, ``resize_bicubic``,
clip and round half up again, as JAX's ``_resize``); it needs the RGB
output, so ``set_output_color("yuv420")`` refuses it, and the stats stay
those of the model's output. As in JAX, outscale alone keeps RRDB's
fused u8 epilogue (it resizes what the epilogue wrote).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from framewright_tpu_torch import planner as planner_mod
from framewright_tpu_torch.errors import ConfigError, HBMError, InputError, ShardingError
from framewright_tpu_torch.hw import device_info, full_f32, resolve_device
from framewright_tpu_torch.models.layers import (
    mul_weak,
    out_epilogue,
    resize_bicubic,
    resize_bilinear,
)
from framewright_tpu_torch.ops import tiling
from framewright_tpu_torch.ops.metrics import psnr_per_frame, ssim_per_frame
from framewright_tpu_torch.parallel.bands import Bands
from framewright_tpu_torch.parallel.mesh import device_current
from framewright_tpu_torch.processors.base import to_uint8

logger = logging.getLogger(__name__)

_OUT_COLORS = ("rgb", "yuv420")
_DTYPES = ("bfloat16", "float32", "int8")
_INT8_SCALES = ("static", "dynamic")
# Frames per dispatch when the caller sets none: the batch chip_smoke.py
# runs the restore at on the card; larger batches are not measured yet.
_DEFAULT_MAX_BATCH = 4
_MAX_OOM_RETRIES = 3

# The diffusion SR's noise source of a split dispatch's part (``ShardedSR``):
# (plan, device) -> the part's rows, on device, of the noise one card with
# that plan draws for the whole dispatch (``dispatch_noise``).
NoiseRows = Callable[[planner_mod.Plan, torch.device], torch.Tensor]


def dispatch_noise(plan: planner_mod.Plan, n: int, height: int, width: int,
                   device: torch.device):
    """The diffusion SR's noise for a dispatch of n frames of height x
    width under ``plan``, as one card draws it: ``PRNGKey(0)``'s normal for
    each chunk of the plan's ``batch`` rows, in order, a row a frame or,
    under a tiled plan, a window (frame by frame) -> (noise, rows a
    frame)."""
    from framewright_tpu_torch.ops import jax_random

    s = plan.scale
    geo = tiling.window_geometry(height, width, plan) if plan.tiled else None
    if geo is None:
        per, shape = 1, (height * s, width * s, 3)
    else:
        per, shape = len(geo[1]) * len(geo[2]), (geo[0] * s, geo[0] * s, 3)
    rows, chunk = n * per, max(plan.batch, 1)
    with device_current(device):
        noise = torch.cat([jax_random.normal(0, (min(chunk, rows - i),) + shape, device)
                           for i in range(0, rows, chunk)])
    return noise, per


@dataclass
class SRConfig:
    model_name: str = "RealESRGAN_x2plus"
    compute_dtype: str = "bfloat16"
    tile_size: int = 0                # 0 = planner decides
    tile_overlap: int = 0             # 0 = the family's receptive overlap
    batch_size: int = 0               # 0 = planner decides
    hbm_utilization: float = 0.85
    weights_dir: Optional[str] = None
    output_color: str = "rgb"         # rgb | yuv420 (planes from the tail kernel)
    yuv_full_range: bool = False      # BT.601 limited unless the writer says full
    device: str = "cuda"              # cuda | cpu
    int8_scales: str = "static"       # static: calibrated on the first batch;
                                      # dynamic: per frame, in the kernel (rrdb)
    int8_calib_margin: float = 1.25   # headroom over the observed ranges
    device_stats: bool = False        # per-frame PSNR/SSIM/luma/std/finite
                                      # against the bicubic upscale, in the
                                      # same device pass (the quality gate)
    reserved_bytes: int = 0           # card memory kept off the batch's plan
                                      # (the restorer's pre-SR stream)
    outscale: float = 0.0             # final bicubic resize; 0 = the model's scale
    enhancement_cap: float = 1.0      # < 1 lerps the output toward the bilinear
                                      # upscale on the card
    diffusion_steps: int = 0          # diffusion family: DDIM steps (0 = the arch's)
    sharding: str = "auto"            # auto | data | 2d | none: the split that
                                      # parallel.distributor.sharded_sr builds;
                                      # only it reads this: a SuperResolution
                                      # built directly runs on its one device


def _frame_stats(yf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The quality gate's signals of one frame: yf (1, H, W, C) f32 in
    [0, 1] (C = 1: luma, compared with the BT.601 luma of the reference;
    C = 3: RGB), x (1, h, w, 3) the model's input. The reference is
    ``resize_bicubic(x)``, not clipped; its luma is the resize of x's
    luma (both are linear: the same values, a third of the resize's
    work). -> (5,) f32: PSNR (dB), SSIM, mean luma and std on 0..255,
    1.0 if every value is finite else 0.0."""
    if yf.shape[-1] == 1:
        x = x.float()
        x = (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]
    ref = resize_bicubic(x, yf.shape[1:3])
    y255 = yf * 255.0
    return torch.stack([psnr_per_frame(yf, ref)[0], ssim_per_frame(yf, ref)[0],
                        y255.mean(), y255.std(correction=0),
                        torch.isfinite(yf).all().float()])


_STAT_KEYS = ("psnr", "ssim", "luma", "std", "finite")


def _pinned_empty(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, pin_memory=True)


class HostStaging:
    """Pinned host buffers, allocated once and reused: an allocation of
    page-locked memory waits for the card, which the upload and the copy
    back must not. Batches are uploaded from two buffers used in turn (one
    is refilled only after the copy that last read it has run, its event);
    results come back into an output slot that stays taken until
    ``release``, after the host has copied them out."""

    def __init__(self, slots: int = 2):
        self._bufs = [None] * slots
        self._events = [None] * slots
        self._next = 0
        self._out = []                # pinned output buffers
        self._out_free = []           # indices of the free ones

    @staticmethod
    def _fit(buf, nbytes: int):
        """``buf``, or a new pinned buffer when it holds fewer than
        ``nbytes`` (batches of unique frames vary in size: a buffer keeps
        the largest and lends each a view of its head)."""
        return buf if buf is not None and buf.shape[0] >= nbytes else \
            _pinned_empty((nbytes,), torch.uint8)

    def upload(self, x: np.ndarray, device: torch.device) -> torch.Tensor:
        k = self._next
        self._next = (k + 1) % len(self._bufs)
        if self._events[k] is not None:
            self._events[k].synchronize()
        buf = self._bufs[k] = self._fit(self._bufs[k], x.nbytes)
        view = buf.narrow(0, 0, x.nbytes).view(x.shape)
        view.numpy()[...] = x
        xt = view.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        self._events[k] = event
        return xt

    def download(self, tensors):
        """Copies of the device ``tensors`` into a free output slot,
        enqueued on the current stream (complete once the stream reaches
        them) -> (the slot, pinned views of the copies)."""
        sizes = [-(-t.numel() * t.element_size() // 64) * 64 for t in tensors]
        if not self._out_free:
            self._out.append(None)
            self._out_free.append(len(self._out) - 1)
        k = self._out_free.pop()
        buf = self._out[k] = self._fit(self._out[k], sum(sizes))
        views, off = [], 0
        for t, size in zip(tensors, sizes):
            v = buf.narrow(0, off, t.numel() * t.element_size()).view(t.dtype).view(t.shape)
            v.copy_(t, non_blocking=True)
            views.append(v)
            off += size
        return k, views

    def release(self, slot: int) -> None:
        self._out_free.append(slot)


def check_frames(name: str, frames: np.ndarray) -> np.ndarray:
    """A dispatch's uint8 (B, H, W, 3) batch, contiguous, or InputError."""
    if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8:
        raise InputError(f"{name}: expected uint8 (B, H, W, 3), got "
                         f"{frames.shape} {frames.dtype}")
    return np.ascontiguousarray(frames)


class SuperResolution:
    name = "super_resolution"

    def __init__(self, config: Optional[SRConfig] = None, space_devices=None):
        self.config = config or SRConfig()
        self.model = None
        self.space_devices = tuple(torch.device(d) for d in (space_devices or ()))
        self.bands = None                 # parallel.bands.Bands of a banded plan
        self._band_models: list = []      # the model on each band's device
        self.device: Optional[torch.device] = None
        self.scale = 0
        self.family = ""
        self.weights_source = ""
        self.dispatches = 0
        self._plan: Optional[planner_mod.Plan] = None
        self._plan_args: Optional[dict] = None
        self._int8_calibrate = False
        self._staging: Optional[HostStaging] = None
        self._noise: Optional[torch.Tensor] = None    # the diffusion SR's given noise
        self._noise_at = 0                            # rows of it used so far

    def setup(self, height: int, width: int) -> None:
        from framewright_tpu_torch.models.registry import (
            VSR_FAMILIES,
            bf16_masters,
            get_model,
            load_weights,
        )
        from framewright_tpu_torch.models.rrdb import RRDBNet
        from framewright_tpu_torch.models.srvgg import SRVGGNet

        cfg = self.config
        if cfg.compute_dtype not in _DTYPES:
            raise ConfigError(f"compute_dtype must be one of {_DTYPES}")
        if not 0.0 <= cfg.enhancement_cap <= 1.0:
            raise ConfigError("enhancement_cap must be in [0, 1]")
        int8 = cfg.compute_dtype == "int8"
        self.family = family = get_model(cfg.model_name).family
        if family in VSR_FAMILIES:
            raise ConfigError(f"{cfg.model_name} is a video SR model: "
                              "processors.video_sr.VideoSuperResolution runs it")
        if family in ("hat", "diffusion"):
            self._setup_tree(height, width)
            return
        if int8 and family == "rrdb" and cfg.int8_scales not in _INT8_SCALES:
            raise ConfigError(f"int8_scales must be one of {_INT8_SCALES}, "
                              f"got {cfg.int8_scales!r}")
        dynamic = int8 and family == "rrdb" and cfg.int8_scales == "dynamic"
        self.device = resolve_device(cfg.device)
        self._staging = HostStaging() if self.device.type == "cuda" else None
        # bf16 and int8: every master weight and bias rounded to bf16 once,
        # in f32 storage, as the JAX processor loads them; the kernel
        # layouts and the int8 scales derive from these values. float32
        # keeps the f32 masters.
        spec, sd, self.weights_source = load_weights(
            cfg.model_name, cfg.weights_dir, dtype=torch.float32)
        self.scale = spec.scale
        net = SRVGGNet if family == "srvgg" else RRDBNet
        masters = sd if cfg.compute_dtype == "float32" else bf16_masters(sd)
        self.model = net.from_state_dict(spec.arch_config, masters, self.device)
        self._band_models = [self.model if d == self.device else
                             net.from_state_dict(spec.arch_config, masters, d)
                             for d in self.space_devices]
        for m in self._models:
            if dynamic:
                m.fast_weights_int8(None)
            elif not int8 and not self._plain_f32:
                m.fast_weights()
        # static int8 scales need activation ranges: calibrated on the
        # first batch (dispatch), then the body is quantized once
        self._int8_calibrate = int8 and not dynamic
        self._plan_args = dict(
            height=height, width=width, scale=spec.scale, family=family,
            utilization=cfg.hbm_utilization,
            max_batch=cfg.batch_size or _DEFAULT_MAX_BATCH,
            dtype="int8-dynamic" if dynamic else cfg.compute_dtype,
            tile_size_override=cfg.tile_size,
            overlap=cfg.tile_overlap or tiling.receptive_overlap(family))
        if len(self.space_devices) > 1:
            self._setup_bands(height, spec)
        self._replan()
        if self.bands is not None and self._plan.tiled:
            # the bands do not fit whole: whole frames, tiled, without bands
            logger.info("SR 2d: bands of %d rows tile; whole frames run tiled", self.bands.rows)
            self.bands = None
            self._plan_args["band_rows"] = 0

    @property
    def _models(self) -> list:
        """The model and its copies on the other band devices, once each."""
        return list({id(m): m for m in [self.model, *self._band_models]}.values())

    def _setup_bands(self, height: int, spec) -> None:
        """The row bands of a frame over ``space_devices`` (RRDB: body rows
        with ``rrdb.BAND_HALO``; SRVGG: input rows with its
        ``band_halo``) and a plan for the bands on the processor's device
        (the most on one device) beside the whole frame's gathered
        output, epilogue and stats."""
        from framewright_tpu_torch.models import rrdb, srvgg
        from framewright_tpu_torch.ops.fused_rrdb import resident_requested

        if self.family == "rrdb":
            if resident_requested():
                raise ConfigError("the 2d split has no band path for FW_RDB_BODY=resident "
                                  "(a TPU memory workaround): use sharding data")
            u = planner_mod.body_divisor(self.family, spec.scale)
            self.bands = Bands.split(-(-height // u), self.space_devices, rrdb.BAND_HALO)
        else:
            u = 1
            self.bands = Bands.split(height, self.space_devices,
                                     srvgg.band_halo(spec.arch_config),
                                     align=1 if spec.scale % 2 == 0 else 2)
        self._plan_args.update(band_rows=self.bands.rows * u, bands_here=max(
            map(self.space_devices.count, self.space_devices)))
        logger.info("SR 2d: %d bands of rows %s (halo %d) on %s", len(self.bands),
                    list(self.bands.cuts), self.bands.halo, [str(d) for d in self.space_devices])

    def _setup_tree(self, height: int, width: int) -> None:
        """HAT and the diffusion SR: the JAX tree at the compute dtype (int8
        runs bf16, as the JAX processor does) and the planner's row for the
        family. The diffusion arch takes ``diffusion_steps`` as its
        ``steps`` when it is non-zero (JAX ``super_resolution.py:122-131``;
        JAX's ``propagate_t`` replacement is left out: only
        ``sample_video`` reads it, and no restore calls that)."""
        from framewright_tpu_torch.models.layers import tree_to_torch
        from framewright_tpu_torch.models.registry import TREE_MODULES, load_params

        cfg = self.config
        self.device = resolve_device(cfg.device)
        self._staging = HostStaging() if self.device.type == "cuda" else None
        spec, tree, self.weights_source = load_params(cfg.model_name, cfg.weights_dir)
        self.scale = spec.scale
        arch = spec.arch_config
        if self.family == "diffusion" and cfg.diffusion_steps:
            arch = dataclasses.replace(arch, steps=cfg.diffusion_steps)
        self.arch = arch
        dt = torch.float32 if cfg.compute_dtype == "float32" else torch.bfloat16
        self.model = functools.partial(TREE_MODULES[self.family].apply,
                                       tree_to_torch(tree, self.device, dt), cfg=arch)
        self._plan_args = dict(
            height=height, width=width, scale=spec.scale, family=self.family,
            utilization=cfg.hbm_utilization,
            max_batch=cfg.batch_size or _DEFAULT_MAX_BATCH,
            dtype="float32" if cfg.compute_dtype == "float32" else "bfloat16",
            tile_size_override=cfg.tile_size,
            overlap=cfg.tile_overlap or tiling.receptive_overlap(self.family))
        self._replan()

    def _replan(self) -> None:
        """The plan for the current free card memory and ``device_stats``."""
        info = device_info(self.device)
        self._plan = planner_mod.plan(free_bytes=info.free_bytes,
                                      stats=self.config.device_stats,
                                      reserved_bytes=self.config.reserved_bytes,
                                      **self._plan_args)
        logger.info("SR %s %s (%s) on %s (%s): %s", self.config.model_name,
                    self.config.compute_dtype, self.weights_source, self.device,
                    info.name, self._plan)

    @property
    def _plain_f32(self) -> bool:
        """SRVGG in float32 runs its plain f32 forward, as the JAX
        processor does; every other case runs the kernels."""
        return self.family == "srvgg" and self.config.compute_dtype == "float32"

    def set_output_color(self, color: str, full_range: Optional[bool] = None) -> None:
        """``rgb`` or ``yuv420`` output; ``full_range`` (when given) sets
        the YUV range (the writer's)."""
        if color not in _OUT_COLORS:
            raise ConfigError(f"output_color must be one of {_OUT_COLORS}")
        if color == "yuv420" and self._resizes:
            raise ConfigError("outscale resizes the RGB output: no YUV420 output")
        self.config.output_color = color
        if full_range is not None:
            self.config.yuv_full_range = full_range

    @property
    def _resizes(self) -> bool:
        """Whether ``outscale`` resizes the model's output."""
        return bool(self.config.outscale) and self.config.outscale != self.scale

    def enable_device_stats(self) -> None:
        """Compute the quality gate's per-frame stats in each batch's
        device pass (``handle["stats_np"]``); re-plans the batch for the
        stats' memory."""
        if self.config.device_stats:
            return
        self.config.device_stats = True
        if self._plan_args is not None:
            self._replan()

    @property
    def plan(self) -> Optional[planner_mod.Plan]:
        return self._plan

    def _frames_float(self, x: torch.Tensor) -> torch.Tensor:
        """``_model_float`` on whole frames: on row bands under a banded
        plan."""
        if self.bands is None:
            return self._model_float(x)
        if self.family == "rrdb":
            return self._rrdb_frames(x, "bf16")
        run = "apply" if self._plain_f32 else "apply_fast"
        bands = self.bands
        xs = bands.cut(x)
        outs = []
        for i, m in enumerate(self._band_models):
            with device_current(bands.devices[i]):
                outs.append(getattr(m, run)(xs[i]))
        return bands.gather(outs, self.scale, x.device)

    def _rrdb_frames(self, x: torch.Tensor, mode: str):
        """RRDB's kernel path on whole frames in ``mode``: on row bands
        under a banded plan."""
        f32_head = self.config.compute_dtype == "float32"
        return self.model.apply_fast(x, mode, self.config.yuv_full_range, f32_head=f32_head,
                                     bands=self.bands,
                                     replicas=self._band_models if self.bands is not None else None)

    def _model_float(self, x: torch.Tensor) -> torch.Tensor:
        """The model's float RGB output on x (N, h, w, 3) in [0, 1] (the
        JAX tiled branch's ``model_fn``): RRDB's kernel path with K2 in its
        bf16 mode, SRVGG's chain path in f32 (its plain f32 forward in
        float32)."""
        if self.family == "diffusion" and self._noise is not None:
            z = self._noise[self._noise_at:self._noise_at + len(x)]
            want = (len(x), x.shape[1] * self.scale, x.shape[2] * self.scale, 3)
            if tuple(z.shape) != want:
                raise ShardingError(f"the dispatch's noise rows {tuple(z.shape)} do not fit "
                                    f"this plan's chunk {want}")
            self._noise_at += len(x)
            return self.model(x, noise=z)
        if self.family in ("hat", "diffusion"):
            return self.model(x)
        if self.family == "srvgg":
            return self.model.apply(x) if self._plain_f32 else self.model.apply_fast(x, "f32")
        return self.model.apply_fast(x, "bf16",
                                     f32_head=self.config.compute_dtype == "float32")

    def _capped(self, img: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``enhancement_cap`` < 1: img lerped toward the bilinear upscale
        of its input x, in img's dtype."""
        cap = float(self.config.enhancement_cap)
        if cap >= 1.0:
            return img
        base = resize_bilinear(x.float(), img.shape[1:3]).to(img.dtype)
        return base + mul_weak(img - base, cap)

    def _run_tiled(self, x: torch.Tensor, mode: str):
        """The tiled branch on x (B, H, W, 3) in [0, 1] -> (per-frame
        epilogue outputs, per-frame stats)."""
        cfg = self.config
        img = self._capped(tiling.tiled_apply(self._model_float, x, self._plan), x)
        outs, stats = [], []
        for j in range(len(img)):
            if cfg.device_stats:
                stats.append(_frame_stats(img[j:j + 1].float().clamp(0.0, 1.0), x[j:j + 1]))
            outs.append(out_epilogue(img[j:j + 1], mode, cfg.yuv_full_range))
        return outs, stats

    def _run(self, x_u8: torch.Tensor):
        """uint8 (B, H, W, 3) on the device -> (uint8 RGB or YUV planes,
        (B, 5) f32 stats or None), resized by ``outscale``."""
        out, stats = self._run_model(x_u8)
        if self._resizes:
            oh = int(round(x_u8.shape[1] * self.config.outscale))
            ow = int(round(x_u8.shape[2] * self.config.outscale))
            out = to_uint8(resize_bicubic(out.float() / 255.0, (oh, ow)))
        return out, stats

    def _run_model(self, x_u8: torch.Tensor):
        cfg, plan = self.config, self._plan
        b, h, w, _ = x_u8.shape
        u, s = plan.body_divisor, plan.scale
        x = x_u8.to(torch.float32 if cfg.compute_dtype == "float32" else torch.bfloat16) / 255.0
        yuv = cfg.output_color == "yuv420"
        mode = "yuv420_u8" if yuv else "rgb_u8"
        if plan.tiled:
            chunks, stats = self._run_tiled(x, mode)
            if yuv:
                out = tuple(torch.cat([c[k] for c in chunks]) for k in range(3))
            else:
                out = torch.cat(chunks)
            return out, (torch.stack(stats) if stats else None)
        hp, wp = -(-h // u) * u, -(-w // u) * u
        xp = tiling.pad_mod(x, hp - h, wp - w)
        nb = max(plan.batch, 1)
        chunks, stats = [], []
        for i in range(0, b, nb):
            xc = xp[i:i + nb].contiguous()
            if self.family != "rrdb" or cfg.enhancement_cap < 1.0:
                # stats from the float RGB image before quantization
                img = self._capped(self._frames_float(xc)[:, :h * s, :w * s], x[i:i + nb])
                if cfg.device_stats:
                    stats += [_frame_stats(img[j:j + 1].float().clamp(0.0, 1.0), x[i + j:i + j + 1])
                              for j in range(len(img))]
                chunks.append(out_epilogue(img, mode, cfg.yuv_full_range))
                del img
            else:
                chunks.append(self._rrdb_frames(xc, mode))
        if yuv:
            yp, up, vp = (torch.cat([c[k] for c in chunks]) for k in range(3))
            out = (yp[:, :h * s, :w * s], up[:, :h * s // 2, :w * s // 2],
                   vp[:, :h * s // 2, :w * s // 2])
        else:
            out = torch.cat(chunks)[:, :h * s, :w * s]
        del chunks
        if cfg.device_stats and self.family == "rrdb" and cfg.enhancement_cap >= 1.0:
            # stats from the quantized output: the dequantized Y plane (luma
            # domain, PSNR-Y) on the YUV path, the uint8 RGB otherwise
            y0, yr = (0.0, 255.0) if cfg.yuv_full_range else (16.0, 219.0)
            for j in range(b):
                if yuv:
                    yf = ((out[0][j:j + 1].float() - y0) / yr).clamp_(0.0, 1.0)[..., None]
                else:
                    yf = out[j:j + 1].float() / 255.0
                stats.append(_frame_stats(yf, x[j:j + 1]))
        return out, (torch.stack(stats) if stats else None)

    def _calibrate_int8(self, x_u8: np.ndarray) -> None:
        """Static int8 scales from the first batch: one bf16 pass over a
        centre crop of its first frame (at most 256x256, sides a multiple
        of 8, u8 / 255 in f32, as the JAX processor takes it), then the
        RRDB body or the SRVGG chain is quantized once
        (``fast_weights_int8``)."""
        from framewright_tpu_torch.models import rrdb, srvgg

        calibrate_act_scales = (srvgg if isinstance(self.model, srvgg.SRVGGNet)
                                else rrdb).calibrate_act_scales
        _, h, w, _ = x_u8.shape
        ch, cw = min(h, 256) & ~7, min(w, 256) & ~7
        r0, c0 = (h - ch) // 2, (w - cw) // 2
        sample = torch.from_numpy(
            x_u8[:1, r0:r0 + ch, c0:c0 + cw].astype(np.float32) / 255.0)
        with full_f32():
            amax = calibrate_act_scales(self.model, sample,
                                        margin=self.config.int8_calib_margin)
        for m in self._models:
            m.fast_weights_int8(amax)
        self._int8_calibrate = False
        logger.info("int8 static scales calibrated (margin %.2f, %s)",
                    self.config.int8_calib_margin,
                    getattr(self.model.int8_weights, "int8_scheme", "srvgg chain"))

    def dispatch(self, frames: np.ndarray, noise: Optional[NoiseRows] = None) -> dict:
        """Enqueue a uint8 (B, H, W, 3) batch; return a handle for
        ``materialize``. Does not wait for the card. ``noise`` (the
        diffusion SR; ``ShardedSR`` passes it) gives these frames' rows of
        the one-card draw for this processor's plan, one row a frame or,
        under a tiled plan, a window, used in order in place of each
        chunk's own draw; an OOM retry asks it again for the downshifted
        plan."""
        x = check_frames(self.name, frames)
        if self._int8_calibrate:
            self._calibrate_int8(x)
        self.dispatches += 1
        return self._enqueue(x, noise)

    def _enqueue(self, x: np.ndarray, noise: Optional[NoiseRows] = None) -> dict:
        """Run the model on ``x`` and copy its result back, without
        waiting for the card. Counts nothing: an OOM retry reruns a batch
        that was dispatched once."""
        out, stats, exc, event = None, None, None, None
        self._noise_at = 0
        try:
            self._noise = None if noise is None else noise(self._plan, self.device)
            xt = (torch.from_numpy(x) if self._staging is None
                  else self._staging.upload(x, self.device))
            with full_f32():
                out, stats = self._run(xt)
        except torch.cuda.OutOfMemoryError as e:   # surfaced at materialize
            exc = e
        finally:
            self._noise = None
        slot = None
        if out is not None and self._staging is not None:
            # the copies back follow the model on the stream; the device
            # tensors may go now (the allocator orders their reuse after
            # the copies)
            parts = list(out) if isinstance(out, tuple) else [out]
            slot, host = self._staging.download(parts + ([] if stats is None else [stats]))
            out = tuple(host[:len(parts)]) if isinstance(out, tuple) else host[0]
            stats = None if stats is None else host[-1]
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return {"out": out, "stats": stats, "event": event, "slot": slot, "exc": exc,
                "x": x, "noise": noise, "n": len(x)}

    def materialize(self, handle: dict):
        """Wait for a dispatched batch and copy it to the host: uint8 RGB
        (B, sH, sW, 3), or a tuple of Y, U, V planes. With device stats,
        ``handle["stats_np"]`` then holds per-frame "psnr", "ssim",
        "luma", "std" (float32) and "finite" (bool) arrays."""
        caller = handle
        attempt = 0
        while True:
            try:
                if handle["exc"] is not None:
                    raise handle["exc"]
                if handle["event"] is not None:
                    handle["event"].synchronize()
                # on the host now; out of a staging slot into arrays of
                # their own, which the caller may keep
                copy = np.array if handle["slot"] is not None else np.asarray
                out = handle["out"]
                if isinstance(out, tuple):
                    out = tuple(copy(p.numpy()) for p in out)
                else:
                    out = copy(out.numpy())
                if handle["stats"] is not None:
                    st = copy(handle["stats"].numpy())
                    caller["stats_np"] = dict(zip(_STAT_KEYS, st.T))
                    caller["stats_np"]["finite"] = caller["stats_np"]["finite"] > 0.5
                if handle["slot"] is not None:
                    self._staging.release(handle["slot"])
                return out
            except torch.cuda.OutOfMemoryError as exc:
                if attempt == _MAX_OOM_RETRIES:
                    raise HBMError(f"device OOM after {attempt} downshifts") from exc
                attempt += 1
                self._plan = self._plan.downshift()   # raises HBMError at batch 1
                logger.warning("device OOM; downshifted plan to %s", self._plan)
                frames, noise = handle["x"], handle["noise"]
                handle = None                          # drop the failed outputs
                torch.cuda.empty_cache()
                handle = self._enqueue(frames, noise)

    def process_batch(self, frames: np.ndarray):
        """One batch through ``dispatch`` and ``materialize`` (JAX's
        ``process_batch``)."""
        return self.materialize(self.dispatch(frames))

    def output_size(self, height: int, width: int):
        if self.config.outscale:
            return (int(round(height * self.config.outscale)),
                    int(round(width * self.config.outscale)))
        return height * self.scale, width * self.scale

    def teardown(self) -> None:
        """Release the model and the staging buffers, after the card has
        finished every copy queued into them (a failed batch may leave one
        in flight)."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.model = None
        self._band_models = []
        self._staging = None
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.empty_cache()
