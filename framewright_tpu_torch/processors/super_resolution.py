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
synchronising; ``materialize`` waits on the batch's CUDA event and
copies to the host. The restorer dispatches batch N+1 before it
materializes batch N, so the card computes while the host writes. A
device out-of-memory (``torch.cuda.OutOfMemoryError``) halves the batch
and reruns, down to batch 1.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch import planner as planner_mod
from framewright_tpu_torch.errors import ConfigError, HBMError, InputError
from framewright_tpu_torch.hw import device_info, full_f32, resolve_device
from framewright_tpu_torch.models.layers import out_epilogue, resize_bicubic
from framewright_tpu_torch.ops.metrics import psnr_per_frame, ssim_per_frame

logger = logging.getLogger(__name__)

_OUT_COLORS = ("rgb", "yuv420")
_DTYPES = ("bfloat16", "float32", "int8")
_INT8_SCALES = ("static", "dynamic")
# Frames per dispatch when the caller sets none: the batch chip_smoke.py
# runs the restore at on the card; larger batches are not measured yet.
_DEFAULT_MAX_BATCH = 4
_MAX_OOM_RETRIES = 3


@dataclass
class SRConfig:
    model_name: str = "RealESRGAN_x2plus"
    compute_dtype: str = "bfloat16"
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


def _pad_mod(x: torch.Tensor, bottom: int, right: int) -> torch.Tensor:
    """Bottom/right alignment padding of NHWC x, reflect mode (edge when
    the pad exceeds the reflectable extent), as ``tiling.pad_mod``."""
    h, w = x.shape[1], x.shape[2]
    mode = "reflect" if bottom < h and right < w else "replicate"
    y = F.pad(x.permute(0, 3, 1, 2).float(), (0, right, 0, bottom), mode=mode)
    return y.to(x.dtype).permute(0, 2, 3, 1)


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


class SuperResolution:
    name = "super_resolution"

    def __init__(self, config: Optional[SRConfig] = None):
        self.config = config or SRConfig()
        self.model = None
        self.device: Optional[torch.device] = None
        self.scale = 0
        self.family = ""
        self.weights_source = ""
        self.dispatches = 0
        self._plan: Optional[planner_mod.Plan] = None
        self._plan_args: Optional[dict] = None
        self._int8_calibrate = False

    def setup(self, height: int, width: int) -> None:
        from framewright_tpu_torch.models.registry import bf16_masters, get_model, load_weights
        from framewright_tpu_torch.models.rrdb import RRDBNet
        from framewright_tpu_torch.models.srvgg import SRVGGNet

        cfg = self.config
        if cfg.compute_dtype not in _DTYPES:
            raise ConfigError(f"compute_dtype must be one of {_DTYPES}")
        int8 = cfg.compute_dtype == "int8"
        self.family = family = get_model(cfg.model_name).family
        if int8 and family == "rrdb" and cfg.int8_scales not in _INT8_SCALES:
            raise ConfigError(f"int8_scales must be one of {_INT8_SCALES}, "
                              f"got {cfg.int8_scales!r}")
        dynamic = int8 and family == "rrdb" and cfg.int8_scales == "dynamic"
        self.device = resolve_device(cfg.device)
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
        if dynamic:
            self.model.fast_weights_int8(None)
        elif int8:
            # static scales need activation ranges: calibrated on the
            # first batch (dispatch), then the body is quantized once
            self._int8_calibrate = True
        elif not self._plain_f32:
            self.model.fast_weights()
        self._plan_args = dict(
            height=height, width=width, scale=spec.scale, family=family,
            utilization=cfg.hbm_utilization,
            max_batch=cfg.batch_size or _DEFAULT_MAX_BATCH,
            dtype="int8-dynamic" if dynamic else cfg.compute_dtype)
        self._replan()

    def _replan(self) -> None:
        """The plan for the current free card memory and ``device_stats``."""
        info = device_info(self.device)
        self._plan = planner_mod.plan(free_bytes=info.free_bytes,
                                      stats=self.config.device_stats, **self._plan_args)
        logger.info("SR %s %s (%s) on %s (%s): %s", self.config.model_name,
                    self.config.compute_dtype, self.weights_source, self.device,
                    info.name, self._plan)

    @property
    def _plain_f32(self) -> bool:
        """SRVGG in float32 runs its plain f32 forward, as the JAX
        processor does; every other case runs the kernels."""
        return self.family == "srvgg" and self.config.compute_dtype == "float32"

    def set_output_color(self, color: str) -> None:
        if color not in _OUT_COLORS:
            raise ConfigError(f"output_color must be one of {_OUT_COLORS}")
        self.config.output_color = color

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

    def _run(self, x_u8: torch.Tensor):
        """uint8 (B, H, W, 3) on the device -> (uint8 RGB or YUV planes,
        (B, 5) f32 stats or None)."""
        cfg, plan = self.config, self._plan
        b, h, w, _ = x_u8.shape
        u, s = plan.body_divisor, plan.scale
        x = x_u8.to(torch.float32 if cfg.compute_dtype == "float32" else torch.bfloat16) / 255.0
        hp, wp = -(-h // u) * u, -(-w // u) * u
        xp = _pad_mod(x, hp - h, wp - w) if (hp, wp) != (h, w) else x
        yuv = cfg.output_color == "yuv420"
        mode = "yuv420_u8" if yuv else "rgb_u8"
        nb = max(plan.batch, 1)
        chunks, stats = [], []
        for i in range(0, b, nb):
            xc = xp[i:i + nb].contiguous()
            if self.family == "srvgg":
                # stats from the float RGB image before quantization
                img = self.model.apply(xc) if self._plain_f32 else self.model.apply_fast(xc, "f32")
                if cfg.device_stats:
                    stats += [_frame_stats(img[j:j + 1].float().clamp(0.0, 1.0), x[i + j:i + j + 1])
                              for j in range(len(img))]
                chunks.append(out_epilogue(img, mode, cfg.yuv_full_range))
                del img
            else:
                chunks.append(self.model.apply_fast(xc, mode, cfg.yuv_full_range,
                                                    f32_head=cfg.compute_dtype == "float32"))
        if yuv:
            yp, up, vp = (torch.cat([c[k] for c in chunks]) for k in range(3))
            out = (yp[:, :h * s, :w * s], up[:, :h * s // 2, :w * s // 2],
                   vp[:, :h * s // 2, :w * s // 2])
        else:
            out = torch.cat(chunks)[:, :h * s, :w * s]
        del chunks
        if cfg.device_stats and self.family == "rrdb":
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
        self.model.fast_weights_int8(amax)
        self._int8_calibrate = False
        logger.info("int8 static scales calibrated (margin %.2f, %s)",
                    self.config.int8_calib_margin,
                    getattr(self.model.int8_weights, "int8_scheme", "srvgg chain"))

    def dispatch(self, frames: np.ndarray) -> dict:
        """Enqueue a uint8 (B, H, W, 3) batch; return a handle for
        ``materialize``. Does not wait for the card."""
        if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8:
            raise InputError(f"{self.name}: expected uint8 (B, H, W, 3), got "
                             f"{frames.shape} {frames.dtype}")
        x = np.ascontiguousarray(frames)
        if self._int8_calibrate:
            self._calibrate_int8(x)
        self.dispatches += 1
        return self._enqueue(x)

    def _enqueue(self, x: np.ndarray) -> dict:
        """Run the model on ``x`` without waiting for the card. Counts
        nothing: an OOM retry reruns a batch that was dispatched once."""
        xt = torch.from_numpy(x).to(self.device)
        out, stats, exc, event = None, None, None, None
        try:
            with full_f32():
                out, stats = self._run(xt)
        except torch.cuda.OutOfMemoryError as e:   # surfaced at materialize
            exc = e
        if out is not None and self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return {"out": out, "stats": stats, "event": event, "exc": exc, "x": x,
                "n": len(x)}

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
                out = handle["out"]
                if isinstance(out, tuple):
                    out = tuple(p.cpu().numpy() for p in out)
                else:
                    out = out.cpu().numpy()
                if handle["stats"] is not None:
                    st = handle["stats"].cpu().numpy()
                    caller["stats_np"] = dict(zip(_STAT_KEYS, st.T))
                    caller["stats_np"]["finite"] = caller["stats_np"]["finite"] > 0.5
                return out
            except torch.cuda.OutOfMemoryError as exc:
                if attempt == _MAX_OOM_RETRIES:
                    raise HBMError(f"device OOM after {attempt} downshifts") from exc
                attempt += 1
                self._plan = self._plan.downshift()   # raises HBMError at batch 1
                logger.warning("device OOM; downshifted plan to %s", self._plan)
                frames = handle["x"]
                handle = None                          # drop the failed outputs
                torch.cuda.empty_cache()
                handle = self._enqueue(frames)

    def output_size(self, height: int, width: int):
        return height * self.scale, width * self.scale

    def teardown(self) -> None:
        self.model = None
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.empty_cache()
