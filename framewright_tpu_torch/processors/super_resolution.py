"""Super-resolution processor: the restore path's hot stage.

The port of ``framewright_tpu/processors/super_resolution.py`` for the
RRDB family (RealESRGAN_x2plus, x4plus, FW_fast6_x2, ...) and the SRVGG
family (realesr-animevideov3, realesr-general-x4v3, FW_fastvgg_x2/x4)
in bf16 and int8: weights from the registry (every master rounded to
bf16 once, as the JAX processor loads them), a whole-frame batch from
the planner, and the model's kernel path (``apply_fast``, the JAX
processor's ``use_fused_kernel=True`` path) with the uint8 RGB or
YUV420 output epilogue (fused into the tail kernel for RRDB, applied
after the tail for tail1 and SRVGG, as the JAX package does in XLA).

int8 (``compute_dtype="int8"``), static scales (``int8_scales=
"static"``, the default): ``setup`` builds no int8 weights; the first
``dispatch`` calibrates the activation ranges on a centre crop of its
first frame (``_calibrate_int8``) and quantizes the body or the conv
chain once; later batches reuse those weights. Dynamic scales
(``int8_scales="dynamic"``, RRDB): ``setup`` quantizes the body's
weights once and nothing is calibrated; the kernels take each frame's
activation ranges, and the path runs tail1 (``RRDBNet.apply_fast``).
For SRVGG ``int8_scales`` is ignored, as in the JAX processor.

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
from framewright_tpu_torch.hw import device_info, resolve_device

logger = logging.getLogger(__name__)

_OUT_COLORS = ("rgb", "yuv420")
_DTYPES = ("bfloat16", "int8")
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


def _pad_mod(x: torch.Tensor, bottom: int, right: int) -> torch.Tensor:
    """Bottom/right alignment padding of NHWC x, reflect mode (edge when
    the pad exceeds the reflectable extent), as ``tiling.pad_mod``."""
    h, w = x.shape[1], x.shape[2]
    mode = "reflect" if bottom < h and right < w else "replicate"
    y = F.pad(x.permute(0, 3, 1, 2).float(), (0, right, 0, bottom), mode=mode)
    return y.to(x.dtype).permute(0, 2, 3, 1)


class SuperResolution:
    name = "super_resolution"

    def __init__(self, config: Optional[SRConfig] = None):
        self.config = config or SRConfig()
        self.model = None
        self.device: Optional[torch.device] = None
        self.scale = 0
        self.weights_source = ""
        self.dispatches = 0
        self._plan: Optional[planner_mod.Plan] = None
        self._int8_calibrate = False

    def setup(self, height: int, width: int) -> None:
        from framewright_tpu_torch.models.registry import bf16_masters, get_model, load_weights
        from framewright_tpu_torch.models.rrdb import RRDBNet
        from framewright_tpu_torch.models.srvgg import SRVGGNet

        cfg = self.config
        if cfg.compute_dtype not in _DTYPES:
            raise ConfigError(f"compute_dtype must be one of {_DTYPES} (float32 "
                              "is not ported yet: ROADMAP.md A1)")
        int8 = cfg.compute_dtype == "int8"
        family = get_model(cfg.model_name).family
        if int8 and family == "rrdb" and cfg.int8_scales not in _INT8_SCALES:
            raise ConfigError(f"int8_scales must be one of {_INT8_SCALES}, "
                              f"got {cfg.int8_scales!r}")
        dynamic = int8 and family == "rrdb" and cfg.int8_scales == "dynamic"
        self.device = resolve_device(cfg.device)
        # every master weight and bias rounded to bf16 once, in f32
        # storage, as the JAX processor loads them in bf16 and int8 mode;
        # the kernel layouts and the int8 scales derive from these values
        spec, sd, self.weights_source = load_weights(
            cfg.model_name, cfg.weights_dir, dtype=torch.float32)
        self.scale = spec.scale
        net = SRVGGNet if family == "srvgg" else RRDBNet
        self.model = net.from_state_dict(spec.arch_config, bf16_masters(sd), self.device)
        if dynamic:
            self.model.fast_weights_int8(None)
        elif int8:
            # static scales need activation ranges: calibrated on the
            # first batch (dispatch), then the body is quantized once
            self._int8_calibrate = True
        else:
            self.model.fast_weights()
        info = device_info(self.device)
        self._plan = planner_mod.plan(
            height, width, spec.scale, spec.family, free_bytes=info.free_bytes,
            utilization=cfg.hbm_utilization,
            max_batch=cfg.batch_size or _DEFAULT_MAX_BATCH,
            dtype="int8-dynamic" if dynamic else cfg.compute_dtype)
        logger.info("SR %s (%s) on %s (%s): %s", cfg.model_name,
                    self.weights_source, self.device, info.name, self._plan)

    def set_output_color(self, color: str) -> None:
        if color not in _OUT_COLORS:
            raise ConfigError(f"output_color must be one of {_OUT_COLORS}")
        self.config.output_color = color

    @property
    def plan(self) -> Optional[planner_mod.Plan]:
        return self._plan

    def _run(self, x_u8: torch.Tensor):
        """uint8 (B, H, W, 3) on the device -> uint8 RGB or YUV planes."""
        plan = self._plan
        b, h, w, _ = x_u8.shape
        u, s = plan.body_divisor, plan.scale
        x = x_u8.to(torch.bfloat16) / 255.0
        hp, wp = -(-h // u) * u, -(-w // u) * u
        if (hp, wp) != (h, w):
            x = _pad_mod(x, hp - h, wp - w)
        yuv = self.config.output_color == "yuv420"
        mode = "yuv420_u8" if yuv else "rgb_u8"
        nb = max(plan.batch, 1)
        chunks = [self.model.apply_fast(x[i:i + nb].contiguous(), mode,
                                        self.config.yuv_full_range)
                  for i in range(0, b, nb)]
        if yuv:
            yp, up, vp = (torch.cat([c[k] for c in chunks]) for k in range(3))
            return (yp[:, :h * s, :w * s], up[:, :h * s // 2, :w * s // 2],
                    vp[:, :h * s // 2, :w * s // 2])
        return torch.cat(chunks)[:, :h * s, :w * s]

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
        out, exc, event = None, None, None
        try:
            out = self._run(xt)
        except torch.cuda.OutOfMemoryError as e:   # surfaced at materialize
            exc = e
        if out is not None and self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return {"out": out, "event": event, "exc": exc, "x": x, "n": len(x)}

    def materialize(self, handle: dict):
        """Wait for a dispatched batch and copy it to the host: uint8 RGB
        (B, sH, sW, 3), or a tuple of Y, U, V planes."""
        attempt = 0
        while True:
            try:
                if handle["exc"] is not None:
                    raise handle["exc"]
                if handle["event"] is not None:
                    handle["event"].synchronize()
                out = handle["out"]
                if isinstance(out, tuple):
                    return tuple(p.cpu().numpy() for p in out)
                return out.cpu().numpy()
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
