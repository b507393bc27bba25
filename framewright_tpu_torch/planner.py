"""Batch planner for the card's free memory.

The port's counterpart of ``framewright_tpu.planner``: the body runs at
input resolution / ``body_divisor`` (pixel_unshuffle for RRDB at scale
2 and 1; SRVGG always at input resolution), and the batch is
the largest number of whole frames whose peak device memory fits the
free card memory times the utilization. The TPU-only caps of the JAX
planner (compiler limits, measured best batches on v5e) have no
counterpart here. Tiling is not ported yet: a frame that does not fit
at batch 1 raises ``HBMError``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

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
_CPU_BUDGET = 8 * 2**30   # what to plan for when running on the CPU


@dataclass(frozen=True)
class Plan:
    height: int
    width: int
    scale: int
    batch: int            # whole frames per device step
    body_divisor: int     # input-res -> body-res factor
    est_bytes: int        # estimated peak device bytes at this batch

    def downshift(self) -> "Plan":
        """The next-smaller plan after a device OOM: halve the batch."""
        if self.batch <= 1:
            raise HBMError(
                f"{self.width}x{self.height} x{self.scale} does not fit the "
                "device at batch 1 (tiling is not ported yet)")
        b = max(1, self.batch // 2)
        return replace(self, batch=b, est_bytes=self.est_bytes // self.batch * b)


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


def plan(height: int, width: int, scale: int, family: str = "rrdb",
         free_bytes: int | None = None, utilization: float = 0.85,
         max_batch: int = 16, dtype: str = "bfloat16", stats: bool = False) -> Plan:
    """Largest whole-frame batch <= ``max_batch`` that fits
    ``free_bytes * utilization`` (the CPU budget when ``free_bytes`` is
    None) at the peak bytes of ``dtype``'s kernel path (with the quality
    gate's stats when ``stats``)."""
    budget = int((_CPU_BUDGET if free_bytes is None else free_bytes) * utilization)
    per_frame = frame_bytes(height, width, scale, family, dtype, stats)
    batch = min(max_batch, budget // per_frame)
    if batch < 1:
        raise HBMError(
            f"{width}x{height} x{scale} needs ~{per_frame / 2**30:.1f} GiB per "
            f"frame, {budget / 2**30:.1f} GiB available (tiling is not ported yet)")
    return Plan(height, width, scale, batch, body_divisor(family, scale),
                batch * per_frame)
