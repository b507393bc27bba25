"""Batch planner for the card's free memory.

The port's counterpart of ``framewright_tpu.planner``: the body runs at
input resolution / ``body_divisor`` (pixel_unshuffle), and the batch is
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
# path, with 10% headroom:
#   bfloat16: three 192-channel bf16 RDB workspaces (1152), the head
#     output and K1's output (128 each), and the tail's intermediates at
#     2x and 4x the body resolution (512 + 2 x 2048): 6016 -> 6800
#   int8: three 64-channel bf16 carries (384) and one 192-channel int8
#     code workspace (192) in place of the workspaces, the rest as
#     bfloat16: 5440 -> 6000
_PEAK_BYTES_PER_BODY_PX = {"bfloat16": 6800, "int8": 6000}
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


def frame_bytes(height: int, width: int, scale: int, family: str = "rrdb",
                dtype: str = "bfloat16") -> int:
    u = body_divisor(family, scale)
    return -(-height // u) * -(-width // u) * _PEAK_BYTES_PER_BODY_PX[dtype]


def plan(height: int, width: int, scale: int, family: str = "rrdb",
         free_bytes: int | None = None, utilization: float = 0.85,
         max_batch: int = 16, dtype: str = "bfloat16") -> Plan:
    """Largest whole-frame batch <= ``max_batch`` that fits
    ``free_bytes * utilization`` (the CPU budget when ``free_bytes`` is
    None) at the peak bytes of ``dtype``'s kernel path."""
    budget = int((_CPU_BUDGET if free_bytes is None else free_bytes) * utilization)
    per_frame = frame_bytes(height, width, scale, family, dtype)
    batch = min(max_batch, budget // per_frame)
    if batch < 1:
        raise HBMError(
            f"{width}x{height} x{scale} needs ~{per_frame / 2**30:.1f} GiB per "
            f"frame, {budget / 2**30:.1f} GiB available (tiling is not ported yet)")
    return Plan(height, width, scale, batch, body_divisor(family, scale),
                batch * per_frame)
