"""Warmup for the restore's SR path (the port's ``framewright_tpu/warmup.py``).

JAX's warmup fills the persistent XLA compilation cache for a geometry.
The port compiles nothing per geometry: its kernels are one shared
library that ``nvcc`` builds at first use (``ops/_build.py``, into
``ops/_build/<hash>/``), and the host codec one ``g++`` library
(``native``). ``warmup_sr`` builds both and runs the restorer's own SR
processor (``restorer.build_sr``, the counterpart of JAX's
``build_sr_config``) on one batch of synthetic frames at each size, so a
restore of that geometry afterwards builds nothing and finds cuDNN's and
the allocator's state warm. The ``warmup`` verb calls it.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Sequence

import numpy as np

from framewright_tpu_torch.config import Config

logger = logging.getLogger(__name__)


def warmup_sr(height: int, width: int, config: Optional[Config] = None,
              output_color: str = "yuv420", batches: Optional[Sequence[int]] = None,
              progress=None) -> Dict:
    """Build the kernel library and the host codec, then run the SR
    processor a restore of (height, width) with ``config`` builds on one
    batch of each size in ``batches`` (default: the planner's batch, and 1
    when that differs). ``output_color`` is the writer's path (``yuv420``
    the straight-to-Y4M one, with the quality gate's stats when the config
    validates, as a restore runs it).

    -> {"cache_dir": the kernel build directory (None on the CPU, whose
    restore runs the kernels' plain versions), "plan_batch", "programs":
    [{"batch", "seconds"}]}."""
    from framewright_tpu_torch import native
    from framewright_tpu_torch.hw import resolve_device
    from framewright_tpu_torch.restorer import _device, build_sr

    cfg = config or Config()
    dev = resolve_device(_device(cfg))

    def say(msg: str) -> None:
        logger.info(msg)
        if progress is not None:
            progress(msg)

    cache = None
    if dev.type == "cuda":
        from framewright_tpu_torch.ops import _build

        t0 = time.perf_counter()
        cache = _build.build(verbose=False).path.parent
        _build.library()
        say(f"warmup: kernel library {cache} ({time.perf_counter() - t0:.1f}s)")
    native.get_lib()
    say(f"warmup: {cfg.sr_model} {cfg.compute_dtype} {width}x{height} on {dev}")
    sr = build_sr(cfg)
    sr.setup(height, width)
    try:
        if output_color and hasattr(sr, "set_output_color"):
            sr.set_output_color(output_color)
            if output_color == "yuv420" and cfg.validate_output:
                sr.enable_device_stats()
        plan = sr.plan
        plan_batch = plan.batch if plan is not None and not plan.tiled else 1
        if batches is None:
            batches = [plan_batch] + ([1] if plan_batch != 1 else [])
        rng = np.random.default_rng(0)
        programs = []
        for b in batches:
            x = rng.integers(0, 256, (b, height, width, 3), dtype=np.uint8)
            t0 = time.perf_counter()
            sr.materialize(sr.dispatch(x))
            dt = time.perf_counter() - t0
            programs.append({"batch": int(b), "seconds": round(dt, 3)})
            say(f"warmup: batch {b} ran in {dt:.2f}s")
    finally:
        sr.teardown()
    return {"cache_dir": str(cache) if cache is not None else None,
            "plan_batch": int(plan_batch), "programs": programs}
