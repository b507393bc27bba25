"""The models phase of chip_smoke.py alone on the card:

    python3 scripts/torch_models_phase.py

builds the kernels, then runs ``chip_smoke.models_phase`` with the launch
counters, the CLI runner and the kernel path as ``chip_smoke.main``
builds them; prints the phase's JSON lines, each peak against the
planner's count, and ``{"ok": ...}`` last (exit 1 when a check
failed)."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def harness():
    """Build the kernels -> (the card, the phases' ``x``: the launch
    counters' reset and read, the CLI runner, the seeded x2plus model, the
    kernel path and the plan checks), as ``chip_smoke.main`` builds them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from framewright_tpu_torch import cli
    from framewright_tpu_torch.models import rrdb
    from framewright_tpu_torch.models.registry import (
        MODEL_SPECS,
        bf16_masters,
        from_jax_params,
        init_params,
    )
    from framewright_tpu_torch.ops import (
        _build,
        fused_rrdb,
        fused_srvgg,
        fused_tail,
        fused_tail3,
        pallas_conv,
    )

    print(cs.nvidia_smi(), flush=True)
    shutil.rmtree(_build.BUILD_ROOT, ignore_errors=True)
    cs.emit({"phase": "build", "nvcc_seconds": _build.build(verbose=False).seconds})
    dev = torch.device("cuda", 0)
    spec = MODEL_SPECS["RealESRGAN_x2plus"]
    # the draw a restore takes from an empty weights dir: seed 0, bf16 masters
    model = rrdb.RRDBNet.from_state_dict(spec.arch_config, bf16_masters(
        from_jax_params(init_params(spec.arch_config, seed=0), torch.float32)), dev)
    counters = (fused_rrdb.fused_rdb, fused_rrdb.fused_rdb_i32, fused_rrdb.fused_rdb_f32acc,
                fused_rrdb.fused_rdb_dynamic, fused_tail3.conv_body_skip,
                fused_tail.fused_tail, fused_tail.fused_tail1, fused_rrdb.halo_refresh,
                pallas_conv.band_conv3x3, fused_srvgg.fused_conv_chain,
                fused_srvgg.fused_conv_chain_int8)

    def reset():
        for fn in counters:
            fn.launches = 0

    def read():
        return {fn.__name__: fn.launches for fn in counters}

    def cli_run(argv, env=None):
        buf = io.StringIO()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        return (rc, json.loads(buf.getvalue()) if rc == 0 else None,
                torch.cuda.max_memory_allocated() - base)

    def kernel_path(m, weights=None, dtype="bfloat16"):
        def run(xs):
            return m.apply_fast(xs.to(torch.bfloat16) / 255.0, "yuv420_u8", True,
                                weights=weights)
        return run

    return dev, {"cli_run": cli_run, "reset_counters": reset, "read_counters": read,
                 "model": model, "plan_checks": [], "kernel_path": kernel_path}


def main() -> int:
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print("torch_models_phase: no CUDA device", file=sys.stderr)
        return 2
    dev, x = harness()
    ok = True
    with tempfile.TemporaryDirectory(prefix="fw_models_") as tmp:
        tmp = Path(tmp)
        x["nw"] = str(tmp / "no_weights")
        try:
            cs.models_phase(tmp, dev, x)
        except cs.SmokeFailure as exc:
            ok = False
            print(f"torch_models_phase: FAILED: {exc}", file=sys.stderr)
        for key, peak, plan in x["plan_checks"]:
            cs.emit({"plan_check": key, "peak": peak, "plan": plan, "ok": peak <= plan})
            ok = ok and peak <= plan
    print(json.dumps({"ok": ok, "seconds": time.perf_counter() - t_all}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
