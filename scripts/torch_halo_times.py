"""Times the halo refresh (``ops/csrc/halo.cu``, PERF.md row 8) at the
resident body's main-path shape (60 blocks of 112x112, 192 channels, the
1080p x2plus body) on the card:

    python3 scripts/torch_halo_times.py [--after-engine]

prints one JSON line: the kernel's ms by CUDA events over 10 launches
after 2 warm-up (as ``chip_smoke.py`` phase 6 times it) and over 1,000
launches, and the host's issue time per launch (the wrapper's ctypes
call, no synchronisation). ``--after-engine`` first runs
``chip_smoke.engine_phase`` through ``scripts/torch_engine_phase.py``
in this process, as the smoke does before its phase 6. A kernel time
that grows from 10 to 1,000 launches' mean, or that tracks the issue
time, is bound by the host's launch rate, not by the kernel.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_halo_times: no CUDA device", file=sys.stderr)
        return 2
    argv = sys.argv[1:] if argv is None else argv
    if "--after-engine" in argv:
        import torch_engine_phase

        if torch_engine_phase.main() != 0:
            return 1
    import chip_smoke as cs
    from framewright_tpu_torch.ops import _build, fused_rrdb

    _build.build(verbose=False)
    dev = torch.device("cuda", 0)
    b, h, w = 1, 540, 960
    bh, bw = fused_rrdb.grid_dims(h, w)
    nb = b * bh * bw
    s = fused_rrdb.S
    ws = torch.randn(nb, s, s, 192, device=dev).to(torch.bfloat16)

    def launch():
        fused_rrdb.halo_refresh(ws, b, bh, bw)

    ms10 = cs.cuda_ms(launch, 10)
    ms1000 = cs.cuda_ms(launch, 1000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        launch()
    issue_us = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    print(json.dumps({"name": "halo_refresh", "shape": list(ws.shape),
                      "after_engine": "--after-engine" in argv, "ms_10": ms10,
                      "ms_1000": ms1000, "host_issue_us_per_launch": issue_us,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
