#!/usr/bin/env python3
"""Write the seeded IFNet draws of the JAX package for the PyTorch port.

    python3 scripts/export_align_ifnet.py [--only NAME ...] [--out-dir DIR]

The JAX package draws three IFNets at fixed keys and has no checkpoint
path for them:

- ``align_ifnet_key1``: ``ifnet.init(PRNGKey(1), IFNetConfig(channels=(96,
  64), scales=(4, 2), num_res_convs=4))``, the temporal denoiser's
  alignment flow (framewright_tpu/processors/temporal_denoise.py:99-104)
  and ``FlowEstimator``'s ``ifnet`` backend (processors/flow.py:85-87);
  608,864 parameters in 40 arrays;
- ``colorize_ifnet_key4``: ``PRNGKey(4)`` at channels (64, 48), scales (4,
  2), 3 res convs, colorize's propagation flow
  (processors/colorize.py:74-75);
- ``gapfill_ifnet_key5``: ``PRNGKey(5)`` at channels (96, 64), scales (4,
  2), 4 res convs, the gap filler's midpoint synthesis
  (processors/frame_generation.py:57-58).

The port cannot import JAX, so it reads these parameters from data files:
this script runs each init on the CPU and writes it (float32) in the
package's ``.npz`` layout (dotted keys, list indices) as
``framewright_tpu_torch/models/weights/<name>.npz``.
``tests/test_torch_denoise.py`` (key 1) and ``tests/test_torch_flow.py``
(keys 4 and 5) re-derive them and hold the files to them bit for bit.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT_DIR = ROOT / "framewright_tpu_torch" / "models" / "weights"

# name -> (PRNGKey, channels, scales, num_res_convs)
DRAWS = {
    "align_ifnet_key1": (1, (96, 64), (4, 2), 4),
    "colorize_ifnet_key4": (4, (64, 48), (4, 2), 3),
    "gapfill_ifnet_key5": (5, (96, 64), (4, 2), 4),
}


def draw_params(name: str):
    """The JAX package's IFNet draw ``name`` (numpy, float32)."""
    import jax
    import numpy as np

    from framewright_tpu.models import ifnet

    jax.config.update("jax_platforms", "cpu")
    key, channels, scales, convs = DRAWS[name]
    arch = ifnet.IFNetConfig(channels=channels, scales=scales, num_res_convs=convs)
    params = ifnet.init(jax.random.PRNGKey(key), arch)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=sorted(DRAWS), default=sorted(DRAWS))
    ap.add_argument("--out-dir", type=Path, default=OUT_DIR)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from framewright_tpu.models.torch_port import export_npz

    for name in args.only:
        out = args.out_dir / f"{name}.npz"
        export_npz(draw_params(name), out)
        print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
