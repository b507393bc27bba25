#!/usr/bin/env python3
"""Write the alignment IFNet's weights for the PyTorch port.

    python3 scripts/export_align_ifnet.py [--out PATH]

The JAX temporal denoiser aligns its neighbours with an IFNet whose
weights it draws as ``ifnet.init(jax.random.PRNGKey(1), IFNetConfig(
channels=(96, 64), scales=(4, 2), num_res_convs=4))``
(framewright_tpu/processors/temporal_denoise.py:99-104). The port cannot
import JAX, so it reads these parameters from a data file: this script
runs the init on the CPU and writes them (float32, 608,864 parameters in
40 arrays) in the package's ``.npz`` layout (dotted keys, list indices),
by default to ``framewright_tpu_torch/models/weights/align_ifnet_key1.npz``.
``tests/test_torch_denoise.py`` re-derives them and holds the file to
them bit for bit.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
DEFAULT_OUT = ROOT / "framewright_tpu_torch" / "models" / "weights" / "align_ifnet_key1.npz"


def align_params():
    """The JAX denoiser's alignment IFNet parameters (numpy, float32)."""
    import jax
    import numpy as np

    from framewright_tpu.models import ifnet

    jax.config.update("jax_platforms", "cpu")
    arch = ifnet.IFNetConfig(channels=(96, 64), scales=(4, 2), num_res_convs=4)
    params = ifnet.init(jax.random.PRNGKey(1), arch)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from framewright_tpu.models.torch_port import export_npz

    params = align_params()
    export_npz(params, args.out)
    print(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
