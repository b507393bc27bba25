"""Film-grain level: the port's copy of
``framewright_tpu.processors.film.estimate_grain_level`` (numpy), which
the long-form anchors record."""

from __future__ import annotations

import numpy as np


def estimate_grain_level(frame: np.ndarray) -> float:
    """High-frequency residual energy: std of the 4-neighbour Laplacian
    residual of the grey frame (wrapping at the borders) / 40, in 0-1."""
    g = frame.astype(np.float32).mean(axis=-1)
    blur = (np.roll(g, 1, 0) + np.roll(g, -1, 0) + np.roll(g, 1, 1)
            + np.roll(g, -1, 1)) / 4.0
    return float(np.clip((g - blur).std() / 40.0, 0.0, 1.0))
