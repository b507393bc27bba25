"""VHS repair and stabilization in the port (``processors/vhs.py``,
``processors/stabilization.py``: numpy on the host, as in JAX) held to
the JAX package: every output equal, byte for byte; the restore's VHS and
stabilizer stages resumed equal to a straight run."""

from __future__ import annotations

import numpy as np
import pytest

from framewright_tpu.processors import stabilization as jst
from framewright_tpu.processors import vhs as jvhs
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.processors import stabilization as pst
from framewright_tpu_torch.processors import vhs as pvhs

from conftest import make_gradient_frame


def vhs_clip(n: int = 9, h: int = 40, w: int = 56, seed: int = 0) -> list:
    """Frames with a tracking-line burst, dropout streaks and dot crawl."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        f = make_gradient_frame(h, w, t).astype(np.float32)
        if t == 4:
            f[10:13] = 255.0                               # tracking burst
        if t % 3 == 1:
            f[20, 5:30] = 250.0                            # dropout streak
        yy, xx = np.mgrid[0:h, 0:w]
        f += 6.0 * (((xx + yy) % 2) * 2 - 1)[..., None]    # dot crawl
        out.append(np.clip(f + rng.normal(0, 2, f.shape), 0, 255).astype(np.uint8))
    return out


def shaky_clip(n: int = 14, h: int = 48, w: int = 64, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    base = make_gradient_frame(h + 16, w + 16, 0)
    out = []
    for t in range(n):
        dy, dx = rng.integers(-3, 4, 2)
        out.append(base[8 + dy:8 + dy + h, 8 + dx:8 + dx + w].copy())
    return out


@pytest.mark.parametrize("flags", [
    {}, {"fix_tracking_lines": False}, {"fix_dropouts": False},
    {"reduce_chroma_bleed": False}, {"reduce_dot_crawl": False},
    {"tracking_threshold": 10.0}], ids=["all", "no-tracking", "no-dropouts",
                                        "no-chroma", "no-dot-crawl", "threshold-10"])
def test_vhs_stream_equals_jax(flags):
    clip = vhs_clip()
    got = list(pvhs.VHSProcessor(pvhs.VHSConfig(**flags)).process_stream(iter(clip)))
    want = list(jvhs.VHSProcessor(jvhs.VHSConfig(**flags)).process_stream(iter(clip)))
    assert len(got) == len(want) == len(clip)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_vhs_parts_equal_jax():
    clip = vhs_clip(5)
    p, j = pvhs.VHSProcessor(), jvhs.VHSProcessor()
    np.testing.assert_array_equal(p.detect_tracking_rows(clip, 4), j.detect_tracking_rows(clip, 4))
    for f in clip[:2]:
        np.testing.assert_array_equal(p.repair_dropouts(f), j.repair_dropouts(f))
        np.testing.assert_array_equal(p.reduce_chroma_bleed(f), j.reduce_chroma_bleed(f))
        np.testing.assert_array_equal(p.reduce_dot_crawl(f), j.reduce_dot_crawl(f))


@pytest.mark.parametrize("cfg", [
    dict(), dict(estimate_rotation=False), dict(smoothing=3, crop_ratio=1.0),
    dict(smoothing=2, crop_ratio=0.9, analysis_size=32)],
    ids=["default", "no-rotation", "radius-3-no-crop", "radius-2-small-analysis"])
def test_stabilizer_equals_jax(cfg):
    clip = shaky_clip()
    p, j = pst.VideoStabilizer(pst.StabilizeConfig(**cfg)), jst.VideoStabilizer(
        jst.StabilizeConfig(**cfg))
    got, want = list(p.process_stream(iter(clip))), list(j.process_stream(iter(clip)))
    assert len(got) == len(want) == len(clip)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert vars(p.result) == vars(j.result)


def test_stabilizer_cut_and_parts_equal_jax():
    clip = shaky_clip(8) + [np.full((48, 64, 3), 30, np.uint8)] + shaky_clip(6, seed=2)
    p, j = pst.VideoStabilizer(), jst.VideoStabilizer()
    got, want = list(p.process_stream(iter(clip))), list(j.process_stream(iter(clip)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert vars(p.result) == vars(j.result) and p.result.scene_cuts == 2
    a = pst._to_luma_small(clip[0], 32)
    b = pst._to_luma_small(clip[1], 32)
    assert pst.phase_correlate(a, b) == jst.phase_correlate(a, b)
    assert pst.estimate_motion(a, b) == jst.estimate_motion(a, b)
    np.testing.assert_array_equal(pst.warp_frame(clip[0], 1.3, -0.7, 0.02, 1.05),
                                  jst.warp_frame(clip[0], 1.3, -0.7, 0.02, 1.05))
    assert pst.jitter_metric(clip) == jst.jitter_metric(clip)


def test_config_validation():
    with pytest.raises(ConfigError, match="stabilize_crop"):
        Config(stabilize_crop=0.0)
    with pytest.raises(ConfigError, match="stabilize_smoothing"):
        Config(stabilize_smoothing=0)
    # gap filling runs since A10b-1, with JAX's detector ratio
    assert Config(fill_missing_frames=True).gap_jump_ratio == 1.8
    cfg = Config(vhs_restore=True, stabilize=True, stabilize_smoothing=5)
    assert cfg.vhs_fix_tracking and cfg.vhs_tracking_threshold == 30.0
    assert cfg.stabilize_crop == 0.95 and cfg.stabilize_rotation
