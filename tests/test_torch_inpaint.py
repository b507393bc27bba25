"""Inpainting in the port (``models/lama.py``, ``processors/inpaint.py``)
held to the JAX package.

Tolerances: the golden ``tests/goldens/lama_tiny.npz`` within
``tests/test_goldens.py``'s default 2e-4; ``apply_padded`` against JAX's on
the same parameters 1e-4 (f32, the FFTs in another library); the mask
detector (numpy) and the heat fill (f32, the same operations) equal; the
LaMa fill's uint8 within 1 LSB on at most 0.1% of the values. A restore
with LaMa and no ``big-lama.npz`` raises ``InputError`` naming it before
any frame is written (JAX draws ``lama.init(PRNGKey(3))`` instead).
"""

from __future__ import annotations

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from framewright_tpu.models import lama as jlama
from framewright_tpu.processors import inpaint as jinp
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import InputError
from framewright_tpu_torch.io.y4m import Y4MWriter
from framewright_tpu_torch.models import lama as plama
from framewright_tpu_torch.models import layers, registry
from framewright_tpu_torch.processors import inpaint as pinp
from framewright_tpu_torch.restorer import VideoRestorer

from conftest import make_gradient_frame

GOLDEN = Path(__file__).parent / "goldens" / "lama_tiny.npz"
TINY = dict(ngf=8, n_down=2, n_blocks=2)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def golden_params():
    return _np(jax.jit(jlama.init, static_argnums=(1,))(jax.random.PRNGKey(13),
                                                        jlama.LamaConfig(**TINY)))


def overlay_clip(n: int = 8, h: int = 40, w: int = 56) -> list:
    out = []
    for t in range(n):
        f = make_gradient_frame(h, w, t).copy()
        f[28:34, 6:40] = 235                      # a static caption bar
        f[4:9, 44:52] = (20, 200, 40)             # a logo
        out.append(f)
    return out


def test_golden(golden_params):
    with np.load(GOLDEN) as z:
        x, y = z["x"], z["y"]
    p = layers.tree_to_torch(golden_params, "cpu")
    got = plama.apply(p, torch.from_numpy(x[..., :3]), torch.from_numpy(x[..., 3:]),
                      plama.LamaConfig(**TINY)).numpy()
    assert np.abs(got - y).max() < 2e-4


@pytest.mark.parametrize("hw", [(16, 16), (21, 30), (37, 25)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_apply_padded_matches_jax(golden_params, hw):
    h, w = hw
    rng = np.random.default_rng(h * w)
    img = rng.random((1, h, w, 3), dtype=np.float32)
    mask = (rng.random((1, h, w, 1)) > 0.8).astype(np.float32)
    cfg = jlama.LamaConfig(**TINY)
    want = np.asarray(jax.jit(lambda p, a, b: jlama.apply_padded(p, a, b, cfg))(
        golden_params, img, mask))
    got = plama.apply_padded(layers.tree_to_torch(golden_params, "cpu"), torch.from_numpy(img),
                             torch.from_numpy(mask), plama.LamaConfig(**TINY)).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() < 1e-4


def test_config_from_params_and_init_shapes(golden_params):
    assert plama.config_from_params(golden_params) == plama.LamaConfig(
        **vars(jlama.config_from_params(golden_params)))
    mine = plama.init_params(plama.LamaConfig(ngf=8, n_down=2, n_blocks=2, global_ratio=0.75), 0)
    jcfg = jlama.LamaConfig(ngf=8, n_down=2, n_blocks=2, global_ratio=0.75)
    theirs = jax.eval_shape(lambda k: jlama.init(k, jcfg), jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda a: a.shape, mine)
    assert shapes == jax.tree_util.tree_map(lambda a: a.shape, theirs)


@pytest.mark.parametrize("cls,kw", [
    ("WatermarkRemover", {}), ("SubtitleRemover", {}),
    ("WatermarkRemover", {"custom_masks": [(2, 2, 10, 8)]}),
    ("WatermarkRemover", {"auto_detect": False, "custom_masks": [(30, 10, 50, 20)]})],
    ids=["watermark", "subtitle", "watermark-and-region", "region-only"])
def test_mask_and_heat_fill_stream_equal_jax(cls, kw):
    clip = overlay_clip()
    j = getattr(jinp, cls)(jinp.InpaintConfig(method="diffusion", **kw))
    p = getattr(pinp, cls)(pinp.InpaintConfig(method="diffusion", device="cpu", **kw))
    want, got = list(j.process_stream(iter(clip))), list(p.process_stream(iter(clip)))
    np.testing.assert_array_equal(p.mask, j._mask)
    assert len(got) == len(want) == len(clip)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_lama_fill_matches_jax(tmp_path, golden_params):
    """The processor reads <weights_dir>/big-lama.npz, its widths from the
    tree; JAX's processor with the same file (JAX's restorer never passes
    its weights directory: it always draws PRNGKey(3))."""
    registry.write_npz(golden_params, tmp_path / pinp.LAMA_NPZ)
    clip = overlay_clip()
    j = jinp.WatermarkRemover(jinp.InpaintConfig(weights_dir=str(tmp_path)))
    p = pinp.WatermarkRemover(pinp.InpaintConfig(weights_dir=str(tmp_path), device="cpu"))
    want, got = list(j.process_stream(iter(clip))), list(p.process_stream(iter(clip)))
    assert p._arch == plama.LamaConfig(**TINY)
    d = np.abs(np.stack(got).astype(np.int16) - np.stack(want))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_lama_without_its_checkpoint_raises_before_any_compute(tmp_path):
    with pytest.raises(InputError, match="big-lama.npz"):
        pinp.WatermarkRemover(pinp.InpaintConfig(weights_dir=str(tmp_path), device="cpu")).setup()
    src = tmp_path / "clip.y4m"
    with Y4MWriter(src, 56, 40, fps=24) as w:
        for f in overlay_clip(4):
            w.write_frame(f)
    cfg = Config(sr_model="FW_fast6_x2", device_platform="cpu", weights_dir=tmp_path,
                 project_dir=tmp_path / "p", watermark_removal=True)
    with pytest.raises(InputError, match="big-lama.npz"):
        VideoRestorer(cfg).restore_video(src, tmp_path / "out.y4m")
    assert not (tmp_path / "out.y4m").exists()
    # subtitles with an unknown model run LaMa too (JAX's mapping)
    cfg = Config(sr_model="FW_fast6_x2", device_platform="cpu", weights_dir=tmp_path,
                 project_dir=tmp_path / "p2", subtitle_removal=True, inpaint_model="opencv")
    with pytest.raises(InputError, match="big-lama.npz"):
        VideoRestorer(cfg).restore_video(src, tmp_path / "out2.y4m")
    # the heat fill needs no checkpoint
    cfg = Config(sr_model="FW_fast6_x2", device_platform="cpu", weights_dir=tmp_path,
                 project_dir=tmp_path / "p3", watermark_removal=True, inpaint_model="diffusion")
    res = VideoRestorer(cfg).restore_video(src, tmp_path / "out3.y4m")
    assert res.frames_out == 4 and res.pre_sr["inpaint"]["method"] == "diffusion"
    assert res.pre_sr["inpaint"]["mask_fraction"] > 0
