"""Restormer in the port (``models/restormer.py``, the denoiser's
``restormer`` method, its registry row) held to the JAX package.

The JAX draws are carried across as numpy trees (``from_jax_params``) or
as the ``.npz`` both packages read. Tolerances: the golden
``tests/goldens/restormer_tiny.npz`` within 2e-4 (``tests/test_goldens.py``);
``apply`` and ``apply_padded`` against JAX's within 2e-4 (f32 sums in
another order); the denoiser's uint8 frames within 1 LSB on at most 0.1%
of the values.
"""

from __future__ import annotations

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from framewright_tpu.models import restormer as jr
from framewright_tpu.models import torch_port
from framewright_tpu.processors import temporal_denoise as jtd
from framewright_tpu_torch import planner
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import InputError
from framewright_tpu_torch.models import layers, registry
from framewright_tpu_torch.models import restormer as pr
from framewright_tpu_torch.processors import temporal_denoise as td
from framewright_tpu_torch.restorer import VideoRestorer, pre_sr_reserve, required_weights

from test_torch_denoise import noisy_clip

GOLDEN = Path(__file__).parent / "goldens" / "restormer_tiny.npz"
GOLDEN_CFG = dict(dim=8, num_blocks=(1, 1, 1, 1), heads=(1, 1, 2, 2), num_refinement=1)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# jitted: the eager JAX init and forward compile op by op (tens of seconds)
_jinit = jax.jit(jr.init, static_argnums=(1,))


@pytest.fixture(scope="module")
def golden():
    jcfg = jr.RestormerConfig(**GOLDEN_CFG)
    params = _np(_jinit(jax.random.PRNGKey(6), jcfg))
    return jcfg, params, registry.from_jax_params(params)


def test_golden(golden):
    _, _, tree = golden
    cfg = pr.config_from_params(tree)
    assert (cfg.dim, cfg.num_blocks, cfg.heads, cfg.num_refinement) == (
        8, (1, 1, 1, 1), (1, 1, 2, 2), 1)
    with np.load(GOLDEN) as z:
        x, y = z["x"], z["y"]
    got = pr.apply(layers.tree_to_torch(tree, "cpu"), torch.from_numpy(x), cfg).numpy()
    assert np.abs(got - y).max() < 2e-4


@pytest.mark.parametrize("hw", [(32, 32), (21, 30)])
def test_apply_padded_matches_jax(golden, hw):
    """21x30 reflect-pads to 24x32 (divisor 8) and crops back."""
    jcfg, params, tree = golden
    x = np.random.default_rng(1).random((2,) + hw + (3,), dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, v: jr.apply_padded(p, v, jcfg))(params, x))
    got = pr.apply_padded(layers.tree_to_torch(tree, "cpu"), torch.from_numpy(x),
                          pr.config_from_params(tree)).numpy()
    assert got.shape == want.shape == (2,) + hw + (3,)
    assert np.abs(got - want).max() < 2e-4


def test_init_params_have_jax_shapes_and_default_config():
    ours = pr.init_params(pr.RestormerConfig(), seed=3)
    theirs = jax.eval_shape(lambda: jr.init(jax.random.PRNGKey(0), jr.RestormerConfig()))
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(theirs)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        assert a.shape == b.shape and a.dtype == np.float32
    cfg = pr.config_from_params(ours)
    want = jr.RestormerConfig()
    assert (cfg.dim, cfg.num_blocks, cfg.heads, cfg.num_refinement) == (
        want.dim, want.num_blocks, want.heads, want.num_refinement)
    assert registry.AUX_SPECS["restormer"].arch_config == pr.RestormerConfig()


def test_npz_round_trip_keeps_the_none_leaf(tmp_path):
    """The level-0 decoder has no reduce conv (a None leaf): the port's
    writer marks it as the JAX exporter does, and both readers restore it."""
    params = _np(_jinit(jax.random.PRNGKey(4), jr.RestormerConfig(**GOLDEN_CFG)))
    registry.write_npz(params, tmp_path / "a.npz")
    ours = registry.read_npz(tmp_path / "a.npz")
    theirs = torch_port.import_npz(tmp_path / "a.npz")
    assert ours["reduce"][-1] is None and theirs["reduce"][-1] is None
    torch_port.export_npz(params, tmp_path / "b.npz")
    back = registry.read_npz(tmp_path / "b.npz")
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """``restormer.npz`` at JAX's ``RestormerConfig()`` (what the JAX
    denoiser runs once weighted), exported by the JAX package."""
    wdir = tmp_path_factory.mktemp("w")
    torch_port.export_npz(_jinit(jax.random.PRNGKey(5), jr.RestormerConfig()),
                          wdir / "restormer.npz")
    return wdir


def test_denoiser_restormer_matches_jax(weights):
    """12 frames of 40x56 with a cut at frame 6, window 7: the IFNet blend
    then Restormer, against the JAX denoiser reading the same file."""
    clip = noisy_clip()
    jd = jtd.TemporalDenoiser(jtd.TemporalDenoiseConfig(method="restormer",
                                                        weights_dir=str(weights)))
    jd.setup(40, 56)
    want = np.stack(list(jd.denoise_stream(iter(clip))))
    dn = td.TemporalDenoiser(td.TemporalDenoiseConfig(method="restormer", device="cpu",
                                                      weights_dir=str(weights)))
    dn.setup(40, 56)
    got = np.stack(list(dn.denoise_stream(iter(clip))))
    assert got.shape == want.shape == (12, 40, 56, 3)
    d = np.abs(got.astype(np.int16) - want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())
    assert (dn.result.frames, dn.result.scene_resets) == (12, 1)
    assert dn.refiner.keywords["cfg"].dim == jr.RestormerConfig().dim


def test_missing_checkpoint_raises_input_error_before_compute(tmp_path):
    """JAX draws ``restormer.init(PRNGKey(2), dim=8)``; the port refuses,
    naming the file, in the denoiser and in the restore's check before any
    stage runs."""
    dn = td.TemporalDenoiser(td.TemporalDenoiseConfig(method="restormer", device="cpu",
                                                      weights_dir=str(tmp_path)))
    with pytest.raises(InputError, match="restormer.npz"):
        dn.setup(40, 56)
    cfg = Config(sr_model="FW_fastvgg_x2", device_platform="cpu", denoise=True,
                 denoise_model="restormer", weights_dir=tmp_path,
                 project_dir=tmp_path / "p")
    assert required_weights(cfg) == ["restormer"]
    src = tmp_path / "c.y4m"
    src.write_bytes(b"")
    with pytest.raises(InputError, match="restormer.npz"):
        VideoRestorer(cfg).restore_video(src, tmp_path / "o.y4m")
    assert not (tmp_path / "o.y4m").exists() and not (tmp_path / "p").exists()


def test_plan_reserves_restormer(weights, tmp_path):
    """The pre-SR row is sized from the checkpoint's widths: JAX's
    ``RestormerConfig()`` (dim 16) and the published dim 48 (4 (2C + 6h +
    3) B a pixel at C = 2 dim, h = int(C x 2.66), + 15%)."""
    cfg = Config(denoise=True, denoise_model="restormer", weights_dir=weights)
    assert planner.restormer_bytes_per_px() == 4 * (64 + 6 * 85 + 3) * 115 // 100 == 2654
    assert pre_sr_reserve(cfg, 1080, 1920) == 1080 * 1920 * 2654
    wide = pr.RestormerConfig(dim=48, num_blocks=(1, 1, 1, 1), num_refinement=1)
    registry.write_npz(pr.init_params(wide, seed=1), tmp_path / "restormer.npz")
    cfg = Config(denoise=True, denoise_model="restormer", weights_dir=tmp_path)
    assert planner.restormer_bytes_per_px(48) == 4 * (192 + 6 * 255 + 3) * 115 // 100
    assert pre_sr_reserve(cfg, 1080, 1920) == 1080 * 1920 * planner.restormer_bytes_per_px(48)
