"""HAT in the port (``models/hat.py``, the ``HAT_SRx4`` row, the SR
processor's path for a family without a kernel) held to the JAX package.

Tolerances: the golden ``tests/goldens/hat_tiny.npz`` within 5e-4
(``tests/test_goldens.py``); ``apply`` against JAX's within 2e-3 of the
output's largest magnitude (``tests/test_hat.py``); the port of the
official state dict equal to ``torch_port.port_hat``'s; the processors'
uint8 frames (float32, whole and tiled) within 1 LSB on at most 0.1% of
the values.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from framewright_tpu.models import hat as jh
from framewright_tpu.models import registry as jregistry
from framewright_tpu.models import torch_port
from framewright_tpu.processors.super_resolution import SRConfig as JaxSRConfig
from framewright_tpu.processors.super_resolution import SuperResolution as JaxSR
from framewright_tpu_torch import planner
from framewright_tpu_torch.models import hat as ph
from framewright_tpu_torch.models import layers, registry
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution

from test_manifests import load_manifest, synth_sd

GOLDEN = Path(__file__).parent / "goldens" / "hat_tiny.npz"
TINY = dict(embed_dim=48, depths=(2,), num_heads=4, window=8, scale=4)
_jinit = jax.jit(jh.init, static_argnums=(1,))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def golden():
    params = _np(_jinit(jax.random.PRNGKey(2), jh.HATConfig(**TINY)))
    return params, layers.tree_to_torch(registry.from_jax_params(params), "cpu")


def test_golden(golden):
    _, p = golden
    with np.load(GOLDEN) as z:
        x, y = z["x"], z["y"]
    got = ph.apply(p, torch.from_numpy(x), ph.HATConfig(**TINY)).numpy()
    assert np.abs(got - y).max() < 5e-4


@pytest.mark.parametrize("chunk", [512, 3])
def test_apply_matches_jax(golden, chunk, monkeypatch):
    """21x19: reflect-padded to 24x24 (window 8), shifted windows with
    the mask, OCAB's zero-padded overlapping windows; the attention in
    chunks of 3 windows gives the unchunked values."""
    monkeypatch.setattr(ph, "_WINDOW_CHUNK", chunk)
    params, p = golden
    x = np.random.default_rng(0).random((2, 21, 19, 3), dtype=np.float32)
    jcfg = jh.HATConfig(**TINY)
    want = np.asarray(jax.jit(lambda q, v: jh.apply(q, v, jcfg))(params, x))
    got = ph.apply(p, torch.from_numpy(x), ph.HATConfig(**TINY)).numpy()
    assert got.shape == want.shape == (2, 84, 76, 3)
    assert np.abs(got - want).max() / (np.abs(want).max() + 1e-6) < 2e-3


def test_port_state_dict_equals_jax_port_hat(tmp_path):
    """XPixelGroup's names (the JAX manifest of HAT_SRx4, synthesized
    values, the ``params_ema`` wrapper) -> the same tree as
    ``torch_port.port_hat``; ``HAT_SRx4.pth`` in the weights directory
    loads through the registry."""
    keys, _ = load_manifest("HAT_SRx4")
    sd = synth_sd(keys)
    want = torch_port.port_hat(sd)
    got = ph.port_state_dict({"params_ema." + k: torch.from_numpy(v) for k, v in sd.items()})
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    torch.save({"params_ema": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "HAT_SRx4.pth")
    spec, tree, src = registry.load_params("HAT_SRx4", tmp_path)
    assert src.endswith("HAT_SRx4.pth") and spec.arch_config == ph.official_config()
    np.testing.assert_array_equal(tree["layers"][5]["ocab"]["attn"]["rpb"],
                                  want["layers"][5]["ocab"]["attn"]["rpb"])


def test_registry_row_and_init_shapes():
    ours, theirs = registry.get_model("HAT_SRx4"), jregistry.get_model("HAT_SRx4")
    assert (ours.family, ours.scale, ours.url) == (theirs.family, theirs.scale, theirs.url)
    assert dataclasses.asdict(ours.arch_config) == dataclasses.asdict(theirs.arch_config)
    cfg = ph.HATConfig(**TINY)
    mine = ph.init_params(cfg, seed=1)
    shapes = jax.eval_shape(lambda: jh.init(jax.random.PRNGKey(0), jh.HATConfig(**TINY)))
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(shapes)
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(shapes)):
        assert a.shape == b.shape and a.dtype == np.float32
    spec, _, src = registry.load_params("HAT_SRx4", Path("/nonexistent"), seed=4)
    assert src == "random(seed=4)"


@pytest.fixture
def tiny_row(tmp_path, monkeypatch):
    """HAT_SRx4's row at the tiny widths in both registries, its weights
    one JAX draw written as HAT_SRx4.npz."""
    monkeypatch.setitem(jregistry.MODEL_SPECS, "HAT_SRx4", dataclasses.replace(
        jregistry.MODEL_SPECS["HAT_SRx4"], arch_config=jh.HATConfig(**TINY)))
    monkeypatch.setitem(registry.MODEL_SPECS, "HAT_SRx4", dataclasses.replace(
        registry.MODEL_SPECS["HAT_SRx4"], arch_config=ph.HATConfig(**TINY)))
    torch_port.export_npz(_jinit(jax.random.PRNGKey(3), jh.HATConfig(**TINY)),
                          tmp_path / "HAT_SRx4.npz")
    return tmp_path


@pytest.mark.parametrize("tile", [0, 16])
def test_processor_matches_jax(tiny_row, tile):
    """float32, 2 frames of 56x64: whole frames, and tiles of 16 with the
    family's 16-pixel halo (windows of 48)."""
    rng = np.random.default_rng(5)
    frames = (rng.random((2, 56, 64, 3)) * 255).astype(np.uint8)
    jsr = JaxSR(JaxSRConfig(model_name="HAT_SRx4", compute_dtype="float32", sharding="none",
                            tile_size=tile, weights_dir=str(tiny_row)))
    jsr.setup(56, 64)
    want = jsr.process_batch(frames)
    sr = SuperResolution(SRConfig(model_name="HAT_SRx4", compute_dtype="float32",
                                  device="cpu", tile_size=tile, weights_dir=str(tiny_row)))
    sr.setup(56, 64)
    assert sr.family == "hat" and sr.plan.tiled == bool(tile)
    assert sr.weights_source.endswith("HAT_SRx4.npz")
    got = sr.materialize(sr.dispatch(frames))
    assert got.shape == want.shape == (2, 224, 256, 3)
    d = np.abs(got.astype(np.int16) - want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def test_processor_bf16_yuv_and_stats(tiny_row):
    """bf16 (int8 runs it too, as in JAX): the YUV planes of the float
    image's epilogue and the gate's stats from the float image."""
    frames = (np.random.default_rng(6).random((1, 24, 32, 3)) * 255).astype(np.uint8)
    outs = []
    for dtype in ("bfloat16", "int8"):
        sr = SuperResolution(SRConfig(model_name="HAT_SRx4", compute_dtype=dtype,
                                      device="cpu", weights_dir=str(tiny_row)))
        sr.setup(24, 32)
        sr.set_output_color("yuv420")
        sr.enable_device_stats()
        h = sr.dispatch(frames)
        outs.append(sr.materialize(h))
        assert [p.shape for p in outs[-1]] == [(1, 96, 128), (1, 48, 64), (1, 48, 64)]
        assert set(h["stats_np"]) == {"psnr", "ssim", "luma", "std", "finite"}
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_planner_row():
    """Bytes per input pixel beside the attention chunk, which grows with
    the dispatch's windows up to 512: 960x540 frames (2040 windows each)
    plan a full chunk, a 192x256 frame (192 windows) or 4 tiles of 128
    with their 16-pixel halo (400 windows) less."""
    assert planner.peak_bytes_per_body_px("hat", 4, "bfloat16") == 6300
    assert planner.peak_bytes_per_body_px("hat", 4, "float32") == 12600
    chunk = 512 * 9_700_000
    p = planner.plan(540, 960, 4, family="hat", free_bytes=80 * 10**9, max_batch=4)
    assert not p.tiled and p.batch == 4 and p.body_divisor == 1
    assert p.est_bytes == 4 * 540 * 960 * 6300 + chunk
    assert p.with_batch(2).est_bytes == 2 * 540 * 960 * 6300 + chunk
    assert p.downshift() == p.with_batch(2)
    small = planner.plan(192, 256, 4, family="hat", free_bytes=80 * 10**9, max_batch=1)
    assert small.est_bytes == 192 * 256 * 6300 + 12 * 16 * 9_700_000
    tiled = planner.plan(192, 256, 4, family="hat", free_bytes=80 * 10**9,
                         tile_size_override=128, overlap=16)
    assert tiled.tiled and tiled.tiles_per_frame == 4 and tiled.overlap == 16
    four = tiled.with_batch(4)
    assert four.chunk_bytes(4) == 400 * 9_700_000
    assert four.est_bytes == (4 * 160 * 160 * 6300 + 400 * 9_700_000
                              + 192 * 256 * 16 * (tiled.frames * 14 + 36))
    # the chunk counts against the budget: 13 GB holds 3 frames alone, 2
    # beside it
    assert planner.plan(540, 960, 4, family="hat", free_bytes=13 * 10**9,
                        utilization=1.0).batch == 2
    # the kernel paths have no chunk
    assert planner.plan(540, 960, 2, free_bytes=80 * 10**9).chunk_bytes(4) == 0
