"""The diffusion SR in the port (``models/diffusion_sr.py``, the
``DiffusionSR_x4`` row, the SR processor's diffusion family, the guided
diffusion backend, the restore) held to the JAX package on the packaged
checkpoint (``framewright_tpu/models/weights/DiffusionSR_x4.npz``).

Tolerances: the schedule 1e-6 relative (f32 ulps of XLA's cosine) and the timesteps equal; the time
embedding 1e-4 (XLA's f32 sine of arguments up to 1000 rad); the zero-head
init equal to the bicubic upsample within 1e-5 (``tests/test_diffusion.py``);
in float32 ``denoise`` and ``ddim_sample`` within 1e-4 of the output range
and uint8 within 1 LSB on at most 0.1% of the values (measured: at most 1
LSB on 0.003%), the processors and the restores too. In bfloat16 the
port rounds every op as XLA's CPU compile of JAX's graph does (each
elementwise op to bf16, but a value handed straight to a 3x3 convolution
or to the f32 cast unrounded), yet a convolution's f32 sum in another
order lands a value one bf16 step away on ~0.03% of a block's outputs and
the UNet spreads those steps: uint8 within 3 LSB, mean under 0.3 LSB
(measured: max 2, mean 0.14-0.19, on 14-22% of the values).
A diffusion restore's bytes depend on its batch: a frame's noise is its
slice of its dispatch chunk's draw, as in JAX.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framewright_tpu.models import diffusion_sr as jd
from framewright_tpu.models import registry as jregistry
from framewright_tpu.models.layers import resize_bicubic as jresize
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.models import diffusion_sr as pd
from framewright_tpu_torch.models import layers, registry
from framewright_tpu_torch.ops import jax_random
from framewright_tpu_torch.processors import guided as pg

F32_RANGE_TOL = 1e-4
U8_FRAC = 1e-3
BF16_MAX_LSB, BF16_MEAN_LSB = 3, 0.3
TINY = dict(base_ch=8, ch_mults=(1, 2), time_dim=16, steps=4)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def packaged():
    spec, params = jregistry.init_model("DiffusionSR_x4", dtype=jnp.float32, device=False)
    pspec, tree, src = registry.load_params("DiffusionSR_x4")
    return spec, params, pspec, tree, src


def _u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.floor(np.asarray(x, np.float32) * 255.0 + 0.5), 0, 255).astype(np.uint8)


def _u8_within(got: np.ndarray, want: np.ndarray, dtype: str) -> dict:
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    stats = {"max": int(d.max()), "mean": float(d.mean()), "frac": float((d > 0).mean())}
    if dtype == "float32":
        assert stats["max"] <= 1 and stats["frac"] <= U8_FRAC, stats
    else:
        assert stats["max"] <= BF16_MAX_LSB and stats["mean"] <= BF16_MEAN_LSB, stats
    return stats


def _lr(n=1, h=12, w=16, seed=0):
    return np.random.default_rng(seed).random((n, h, w, 3), dtype=np.float32)


# -- the schedule, the embedding, the row ------------------------------------------------

def test_schedule_timesteps_and_time_embedding():
    np.testing.assert_allclose(pd.alphas_cumprod(1000), np.asarray(jd.alphas_cumprod(1000)),
                               rtol=1e-6, atol=0)
    for steps in (1, 2, 3, 7, 8, 50):
        for frac in (1.0, 0.35, 0.5):
            cfg = pd.DiffusionSRConfig(steps=steps)
            n, ts = pd.timesteps(cfg, frac)
            want = np.asarray(jnp.linspace(int(999 * frac), 0, n + 1).astype(jnp.int32))
            assert n == max(1, int(steps * frac))
            np.testing.assert_array_equal(ts, want)
    t = np.array([0.999, 0.5, 0.0, 0.124], np.float32)
    want = np.asarray(jax.jit(lambda v: jd._time_embed(v, 64))(t))
    np.testing.assert_allclose(pd._time_embed(torch.from_numpy(t), 64).numpy(), want,
                               rtol=0, atol=1e-4)


def test_registry_row(packaged):
    spec, _, pspec, tree, src = packaged
    assert pspec.family == "diffusion" and pspec.scale == 4 and pspec.arch_config.steps == 1
    assert dataclasses.asdict(pspec.arch_config) == dataclasses.asdict(spec.arch_config)
    assert src.endswith("framewright_tpu/models/weights/DiffusionSR_x4.npz")
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, packaged[1]))
    got = jax.tree_util.tree_leaves(tree)
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    assert Config(sr_model="DiffusionSR_x4", scale_factor=4).diffusion_steps == 8
    with pytest.raises(ConfigError, match="diffusion_steps"):
        Config(diffusion_steps=0)
    with pytest.raises(ConfigError, match="diffusion_strength"):
        Config(diffusion_strength=1.5)


def test_zero_head_init_is_the_bicubic_upsample():
    """The init's zero head: x0 is the condition, so an untrained net is a
    bicubic upscaler (JAX's bound)."""
    cfg = pd.DiffusionSRConfig(**TINY)
    p = layers.tree_to_torch(pd.init_params(cfg, seed=3), "cpu")
    lr = _lr(2, 8, 8, seed=3)
    y = pd.apply(p, torch.from_numpy(lr), cfg).numpy()
    base = np.clip(np.asarray(jresize(jnp.asarray(lr), (32, 32))), 0, 1)
    np.testing.assert_allclose(y, base, rtol=0, atol=1e-5)


# -- the forward ----------------------------------------------------------------------

def test_denoise_f32_matches_jax(packaged):
    spec, params, _, tree, _ = packaged
    rng = np.random.default_rng(1)
    xn = rng.standard_normal((1, 24, 40, 3)).astype(np.float32)
    cond = (rng.random((1, 24, 40, 3), dtype=np.float32) * 2 - 1)
    t = np.array([0.874], np.float32)
    want = np.asarray(jax.jit(lambda p, a, b, c: jd.denoise(p, a, b, c, spec.arch_config))(
        params, xn, cond, t))
    got = pd.denoise(layers.tree_to_torch(tree, "cpu"), torch.from_numpy(xn),
                     torch.from_numpy(cond), torch.from_numpy(t), spec.arch_config).numpy()
    assert np.abs(got - want).max() <= F32_RANGE_TOL * (np.abs(want).max() + 1e-6)


@pytest.mark.parametrize("case", [
    dict(dtype="float32", steps=1), dict(dtype="float32", steps=8),
    dict(dtype="float32", steps=2, guidance=5.0), dict(dtype="float32", steps=3, frac=0.35),
    dict(dtype="bfloat16", steps=1), dict(dtype="bfloat16", steps=8)],
    ids=["f32-1", "f32-8", "f32-guided", "f32-sdedit", "bf16-1", "bf16-8"])
def test_ddim_sample_matches_jax(packaged, case):
    spec, params, _, tree, _ = packaged
    jdt = jnp.float32 if case["dtype"] == "float32" else jnp.bfloat16
    tdt = torch.float32 if case["dtype"] == "float32" else torch.bfloat16
    cfg = dataclasses.replace(spec.arch_config, steps=case["steps"])
    lr = _lr(2, 12, 16, seed=4)
    init = np.random.default_rng(5).random((2, 48, 64, 3), dtype=np.float32)
    style = pg.parse_style("sharp warm cinematic grain")[None].repeat(2, 0)
    frac, g = case.get("frac", 1.0), case.get("guidance", 1.0)
    kw = dict(t_start_frac=frac, guidance_scale=g)

    def jrun(p, x, ih, sv):
        return jd.ddim_sample(p, x, cfg, key=jax.random.PRNGKey(7),
                              init_hr=ih if frac < 1 else None,
                              style=sv if g != 1.0 else None, **kw)

    jp = jax.tree_util.tree_map(lambda v: jnp.asarray(v).astype(jdt), params)
    want = np.asarray(jax.jit(jrun)(jp, jnp.asarray(lr).astype(jdt), jnp.asarray(init),
                                   jnp.asarray(style)).astype(jnp.float32))
    got = pd.ddim_sample(layers.tree_to_torch(tree, "cpu", tdt), torch.from_numpy(lr).to(tdt),
                         cfg, seed=7, init_hr=torch.from_numpy(init) if frac < 1 else None,
                         style=torch.from_numpy(style) if g != 1.0 else None,
                         **kw).float().numpy()
    assert got.shape == want.shape == (2, 48, 64, 3)
    if case["dtype"] == "float32":
        assert np.abs(got - want).max() <= F32_RANGE_TOL * max(np.abs(want).max(), 1e-6)
    _u8_within(_u8(got), _u8(want), case["dtype"])


def test_batch_position_draws_jax_slice(packaged):
    """Frame i of a batch is sampled from slice i of the batch's draw:
    alone (a batch of 1, slice 0) its output differs; with slice i of
    JAX's draw passed in, it equals the batched frame."""
    _, _, pspec, tree, _ = packaged
    p = layers.tree_to_torch(tree, "cpu")
    lr = torch.from_numpy(_lr(3, 8, 12, seed=6))
    batched = pd.apply(p, lr, pspec.arch_config)
    alone = pd.apply(p, lr[2:], pspec.arch_config)
    jnoise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (3, 32, 48, 3)))
    passed = pd.ddim_sample(p, lr[2:], pspec.arch_config,
                            noise=torch.from_numpy(jnoise[2:]))
    assert not torch.equal(batched[2:], alone)
    assert np.abs(passed.numpy() - batched[2:].numpy()).max() <= 1e-6
    torch.testing.assert_close(jax_random.normal(0, (3, 32, 48, 3))[2],
                               torch.from_numpy(jnoise[2]), rtol=0, atol=1e-6)


def test_sample_video_matches_jax():
    cfg = jd.DiffusionSRConfig(**TINY)
    params = pd.init_params(pd.DiffusionSRConfig(**TINY), seed=0)
    # a head that is not zero, so the propagation shows
    params["conv_out"]["w"] = np.random.default_rng(8).normal(
        0, 0.05, params["conv_out"]["w"].shape).astype(np.float32)
    fr = np.random.default_rng(9).random((1, 2, 8, 8, 3), dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, v: jd.sample_video(p, v, cfg))(params, fr))
    got = pd.sample_video(layers.tree_to_torch(params, "cpu"), torch.from_numpy(fr),
                          pd.DiffusionSRConfig(**TINY)).numpy()
    assert got.shape == want.shape == (1, 2, 32, 32, 3)
    assert np.abs(got - want).max() <= F32_RANGE_TOL
