"""RRDBNet of the PyTorch port against the JAX reference on the CPU.

Inputs and weights are made with numpy from a seed and passed to both
frameworks as numpy arrays. On the CPU the port's ``apply_fast`` runs
the plain PyTorch versions of its kernels (the kernels themselves run
on the card: chip_smoke.py, tests/test_torch_gpu.py); the JAX
``apply_fast`` runs its Pallas kernels in interpret mode at the block
size tests/conftest.py pins.

Tolerances: f32 against f32 to 1e-4 (summation order only); bf16 paths
against the f32 oracle at max 0.05 / mean 0.005 and uint8 outputs at 1
LSB on < 2% of values, the JAX package's own (tests/test_fused_tail3.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framewright_tpu.models import rrdb as jrrdb
from framewright_tpu.models.registry import packaged_weights_dir
from framewright_tpu_torch.models import rrdb
from framewright_tpu_torch.models.registry import (
    from_jax_params,
    init_params,
    read_npz,
)

SHAPES = [(1, 40, 56), (2, 40, 56), (1, 200, 208), (2, 200, 208)]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    # shared seeded weights, drawn with numpy (JAX's eager init is slow)
    cfg = jrrdb.RRDBConfig(num_block=2, scale=2)
    params = jax.device_get(jrrdb.stack_body(
        init_params(rrdb.RRDBConfig(num_block=2, scale=2), seed=0)))
    fast = jrrdb.make_fast_params(params)
    model = rrdb.RRDBNet.from_state_dict(rrdb.RRDBConfig(num_block=2, scale=2),
                                         from_jax_params(params, torch.float32),
                                         torch.device("cpu"))
    return cfg, params, fast, model


@pytest.fixture(scope="module")
def oracle(nets):
    """JAX f32 ``apply`` outputs per input shape (computed once)."""
    cfg, params, _, _ = nets
    cache = {}

    def get(shape):
        if shape not in cache:
            x = _frames(shape)
            cache[shape] = (x, np.asarray(jrrdb.apply(params, jnp.asarray(x), cfg),
                                          np.float32))
        return cache[shape]

    return get


def _frames(shape, seed=5):
    b, h, w = shape
    return np.random.default_rng(seed + h + b).random((b, h, w, 3)).astype(np.float32)


def _err(got, want):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    return d.max(), d.mean()


@pytest.mark.parametrize("shape", SHAPES)
def test_apply_f32_matches_jax(nets, oracle, shape):
    _, _, _, model = nets
    x, want = oracle(shape)
    got = model.apply(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], 2 * shape[1], 2 * shape[2], 3)
    mx, _ = _err(got, want)
    assert mx < 1e-4, mx


@pytest.mark.parametrize("shape", SHAPES)
def test_apply_fast_bf16_matches_jax_apply(nets, oracle, shape):
    _, _, _, model = nets
    x, want = oracle(shape)
    got = model.apply_fast(torch.from_numpy(x)).float().numpy()
    assert got.shape == want.shape
    mx, mean = _err(got, want)
    assert mx < 0.05 and mean < 0.005, (mx, mean)


@pytest.mark.parametrize("shape", [(1, 40, 56), (2, 200, 208)])
def test_apply_fast_bf16_matches_jax_apply_fast(nets, shape):
    cfg, params, fast, model = nets
    x = _frames(shape, seed=9)
    want = np.asarray(jrrdb.apply_fast(params, fast, jnp.asarray(x, jnp.bfloat16), cfg,
                                       interpret=True), np.float32)
    got = model.apply_fast(torch.from_numpy(x)).float().numpy()
    mx, mean = _err(got, want)
    assert mx < 0.05 and mean < 0.005, (mx, mean)


@pytest.mark.parametrize("shape", [(1, 40, 56), (2, 200, 208)])
def test_rgb_u8_matches_epilogue_of_own_bf16(nets, shape):
    _, _, _, model = nets
    x = torch.from_numpy(_frames(shape, seed=3))
    ref = model.apply_fast(x, "bf16")
    got = model.apply_fast(x, "rgb_u8")
    want = rrdb._out_epilogue(ref, "rgb_u8", False)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    d = (got.float() - want.float()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() < 0.02


@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("shape", [(2, 40, 56), (1, 200, 208)])
def test_yuv420_u8_matches_epilogue_of_own_bf16(nets, shape, full_range):
    _, _, _, model = nets
    b, h, w = shape
    x = torch.from_numpy(_frames(shape, seed=4))
    ref = model.apply_fast(x, "bf16")
    got = model.apply_fast(x, "yuv420_u8", full_range)
    want = rrdb._out_epilogue(ref, "yuv420_u8", full_range)
    assert [tuple(p.shape) for p in got] == [(b, 2 * h, 2 * w), (b, h, w), (b, h, w)]
    for g, wt in zip(got, want):
        assert g.dtype == torch.uint8
        d = (g.float() - wt.float()).abs()
        assert d.max() <= 1 and (d > 0).float().mean() < 0.02


def test_out_epilogue_matches_jax(nets):
    y = np.random.default_rng(1).uniform(-0.2, 1.2, (2, 16, 24, 3)).astype(np.float32)
    for full in (False, True):
        want = jax.device_get(jrrdb._out_epilogue(jnp.asarray(y), "yuv420_u8", full))
        got = rrdb._out_epilogue(torch.from_numpy(y), "yuv420_u8", full)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(
        rrdb._out_epilogue(torch.from_numpy(y), "rgb_u8", False).numpy(),
        jax.device_get(jrrdb._out_epilogue(jnp.asarray(y), "rgb_u8", False)))


class TestTrainedWeights:
    """FW_fast6_x2, the repository's trained 6-block RRDB at scale 2."""

    @pytest.fixture(scope="class")
    def fast6(self):
        params = read_npz(packaged_weights_dir() / "FW_fast6_x2.npz")
        jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
        model = rrdb.RRDBNet.from_state_dict(rrdb.RRDBConfig(num_block=6, scale=2),
                                             from_jax_params(jp, torch.float32),
                                             torch.device("cpu"))
        return jp, model

    def test_apply_and_apply_fast(self, fast6):
        jp, model = fast6
        cfg = jrrdb.RRDBConfig(num_block=6, scale=2)
        x = _frames((1, 48, 64), seed=11)
        want = np.asarray(jrrdb.apply(jp, jnp.asarray(x), cfg), np.float32)
        got = model.apply(torch.from_numpy(x)).numpy()
        assert _err(got, want)[0] < 1e-4
        mx, mean = _err(model.apply_fast(torch.from_numpy(x)).float().numpy(), want)
        assert mx < 0.05 and mean < 0.005, (mx, mean)


def test_random_23_block_error_scales_with_range():
    """With seeded random weights the 23-block x2plus output spans tens of
    units and every bf16 path's error grows with it, the JAX reference's
    own included: chip_smoke.py therefore divides that model's error by
    the f32 output's range before applying the tolerance."""
    cfg = rrdb.RRDBConfig(num_block=23, scale=2)
    params = init_params(cfg, seed=0)
    jcfg = jrrdb.RRDBConfig(num_block=23, scale=2)
    x = _frames((1, 32, 48), seed=2)
    ref = np.asarray(jrrdb.apply(params, jnp.asarray(x), jcfg), np.float32)
    pb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jax_bf16 = np.asarray(jrrdb.apply(pb, jnp.asarray(x, jnp.bfloat16), jcfg), np.float32)
    model = rrdb.RRDBNet.from_state_dict(cfg, from_jax_params(params, torch.float32),
                                         torch.device("cpu"))
    port = model.apply_fast(torch.from_numpy(x)).float().numpy()
    span = float(ref.max() - ref.min())
    assert span > 10.0                          # far outside an image's [0, 1]
    jmx, jmean = _err(jax_bf16, ref)
    pmx, pmean = _err(port, ref)
    assert jmx > 0.05                           # the absolute tolerance fails for JAX too
    assert pmean < 1.5 * jmean and pmx < 2.0 * jmx, ((pmx, pmean), (jmx, jmean))
    assert pmx / span < 0.05 and pmean / span < 0.005
