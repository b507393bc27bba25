"""The RRDB rows at scale 4 (RealESRGAN_x4plus, RealESRGAN_x4plus_anime_6B:
the body at input resolution) and at scale 1 (the body at input / 4
through pixel_unshuffle 4; ``RRDBConfig`` allows it, no registry row uses
it) in the PyTorch port against the JAX package on the CPU.

Two blocks, weights from the port's seeded init (seed 0) given to both
packages; the JAX ``apply_fast`` runs its Pallas kernels in interpret
mode, the port its kernels' plain versions. Inputs 1x24x32 at scale 4 and
1x48x64 at scale 1, both to 96x128 and 48x64 outputs.

Tolerances, the JAX package's: the bf16 and int8 kernel paths against
JAX's within 0.05 max and 0.005 mean, and against the f32 ``apply``
likewise; uint8 planes within 1 LSB with no bound on the share (outputs
in [0, 1] clip little, and one bf16 step there is about one LSB:
ROADMAP.md, section C's caveats).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framewright_tpu.models import rrdb as jrrdb
from framewright_tpu_torch.models import rrdb
from framewright_tpu_torch.models.registry import from_jax_params, init_params
from framewright_tpu_torch.ops import fused_rrdb

CASES = {4: (1, 24, 32), 1: (1, 48, 64)}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(CASES), ids=lambda s: f"x{s}")
def net(request):
    scale = request.param
    cfg = rrdb.RRDBConfig(num_block=2, scale=scale)
    params = jax.device_get(jrrdb.stack_body(init_params(cfg, seed=0)))
    model = rrdb.RRDBNet.from_state_dict(cfg, from_jax_params(params, torch.float32),
                                         torch.device("cpu"))
    b, h, w = CASES[scale]
    x = np.random.default_rng(scale).random((b, h, w, 3)).astype(np.float32)
    jcfg = jrrdb.RRDBConfig(num_block=2, scale=scale)
    ref = np.asarray(jrrdb.apply(params, jnp.asarray(x), jcfg), np.float32)
    return scale, jcfg, params, model, x, ref


def _lsb(got, want):
    return int(np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int)).max())


def test_shapes_and_body_resolution(net):
    scale, _, _, model, x, ref = net
    b, h, w, _ = x.shape
    assert ref.shape == ((b, 4 * h, 4 * w, 3) if scale == 4 else (b, h, w, 3))
    feat = model._head(torch.from_numpy(x).to(torch.bfloat16))
    u = {4: 1, 1: 4}[scale]
    assert feat.shape == (b, h // u, w // u, 64)


def test_apply_f32_matches_jax(net):
    _, _, _, model, x, ref = net
    assert np.abs(model.apply(torch.from_numpy(x)).numpy() - ref).max() < 1e-4


def test_bf16_kernel_path_matches_jax(net):
    _, jcfg, params, model, x, ref = net
    fast = jrrdb.make_fast_params(params)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jrrdb.apply_fast(params, fast, xj, jcfg, interpret=True), np.float32)
    got = model.apply_fast(torch.from_numpy(x)).float().numpy()
    for other in (want, ref):
        d = np.abs(got - other)
        assert d.max() < 0.05 and d.mean() < 0.005, (d.max(), d.mean())
    want_p = jrrdb.apply_fast(params, fast, xj, jcfg, interpret=True, out_mode="yuv420_u8")
    got_p = model.apply_fast(torch.from_numpy(x), "yuv420_u8")
    for g, w in zip(got_p, want_p):
        assert g.shape == np.asarray(w).shape
        assert _lsb(g.numpy(), w) <= 1


def test_int8_i32_kernel_path_matches_jax(net):
    """Static int8, scheme i32, the same calibration for both."""
    _, jcfg, params, model, x, _ = net
    amax = rrdb.calibrate_act_scales(model, torch.from_numpy(x))
    fast = jrrdb.make_fast_params(params, compute_dtype="int8", act_amax=amax,
                                  int8_scheme="i32")
    fw = model.fast_weights_int8(amax, "i32")
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jrrdb.apply_fast(params, fast, xj, jcfg, interpret=True), np.float32)
    got = model.apply_fast(torch.from_numpy(x), weights=fw).float().numpy()
    d = np.abs(got - want)
    assert d.max() < 0.05 and d.mean() < 0.005, (d.max(), d.mean())
    want_p = jrrdb.apply_fast(params, fast, xj, jcfg, interpret=True, out_mode="yuv420_u8")
    got_p = model.apply_fast(torch.from_numpy(x), "yuv420_u8", weights=fw)
    for g, w in zip(got_p, want_p):
        assert _lsb(g.numpy(), w) <= 1


def test_int8_body_is_the_plain_version(net):
    """On the CPU the int8 wrapper runs its plain version: the same body."""
    _, _, _, model, x, _ = net
    amax = rrdb.calibrate_act_scales(model, torch.from_numpy(x))
    fw = model.fast_weights_int8(amax, "i32")
    feat = model._head(torch.from_numpy(x).to(torch.bfloat16)).contiguous()
    assert torch.equal(fused_rrdb.rrdb_body_int8(feat, fw.body),
                       fused_rrdb.rrdb_body_int8(feat, fw.body, plain=True))
