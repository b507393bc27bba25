"""RAFT in the port (``models/raft.py``, the denoiser's
``flow_model="raft"``, its registry row and planner term) held to the
JAX package.

Tolerances: the golden ``tests/goldens/raft_tiny.npz`` within 2e-2 max
and 1e-3 mean (``tests/test_goldens.py``); the flow against JAX's
``apply`` and ``estimate_flow`` within 0.01 of the flow's largest
magnitude (``tests/test_raft.py``); the correlation pyramid within 1e-5
relative; the port of a princeton-vl state dict equal to
``torch_port.port_raft``'s to 1e-6; the denoiser's uint8 frames within 1
LSB on at most 0.1% of the values.
"""

from __future__ import annotations

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from framewright_tpu.models import raft as jr
from framewright_tpu.models import torch_port
from framewright_tpu.processors import temporal_denoise as jtd
from framewright_tpu_torch import planner
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import HBMError, InputError
from framewright_tpu_torch.models import layers, registry
from framewright_tpu_torch.models import raft as pr
from framewright_tpu_torch.processors import temporal_denoise as td
from framewright_tpu_torch.restorer import pre_sr_reserve, raft_pairs, required_weights

from test_manifests import load_manifest, synth_sd
from test_torch_denoise import noisy_clip

GOLDEN = Path(__file__).parent / "goldens" / "raft_tiny.npz"
_jinit = jax.jit(jr.init, static_argnums=(1,))


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
    params = _np(_jinit(jax.random.PRNGKey(10), jr.RAFTConfig()))
    return params, layers.tree_to_torch(registry.from_jax_params(params), "cpu")


def test_golden(golden):
    _, p = golden
    with np.load(GOLDEN) as z:
        x, y = z["x"], z["y"]
    got = pr.apply(p, torch.from_numpy(x[0]), torch.from_numpy(x[1]),
                   pr.RAFTConfig(iters=4)).numpy()
    assert np.abs(got - y).max() < 2e-2 and np.abs(got - y).mean() < 1e-3


def _pair(h, w, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((1, h, w, 3), dtype=np.float32)
    b = np.roll(a, (2, 3), axis=(1, 2))           # a known shift
    return a, b


@pytest.mark.parametrize("hw", [(40, 48), (37, 45)])
def test_estimate_flow_matches_jax(golden, hw):
    """40x48 runs unpadded; 37x45 edge-pads to 40x48 and crops back."""
    params, p = golden
    a, b = _pair(*hw)
    jcfg = jr.RAFTConfig(iters=4)
    want = np.asarray(jax.jit(lambda q, u, v: jr.estimate_flow(q, u, v, jcfg))(params, a, b))
    got = pr.estimate_flow(p, torch.from_numpy(a), torch.from_numpy(b),
                           pr.RAFTConfig(iters=4)).numpy()
    assert got.shape == want.shape == (1,) + hw + (2,)
    err = np.abs(got - want)
    assert err.max() / (np.abs(want).max() + 1e-3) < 0.01 and err.mean() < 1e-3


def test_corr_pyramid_matches_jax():
    rng = np.random.default_rng(2)
    f1, f2 = (rng.standard_normal((2, 5, 6, 32)).astype(np.float32) for _ in range(2))
    want = jr.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    got = pr.corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        if w.size:
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-5 * (np.abs(w).max() + 1e-6)


def test_port_state_dict_equals_jax_port_raft(tmp_path):
    """princeton-vl's names (the JAX manifest, synthesized values, the
    ``module.`` prefix of a DataParallel save): the context encoder's
    BatchNorms folded as ``torch_port.port_raft`` folds them; a ``.pth``
    in the weights directory loads through ``load_aux``."""
    keys, _ = load_manifest("raft-things")
    sd = synth_sd(keys)
    want = torch_port.port_raft(sd)
    got = pr.port_state_dict({"module." + k: torch.from_numpy(v) for k, v in sd.items()})
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "raft-things.pth")
    assert registry.aux_path("raft-things", tmp_path) == tmp_path / "raft-things.pth"
    _, tree, src = registry.load_aux("raft-things", tmp_path)
    assert src.endswith("raft-things.pth")
    np.testing.assert_allclose(tree["cnet"]["conv1"]["w"], want["cnet"]["conv1"]["w"],
                               rtol=1e-6, atol=1e-6)


def test_init_params_have_jax_shapes():
    ours = pr.init_params(pr.RAFTConfig(), seed=1)
    theirs = jax.eval_shape(lambda: jr.init(jax.random.PRNGKey(0), jr.RAFTConfig()))
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(theirs)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        assert a.shape == b.shape and a.dtype == np.float32


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("w")
    torch_port.export_npz(_jinit(jax.random.PRNGKey(11), jr.RAFTConfig()),
                          wdir / "raft-things.npz")
    return wdir


def test_denoiser_raft_matches_jax(weights):
    """12 frames of 40x56 with a cut at frame 6, window 5: the temporal
    blend aligned by RAFT (iters 8) against the JAX denoiser reading the
    same file; the port in steps of 3 pairs and of 1."""
    clip = noisy_clip()
    jd = jtd.TemporalDenoiser(jtd.TemporalDenoiseConfig(radius=2, flow_model="raft",
                                                        weights_dir=str(weights)))
    jd.setup(40, 56)
    want = np.stack(list(jd.denoise_stream(iter(clip))))
    outs = []
    for pairs in (3, 1):
        dn = td.TemporalDenoiser(td.TemporalDenoiseConfig(
            radius=2, flow_model="raft", flow_pairs=pairs, device="cpu",
            weights_dir=str(weights)))
        dn.setup(40, 56)
        assert dn.flow_net.pairs == pairs and dn.flow_net.cfg.iters == 8
        outs.append(np.stack(list(dn.denoise_stream(iter(clip)))))
        assert (dn.result.frames, dn.result.scene_resets) == (12, 1)
    for got in outs:
        d = np.abs(got.astype(np.int16) - want)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def test_missing_checkpoint_raises_input_error(tmp_path):
    dn = td.TemporalDenoiser(td.TemporalDenoiseConfig(flow_model="raft", device="cpu",
                                                      weights_dir=str(tmp_path)))
    with pytest.raises(InputError, match="raft-things.npz"):
        dn.setup(40, 56)
    cfg = Config(denoise=True, denoise_model="nafnet", flow_model="raft", weights_dir=tmp_path)
    assert required_weights(cfg) == ["raft-things"]
    assert required_weights(Config(denoise=True, denoise_model="bilateral",
                                   flow_model="raft")) == []


def test_planner_counts_the_quadratic_volume():
    """1080p: 240 x 135 = 32,400 positions, 4.2 GB of f32 correlation and
    5.6 GB with the pyramid, a pair; half of the budget holds the pairs."""
    n8 = 240 * 135
    per_pair = planner.raft_pair_bytes(1080, 1920)
    assert per_pair == n8 * n8 * 4 * 85 // 64 + 1080 * 1920 * 600
    assert 5.5e9 < n8 * n8 * 4 * 85 // 64 < 5.7e9
    # 4x the pixels: ~16x the volume
    assert planner.raft_pair_bytes(2160, 3840) > 15 * n8 * n8 * 4
    assert planner.raft_pairs(1080, 1920, 80 * 10**9, 0.85) == 4
    assert planner.raft_pairs(1080, 1920, 80 * 10**9, 0.85, max_pairs=2) == 2
    with pytest.raises(HBMError, match="RAFT"):
        planner.raft_pairs(2160, 3840, 80 * 10**9, 0.85)
    cfg = Config(denoise=True, denoise_model="temporal", flow_model="raft",
                 device_platform="cpu")
    pairs = raft_pairs(cfg, 270, 480)           # the CPU's 8 GiB budget
    assert pairs == planner.raft_pairs(270, 480, None, 0.85, max_pairs=6) == 6
    assert pre_sr_reserve(cfg, 270, 480) == max(
        pairs * planner.raft_pair_bytes(270, 480), 270 * 480 * (120 + 6 * 180))
