"""CodeFormer in the port (``models/codeformer.py``, the ``codeformer``
face backend, its registry row) held to the JAX package.

The JAX draws are carried across in memory (``state_dict_from_params``)
or as ``.npz`` through the port's reader: the golden
``tests/goldens/codeformer_tiny.npz`` (``codeformer.init(PRNGKey(9))``
at its tiny widths) and the JAX face restorer's stand-in
(``PRNGKey(7)``, what a JAX restore without a checkpoint runs).

Tolerances: the golden within 2e-4 (``tests/test_goldens.py``); the
model against JAX's ``apply`` at w 0, 0.5 and 1 within 1e-4 (f32 sums in
another order; measured 4e-6); ``restore_frame`` within 1 LSB on at most
0.1% of the values (as GFPGAN's, ``tests/test_torch_faces.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from pathlib import Path

import framewright_tpu.processors.faces as jfaces
from framewright_tpu.models import codeformer as jcf
from framewright_tpu.models import torch_port
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import InputError
from framewright_tpu_torch.models import codeformer as cf
from framewright_tpu_torch.models import registry
from framewright_tpu_torch.processors import faces
from framewright_tpu_torch.restorer import face_reserve, required_weights

GOLDEN = Path(__file__).parent / "goldens" / "codeformer_tiny.npz"
GOLDEN_CFG = dict(img_size=64, nf=8, ch_mult=(1, 2, 4), res_blocks=1, attn_resolution=16,
                  emb_dim=16, codebook_size=32, dim_embd=32, n_head=4, n_layers=2,
                  connect=(32,))
# the JAX face restorer's stand-in (framewright_tpu/processors/faces.py:268-273)
STAND_IN_CFG = dict(img_size=64, nf=8, ch_mult=(1, 2, 4), res_blocks=1, emb_dim=16,
                    codebook_size=64, dim_embd=32, n_head=4, n_layers=2, connect=(32,))
LSB_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch, tmp_path):
    monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(tmp_path / "default_weights"))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port(tree, n_head):
    tree = {**tree, "n_head": np.asarray(n_head)}
    cfg = cf.config_from_params(tree)
    return cfg, cf.CodeFormer.from_state_dict(cfg, registry.from_jax_params(tree, torch.float32),
                                              "cpu")


@pytest.fixture(scope="module")
def golden_model():
    jcfg = jcf.CodeFormerConfig(**GOLDEN_CFG)
    params = _np_tree(jcf.init(jax.random.PRNGKey(9), jcfg))
    cfg, net = _port(params, 4)
    return jcfg, params, cfg, net


def test_golden(golden_model):
    _, _, cfg, net = golden_model
    assert cfg == cf.CodeFormerConfig(**GOLDEN_CFG)
    with np.load(GOLDEN) as z:
        x, y = z["x"], z["y"]
    with torch.no_grad():
        got = net.apply(torch.from_numpy(x)).numpy()
    assert np.abs(got - y).max() < 2e-4


@pytest.mark.parametrize("w", [0.0, 0.5, 1.0])
def test_apply_matches_jax(golden_model, w):
    jcfg, params, _, net = golden_model
    x = np.random.default_rng(int(w * 10)).random((2, 64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        got = net.apply(torch.from_numpy(x), w).numpy()
    want = np.asarray(jcf.apply(params, jnp.asarray(x), jcfg, w=w))
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert np.abs(got - want).max() < 1e-4


def test_fidelity_weight_moves_the_output(golden_model):
    _, _, _, net = golden_model
    x = torch.from_numpy(np.random.default_rng(3).random((1, 64, 64, 3), dtype=np.float32))
    with torch.no_grad():
        a, b = net.apply(x, 0.0), net.apply(x, 1.0)
    assert (a - b).abs().max() > 1e-3


@pytest.mark.parametrize("which", ["published", "golden", "stand_in"])
def test_block_plans_equal_jax(which):
    kw = {"published": {}, "golden": GOLDEN_CFG, "stand_in": STAND_IN_CFG}[which]
    cfg, jcfg = cf.CodeFormerConfig(**kw), jcf.CodeFormerConfig(**kw)
    assert cf.encoder_plan(cfg) == jcf._encoder_plan(jcfg)
    assert cf.generator_plan(cfg) == jcf._generator_plan(jcfg)
    assert cfg.latent_size == jcfg.latent_size


def test_published_widths():
    """94.1 M parameters at ``CodeFormerConfig()``, sczhou's names, and the
    registry's row."""
    with torch.device("meta"):
        net = cf.CodeFormer(cf.CodeFormerConfig())
    sd = net.state_dict()
    assert sum(p.numel() for p in net.parameters()) == 94_112_707
    for key in ("encoder.blocks.0.weight", "encoder.blocks.1.norm1.weight",
                "quantize.embedding.weight", "position_emb", "feat_emb.weight",
                "ft_layers.8.self_attn.in_proj_weight", "ft_layers.0.self_attn.out_proj.bias",
                "ft_layers.0.linear1.weight", "idx_pred_layer.0.weight",
                "idx_pred_layer.1.weight", "fuse_convs_dict.256.scale.0.weight",
                "fuse_convs_dict.32.encode_enc.conv_out.weight", "generator.blocks.0.weight"):
        assert key in sd, key
    assert tuple(sd["quantize.embedding.weight"].shape) == (1024, 256)
    assert registry.AUX_SPECS["CodeFormer"].arch_config == cf.CodeFormerConfig()


def test_sczhou_key_map_round_trips_through_jax_port(golden_model):
    """The state dict the port loads, in sczhou's names, read back by the
    JAX package's own ``port_codeformer`` (its ``.pth`` key map): the
    same tree as the JAX draw."""
    jcfg, params, cfg, _ = golden_model
    sd = cf.state_dict_from_params(params, cfg)
    back = torch_port.port_codeformer({k: v.numpy() for k, v in sd.items()}, jcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_b[path]))


def test_config_from_params_and_state_dict():
    for kw in ({}, GOLDEN_CFG, STAND_IN_CFG):
        cfg = cf.CodeFormerConfig(**kw)
        tree = cf.init_params(cfg, seed=1)
        assert cf.config_from_params(tree) == cfg
        sd = registry.from_jax_params(tree, torch.float32)
        assert cf.config_from_state_dict(sd, cfg.n_head) == cfg
    jtree = _np_tree(jcf.init(jax.random.PRNGKey(7), jcf.CodeFormerConfig(**STAND_IN_CFG)))
    assert cf.config_from_params(jtree) == cf.CodeFormerConfig(**{**STAND_IN_CFG, "n_head": 8})


def test_npz_and_pth_load_through_the_registry(tmp_path, golden_model):
    """``CodeFormer.npz`` in the JAX layout (its ``fuse`` keyed by
    resolution reads back as a dict: the JAX ``import_npz`` takes the keys
    for list indices and fails) and sczhou's ``CodeFormer.pth``."""
    jcfg, params, cfg, net = golden_model
    registry.write_npz({**params, "n_head": np.asarray(4)}, tmp_path / "a" / "CodeFormer.npz")
    with pytest.raises(KeyError):
        torch_port.import_npz(tmp_path / "a" / "CodeFormer.npz")
    spec, sd, src = registry.load_aux("CodeFormer", tmp_path / "a")
    assert spec.arch_config == cfg and src.endswith("CodeFormer.npz")
    (tmp_path / "b").mkdir()
    torch.save({"params_ema": net.state_dict()}, tmp_path / "b" / "CodeFormer.pth")
    spec_p, sd_p, src_p = registry.load_aux("CodeFormer", tmp_path / "b")
    assert spec_p.arch_config == cf.CodeFormerConfig(**{**GOLDEN_CFG, "n_head": 8})
    assert src_p.endswith("CodeFormer.pth") and set(sd_p) == set(sd)
    for k in sd:
        torch.testing.assert_close(sd_p[k], sd[k], rtol=0, atol=0)
    with pytest.raises(InputError, match="CodeFormer"):
        registry.load_aux("CodeFormer", tmp_path / "empty")


def face_frame(seed: int, h: int = 96, w: int = 128) -> np.ndarray:
    rng = np.random.default_rng(seed)
    f = rng.integers(20, 90, (h, w, 3)).astype(np.int16)
    for _ in range(2):
        bh, bw = rng.integers(18, 30), rng.integers(14, 24)
        y0, x0 = rng.integers(0, h - bh), rng.integers(0, w - bw)
        f[y0:y0 + bh, x0:x0 + bw] = np.array([205, 150, 125]) + rng.integers(-12, 12, (bh, bw, 3))
    return np.clip(f, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("fidelity", [0.0, 0.5, 1.0])
def test_backend_restore_frame_equals_jax(tmp_path, fidelity):
    """The ``codeformer`` backend on a frame with skin regions against the
    JAX backend without a checkpoint (its ``PRNGKey(7)`` stand-in), the
    port reading the same draw as ``CodeFormer.npz``: within 1 LSB on at
    most 0.1% of the values, the same faces restored."""
    jr = jfaces.FaceRestorer(jfaces.FaceRestoreConfig(backend="codeformer",
                                                      fidelity_weight=fidelity))
    frame = face_frame(5)
    jr.setup(*frame.shape[:2])
    registry.write_npz({**_np_tree(jr._params), "n_head": np.asarray(4)},
                       tmp_path / "w" / "CodeFormer.npz")
    port = faces.FaceRestorer(faces.FaceRestoreConfig(
        backend="codeformer", weights_dir=str(tmp_path / "w"), device="cpu",
        fidelity_weight=fidelity))
    port.setup(*frame.shape[:2])
    assert port.config.crop_size == jr.config.crop_size == 64
    got, want = port.restore_frame(frame), jr.restore_frame(frame)
    assert port.result.faces_restored == jr.result.faces_restored >= 1
    assert not np.array_equal(got, frame)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= LSB_SHARE, (d.max(), (d > 0).mean())


def test_restore_config_reads_codeformer(tmp_path):
    cfg = Config(face_restore=True, face_model="codeformer", face_fidelity=0.7,
                 weights_dir=tmp_path)
    assert "CodeFormer" in required_weights(cfg)
    assert face_reserve(cfg, 2160, 3840) == 1_200_000_000
