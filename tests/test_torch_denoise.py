"""The port's temporal denoiser on the CPU against the JAX package's:
the flow warp, the bilinear resize and transposed conv, the alignment
IFNet (and its weights file against ``ifnet.init(PRNGKey(1))``), the
packaged ``FW_nafnet_dn``, the noise profile, the scene scores, the
median of the blend, and ``TemporalDenoiser`` per method on a small
clip with a scene cut. Inputs from seeded numpy; weights carried across
with ``from_jax_params`` (or read from the same files)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framewright_tpu.models import ifnet as jifnet
from framewright_tpu.models import layers as jlayers
from framewright_tpu.models import nafnet as jnafnet
from framewright_tpu.models import registry as jregistry
from framewright_tpu.ops import warp as jwarp
from framewright_tpu.processors import noise_profiler as jnp_prof
from framewright_tpu.processors import scene_detection as jscene
from framewright_tpu.processors import temporal_denoise as jtd
from framewright_tpu_torch.errors import ConfigError, InputError
from framewright_tpu_torch.models import layers, registry
from framewright_tpu_torch.models.ifnet import ALIGN_ARCH, ConvTranspose4x2, IFNet
from framewright_tpu_torch.models.nafnet import NAFNet
from framewright_tpu_torch.ops import warp
from framewright_tpu_torch.processors import noise_profiler, scene_detection
from framewright_tpu_torch.processors import temporal_denoise as td


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def noisy_clip(n=12, h=40, w=56, seed=3, noise=8.0, cut=6):
    """A coarse texture panning right by a pixel a frame, with seeded
    noise, and a different texture from frame ``cut`` on (a scene cut)."""
    rng = np.random.default_rng(seed)
    a, b = (rng.random((h // 4 + 1, w // 4 + 1, 3)) for _ in range(2))
    frames = []
    for t in range(n):
        big = np.repeat(np.repeat(a if t < cut else b, 4, 0), 4, 1)[:h, :w]
        big = np.roll(big, t, axis=1)
        frames.append(np.clip(big * 255 + rng.normal(0, noise, big.shape), 0, 255)
                      .astype(np.uint8))
    return frames


# -- warp, resize, transposed conv -----------------------------------------

@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_flow_warp_matches_jax(mode):
    """Flows up to +-3 frame sides, so many samples fall outside the
    frame. Tolerance 1e-5 absolute (values in [0, 1])."""
    rng = np.random.default_rng(0)
    img = rng.random((2, 9, 11, 3), dtype=np.float32)
    flow = rng.normal(0, 12.0, (2, 9, 11, 2)).astype(np.float32)
    want = np.asarray(jwarp.flow_warp(jnp.asarray(img), jnp.asarray(flow), mode))
    got = warp.flow_warp(_t(img), _t(flow), mode).numpy()
    assert (np.abs(flow) > 11).any()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_grid_sample_is_torch_border_sampling():
    """The JAX gather (both neighbours clipped from the unclipped floor)
    equals ``F.grid_sample(padding_mode="border", align_corners=True)``,
    which the port calls, on coordinates well outside [-1, 1]."""
    rng = np.random.default_rng(1)
    img = rng.random((2, 7, 10, 3), dtype=np.float32)
    grid = rng.uniform(-2.0, 2.0, (2, 6, 5, 2)).astype(np.float32)
    want = np.asarray(jwarp.grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    np.testing.assert_allclose(warp.grid_sample(_t(img), _t(grid)).numpy(), want,
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("out_hw", [(4, 5), (3, 22), (20, 31), (36, 44)])
def test_resize_bilinear_matches_jax(out_hw):
    """Down (the JAX gather), up (``jax.image.resize(linear)``) and mixed;
    tolerance 1e-6."""
    img = np.random.default_rng(2).random((2, 9, 11, 3), dtype=np.float32)
    want = np.asarray(jlayers.resize_bilinear(jnp.asarray(img), out_hw))
    np.testing.assert_allclose(layers.resize_bilinear(_t(img), out_hw).numpy(), want,
                               atol=1e-6, rtol=0)


def test_conv2d_transpose_matches_jax():
    """Kernel 4, stride 2, padding 1 (IFNet's head); HWIO ->
    ``transpose(2, 3, 0, 1)``. Tolerance 1e-5."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 9, 11, 6), dtype=np.float32)
    w = rng.normal(0, 0.2, (4, 4, 6, 5)).astype(np.float32)
    b = rng.normal(0, 0.2, 5).astype(np.float32)
    want = np.asarray(jlayers.conv2d_transpose({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                               jnp.asarray(x), stride=2, kernel=4, pad=1))
    got = layers.conv2d_transpose(_t(x), _t(w.transpose(2, 3, 0, 1)), _t(b)).numpy()
    assert got.shape == want.shape == (2, 18, 22, 5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # IFNet's head computes it as a 3x3 conv to the four phases (a forward
    # conv: the same sums on every run on the card)
    head = ConvTranspose4x2(6, 5)
    head.load_state_dict({"weight": _t(w.transpose(2, 3, 0, 1)), "bias": _t(b)})
    with torch.no_grad():
        phased = head(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(phased, want, atol=1e-5, rtol=0)


# -- the flow net -----------------------------------------------------------

@pytest.fixture(scope="module")
def align_params():
    return jifnet.init(jax.random.PRNGKey(1), jifnet.IFNetConfig(
        channels=(96, 64), scales=(4, 2), num_res_convs=4))


def test_align_ifnet_file_is_jax_init_key1(align_params):
    """``models/weights/align_ifnet_key1.npz`` holds exactly the JAX
    denoiser's ``ifnet.init(PRNGKey(1), ...)``: float32, bit for bit."""
    got = registry.read_npz(registry.ALIGN_IFNET_NPZ)
    want = jax.tree_util.tree_map(np.asarray, align_params)
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    flat_want, tree_want = jax.tree_util.tree_flatten(want)
    assert tree_got == tree_want and len(flat_got) == 40
    assert sum(a.size for a in flat_got) == 608_864
    for a, b in zip(flat_got, flat_want):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    # the tree loads into the module under the Practical-RIFE names
    sd = registry.from_jax_params(got, torch.float32)
    assert sd["block0.lastconv.0.weight"].shape == (96, 24, 4, 4)    # (in, out, kh, kw)
    assert sd["block1.conv0.0.1.weight"].shape == (32,)              # PReLU
    IFNet.from_state_dict(ALIGN_ARCH, sd, "cpu")                     # strict


def test_estimate_flow_matches_jax(align_params):
    """The alignment arch on 2x50x70 (edge-padded to 64x96, cropped back),
    img1 a shifted, rescaled img0. Tolerance 1e-5 px; also the frame
    interpolation (``interpolate_padded``) within 1e-5."""
    rng = np.random.default_rng(4)
    a = rng.random((2, 50, 70, 3), dtype=np.float32)
    b = np.roll(a, 2, axis=2) * 0.9 + 0.05
    net = registry.load_align_ifnet("cpu")
    want = np.asarray(jifnet.estimate_flow(align_params, jnp.asarray(a), jnp.asarray(b),
                                           jifnet.IFNetConfig(channels=(96, 64),
                                                              scales=(4, 2),
                                                              num_res_convs=4)))
    got = net.estimate_flow(_t(a), _t(b)).numpy()
    assert got.shape == (2, 50, 70, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    want_i = np.asarray(jifnet.interpolate_padded(
        align_params, jnp.asarray(a), jnp.asarray(b), 0.5,
        jifnet.IFNetConfig(channels=(96, 64), scales=(4, 2), num_res_convs=4)))
    np.testing.assert_allclose(net.interpolate_padded(_t(a), _t(b)).numpy(), want_i,
                               atol=1e-5, rtol=0)


# -- the denoiser's NAFNet ---------------------------------------------------------

def test_fw_nafnet_dn_matches_jax():
    """The packaged checkpoint through both ``apply_padded`` on 1x30x44
    (reflect-padded to 32x48). Tolerance 1e-5."""
    spec, params = jregistry.init_model("FW_nafnet_dn", allow_random=False)
    pspec, sd, source = registry.load_weights("FW_nafnet_dn")
    assert pspec.arch_config.__dict__ == spec.arch_config.__dict__
    assert source.endswith("framewright_tpu/models/weights/FW_nafnet_dn.npz")
    x = np.random.default_rng(5).random((1, 30, 44, 3), dtype=np.float32)
    want = np.asarray(jnafnet.apply_padded(params, jnp.asarray(x), spec.arch_config))
    got = NAFNet.from_state_dict(pspec.arch_config, sd, "cpu").apply_padded(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_missing_checkpoints_raise_input_error(tmp_path, monkeypatch):
    """No random NAFNet and no random flow net: a missing or unreadable
    file is an ``InputError`` (the JAX denoiser falls back to a random
    NAFNet)."""
    monkeypatch.setattr(registry, "packaged_weights_dir", lambda: tmp_path / "none")
    with pytest.raises(InputError):
        registry.load_weights("FW_nafnet_dn", tmp_path, allow_random=True)
    bad = tmp_path / "FW_nafnet_dn.npz"
    bad.write_bytes(b"not a zip")
    with pytest.raises(InputError, match="unreadable"):
        registry.load_weights("FW_nafnet_dn", tmp_path)
    dn = td.TemporalDenoiser(td.TemporalDenoiseConfig(method="nafnet", device="cpu",
                                                      weights_dir=str(tmp_path / "x")))
    with pytest.raises(InputError):
        dn.setup(8, 8)
    monkeypatch.setattr(registry, "ALIGN_IFNET_NPZ", tmp_path / "missing.npz")
    with pytest.raises(InputError, match="alignment"):
        td.TemporalDenoiser(td.TemporalDenoiseConfig(method="temporal",
                                                     device="cpu")).setup(8, 8)


# -- the host parts: profile, scene scores -----------------------------------------

def _base(h=128, w=160):
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    g = 60 + 80 * (xx / w) + 40 * (yy / h)
    g += 50 * np.exp(-(((xx - w * 0.6) / 20) ** 2 + ((yy - h * 0.4) / 15) ** 2))
    return np.clip(np.stack([g, g * 0.9 + 10, g * 1.05], -1), 0, 255)


def _salt(f, rng):
    m = rng.random(f.shape[:2]) < 0.01
    f[m] = rng.choice([0.0, 255.0], size=int(m.sum()))[:, None]
    return f


def _blocky(f, rng):
    h, w = f.shape[:2]
    blocks = f.reshape(h // 8, 8, w // 8, 8, 3).mean((1, 3))
    return np.repeat(np.repeat(blocks, 8, 0), 8, 1) + rng.normal(0, 3.0, f.shape[:2])[..., None]


_PATTERN = np.random.default_rng(9).normal(0, 7.0, (128, 160, 1))
NOISES = {
    "clean": lambda f, rng: f,
    "iid": lambda f, rng: f + rng.normal(0, 10.0, f.shape[:2])[..., None],
    "salt_pepper": _salt,
    "chroma": lambda f, rng: f + np.stack([-0.2, 0.0, 2.0])
                             * rng.normal(0, 12.0, f.shape[:2])[..., None],
    "fixed_pattern": lambda f, rng: f + _PATTERN,
    "blocky": _blocky,
}


def test_noise_profile_equals_jax():
    """``NoiseProfile.to_dict()`` equal to the JAX profiler's on clips
    built to reach every recommended denoiser the auto mode can pick."""
    picks = set()
    for name, fn in NOISES.items():
        rng = np.random.default_rng(1)
        clip = [np.clip(fn(_base(), rng), 0, 255).astype(np.uint8) for _ in range(8)]
        want = jnp_prof.NoiseProfiler(sample_frames=8).analyze_frames(clip).to_dict()
        got = noise_profiler.NoiseProfiler(sample_frames=8).analyze_frames(clip).to_dict()
        assert got == want, name
        picks.add(got["recommended_denoiser"])
    assert picks == {"none", "temporal", "nafnet", "bilateral"}


def test_frame_pair_scores_equal_jax():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, (3, 24, 32, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-40, 40, a.shape), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(scene_detection.frame_pair_scores(a, b),
                                  jscene.frame_pair_scores(a, b))


# -- the blend's median ------------------------------------------------------------

@pytest.mark.parametrize("n", [6 * 7 * 5, 5 * 7 * 5, 2, 1])
def test_nanmedian_is_jax_nanmedian(n):
    """Even counts average the two middle values (``torch.nanmedian``
    would return the lower one); odd counts take the middle one. The
    JAX form: NaN-masked padding slots; the port: the real slots only.
    Exact."""
    rng = np.random.default_rng(n)
    v = rng.random(n).astype(np.float32)
    padded = np.concatenate([v, np.full(7, np.nan, np.float32)])
    want = float(jnp.nanmedian(jnp.asarray(padded)))
    assert float(td.nanmedian(_t(v))) == want
    if n % 2 == 0 and n > 2:
        assert want != float(torch.nanmedian(_t(v)))


# -- the denoiser -----------------------------------------------------------------

@pytest.fixture(scope="module")
def clip():
    return noisy_clip()


@pytest.mark.parametrize("method", ["temporal", "nafnet", "bilateral", "auto", "none"])
def test_denoiser_matches_jax(clip, method):
    """12 frames of 40x56 with a cut at frame 6 (one scene reset), window
    7. uint8 frames within 1 LSB of the JAX denoiser's on at most 0.1% of
    the values (measured: 1 LSB on 0.0012% for the flow-aligned methods,
    none for bilateral); ``frames``, ``scene_resets`` and the ``auto``
    profile equal."""
    jd = jtd.TemporalDenoiser(jtd.TemporalDenoiseConfig(method=method))
    jd.setup(40, 56)
    want = np.stack(list(jd.denoise_stream(iter(clip))))
    dn = td.TemporalDenoiser(td.TemporalDenoiseConfig(method=method, device="cpu"))
    dn.setup(40, 56)
    got = np.stack(list(dn.denoise_stream(iter(clip))))
    assert got.shape == want.shape == (12, 40, 56, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())
    assert (dn.result.frames, dn.result.scene_resets) == (jd.result.frames,
                                                         jd.result.scene_resets)
    assert (dn.result.frames, dn.result.scene_resets) == (12, int(method != "none"))
    assert dn.result.profile == jd.result.profile
    assert (dn.result.profile is not None) == (method == "auto")
    if method != "none":
        assert not np.array_equal(got, np.stack(clip))


def test_refused_methods():
    with pytest.raises(ConfigError, match="A6"):
        td.TemporalDenoiser(td.TemporalDenoiseConfig(method="restormer", device="cpu"))
    with pytest.raises(ConfigError, match="A6"):
        td.TemporalDenoiser(td.TemporalDenoiseConfig(flow_model="raft", device="cpu"))
