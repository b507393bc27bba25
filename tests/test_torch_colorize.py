"""Colorization in the port (``models/ddcolor.py``, ``models/colorizer_net.py``,
``processors/colorize.py``) held to the JAX package.

Tolerances: DDColor and ECCV16 against JAX's ``apply`` on the same
parameters within 1e-4 absolute or 1e-3 relative (JAX's own bound for a
network against its twin, ``tests/test_restoration_stack.py``), the golden
``tests/goldens/ddcolor_small.npz`` the same; Lab: the RGB round trip
within 1e-5 of JAX's, the Lab values within 1e-4 (L, a and b span ~100:
one f32 ulp of ``pow(v, 1/3)`` times 500 is ~6e-5, and XLA's CPU ``pow``
rounds ~1.5% of values the other way from torch's). The ``Colorizer``
stream against JAX's on the same nets (JAX's ``PRNGKey(9)`` DDColor and
``PRNGKey(7)`` ECCV16 draws written as the port's ``.npz``): keyframe
decisions equal, the palette and exemplar keyframes (numpy) equal, net
keyframes and propagated frames within 1 LSB on at most 0.1% of values.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framewright_tpu.models import colorizer_net as jcn
from framewright_tpu.models import ddcolor as jdd
from framewright_tpu.processors import colorize as jcol
from framewright_tpu_torch.errors import InputError
from framewright_tpu_torch.models import colorizer_net as pcn
from framewright_tpu_torch.models import ddcolor as pdd
from framewright_tpu_torch.models import layers, registry
from framewright_tpu_torch.processors import colorize as pcol

GOLDEN = Path(__file__).parent / "goldens" / "ddcolor_small.npz"
ECCV_SMALL = jcn.ECCV16Config(width_mult=0.125)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, atol=1e-4, rtol=1e-3):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def dd_params():
    """JAX's restore draw: ``ddcolor.init(PRNGKey(9))`` at the default config."""
    return _np(jdd.init(jax.random.PRNGKey(9), jdd.DDColorConfig()))


@pytest.fixture(scope="module")
def eccv_params():
    """JAX's restore draw: ``colorizer_net.init(PRNGKey(7))`` at width 0.125."""
    return _np(jcn.init(jax.random.PRNGKey(7), ECCV_SMALL))


@pytest.fixture(scope="module")
def weights(tmp_path_factory, dd_params, eccv_params):
    """A weights directory holding JAX's two draws as the port's files."""
    d = tmp_path_factory.mktemp("colorize_weights")
    registry.write_npz(dd_params, d / "ddcolor.npz")
    registry.write_npz(eccv_params, d / "eccv16.npz")
    return d


# -- the networks ----------------------------------------------------------------

def test_ddcolor_golden():
    with np.load(GOLDEN) as z:
        x, y = z["x"], z["y"]
    p = _np(jdd.init(jax.random.PRNGKey(4), jdd.DDColorConfig()))
    got = pdd.apply(layers.tree_to_torch(p, "cpu"), torch.from_numpy(x),
                    pdd.config_from_params(p)).numpy()
    _close(got, y)


@pytest.mark.parametrize("hw", [(32, 32), (64, 96)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_ddcolor_matches_jax(dd_params, hw):
    x = np.random.default_rng(hw[1]).random((2, *hw, 1), dtype=np.float32) * 100.0
    want = np.asarray(jdd.apply(dd_params, jnp.asarray(x), jdd.DDColorConfig()))
    got = pdd.apply(layers.tree_to_torch(dd_params, "cpu"), torch.from_numpy(x),
                    pdd.config_from_params(dd_params)).numpy()
    assert got.shape == (2, *hw, 2)
    _close(got, want)


@pytest.mark.parametrize("hw", [(32, 32), (48, 64)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_eccv16_matches_jax(eccv_params, hw):
    x = np.random.default_rng(hw[0]).random((1, *hw, 1), dtype=np.float32) * 100.0
    want = np.asarray(jcn.apply(eccv_params, jnp.asarray(x), ECCV_SMALL))
    got = pcn.apply(layers.tree_to_torch(eccv_params, "cpu"), torch.from_numpy(x),
                    pcn.config_from_params(eccv_params)).numpy()
    assert got.shape == (1, *hw, 2)
    _close(got, want)


def test_lab_round_trip_matches_jax():
    rgb = np.random.default_rng(2).random((3, 17, 23, 3), dtype=np.float32)
    rgb[0, 0, :4] = np.float32([[0.0], [1.0], [0.04045], [0.0031308]])   # branch points
    lab_j = np.asarray(jcn.rgb_to_lab(jnp.asarray(rgb)))
    lab_p = pcn.rgb_to_lab(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(lab_p, lab_j, atol=1e-4, rtol=0)
    back_j = np.asarray(jcn.lab_to_rgb(jnp.asarray(lab_j)))
    back_p = pcn.lab_to_rgb(torch.from_numpy(lab_p)).numpy()
    np.testing.assert_allclose(back_p, back_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(back_p, rgb, atol=1e-4, rtol=0)


def test_configs_inferred_from_shapes():
    """Both DDColor configs and both ECCV16 widths from the arrays' shapes;
    the seeded inits have JAX's shapes."""
    for jcfg, pcfg in ((jdd.large_config(), pdd.large_config()),
                       (jdd.DDColorConfig(), pdd.DDColorConfig())):
        assert vars(pcfg) == vars(jcfg)
        shapes = jax.eval_shape(lambda k, c=jcfg: jdd.init(k, c), jax.random.PRNGKey(0))
        mine = pdd.init_params(pcfg, 0)
        assert (jax.tree_util.tree_map(np.shape, mine)
                == jax.tree_util.tree_map(lambda a: a.shape, shapes))
        assert pdd.config_from_params(shapes) == pcfg
    for m in (1.0, 0.125):
        shapes = jax.eval_shape(lambda k, m=m: jcn.init(k, jcn.ECCV16Config(m)),
                                jax.random.PRNGKey(0))
        mine = pcn.init_params(pcn.ECCV16Config(m), 0)
        assert (jax.tree_util.tree_map(np.shape, mine)
                == jax.tree_util.tree_map(lambda a: a.shape, shapes))
        assert pcn.config_from_params(shapes) == pcn.ECCV16Config(m)


# -- the colorizer ----------------------------------------------------------------

def grey_clip(n: int = 10, h: int = 40, w: int = 56, cut: int = 6) -> list:
    """A panning grey texture with a scene cut at ``cut``."""
    rng = np.random.default_rng(11)
    tex = rng.random((h, w + 4 * n)) * 200 + 20
    for _ in range(3):
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3
    out = []
    for t in range(n):
        g = tex[:, 2 * t:2 * t + w] if t < cut else 255 - tex[:, t:t + w]
        out.append(np.repeat(g[..., None], 3, -1).astype(np.uint8))
    return out


def _lsb(got, want, share=1e-3):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= share, (d.max(), (d > 0).mean())


def _keys(col, clip, monkeypatch):
    """The keyframe decisions of a colourizer over ``clip``."""
    keys = []
    orig = type(col)._colorize_keyframe

    def spy(self, f):
        keys.append(len(seen))
        return orig(self, f)

    seen = []
    monkeypatch.setattr(type(col), "_colorize_keyframe", spy)
    out = []
    for f in col.colorize_stream(iter(clip)):
        out.append(f)
        seen.append(f)
    monkeypatch.undo()
    return out, keys


def _jax_propagated_float(jc, prev_col, g_prev, g_cur) -> np.ndarray:
    """JAX's propagated frame before its truncating ``astype(np.uint8)``."""
    from framewright_tpu.ops.warp import flow_warp

    flow = jc._flow_fn(jc._flow_params, jnp.asarray(g_cur[None] / np.float32(255)),
                       jnp.asarray(g_prev[None] / np.float32(255)))
    warped = np.asarray(flow_warp(jnp.asarray(prev_col[None].astype(np.float32)), flow))[0]
    y, _, _ = jcol.rgb_to_ycbcr(g_cur.astype(np.float32))
    _, cb, cr = jcol.rgb_to_ycbcr(warped)
    return jcol.ycbcr_to_rgb(y, cb, cr)


@pytest.mark.parametrize("method", ["palette", "exemplar", "eccv16", "ddcolor"])
def test_colorizer_stream_matches_jax(method, weights, monkeypatch):
    """The stream against JAX's: keyframe decisions equal; palette and
    exemplar keyframes equal, net keyframes within 1 LSB on <= 0.1%; each
    propagation step from JAX's previous frame within 1 LSB, the values
    that differ on <= 0.1% of those JAX puts at least 1e-3 from an integer
    (its truncation turns a 1e-4 difference in the warp into 1 LSB at the
    others). The untrained ECCV16 draw's keyframes are grey (chroma < 0.1
    LSB), so each propagated value sits on an integer and the whole stream
    differs by 1 LSB on up to ~20% of values (measured 7-18%); the other
    methods' streams hold 1 LSB on <= 0.1%."""
    clip = grey_clip()
    ref = np.random.default_rng(3).integers(0, 256, (24, 32, 3), dtype=np.uint8)
    kw = dict(method=method, keyframe_interval=3, saturation=0.7,
              reference_image=ref if method == "exemplar" else None)
    jc = jcol.Colorizer(jcol.ColorizeConfig(**kw))
    pc = pcol.Colorizer(pcol.ColorizeConfig(weights_dir=str(weights), device="cpu", **kw))
    want, jkeys = _keys(jc, clip, monkeypatch)
    got, pkeys = _keys(pc, clip, monkeypatch)
    assert pkeys == jkeys and 6 in pkeys and len(pkeys) >= 3      # the interval, the cut
    assert len(got) == len(clip)
    grey = method == "eccv16"
    for i, (g, w) in enumerate(zip(got, want)):
        if i in pkeys:
            if method in ("palette", "exemplar"):
                np.testing.assert_array_equal(g, w)
            else:
                _lsb(g, w)
            assert (np.ptp(w.astype(int), axis=-1).max() <= 1) == grey
            continue
        _lsb(g, w, share=0.25 if grey else 1e-3)
        step = pc._propagate(want[i - 1], clip[i - 1], clip[i])
        r = _jax_propagated_float(jc, want[i - 1], clip[i - 1], clip[i])
        np.testing.assert_array_equal(w, r.astype(np.uint8))
        d = np.abs(step.astype(np.int16) - w)
        assert d.max() <= 1
        far = np.abs(r - np.round(r)) >= 1e-3
        assert np.count_nonzero(d[far]) <= 1e-3 * max(1, np.count_nonzero(far))


def test_propagation_equals_jax_numpy_around_the_warp(weights):
    """The propagated frame is JAX's numpy around the port's warp."""
    clip = grey_clip()
    pc = pcol.Colorizer(pcol.ColorizeConfig(device="cpu"))
    pc.setup()
    col = pc._colorize_keyframe(clip[0])
    warped = pc._warp_previous(col, clip[0], clip[1])
    y, _, _ = jcol.rgb_to_ycbcr(clip[1].astype(np.float32))
    _, cb, cr = jcol.rgb_to_ycbcr(warped)
    np.testing.assert_array_equal(pc._propagate(col, clip[0], clip[1]),
                                  jcol.ycbcr_to_rgb(y, cb, cr).astype(np.uint8))


@pytest.mark.parametrize("method", ["eccv16", "ddcolor"])
def test_missing_checkpoint_raises_before_compute(method, tmp_path):
    pc = pcol.Colorizer(pcol.ColorizeConfig(method=method, weights_dir=str(tmp_path),
                                            device="cpu"))
    with pytest.raises(InputError, match=f"{method}.npz"):
        next(pc.colorize_stream(iter(grey_clip(2))))
    assert pc.flow_net is None
