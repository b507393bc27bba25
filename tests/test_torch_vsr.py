"""Video SR in the port (``models/vsr.py`` BasicVSR, ``models/tvsr.py``,
``processors/video_sr.py``, the restorer's ``vsr`` branch) held to the
JAX package.

Tolerances: the goldens ``tests/goldens/basicvsr_tiny.npz`` and
``tvsr_tiny.npz`` within 2e-4 (``tests/test_goldens.py``); BasicVSR's
``apply`` against JAX's within 1e-2 (``tests/test_vsr.py``), TVSR's within
2e-3 of the output's largest magnitude (``tests/test_tvsr.py``); the port
of mmediting's state dict equal to ``torch_port.port_basicvsr``'s; the
processors' uint8 frames (float32) within 1 LSB on at most 0.1% of the
values. A resumed restore equals a straight one byte for byte, which the
JAX processor's resume does not (its carry restarts from copies of the
first resumed frame).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from framewright_tpu.io import y4m as jy4m
from framewright_tpu.models import registry as jregistry
from framewright_tpu.models import torch_port
from framewright_tpu.models import tvsr as jt
from framewright_tpu.models import vsr as jv
from framewright_tpu.processors.video_sr import VideoSuperResolution as JaxVSR
from framewright_tpu.processors.video_sr import VSRConfig as JaxVSRConfig
from framewright_tpu_torch import planner
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import HBMError
from framewright_tpu_torch.models import layers, registry
from framewright_tpu_torch.models import tvsr as pt
from framewright_tpu_torch.models import vsr as pv
from framewright_tpu_torch.processors.video_sr import VideoSuperResolution, VSRConfig
from framewright_tpu_torch.restorer import VideoRestorer, build_sr

from test_manifests import load_manifest, synth_sd

GOLDENS = Path(__file__).parent / "goldens"
VSR_TINY = dict(mid_channels=8, num_blocks=2, spynet_levels=3)
TVSR_TINY = dict(dim=32, depth=2, window=8, scale=4)
_jv_init = jax.jit(jv.init, static_argnums=(1,))
_jt_init = jax.jit(jt.init, static_argnums=(1,))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _frames(n, h, w, seed=0):
    """A smooth texture panning a pixel a frame, with seeded noise."""
    rng = np.random.default_rng(seed)
    tex = rng.random((h // 4 + 2, (w + n) // 4 + 2, 3))
    big = np.repeat(np.repeat(tex, 4, 0), 4, 1)
    return np.stack([np.clip(big[:h, t:t + w] * 255 + rng.normal(0, 4, (h, w, 3)), 0, 255)
                     for t in range(n)]).astype(np.uint8)


# -- the models -----------------------------------------------------------------

@pytest.fixture(scope="module")
def basicvsr():
    params = _np(_jv_init(jax.random.PRNGKey(11), jv.BasicVSRConfig(**VSR_TINY)))
    return params, layers.tree_to_torch(registry.from_jax_params(params), "cpu")


@pytest.fixture(scope="module")
def tvsr():
    params = _np(_jt_init(jax.random.PRNGKey(3), jt.TVSRConfig(**TVSR_TINY)))
    return params, layers.tree_to_torch(registry.from_jax_params(params), "cpu")


@pytest.mark.parametrize("name", ["basicvsr", "tvsr"])
def test_goldens(request, name):
    _, p = request.getfixturevalue(name)
    with np.load(GOLDENS / f"{name}_tiny.npz") as z:
        x, y = z["x"], z["y"]
    if name == "basicvsr":
        got = pv.apply(p, torch.from_numpy(x), pv.BasicVSRConfig(**VSR_TINY)).numpy()
    else:
        got = pt.apply(p, torch.from_numpy(x), pt.TVSRConfig(**TVSR_TINY)).numpy()
    assert np.abs(got - y).max() < 2e-4


def test_basicvsr_matches_jax(basicvsr):
    params, p = basicvsr
    x = np.random.default_rng(0).random((1, 3, 32, 32, 3), dtype=np.float32)
    cfg = jv.BasicVSRConfig(**VSR_TINY)
    want = np.asarray(jax.jit(lambda q, v: jv.apply(q, v, cfg))(params, x))
    got = pv.apply(p, torch.from_numpy(x), pv.BasicVSRConfig(**VSR_TINY)).numpy()
    assert got.shape == want.shape == (1, 3, 128, 128, 3)
    assert np.abs(got - want).max() < 1e-2


@pytest.mark.parametrize("chunk", [256, 5])
def test_tvsr_matches_jax(tvsr, chunk, monkeypatch):
    """Two frames of 32x40, shifted windows with the mask tiled across the
    frames; the attention in chunks of 5 windows gives the same values."""
    monkeypatch.setattr(pt, "_WINDOW_CHUNK", chunk)
    params, p = tvsr
    x = np.random.default_rng(1).random((1, 2, 32, 40, 3), dtype=np.float32)
    cfg = jt.TVSRConfig(**TVSR_TINY)
    want = np.asarray(jax.jit(lambda q, v: jt.apply(q, v, cfg))(params, x))
    got = pt.apply(p, torch.from_numpy(x), pt.TVSRConfig(**TVSR_TINY)).numpy()
    assert got.shape == want.shape == (1, 2, 128, 160, 3)
    assert np.abs(got - want).max() / (np.abs(want).max() + 1e-6) < 2e-3


def test_port_state_dict_equals_jax_port_basicvsr(tmp_path):
    keys, _ = load_manifest("basicvsr_reds4")
    sd = synth_sd(keys)
    want = torch_port.port_basicvsr(sd)
    got = pv.port_state_dict({"generator." + k: torch.from_numpy(v) for k, v in sd.items()})
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "BasicVSR.pth")
    _, tree, src = registry.load_params("BasicVSR", tmp_path)
    assert src.endswith("BasicVSR.pth")
    np.testing.assert_array_equal(tree["forward"]["conv2"]["w"], want["forward"]["conv2"]["w"])


@pytest.mark.parametrize("name", ["BasicVSR", "TVSR_x4"])
def test_registry_rows_and_init_shapes(name):
    """JAX's scale, url and widths; JAX's family ``vsr`` is a family a
    model in the port (``basicvsr``, ``tvsr``), whose module runs it."""
    ours, theirs = registry.get_model(name), jregistry.get_model(name)
    assert (ours.scale, ours.url) == (theirs.scale, theirs.url) and theirs.family == "vsr"
    assert ours.family in registry.VSR_FAMILIES
    assert dataclasses.asdict(ours.arch_config) == dataclasses.asdict(theirs.arch_config)
    mod, jmod = (pv, jv) if name == "BasicVSR" else (pt, jt)
    assert registry.TREE_MODULES[ours.family] is mod
    mine = mod.init_params(ours.arch_config, seed=2)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), theirs.arch_config))
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(shapes)
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(shapes)):
        assert a.shape == b.shape and a.dtype == np.float32


# -- the processor ----------------------------------------------------------------

@pytest.fixture
def tiny_rows(tmp_path, monkeypatch):
    """The vsr rows at tiny widths in both registries, their weights one
    JAX draw each, written as <name>.npz."""
    for name, jcfg, pcfg, init in (
            ("BasicVSR", jv.BasicVSRConfig(**VSR_TINY), pv.BasicVSRConfig(**VSR_TINY),
             _jv_init),
            ("TVSR_x4", jt.TVSRConfig(**TVSR_TINY), pt.TVSRConfig(**TVSR_TINY), _jt_init)):
        monkeypatch.setitem(jregistry.MODEL_SPECS, name, dataclasses.replace(
            jregistry.MODEL_SPECS[name], arch_config=jcfg))
        monkeypatch.setitem(registry.MODEL_SPECS, name, dataclasses.replace(
            registry.MODEL_SPECS[name], arch_config=pcfg))
        torch_port.export_npz(init(jax.random.PRNGKey(7), jcfg), tmp_path / f"{name}.npz")
    return tmp_path


@pytest.mark.parametrize("name", ["BasicVSR", "TVSR_x4"])
def test_processor_matches_jax(tiny_rows, name):
    """float32, 10 frames of 20x28 (padded to 32x32) in batches of 4, 4
    and 2 (chunk 4, overlap 2): the carry across batches, the short last
    window padded with its last frame."""
    frames = _frames(10, 20, 28)
    jsr = JaxVSR(JaxVSRConfig(model_name=name, chunk=4, compute_dtype="float32",
                              weights_dir=str(tiny_rows)))
    jsr.setup(20, 28)
    want = np.concatenate([jsr.process_batch(frames[i:i + 4]) for i in range(0, 10, 4)])
    sr = VideoSuperResolution(VSRConfig(model_name=name, chunk=4, compute_dtype="float32",
                                        weights_dir=str(tiny_rows), device="cpu"))
    sr.setup(20, 28)
    assert sr.weights_source.endswith(f"{name}.npz") and sr.plan.frames == 4
    got = np.concatenate([sr.materialize(sr.dispatch(frames[i:i + 4]))
                          for i in range(0, 10, 4)])
    assert got.shape == want.shape == (10, 80, 112, 3) and sr.dispatches == 3
    d = np.abs(got.astype(np.int16) - want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())
    # a batch over the chunk runs in slices, with the same carry
    sr.setup(20, 28)
    np.testing.assert_array_equal(sr.process_batch(frames[:8]), got[:8])


def test_seeded_context_resumes_like_a_straight_run_and_jax_does_not(tiny_rows):
    """A processor seeded with the 2 frames before frame 4 gives frames
    4.. of a straight run; the JAX processor, resumed at 4, carries copies
    of frame 4 and differs."""
    frames = _frames(10, 20, 28, seed=4)
    sr = VideoSuperResolution(VSRConfig(chunk=4, compute_dtype="float32", device="cpu",
                                        weights_dir=str(tiny_rows)))
    sr.setup(20, 28)
    straight = np.concatenate([sr.process_batch(frames[i:i + 4]) for i in range(0, 10, 4)])
    sr.setup(20, 28)
    sr.seed_context(list(frames[2:4]))
    resumed = np.concatenate([sr.process_batch(frames[i:i + 4]) for i in (4, 8)])
    np.testing.assert_array_equal(resumed, straight[4:])
    # chunk 1, resumed at 1 < overlap: the carry is frame 0 twice
    one = _fresh(tiny_rows, 1)
    straight1 = np.concatenate([one.process_batch(frames[i:i + 1]) for i in range(4)])
    one = _fresh(tiny_rows, 1)
    one.seed_context(list(frames[:1]))
    np.testing.assert_array_equal(
        np.concatenate([one.process_batch(frames[i:i + 1]) for i in range(1, 4)]),
        straight1[1:])
    jsr = JaxVSR(JaxVSRConfig(chunk=4, compute_dtype="float32", weights_dir=str(tiny_rows)))
    jsr.setup(20, 28)
    jres = np.concatenate([jsr.process_batch(frames[i:i + 4]) for i in (4, 8)])
    assert not np.array_equal(jres, straight[4:])


def _fresh(wdir, chunk):
    sr = VideoSuperResolution(VSRConfig(chunk=chunk, compute_dtype="float32", device="cpu",
                                        weights_dir=str(wdir)))
    sr.setup(20, 28)
    return sr


def test_planner_window_bytes():
    """Keyed by the registry's family of each row."""
    assert [registry.get_model(n).family for n in ("BasicVSR", "TVSR_x4")] == ["basicvsr", "tvsr"]
    b = planner.vsr_bytes(540, 960, 10, "basicvsr")
    assert b == 544 * 960 * (560 * 10 + max(1700 * 9, 6000))
    assert planner.vsr_bytes(540, 960, 10, "basicvsr", "float32") == 2 * b
    assert planner.vsr_bytes(540, 960, 10, "tvsr") == 544 * 960 * (1500 * 10 + 11300)


# -- the restorer's vsr branch ------------------------------------------------------

def _clip(path: Path, frames) -> Path:
    with jy4m.Y4MWriter(path, frames.shape[2], frames.shape[1], fps=12) as w:
        for f in frames:
            w.write_frame(f)
    return path


class _Stop(Exception):
    pass


def _restore(cfg, src, out, progress=None):
    with contextlib.redirect_stdout(io.StringIO()):
        return VideoRestorer(cfg, progress).restore_video(src, out)


def _cfg(tmp_path, wdir, **kw):
    return Config(sr_model="BasicVSR", scale_factor=4, device_platform="cpu", batch_size=4,
                  compute_dtype="float32", weights_dir=wdir, project_dir=tmp_path / "proj",
                  **kw)


def test_restore_resumes_to_the_straight_output(tmp_path, tiny_rows):
    """A BasicVSR restore (chunk 4, overlap 2) stopped after its first
    chunk and rerun: it resumes at frame 4 with frames 2 and 3 as the
    carry, and the output equals a straight run's byte for byte; the
    restorer passes ``weights_dir`` (the JAX restorer does not)."""
    src = _clip(tmp_path / "c.y4m", _frames(10, 20, 28, seed=9))
    cfg = _cfg(tmp_path / "s", tiny_rows)
    sr = build_sr(cfg)
    assert isinstance(sr, VideoSuperResolution)
    assert (sr.config.weights_dir, sr.config.chunk) == (str(tiny_rows), 4)
    res = _restore(cfg, src, tmp_path / "straight.y4m")
    assert res.frames_out == 10 and res.batches == 3 and res.errors == 0
    straight = (tmp_path / "straight.y4m").read_bytes()

    def stop(info):
        if info.frames_done >= 4:
            raise _Stop()

    out = tmp_path / "o.y4m"
    with pytest.raises(_Stop):
        _restore(_cfg(tmp_path, tiny_rows), src, out, stop)
    res = _restore(_cfg(tmp_path, tiny_rows), src, out)
    assert res.resumed_from == 4 and res.frames_out == 10 and res.batches == 2
    assert out.read_bytes() == straight


def test_window_is_held_against_the_reserve(tmp_path, tiny_rows):
    """``build_sr`` hands the restore's reserve and utilization to the
    video SR processor, whose window must fit beside the reserve: at a
    reserve that leaves less than the window, ``setup`` raises
    ``HBMError`` (the chunk stays: the output depends on it)."""
    cfg = _cfg(tmp_path, tiny_rows, hbm_utilization=0.5)
    sr = build_sr(cfg, 12345)
    assert (sr.config.reserved_bytes, sr.config.hbm_utilization) == (12345, 0.5)
    sr.setup(20, 28)
    budget = planner.budget_bytes(None, 0.5)
    assert 0 < sr.plan.est_bytes <= budget - 12345
    sr = build_sr(cfg, budget - sr.plan.est_bytes + 1)
    with pytest.raises(HBMError, match="lower --batch \\(chunk\\)"):
        sr.setup(20, 28)
    assert sr.plan.frames == 4


def test_restore_bypasses_the_dedup_mapping(tmp_path, tiny_rows):
    """Every frame runs through the recurrent model (duplicates included),
    as the JAX restorer's vsr branch does."""
    frames = _frames(6, 20, 28, seed=2)
    frames[3] = frames[2]
    src = _clip(tmp_path / "d.y4m", frames)
    res = _restore(_cfg(tmp_path, tiny_rows, deduplicate=True), src, tmp_path / "o.y4m")
    assert res.dedup is not None and res.dedup.duplicates == 1
    assert res.frames_out == 6 and res.batches == 2
