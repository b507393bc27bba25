"""Spatial tiling of the port (``ops/tiling.py``, the planner's tiles and
downshift, the SR processor's tiled branch) held to the JAX package.

Tolerances:
- the window geometry and the stitching: equal (exactly, on a model-like
  function whose output depends on each window's position);
- the tiny RRDB of ``tests/goldens/rrdb_x2_2b.npz`` (``rrdb.init(
  PRNGKey(0))``, 2 blocks, carried across) under ``tiled_apply`` in f32:
  max abs 1e-4 against JAX's ``tiled_apply`` of its ``apply`` (the CPU's
  f32 sums in another order), and the golden itself within 2e-4
  (``tests/test_goldens.py``) where the plan runs the frame whole;
- the planner: the downshift sequence (batch, tile) equal to JAX's
  ``TilePlan.downshift`` from the same plan, the grid equal, and the
  choices of ``tests/test_tiling_planner.py:20-100`` (whole frame with
  room, tiles without, a pinned tile, a refusal);
- a tiled restore (FW_fast6_x2, 4:2:0 planes) against the JAX tiled
  restore: max 2 LSB, mean 0.2 a frame, the bound of the whole-frame
  restores (``tests/test_torch_slice.py::test_cli_restore_matches_jax_cli``).
"""

from __future__ import annotations

import contextlib
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framewright_tpu import planner as jplanner
from framewright_tpu.config import Config as JaxConfig
from framewright_tpu.io import y4m as jy4m
from framewright_tpu.models import rrdb as jrrdb
from framewright_tpu.ops import tiling as jtiling
from framewright_tpu.restorer import VideoRestorer as JaxRestorer
from framewright_tpu_torch import planner
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import ConfigError, HBMError
from framewright_tpu_torch.models import rrdb
from framewright_tpu_torch.models.registry import from_jax_params
from framewright_tpu_torch.ops import tiling
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution
from framewright_tpu_torch.restorer import VideoRestorer

GOLDEN = Path(__file__).parent / "goldens" / "rrdb_x2_2b.npz"
MAX_LSB, MEAN_LSB = 2, 0.2


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _plans(h, w, s, ts, o, b, u):
    return (jplanner.TilePlan(h, w, s, ts, o, b, u, 0),
            planner.Plan(h, w, s, b, u, 0, tile_size=ts, overlap=o, frame_batch=1))


# -- the geometry --------------------------------------------------------

@pytest.mark.parametrize("h,w,ts,o,s,u,b", [
    (40, 56, 16, 4, 2, 2, 3), (37, 53, 16, 3, 2, 2, 2), (30, 30, 8, 2, 4, 1, 5),
    (33, 129, 32, 4, 2, 1, 2), (20, 20, 32, 4, 2, 2, 1)])
def test_window_geometry_and_stitching_equal_jax(h, w, ts, o, s, u, b):
    """A function that adds each window's top-left value to its nearest
    upsample: any difference in the windows' starts, the halo after
    alignment, the batching or the interior crops shows. The last case
    cannot hold one window and runs whole in both."""
    x = np.random.default_rng(h + w).random((2, h, w, 3)).astype(np.float32)

    def jfn(t):
        return jnp.repeat(jnp.repeat(t, s, 1), s, 2) + t[:, :1, :1, :1]

    def pfn(t):
        return t.repeat_interleave(s, 1).repeat_interleave(s, 2) + t[:, :1, :1, :1]

    jp, pp = _plans(h, w, s, ts, o, b, u)
    want = np.asarray(jtiling.tiled_apply(jfn, jnp.asarray(x), jp))
    got = tiling.tiled_apply(pfn, torch.from_numpy(x), pp).numpy()
    assert got.shape == want.shape == (2, h * s, w * s, 3)
    np.testing.assert_array_equal(got, want)
    hp, wp = -(-h // u) * u, -(-w // u) * u
    full = -(-(ts + 2 * o) // u) * u
    geo = tiling.window_geometry(h, w, pp)
    if geo is None:
        assert hp < full or wp < full
    else:
        nh, nw = -(-hp // ts), -(-wp // ts)
        o2 = (full - ts) // 2
        assert geo[1] == jtiling._window_starts(hp, ts, o2, nh)
        assert geo[2] == jtiling._window_starts(wp, ts, o2, nw)


@pytest.mark.parametrize("bottom,right", [(0, 0), (1, 3), (3, 1), (40, 2)])
def test_pad_mod_equals_jax(bottom, right):
    x = np.random.default_rng(2).random((1, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(tiling.pad_mod(torch.from_numpy(x), bottom, right).numpy(),
                                  np.asarray(jtiling.pad_mod(jnp.asarray(x), bottom, right)))


def test_receptive_overlap_equals_jax():
    for fam in ("rrdb", "srvgg", "nafnet", "restormer", "other"):
        assert tiling.receptive_overlap(fam) == jtiling.receptive_overlap(fam)


# -- the tiny RRDB under tiling -----------------------------------------

@pytest.fixture(scope="module")
def tiny_rrdb():
    cfg = jrrdb.RRDBConfig(num_block=2, scale=2)
    params = jax.device_get(jrrdb.stack_body(jrrdb.init(jax.random.PRNGKey(0), cfg)))
    model = rrdb.RRDBNet.from_state_dict(rrdb.RRDBConfig(num_block=2, scale=2),
                                         from_jax_params(params, torch.float32),
                                         torch.device("cpu"))
    return cfg, params, model


@pytest.mark.parametrize("ts,o,b", [(16, 4, 3), (24, 10, 8)])
def test_tiny_rrdb_tiled_apply_matches_jax(tiny_rrdb, ts, o, b):
    cfg, params, model = tiny_rrdb
    with np.load(GOLDEN) as z:
        x = z["x"]
    h, w = x.shape[1:3]
    jp, pp = _plans(h, w, 2, ts, o, b, 2)
    want = np.asarray(jtiling.tiled_apply(lambda t: jrrdb.apply(params, t, cfg),
                                          jnp.asarray(x), jp))
    with torch.no_grad():
        got = tiling.tiled_apply(model.apply, torch.from_numpy(x), pp).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-4


def test_tiny_rrdb_whole_frame_matches_the_golden(tiny_rrdb):
    _, _, model = tiny_rrdb
    with np.load(GOLDEN) as z:
        x, y = z["x"], z["y"]
    h, w = x.shape[1:3]
    whole = planner.Plan(h, w, 2, 1, 2, 0, overlap=8)
    with torch.no_grad():
        got = tiling.tiled_apply(model.apply, torch.from_numpy(x), whole).numpy()
    assert np.abs(got - y).max() < 2e-4


# -- the planner ---------------------------------------------------------

@pytest.mark.parametrize("h,w,s,u,batch", [(512, 512, 2, 2, 8), (1080, 1920, 2, 2, 1),
                                           (2160, 3840, 4, 1, 2), (300, 200, 4, 1, 1)])
def test_downshift_sequence_equals_jax(h, w, s, u, batch):
    """From the same whole-frame plan: halve the batch, then the first
    tile (min(1024, half the longer side rounded to 8), at least 64), then
    each smaller candidate, then HBMError below 64 px, as JAX's."""
    jp = jplanner.TilePlan(h, w, s, 0, 8, batch, u, 0)
    pp = planner.Plan(h, w, s, batch, u, batch * 10**6, overlap=8, px_bytes=6800)
    seq_j, seq_p = [], []
    for _ in range(40):
        try:
            jp = jp.downshift()
        except Exception as exc:     # noqa: BLE001 - JAX's HBMError
            seq_j.append(type(exc).__name__)
            break
        seq_j.append((jp.batch, jp.tile_size, jp.grid, jp.tiles_per_frame))
    for _ in range(40):
        try:
            pp = pp.downshift()
        except HBMError as exc:
            seq_p.append(type(exc).__name__)
            break
        seq_p.append((pp.batch, pp.tile_size, pp.grid, pp.tiles_per_frame))
        assert pp.overlap == 8 and pp.est_bytes > 0
    assert seq_p == seq_j and seq_p[-1] == "HBMError"


def test_tiled_downshift_halves_the_tile_batch_first():
    p = planner.plan(2160, 3840, 2, free_bytes=10 * 2**30, tile_size_override=256)
    assert p.tiled and p.batch > 1
    d = p.downshift()
    assert (d.tile_size, d.batch) == (256, p.batch // 2) and d.est_bytes < p.est_bytes
    jp = jplanner.TilePlan(2160, 3840, 2, 256, 8, p.batch, 2, 0).downshift()
    assert (jp.tile_size, jp.batch) == (d.tile_size, d.batch)


def test_whole_frame_when_memory_is_large():
    p = planner.plan(1080, 1920, 2, free_bytes=14 * 2**30)
    assert not p.tiled and p.batch >= 1 and p.frames == p.batch
    assert jplanner.plan(1080, 1920, 2, "rrdb", "bfloat16",
                         hbm_free_bytes=14 * 2**30).tiled is False


@pytest.mark.parametrize("gib", [2, 8])
def test_tiles_when_memory_is_small(gib):
    """A 4K x4 frame in 2 GiB: JAX tiles it. The port's plan holds the
    16K output frame beside the tiles (~6 GB): it tiles it in 8 GiB and
    refuses 2 GiB, where it tiles a 1080p x4 frame. Both from the same
    candidates, the grid covering the frame and the estimate within the
    budget."""
    j = jplanner.plan(2160, 3840, 4, "rrdb", "bfloat16", hbm_free_bytes=2 * 2**30)
    if gib == 2:
        with pytest.raises(HBMError):
            planner.plan(2160, 3840, 4, free_bytes=2 * 2**30)
        p = planner.plan(1080, 1920, 4, free_bytes=2 * 2**30)
    else:
        p = planner.plan(2160, 3840, 4, free_bytes=gib * 2**30)
    for q in (j, p):
        assert q.tiled and q.tile_size in planner._TILE_CANDIDATES
        nh, nw = q.grid
        assert nh * q.tile_size >= q.height and nw * q.tile_size >= q.width
    assert p.est_bytes <= gib * 2**30 * 0.85 and p.frames >= 1
    assert planner._TILE_CANDIDATES == jplanner._TILE_CANDIDATES


def test_a_frame_that_does_not_fit_at_batch_1_is_tiled():
    per = planner.frame_bytes(1080, 1920, 2)
    p = planner.plan(1080, 1920, 2, free_bytes=per // 2, utilization=1.0)
    assert p.tiled and p.est_bytes <= per // 2
    assert p.tile_extent() == -(-(p.tile_size + 16) // 2) * 2


def test_override_pins_the_tile():
    p = planner.plan(1080, 1920, 2, free_bytes=14 * 2**30, tile_size_override=256)
    j = jplanner.plan(1080, 1920, 2, "rrdb", hbm_free_bytes=14 * 2**30,
                      tile_size_override=256)
    assert p.tile_size == j.tile_size == 256 and p.grid == j.grid == (5, 8)
    assert p.tiles_per_frame == 40 and p.tile_extent() == 272


def test_impossible_raises():
    with pytest.raises(HBMError):
        planner.plan(8192, 8192, 4, "rrdb", free_bytes=2**20, dtype="float32")
    with pytest.raises(Exception):
        jplanner.plan(8192, 8192, 4, "rrdb", "float32", hbm_free_bytes=2**20)


@pytest.mark.parametrize("kw", [dict(tile_size=12), dict(tile_size=-8), dict(tile_overlap=-1)])
def test_tile_config_validation_follows_jax(kw):
    from framewright_tpu.errors import ConfigError as JaxConfigError

    with pytest.raises(ConfigError, match="tile"):
        Config(**kw)
    with pytest.raises(JaxConfigError, match="tile"):
        JaxConfig(**kw)
    c = Config(tile_size=256, tile_overlap=0)
    assert (c.tile_size, c.tile_overlap) == (256, 0)
    assert Config(tile_size=256).get_hash() != Config().get_hash()


# -- the SR processor and the restore ------------------------------------

def _frames(n, h, w, seed=3):
    rng = np.random.default_rng(seed)
    coarse = rng.random((n, h // 4 + 2, w // 4 + 2, 3))
    big = np.repeat(np.repeat(coarse, 4, axis=1), 4, axis=2)[:, :h, :w]
    return np.clip(big * 255 + rng.normal(0, 6, big.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("color", ["yuv420", "rgb"])
def test_processor_tiled_branch_is_tiled_apply_then_the_epilogue(color):
    """The tiled branch equals ``tiled_apply`` over the model's float path
    then ``out_epilogue`` (exactly: the same plain kernels), and its stats
    are the float RGB image's."""
    from framewright_tpu_torch.models.layers import out_epilogue
    from framewright_tpu_torch.processors.super_resolution import _frame_stats

    frames = _frames(3, 40, 56)
    sr = SuperResolution(SRConfig(model_name="FW_fast6_x2", device="cpu", output_color=color,
                                  tile_size=16, tile_overlap=10))
    sr.setup(40, 56)
    sr.enable_device_stats()
    assert sr.plan.tiled and sr.plan.tile_extent() == 36 and sr.plan.frames >= 3
    handle = sr.dispatch(frames)
    got = sr.materialize(handle)
    x = torch.from_numpy(frames).to(torch.bfloat16) / 255.0
    with torch.no_grad():
        img = tiling.tiled_apply(lambda t: sr.model.apply_fast(t, "bf16"), x, sr.plan)
        want = out_epilogue(img, "yuv420_u8" if color == "yuv420" else "rgb_u8", False)
        st = torch.stack([_frame_stats(img[j:j + 1].float().clamp(0, 1), x[j:j + 1])
                          for j in range(3)]).numpy()
    for g, w in zip(got if color == "yuv420" else [got], want if color == "yuv420" else [want]):
        np.testing.assert_array_equal(g, w.numpy())
    np.testing.assert_allclose(handle["stats_np"]["psnr"], st[:, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(handle["stats_np"]["std"], st[:, 3], rtol=0, atol=1e-4)


def test_oom_at_batch_one_downshifts_into_tiles(monkeypatch):
    """An out-of-memory at batch 1 on a whole frame moves the plan to
    tiles and reruns the batch there (JAX raises HBMError at batch 1 of
    the port before this slice)."""
    frames = _frames(2, 40, 56, seed=4)
    sr = SuperResolution(SRConfig(model_name="FW_fast6_x2", device="cpu", batch_size=1,
                                  output_color="yuv420"))
    sr.setup(40, 56)
    assert not sr.plan.tiled and sr.plan.batch == 1
    real, calls = sr.model.apply_fast, []

    def apply_fast(x, *a, **k):
        calls.append(tuple(x.shape[:3]))
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("device out of memory")
        return real(x, *a, **k)

    monkeypatch.setattr(sr.model, "apply_fast", apply_fast)
    out = sr.materialize(sr.dispatch(frames))
    assert sr.plan.tiled and sr.plan.tile_size == 64
    assert [p.shape for p in out] == [(2, 80, 112), (2, 40, 56), (2, 40, 56)]
    assert calls[0] == (1, 40, 56) and len(calls) >= 2


def _write(path, frames):
    with jy4m.Y4MWriter(path, frames.shape[2], frames.shape[1], fps=12) as w:
        for f in frames:
            w.write_frame(f)
    return path


def _planes(path: Path):
    header, rest = path.read_bytes().split(b"\n", 1)
    w, h = (int(re.search(rb" %s(\d+)" % k, header).group(1)) for k in (b"W", b"H"))
    frames = [np.frombuffer(c, np.uint8) for c in rest.split(b"FRAME\n")[1:]]
    assert all(len(f) == w * h * 3 // 2 for f in frames)
    return frames


def test_tiled_restore_matches_the_jax_tiled_restore(tmp_path, gradient_frame, monkeypatch):
    """Both packages' ``VideoRestorer`` with ``tile_size=16`` (the JAX one
    on its plain bf16 path on the CPU, the port on its kernels' plain
    versions) on a 4-frame 40x56 clip: planes within max 2, mean 0.2
    LSB; the port's plan is tiled and the restore reports no errors.
    The JAX restore runs on one device (its ``build_sr_config`` never maps
    ``sharding_strategy``, so the SR config is set here): with its frames
    sharded over the test mesh's 8 CPU devices, its tiled plan garbles
    frames 2 and 3 of the batch (max 198 LSB from its own one-device
    output; ROADMAP.md, "JAX faults the port must not copy")."""
    import framewright_tpu.restorer as jrestorer

    real = jrestorer.build_sr_config

    def one_device(cfg):
        sr_cfg = real(cfg)
        sr_cfg.sharding = "none"
        return sr_cfg

    monkeypatch.setattr(jrestorer, "build_sr_config", one_device)
    src = _write(tmp_path / "c.y4m", np.stack([gradient_frame(40, 56, t) for t in range(4)]))
    common = dict(sr_model="FW_fast6_x2", device_platform="cpu", tile_size=16,
                  checkpoint_enabled=False, validate_output=False)
    with contextlib.redirect_stdout(io.StringIO()):
        JaxRestorer(JaxConfig(project_dir=tmp_path / "pj", **common)).restore_video(
            src, tmp_path / "jax.y4m")
        r = VideoRestorer(Config(project_dir=tmp_path / "pt", **common))
        res = r.restore_video(src, tmp_path / "port.y4m")
    assert res.frames_out == 4 and res.errors == 0 and r.sr.plan.tiled
    a, b = _planes(tmp_path / "port.y4m"), _planes(tmp_path / "jax.y4m")
    assert len(a) == len(b) == 4
    d = [np.abs(x.astype(np.int16) - y) for x, y in zip(a, b)]
    mx, mean = max(x.max() for x in d), max(x.mean() for x in d)
    assert mx <= MAX_LSB and mean <= MEAN_LSB, (mx, mean)
