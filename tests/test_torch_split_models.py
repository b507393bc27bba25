"""The splits of the last SR families over a mesh of ``cpu`` entries: the
diffusion SR's frames split (A11d) and the video SR's spatial split
(A11c), on the CPU.

* DiffusionSR_x4 (the packaged checkpoint, float32, 16x16 frames, 2 DDIM
  steps, dispatches of 4): each member's noise is its rows of the one-card
  chunk's ``PRNGKey(0)`` draw, exactly, for whole frames and for a tiled
  plan's windows; the restore's split over two entries (``build_sr`` with
  ``sharding_strategy="auto"``) is within 1 LSB on at most 0.1% of values
  of the one-card restore (``"none"``) at the same chunk (measured: equal),
  and noise drawn once a member, as the split would draw it without the
  shared draw, fails that bound; a member that downshifts to tiles after
  an OOM partway through samples from its plan's one-card draw.
* BasicVSR and TVSR_x4 at the registry widths (16x16, chunk 4, overlap 1,
  float32, ``tests/test_parallel.py::TestShardedVSR``'s configuration, the
  weights one seeded draw written as ``<name>.npz`` for both packages,
  BasicVSR's residual blocks at mmediting's 0.1 scale): the
  port's split over 2 and 4 entries against JAX's spatial run on the
  test's 8 CPU devices, with JAX's own bound (more than 1 LSB on under 2%
  of values), and against the port's unsplit run within 1 LSB. The band
  forwards (``apply(bands=)``) equal ``apply`` at narrow widths on uneven
  bands; a resumed split run equals a straight one; a height that does not
  divide and a TVSR window without a cut on window rows skip the split
  with JAX's warning; the restorer maps ``sharding_strategy`` as JAX's.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

from framewright_tpu.processors import video_sr as jvideo_sr
from framewright_tpu_torch import restorer
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.models import layers, registry, tvsr, vsr
from framewright_tpu_torch.ops import jax_random
from framewright_tpu_torch.parallel import bands as bands_mod
from framewright_tpu_torch.parallel import distributor, mesh
from framewright_tpu_torch.processors.super_resolution import SuperResolution
from framewright_tpu_torch.processors.video_sr import VideoSuperResolution, VSRConfig


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def entries(monkeypatch, n: int) -> None:
    """The local devices: n ``cpu`` entries."""
    monkeypatch.setattr(mesh, "local_devices", lambda: [torch.device("cpu")] * n)


def _frames(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


# -- A11d: the diffusion SR's frames split ---------------------------------------------------

def _diffusion(strategy: str, **kw):
    kw.setdefault("batch_size", 4)
    cfg = Config(sr_model="DiffusionSR_x4", scale_factor=4, device_platform="cpu",
                 compute_dtype="float32", diffusion_steps=2, sharding_strategy=strategy, **kw)
    sr = restorer.build_sr(cfg)
    sr.setup(16, 16)
    return sr


def _restore(sr, x):
    return np.concatenate([sr.materialize(sr.dispatch(x[i:i + 4])) for i in range(0, len(x), 4)])


@pytest.mark.parametrize("tiled", [False, True], ids=["frames", "tiles"])
def test_member_noise_is_its_slice_of_the_one_card_draw(monkeypatch, tiled):
    """Each member's rows equal its frames' (or windows') rows of the
    one-card chunks' draws: ``PRNGKey(0)`` normals of the plan's batch,
    concatenated; the members plan as one card does."""
    entries(monkeypatch, 2)
    kw = dict(tile_size=8, tile_overlap=2) if tiled else {}
    sr = _diffusion("auto", **kw)
    one = _diffusion("none", **kw)
    assert isinstance(sr, distributor.ShardedSR) and len(sr.members) == 2
    assert all(m.plan == one.plan for m in sr.members) and sr.plan.tiled == tiled
    seen = []
    real = SuperResolution.dispatch

    def spy(self, frames, noise=None):
        seen.append(noise(self.plan, self.device))
        return real(self, frames, noise=noise)

    monkeypatch.setattr(SuperResolution, "dispatch", spy)
    sr.materialize(sr.dispatch(_frames(4, 16, 16)))
    p = one.plan
    if tiled:                      # 2 x 2 windows of 12 px a frame, chunks of p.batch
        n, shape = 4 * 4, (48, 48, 3)
    else:
        n, shape = 4, (64, 64, 3)
    want = torch.cat([jax_random.normal(0, (min(p.batch, n - i),) + shape)
                      for i in range(0, n, p.batch)])
    assert len(seen) == 2 and torch.equal(torch.cat(seen), want)
    assert len(seen[0]) == n // 2


def test_split_restore_samples_the_one_card_noise(monkeypatch):
    """Eight frames in two dispatches on two entries: within 1 LSB on at
    most 0.1% of values of the one-card restore at the same chunk; noise
    drawn once a member (the members' own chunks) fails that bound."""
    entries(monkeypatch, 2)
    x = _frames(8, 16, 16, seed=3)
    want = _restore(_diffusion("none"), x)
    got = _restore(_diffusion("auto"), x)
    d = np.abs(got.astype(int) - want)
    assert got.shape == want.shape == (8, 64, 64, 3)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())
    own = _diffusion("auto")
    monkeypatch.setattr(own, "_draws", False)
    d = np.abs(_restore(own, x).astype(int) - want)
    assert d.max() > 1 and (d > 0).mean() > 1e-3


def test_member_downshifted_to_tiles_samples_its_plans_noise(monkeypatch):
    """Member 1 runs out of memory in the second of three dispatches of
    two frames and downshifts on its own (batch 2, 1, then tiled): from
    then on it samples its frame from its rows of the draw one card with
    its tiled plan makes, while member 0 keeps the untiled plan's. Each
    frame is within 1 LSB on at most 0.1% of values of that one card's."""
    entries(monkeypatch, 2)
    x = _frames(6, 16, 16, seed=4)
    sr = _diffusion("auto", batch_size=2)
    sub = sr.members[1]
    real = sub._run
    armed = []

    def oom(xt):
        if armed[-1] and not sub.plan.tiled:
            raise torch.cuda.OutOfMemoryError("out of memory (injected)")
        return real(xt)

    monkeypatch.setattr(sub, "_run", oom)
    got = []
    for i in range(0, 6, 2):
        armed.append(i == 2)
        got.append(sr.materialize(sr.dispatch(x[i:i + 2])))
    assert sub.plan.tiled and not sr.members[0].plan.tiled
    flat, tiled = _diffusion("none", batch_size=2), _diffusion("none", batch_size=2)
    tiled._plan = sub.plan
    want_flat = [flat.materialize(flat.dispatch(x[i:i + 2])) for i in range(0, 6, 2)]
    want = np.concatenate([want_flat[0]] + [
        np.concatenate([want_flat[k][:1], tiled.materialize(tiled.dispatch(x[i:i + 2]))[1:]])
        for k, i in ((1, 2), (2, 4))])
    d = np.abs(np.concatenate(got).astype(int) - want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def test_diffusion_2d_splits_frames(monkeypatch):
    """Under "2d" (``sharding_strategy="spatial"``) the diffusion SR has
    no band path: its frames split over every entry, noise drawn once."""
    entries(monkeypatch, 4)
    sr = _diffusion("spatial")
    assert sr.mesh.shape == {"frames": 4} and sr._draws
    assert all(m.bands is None for m in sr.members)


# -- A11c: the video SR's spatial split -------------------------------------------------------

def seeded_tree(spec, seed: int) -> dict:
    """The registry's seeded draw at the row's widths; BasicVSR's residual
    blocks scaled by 0.1, as mmediting initialises them, so that its
    outputs stay mostly inside [0, 1] (the plain draw saturates them)."""
    tree = registry.TREE_MODULES[spec.family].init_params(spec.arch_config, seed)
    if spec.family == "basicvsr":
        for trunk in (tree["backward"], tree["forward"]):
            for k in ("conv1", "conv2"):
                trunk[k]["w"] = trunk[k]["w"] * np.float32(0.1)
    return tree


@pytest.fixture(scope="module")
def registry_rows(tmp_path_factory):
    """BasicVSR and TVSR_x4 at the registry widths, one seeded draw each as
    ``<name>.npz``, and JAX's spatial run (8 devices) of the same window
    (``TestShardedVSR``'s)."""
    wdir = tmp_path_factory.mktemp("vsr_rows")
    frames = _frames(4, 16, 16, seed=1)
    runs = {}
    for name in ("BasicVSR", "TVSR_x4"):
        spec = registry.get_model(name)
        registry.write_npz(seeded_tree(spec, 5), wdir / f"{name}.npz")
        j = jvideo_sr.VideoSuperResolution(jvideo_sr.VSRConfig(
            model_name=name, chunk=4, overlap=1, compute_dtype="float32",
            weights_dir=str(wdir), sharding="spatial"))
        j.setup(16, 16)
        assert j._mesh is not None and j._mesh.devices.size == 8
        runs[name] = j.process_batch(frames)
    return wdir, frames, runs


def _vsr(wdir, name, sharding="spatial", **kw):
    sr = VideoSuperResolution(VSRConfig(model_name=name, chunk=4, overlap=1,
                                        compute_dtype="float32", weights_dir=str(wdir),
                                        device="cpu", sharding=sharding, **kw))
    sr.setup(16, 16)
    return sr


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["BasicVSR", "TVSR_x4"])
def test_vsr_split_matches_jax_spatial(monkeypatch, registry_rows, name, n):
    wdir, frames, runs = registry_rows
    entries(monkeypatch, n)
    sr = _vsr(wdir, name)
    assert sr.bands is not None and len(sr.bands) == n
    got = sr.process_batch(frames)
    assert got.shape == runs[name].shape == (4, 64, 64, 3)
    d = np.abs(got.astype(int) - runs[name])
    assert (d > 1).mean() < 0.02, (d > 1).mean()
    plain = _vsr(wdir, name, sharding="none")
    assert plain.bands is None
    assert np.abs(got.astype(int) - plain.process_batch(frames)).max() <= 1


VSR_NARROW = dict(mid_channels=8, num_blocks=3, spynet_levels=3)
TVSR_NARROW = dict(dim=16, depth=2, window=8, heads=2)


@pytest.mark.parametrize("name,n,h", [("BasicVSR", 3, 40), ("BasicVSR", 2, 16),
                                      ("TVSR_x4", 3, 32), ("TVSR_x4", 2, 48)])
def test_band_forward_equals_the_whole_frame(name, n, h):
    """``apply(bands=)`` on uneven bands (BasicVSR: rows in 3-row halos;
    TVSR: on window rows) equals ``apply`` on the whole window within
    1e-5 of its range (the CPU's convolution order may depend on the
    band's shape); the halo exchanges (TVSR's half-window rows too) and
    the gathers count their bytes."""
    if name == "BasicVSR":
        cfg, mod, halo, align = vsr.BasicVSRConfig(**VSR_NARROW), vsr, vsr.BAND_HALO, 1
    else:
        cfg, mod, halo, align = tvsr.TVSRConfig(**TVSR_NARROW), tvsr, 0, 8
    params = layers.tree_to_torch(mod.init_params(cfg, 4), "cpu")
    x = torch.from_numpy(_frames(5, h, 24, seed=2)).float().div(255.0)[None]
    b = bands_mod.Bands.split(h, ["cpu"] * n, halo, align=align)
    ex, ga = bands_mod.Bands.exchange.bytes, bands_mod.Bands.gather.bytes
    with torch.no_grad():
        want = mod.apply(params, x, cfg)
        got = mod.apply([params] * n, x, cfg, bands=b)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert bands_mod.Bands.gather.bytes > ga
    assert bands_mod.Bands.exchange.bytes > ex


def test_resumed_split_run_equals_the_straight_one(monkeypatch, registry_rows):
    """A split processor seeded with the frame before frame 4 (overlap 1)
    gives frames 4.. of a straight split run, byte for byte."""
    wdir, _, _ = registry_rows
    entries(monkeypatch, 2)
    frames = _frames(8, 16, 16, seed=6)
    straight = _vsr(wdir, "TVSR_x4")
    want = np.concatenate([straight.process_batch(frames[i:i + 4]) for i in (0, 4)])
    resumed = _vsr(wdir, "TVSR_x4")
    resumed.seed_context(list(frames[3:4]))
    np.testing.assert_array_equal(resumed.process_batch(frames[4:]), want[4:])


def test_split_is_skipped_with_jax_warning(monkeypatch, registry_rows, caplog):
    """16 rows on 3 entries do not divide; TVSR's 32 padded rows hold 4
    window rows, fewer than 8 bands: each runs unsplit on the first
    device, with a warning."""
    wdir, _, _ = registry_rows
    caplog.set_level(logging.WARNING, logger="framewright_tpu_torch.processors.video_sr")
    entries(monkeypatch, 3)
    assert _vsr(wdir, "BasicVSR").bands is None
    assert "height 16 not divisible by 3 devices" in caplog.text
    entries(monkeypatch, 8)
    sr = _vsr(wdir, "TVSR_x4")
    assert sr.bands is None and sr.device == torch.device("cpu")
    assert "4 rows of 8-row windows cannot make 8 bands" in caplog.text
    assert _vsr(wdir, "BasicVSR", mesh_shape=(2,)).bands.devices == (torch.device("cpu"),) * 2


@pytest.mark.parametrize("strategy,split", [("auto", True), ("spatial", True), ("data", False),
                                            ("none", False)])
def test_restorer_maps_vsr_sharding_as_jax(monkeypatch, registry_rows, strategy, split):
    wdir, _, _ = registry_rows
    entries(monkeypatch, 2)
    sr = restorer.build_sr(Config(sr_model="BasicVSR", scale_factor=4, device_platform="cpu",
                                  weights_dir=wdir, sharding_strategy=strategy, batch_size=4))
    assert sr.config.sharding == ("spatial" if split else "none")
    sr.setup(16, 16)
    assert (sr.bands is not None) == split


def test_split_plan_counts_the_bands_and_the_gathered_window(monkeypatch, registry_rows):
    """The first entry's plan: both bands' share of the window's features,
    one transient working set and the gathered frames, flows, carry and
    output; above one band's, below two whole windows'."""
    from framewright_tpu_torch import planner

    wdir, _, _ = registry_rows
    entries(monkeypatch, 2)
    sr = _vsr(wdir, "BasicVSR")
    whole = planner.vsr_bytes(16, 16, 5, "basicvsr", "float32")
    assert sr.plan.est_bytes == planner.vsr_bytes(16, 16, 5, "basicvsr", "float32",
                                                  band_rows=19, bands_here=2)
    assert sr.bands.rows == 19 and whole < sr.plan.est_bytes < 2 * whole
    assert sr.plan.frames == 4
