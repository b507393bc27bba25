"""The last data splits (A11b), on meshes of ``cpu`` entries.

* The SR's frames x space split (``SRConfig(sharding="2d")``): JAX's own
  configuration through both packages (``tests/test_parallel.py``'s
  realesr-animevideov3 float32 on a (4, 2) mesh, atol 1, the stats' shape
  and finiteness); then the port's 2d against the port unsplit for every
  body and tail the kernels run on bands (RRDB bf16, int8 static in both
  schemes, int8 dynamic, tail2, the float path of the enhancement cap;
  SRVGG bf16, int8 and its plain float32 forward): the CPU runs the plain
  versions, whose convolutions' sum order may depend on the band's shape
  (ROADMAP C caveats), so uint8 may move 1 LSB, and the stats within a
  bf16 step of the output they read. The odd height and the families
  without a band path split frames; the resident body refuses; a tiled
  plan runs whole frames tiled; the restorer maps ``sharding_strategy``.
* The temporal denoiser's and the interpolator's ``sharding="data"``
  against JAX's sharded and unsharded runs (``tests/test_parallel.py``'s
  configurations, atol 1), and the denoiser's ``batch``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from framewright_tpu.models import ifnet as jifnet
from framewright_tpu.models import srvgg as jsrvgg
from framewright_tpu.models.registry import get_model as jget_model
from framewright_tpu.models.torch_port import export_npz
from framewright_tpu.processors import interpolation as jinterp
from framewright_tpu.processors import super_resolution as jsr
from framewright_tpu.processors import temporal_denoise as jtd
from framewright_tpu_torch import restorer
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.models import rrdb
from framewright_tpu_torch.parallel import bands, distributor, mesh
from framewright_tpu_torch.processors.interpolation import FrameInterpolator, InterpolationConfig
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution
from framewright_tpu_torch.processors.temporal_denoise import (
    TemporalDenoiseConfig,
    TemporalDenoiser,
)


@pytest.fixture(autouse=True)
def eight_cpus(monkeypatch):
    """The local devices: eight ``cpu`` entries (JAX's test mesh)."""
    monkeypatch.setattr(mesh, "local_devices", lambda: [torch.device("cpu")] * 8)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _run(sr, x, color="rgb", stats=True):
    sr.setup(*x.shape[1:3])
    sr.set_output_color(color, full_range=True)
    if stats:
        sr.enable_device_stats()
    h = sr.dispatch(x)
    out = sr.materialize(h)
    sr.teardown()
    return out, h.get("stats_np")


def _planes(out):
    return out if isinstance(out, tuple) else (out,)


def _within_one_lsb(got, want):
    for g, w in zip(_planes(got), _planes(want)):
        assert g.shape == w.shape
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


# -- the SR's 2d split ---------------------------------------------------------------------


def test_sr_2d_matches_jax_2d(tmp_path):
    """tests/test_parallel.py:287-309 through both packages on the same
    weights (JAX's ``srvgg.init(PRNGKey(0))``, exported)."""
    spec = jget_model("realesr-animevideov3")
    params = jax.tree_util.tree_map(np.asarray, jsrvgg.init(jax.random.PRNGKey(0),
                                                            spec.arch_config))
    export_npz(params, tmp_path / "realesr-animevideov3.npz")
    common = dict(model_name="realesr-animevideov3", compute_dtype="float32",
                  weights_dir=str(tmp_path), device_stats=True)
    frames = _frames(5, 16, 16, seed=3)
    jproc = jsr.SuperResolution(jsr.SRConfig(sharding="2d", **common))
    jproc.setup(16, 16)
    assert dict(jproc._mesh.shape) == {"frames": 4, "space": 2}
    jh = jproc.dispatch(frames)
    want = jproc.materialize(jh)
    sr = distributor.sharded_sr(SRConfig(sharding="2d", device="cpu", **common))
    sr.setup(16, 16)
    assert sr.mesh.shape == {"frames": 4, "space": 2} and sr.spatial
    assert all(m.bands is not None and len(m.bands) == 2 for m in sr.members)
    h = sr.dispatch(frames)
    got = sr.materialize(h)
    assert got.shape == want.shape == (5, 64, 64, 3)
    np.testing.assert_allclose(got.astype(int), want.astype(int), atol=1)
    st = h["stats_np"]
    assert st["psnr"].shape == (5,) and np.all(np.isfinite(st["psnr"]))
    np.testing.assert_allclose(st["psnr"], jh["stats_np"]["psnr"], atol=0.05)


CASES = [
    ("FW_fast6_x2", "bfloat16", "yuv420", {}, {}),
    ("FW_fast6_x2", "int8", "yuv420", {}, {}),
    ("FW_fast6_x2", "int8", "yuv420", {}, {"FW_INT8_SCHEME": "f32acc"}),
    ("FW_fast6_x2", "int8", "rgb", {"int8_scales": "dynamic"}, {}),
    ("FW_fast6_x2", "bfloat16", "rgb", {}, {"FW_TAIL": "2"}),
    ("FW_fast6_x2", "float32", "yuv420", {"enhancement_cap": 0.5}, {}),
    ("FW_fastvgg_x2", "bfloat16", "yuv420", {}, {}),
    ("FW_fastvgg_x2", "int8", "rgb", {}, {}),
    ("FW_fastvgg_x2", "float32", "rgb", {}, {}),
]


@pytest.mark.parametrize("model,dtype,color,extra,env", CASES, ids=[
    "rrdb-bf16-yuv", "rrdb-int8-i32", "rrdb-int8-f32acc", "rrdb-dynamic", "rrdb-tail2",
    "rrdb-f32-cap", "vgg-bf16-yuv", "vgg-int8", "vgg-f32"])
def test_sr_2d_equals_unsplit(monkeypatch, model, dtype, color, extra, env):
    """A (4, 2) mesh: every frame of a dispatch in two bands, the port's
    output and stats against the unsplit processor's."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    base = dict(model_name=model, compute_dtype=dtype, device="cpu", **extra)
    x = _frames(3, 40, 48, seed=1)
    want, wst = _run(SuperResolution(SRConfig(sharding="none", **base)), x, color)
    sr = distributor.sharded_sr(SRConfig(sharding="2d", **base))
    got, gst = _run(sr, x, color)
    assert [m.bands.cuts for m in sr.members] == [((0, 10), (10, 20)) if model.startswith(
        "FW_fast6") else ((0, 20), (20, 40))] * 4
    _within_one_lsb(got, want)
    for k in ("psnr", "ssim", "luma", "std"):
        np.testing.assert_allclose(gst[k], wst[k], rtol=0, atol={"psnr": 0.05, "ssim": 2e-3}.get(
            k, 0.05))
    assert np.array_equal(gst["finite"], wst["finite"])


def test_rrdb_bands_exchange_after_head_and_every_rdb():
    """70 exchanges for 23 blocks, here 19 for 6: each moves the 5 halo
    rows of channels 0:64 into each of the two bands."""
    x = _frames(1, 40, 48, seed=2)
    sr = distributor.sharded_sr(SRConfig(model_name="FW_fast6_x2", device="cpu",
                                         sharding="2d", batch_size=1))
    before = bands.Bands.exchange.bytes
    _run(sr, x, stats=False)
    rdbs = 3 * 6
    assert bands.Bands.exchange.bytes - before == (1 + rdbs) * 2 * rrdb.BAND_HALO * 24 * 64 * 2


def test_band_cuts_and_halo_rows():
    b = bands.Bands.split(27, ["cpu"] * 2, halo=5)
    assert b.cuts == ((0, 14), (14, 27)) and b.span(0) == (0, 19) and b.span(1) == (9, 27)
    assert b.own(1) == (5, 18) and b.rows == 19
    assert bands.Bands.split(10, ["cpu"] * 2, halo=3, align=2).cuts == ((0, 6), (6, 10))
    x = torch.arange(27.0).view(1, 27, 1, 1)
    parts = b.cut(x)
    poisoned = [p.clone().fill_(-1) for p in parts]
    for i, p in enumerate(poisoned):        # keep only each band's own rows
        a, e = b.own(i)
        p[:, a:e] = parts[i][:, a:e]
    b.exchange(poisoned)
    assert all(torch.equal(p, q) for p, q in zip(poisoned, parts))
    assert torch.equal(b.gather(parts, 1, torch.device("cpu")), x)


def test_odd_height_and_families_without_bands_split_frames():
    x = _frames(3, 15, 16, seed=4)
    base = dict(model_name="FW_fastvgg_x2", device="cpu")
    sr = distributor.sharded_sr(SRConfig(sharding="2d", **base))
    got, _ = _run(sr, x, stats=False)
    assert sr.mesh.shape == {"frames": 8} and all(m.bands is None for m in sr.members)
    want, _ = _run(SuperResolution(SRConfig(sharding="none", **base)), x, stats=False)
    _within_one_lsb(got, want)
    hat = distributor.sharded_sr(SRConfig(model_name="HAT_SRx4", device="cpu", sharding="2d"))
    assert hat.spatial
    hat._build_members = lambda m: setattr(hat, "mesh", m)   # no HAT draw at its widths
    hat.members = []
    hat.setup(16, 16)
    assert hat.mesh.shape == {"frames": 8}


def test_2d_refuses_the_resident_body(monkeypatch):
    monkeypatch.setenv("FW_RDB_BODY", "resident")
    sr = distributor.sharded_sr(SRConfig(model_name="FW_fast6_x2", device="cpu", sharding="2d"))
    with pytest.raises(ConfigError, match="FW_RDB_BODY=resident"):
        sr.setup(16, 16)
    two = bands.Bands.split(8, ["cpu"] * 2, rrdb.BAND_HALO)
    with pytest.raises(ConfigError, match="FW_RDB_BODY=resident"):
        rrdb.RRDBNet(rrdb.RRDBConfig(num_block=1)).apply_fast(torch.zeros(1, 8, 8, 3), bands=two)


def test_tiled_plan_runs_whole_frames_tiled():
    """``tile_size`` tiles each band's plan: the members run whole frames
    tiled, equal to the unsplit tiled processor."""
    x = _frames(2, 40, 48, seed=5)
    base = dict(model_name="FW_fastvgg_x2", device="cpu", tile_size=16)
    sr = distributor.sharded_sr(SRConfig(sharding="2d", **base))
    got, _ = _run(sr, x, stats=False)
    assert all(m.bands is None and m.plan.tiled for m in sr.members)
    want, _ = _run(SuperResolution(SRConfig(sharding="none", **base)), x, stats=False)
    _within_one_lsb(got, want)


def test_2d_plan_holds_the_bands_and_the_whole_frame():
    """A member's plan is its device's: its two bands (two ``cpu`` entries
    on the space axis) run in turn, so one band's working set at the
    model's peak and what both keep meanwhile (carried features, the
    head's skip, the band's output), beside the whole frame's gathered
    output and stats, at the frame's own height."""
    from framewright_tpu_torch import planner

    base = dict(model_name="FW_fast6_x2", device="cpu", batch_size=1)
    sr = distributor.sharded_sr(SRConfig(sharding="2d", **base))
    sr.setup(40, 48)
    sr.enable_device_stats()
    plain = SuperResolution(SRConfig(sharding="none", **base))
    plain.setup(40, 48)
    plain.enable_device_stats()
    m = sr.members[0]
    assert m.bands.rows == 15 and m.plan.height == 40 and not m.plan.tiled
    band = planner.frame_bytes(30, 48, 2, "rrdb", "bfloat16")
    resident = 15 * 24 * (2 * 64 * 2 + 6 * 16)
    assert planner.band_resident_bytes_per_body_px("rrdb", 2) == 2 * 64 * 2 + 6 * 16
    gathered = 80 * 96 * (planner._GATHERED_BYTES_PER_OUT_PX
                          + planner._STATS_BYTES_PER_OUT_PX["luma"] * 11 // 10)
    assert m.plan.est_bytes == band + 2 * resident + gathered > plain.plan.est_bytes


@pytest.mark.parametrize("mesh_shape,n", [((), 8), ((2,), 2), ((1, 2), 2)])
def test_data_splits_keep_the_restore_s_cards(mesh_shape, n):
    """The denoiser's and the interpolator's data splits run on the cards
    of the restore's ``mesh_shape`` (every card when it is ())."""
    assert len(mesh.data_mesh("cpu", mesh_shape).devices) == n
    dn = TemporalDenoiser(TemporalDenoiseConfig(sharding="data", device="cpu",
                                                mesh_shape=mesh_shape))
    dn.setup(16, 16)
    assert len(dn._mesh.devices) == n and dn._batch == n


@pytest.mark.parametrize("strategy,shape", [("spatial", {"frames": 4, "space": 2}),
                                            ("data", {"frames": 8}), ("auto", {"frames": 8}),
                                            ("none", None)])
def test_restorer_maps_sharding_strategy(strategy, shape):
    cfg = Config(sr_model="FW_fastvgg_x2", device_platform="cpu", sharding_strategy=strategy)
    sr = restorer.build_sr(cfg)
    assert (type(sr) is SuperResolution) == (shape is None)
    if shape is not None:
        assert sr.mesh.shape == shape
        assert sr.config.sharding == {"spatial": "2d"}.get(strategy, strategy)
    # the denoiser and the interpolator: "data" for auto and data (JAX's restorer)
    assert restorer._data_sharding(cfg) == ("data" if strategy in ("auto", "data") else "none")


# -- the denoiser's and the interpolator's data splits -------------------------------------


def test_denoiser_data_split_matches_jax():
    """tests/test_parallel.py:188-213: 10 noisy frames, radius 2, centres
    over eight devices; the port's split against JAX's split and unsplit."""
    rng = np.random.default_rng(0)
    base = (rng.random((16, 16, 3)) * 200).astype(np.float32)
    frames = [np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)
              for _ in range(10)]
    common = dict(radius=2, strength=1.0, method="temporal", scene_change_threshold=9.9)
    got = {}
    for sharding in ("data", "none"):
        dn = TemporalDenoiser(TemporalDenoiseConfig(sharding=sharding, device="cpu", **common))
        dn.setup(16, 16)
        assert (dn._mesh is not None) == (sharding == "data")
        assert dn._batch == (8 if sharding == "data" else 1)
        got[sharding] = list(dn.denoise_stream(iter(frames)))
        jd = jtd.TemporalDenoiser(jtd.TemporalDenoiseConfig(sharding=sharding, **common))
        jd.setup(16, 16)
        want = list(jd.denoise_stream(iter(frames)))
        assert len(got[sharding]) == len(want) == 10
        for a, b in zip(got[sharding], want):
            np.testing.assert_allclose(a.astype(int), b.astype(int), atol=1)
    for a, b in zip(got["data"], got["none"]):
        np.testing.assert_allclose(a.astype(int), b.astype(int), atol=1)


def test_denoiser_batch_of_centres_keeps_the_bytes():
    """``batch`` is the centres a step (JAX's meaning): 1 gives the
    one-centre bytes, 3 steps three at once (padded to the mesh when
    split) within 1 LSB of them, with nafnet's refiner on the batch."""
    rng = np.random.default_rng(1)
    base = (rng.random((16, 24, 3)) * 200).astype(np.float32)
    frames = [np.clip(base + rng.normal(0, 10, base.shape), 0, 255).astype(np.uint8)
              for _ in range(7)]
    common = dict(radius=1, strength=0.8, method="nafnet", scene_change_threshold=9.9,
                  device="cpu")
    runs = {}
    for key, extra in (("one", {}), ("three", {"batch": 3}),
                       ("split", {"batch": 3, "sharding": "data"})):
        dn = TemporalDenoiser(TemporalDenoiseConfig(**common, **extra))
        dn.setup(16, 24)
        runs[key] = list(dn.denoise_stream(iter(frames)))
        assert dn.result.frames == 7
    one = [dn.denoise_window([torch.from_numpy(f) for f in frames[:2]], 0)]
    assert np.array_equal(one[0], runs["one"][0])
    for key in ("three", "split"):
        for a, b in zip(runs[key], runs["one"]):
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_interpolator_data_split_matches_jax(tmp_path):
    """tests/test_parallel.py:216-237: 7 frames doubled; pairs over eight
    devices, ``batch_pairs`` rounded up to them."""
    params = jax.tree_util.tree_map(np.asarray, jifnet.init(jax.random.PRNGKey(0),
                                                            jifnet.IFNetConfig()))
    export_npz(params, tmp_path / "rife-v4.6.npz")
    rng = np.random.default_rng(2)
    frames = [(rng.random((16, 16, 3)) * 255).astype(np.uint8) for _ in range(7)]
    outs = {}
    for sharding in ("data", "none"):
        it = FrameInterpolator(InterpolationConfig(sharding=sharding, device="cpu",
                                                   weights_dir=str(tmp_path)))
        it.setup(16, 16)
        assert it.config.batch_pairs == (8 if sharding == "data" else 4)
        outs[sharding] = list(it.interpolate_stream(iter(frames), 2))
        jit = jinterp.FrameInterpolator(jinterp.InterpolationConfig(sharding=sharding))
        jit.setup(16, 16)
        want = list(jit.interpolate_stream(iter(frames), 2))
        assert len(outs[sharding]) == len(want) == 13
        for a, b in zip(outs[sharding], want):
            np.testing.assert_allclose(a.astype(int), b.astype(int), atol=1)
    for a, b in zip(outs["data"], outs["none"]):
        assert np.array_equal(a, b)
