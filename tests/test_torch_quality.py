"""The quality gate of the PyTorch port against the JAX package on the CPU:
``layers.resize_bicubic``, ``ops.metrics``, the SR processor's per-frame
stats and ``quality.validators``.

Inputs are made with numpy from a seed; weights are drawn once with the
port's seeded init and written as a ``.npz`` that both packages load.
The JAX processor runs its fused Pallas path in interpret mode
(``FW_INTERPRET=1``, ``use_fused_kernel=True``), as
``tests/test_fused_tail3.py::test_processor_fused_yuv_stats_path`` does;
on the CPU the port's kernel wrappers run their plain versions.

Tolerances: the resize to 1e-5 (f32 against f32, summation order);
PSNR to 1e-3 dB and SSIM to 1e-5 on the same pairs; the processors'
stats, whose outputs differ by the bf16 paths' rounding: PSNR within
0.05 dB, SSIM within 2e-3, luma and std within 0.05, ``finite`` equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framewright_tpu.models import torch_port
from framewright_tpu.ops import metrics as jmetrics
from framewright_tpu.processors.super_resolution import SRConfig as JaxSRConfig
from framewright_tpu.processors.super_resolution import SuperResolution as JaxSR
from framewright_tpu.quality.validators import QualityValidator as JaxValidator
from framewright_tpu_torch.models.layers import resize_bicubic
from framewright_tpu_torch.models.registry import get_model, init_params
from framewright_tpu_torch.ops import metrics
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution
from framewright_tpu_torch.quality.validators import QualityReport, QualityValidator
from framewright_tpu_torch.reports import build_qa_report

STAT_TOL = {"psnr": 0.05, "ssim": 2e-3, "luma": 0.05, "std": 0.05}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_resize(x, oh, ow):
    return np.asarray(jax.image.resize(jnp.asarray(x), (x.shape[0], oh, ow, x.shape[3]),
                                       method="cubic"))


@pytest.mark.parametrize("h,w,oh,ow", [(12, 16, 24, 32), (13, 17, 39, 51), (25, 23, 50, 92),
                                       (37, 29, 11, 14), (41, 33, 20, 17), (9, 11, 9, 11),
                                       (15, 21, 7, 63)])
def test_resize_bicubic_matches_jax_resize_cubic(h, w, oh, ow):
    """Up, down, mixed and identity on odd sizes, values outside [0, 1]
    included (the reference is not clipped)."""
    x = np.random.default_rng(h * w).uniform(-0.5, 1.5, (2, h, w, 3)).astype(np.float32)
    got = resize_bicubic(torch.from_numpy(x), (oh, ow)).numpy()
    want = _jax_resize(x, oh, ow)
    assert got.shape == want.shape == (2, oh, ow, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() < 1e-5


def test_resize_bicubic_is_not_torch_bicubic():
    """The reference the gate uses: Keys' a = -0.5 with dropped edge taps,
    not F.interpolate's a = -0.75 with clamped edges."""
    x = np.random.default_rng(0).random((1, 12, 16, 3)).astype(np.float32)
    ours = resize_bicubic(torch.from_numpy(x), (24, 32))
    theirs = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(24, 32), mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1)
    assert (ours - theirs).abs().max() > 0.02


def _pairs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape).astype(np.float32), 0, 1)
    return a, b


@pytest.mark.parametrize("shape", [(2, 24, 32, 3), (3, 37, 29, 1), (1, 64, 48, 3), (2, 11, 11, 3)])
def test_metrics_match_jax(shape):
    a, b = _pairs(shape, seed=sum(shape))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(metrics.psnr_per_frame(ta, tb).numpy(),
                               np.asarray(jmetrics.psnr_per_frame(a, b)), atol=1e-3, rtol=0)
    np.testing.assert_allclose(metrics.ssim_per_frame(ta, tb).numpy(),
                               np.asarray(jmetrics.ssim_per_frame(a, b)), atol=1e-5, rtol=0)
    assert abs(float(metrics.psnr(ta, tb)) - float(jmetrics.psnr(a, b))) < 1e-3
    assert abs(float(metrics.ssim(ta, tb)) - float(jmetrics.ssim(a, b))) < 1e-5


def test_metrics_identical_and_max_val():
    a, _ = _pairs((1, 16, 16, 3), seed=1)
    ta = torch.from_numpy(a)
    assert float(metrics.psnr_per_frame(ta, ta)[0]) == pytest.approx(120.0)   # mse floor 1e-12
    assert float(metrics.ssim_per_frame(ta, ta)[0]) == pytest.approx(1.0, abs=1e-6)
    a255, b255 = a * 255.0, np.clip(a + 0.01, 0, 1) * 255.0
    np.testing.assert_allclose(
        metrics.ssim_per_frame(torch.from_numpy(a255), torch.from_numpy(b255), 255.0).numpy(),
        np.asarray(jmetrics.ssim_per_frame(a255, b255, 255.0)), atol=1e-5, rtol=0)


# -- the SR processors' stats --------------------------------------------

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One seeded random draw per model, written as <name>.npz for both."""
    wdir = tmp_path_factory.mktemp("weights")
    for name in ("RealESRGAN_x4plus_anime_6B", "realesr-animevideov3"):
        torch_port.export_npz(init_params(get_model(name).arch_config, seed=0),
                              wdir / f"{name}.npz")
    return wdir


def _clip_frames(n, h, w, seed=3):
    """Smooth seeded frames (image-like, so the scores are not noise's)."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((n, h // 4 + 2, w // 4 + 2, 3))
    big = np.repeat(np.repeat(coarse, 4, axis=1), 4, axis=2)[:, :h, :w]
    return np.clip(big * 255 + rng.normal(0, 6, big.shape), 0, 255).astype(np.uint8)


def _jax_stats(name, wdir, frames, monkeypatch, full_range):
    monkeypatch.setenv("FW_TAIL", "3")
    monkeypatch.setenv("FW_INTERPRET", "1")
    sr = JaxSR(JaxSRConfig(model_name=name, compute_dtype="bfloat16",
                           use_fused_kernel=True if get_model(name).family == "rrdb" else None,
                           sharding="none", device_stats=True, output_color="yuv420",
                           yuv_full_range=full_range, weights_dir=str(wdir)))
    sr.setup(*frames.shape[1:3])
    handle = sr.dispatch(frames)
    planes = sr.materialize(handle)
    return planes, handle["stats_np"]


def _port_stats(name, wdir, frames, full_range):
    sr = SuperResolution(SRConfig(model_name=name, device="cpu", output_color="yuv420",
                                  yuv_full_range=full_range, weights_dir=str(wdir)))
    sr.setup(*frames.shape[1:3])
    sr.enable_device_stats()
    handle = sr.dispatch(frames)
    planes = sr.materialize(handle)
    return planes, handle["stats_np"]


def _assert_stats_close(got, want):
    assert set(got) == {"psnr", "ssim", "luma", "std", "finite"}
    for k, tol in STAT_TOL.items():
        assert got[k].shape == np.asarray(want[k]).shape
        d = np.abs(got[k] - np.asarray(want[k], np.float32)).max()
        assert d <= tol, (k, got[k], want[k])
    np.testing.assert_array_equal(got["finite"], np.asarray(want["finite"], bool))


@pytest.fixture(scope="module")
def rrdb_stats(weights):
    """Both processors on RealESRGAN_x4plus_anime_6B (limited range), one
    frame (the JAX interpret-mode pass takes about a minute)."""
    frames = _clip_frames(1, 24, 32)
    with pytest.MonkeyPatch.context() as mp:
        jax_out = _jax_stats("RealESRGAN_x4plus_anime_6B", weights, frames, mp, False)
    return frames, jax_out, _port_stats("RealESRGAN_x4plus_anime_6B", weights, frames, False)


def test_rrdb_yuv_stats_match_jax_processor(rrdb_stats):
    """The fused u8 path: stats of the dequantized Y plane against the
    BT.601 luma of the bicubic reference. (The planes themselves are held
    to JAX's elsewhere; with random weights this model's outputs span far
    beyond [0, 1], where bf16 paths may differ by more than 1 LSB.)"""
    _, (jplanes, jst), (planes, st) = rrdb_stats
    assert [p.shape for p in planes] == [np.asarray(p).shape for p in jplanes] == [
        (1, 96, 128), (1, 48, 64), (1, 48, 64)]
    _assert_stats_close(st, jst)


def test_rrdb_yuv_stats_full_range(weights, monkeypatch):
    frames = _clip_frames(1, 24, 32, seed=8)
    _, jst = _jax_stats("RealESRGAN_x4plus_anime_6B", weights, frames, monkeypatch, True)
    _, st = _port_stats("RealESRGAN_x4plus_anime_6B", weights, frames, True)
    _assert_stats_close(st, jst)


@pytest.fixture(scope="module")
def srvgg_stats(weights):
    """realesr-animevideov3: the JAX processor on its plain path (the
    default for SRVGG), the port on its chain kernels' plain versions."""
    frames = _clip_frames(2, 20, 24, seed=5)
    with pytest.MonkeyPatch.context() as mp:
        jax_out = _jax_stats("realesr-animevideov3", weights, frames, mp, False)
    return frames, jax_out, _port_stats("realesr-animevideov3", weights, frames, False)


def test_srvgg_rgb_stats_match_jax_processor(srvgg_stats):
    """Stats of the float RGB image before quantization."""
    _, (_, jst), (planes, st) = srvgg_stats
    assert planes[0].shape == (2, 80, 96)
    _assert_stats_close(st, jst)


@pytest.mark.parametrize("which", ["rrdb_stats", "srvgg_stats"])
@pytest.mark.parametrize("gate", [(25.0, 0.85), (0.0, 0.0), (-1.0, -1.0)])
def test_validator_on_processor_stats_matches_jax(request, which, gate):
    """Each package's validator on its own processor's stats: the same
    verdict and notes."""
    _, (_, jst), (_, st) = request.getfixturevalue(which)
    reports = []
    for cls, s in ((JaxValidator, jst), (QualityValidator, st)):
        v = cls(*gate)
        v.observe_scores(s["psnr"], s["ssim"], s["luma"], std=s["std"], finite=s["finite"])
        reports.append(v.validate())
    want, got = reports
    assert (got.passed, got.notes, got.samples, got.temporal_ok) == (
        want.passed, want.notes, want.samples, want.temporal_ok)
    assert abs(got.psnr - want.psnr) < 0.05 and abs(got.ssim - want.ssim) < 2e-3


# -- the validator's rules ---------------------------------------------------

SCORES = [
    # (psnr, ssim, luma, std, finite) per frame
    [(30.0, 0.9, 120.0, 40.0, True)] * 5,
    [(30.0, 0.9, 120.0, 40.0, True), (30.0, 0.9, 1.0, 0.1, True),
     (30.0, 0.9, 120.0, 40.0, True)],                                    # black, temporal
    [(30.0, 0.9, 3.0, 0.2, True), (30.0, 0.9, 3.5, 0.4, True)],          # flat dark frames
    [(30.0, 0.9, 100.0, 30.0, False), (31.0, 0.95, 100.0, 30.0, True)],  # non-finite
    [(24.0, 0.95, 100.0, 30.0, True)],                                   # psnr gate
    [(40.0, 0.80, 100.0, 30.0, True)],                                   # ssim gate
    [(30.0, 0.9, 100.0, 30.0, True)] + [(30.0, 0.9, 3.0, 0.1, True)] * 10,  # > 8 failures
]


@pytest.mark.parametrize("rows", SCORES)
def test_observe_scores_rules_match_jax(rows):
    cols = [np.asarray(c) for c in zip(*rows)]
    reports = []
    for cls in (JaxValidator, QualityValidator):
        v = cls(25.0, 0.85)
        half = len(rows) // 2          # two calls: frame indices continue
        for sl in (slice(0, half), slice(half, None)):
            v.observe_scores(cols[0][sl], cols[1][sl], cols[2][sl], std=cols[3][sl],
                             finite=cols[4][sl])
        reports.append(v.validate())
    want, got = reports
    assert got.to_dict() == want.to_dict()
    assert got.per_sample_psnr == want.per_sample_psnr


def test_no_samples_passes():
    rep = QualityValidator().validate()
    assert rep.passed and rep.notes == ["no samples collected"]
    assert rep.to_dict() == JaxValidator().validate().to_dict()


@pytest.mark.parametrize("n", [3, 30])
def test_observe_pairs_matches_jax(n):
    """The pairs path (a writer that is not 4:2:0): every 25th pair kept,
    scored against the bicubic upscale of its input."""
    rng = np.random.default_rng(n)
    ins = _clip_frames(n, 16, 20, seed=n)
    reports = []
    for cls in (JaxValidator, QualityValidator):
        v = cls(25.0, 0.85)
        for f in ins:
            up = np.repeat(np.repeat(f, 2, axis=0), 2, axis=1).astype(np.int16)
            v.observe(f, np.clip(up + rng.integers(-3, 4, up.shape), 0, 255).astype(np.uint8))
        reports.append(v.validate())
        rng = np.random.default_rng(n)
    want, got = reports
    assert (got.samples, got.passed, got.notes, got.temporal_ok) == (
        want.samples, want.passed, want.notes, want.temporal_ok)
    assert abs(got.psnr - want.psnr) < 1e-3 and abs(got.ssim - want.ssim) < 1e-5
    assert got.per_sample_psnr == want.per_sample_psnr


def test_qa_report_files(tmp_path):
    from framewright_tpu_torch.restorer import RestoreResult

    q = QualityReport(psnr=31.5, ssim=0.91, samples=2, passed=True,
                      per_sample_psnr=[31.0, 32.0], per_sample_ssim=[0.9, 0.92])
    res = RestoreResult(tmp_path / "o.y4m", 2, 2, 1.0, quality=q, errors=1,
                        stage_summary={"stages": [{"name": "enhance", "status": "completed",
                                                   "duration_s": 0.5}]})
    rep = build_qa_report(res, "in.y4m")
    js = rep.save(tmp_path / "qa_report.json").read_text()
    import json

    d = json.loads(js)
    assert d["quality"] == q.to_dict() and d["errors"] == 1
    assert d["per_frame"] == {"psnr": [31.0, 32.0], "ssim": [0.9, 0.92]}
    html = rep.save(tmp_path / "qa_report.html").read_text()
    assert "PASSED" in html and "enhance" in html


# -- outscale and the enhancement cap -------------------------------------

@pytest.mark.parametrize("kw", [dict(enhancement_cap=0.5), dict(outscale=3.0),
                                dict(enhancement_cap=0.25, outscale=2.5)])
def test_outscale_and_cap_match_jax_processor(weights, kw):
    """realesr-animevideov3 in float32 (the plain f32 path in both): the
    cap lerps the float output toward the bilinear upscale before the
    clip; outscale resizes the uint8 output bicubically to round(side x
    outscale). uint8 within 1 LSB on at most 0.1% of the values."""
    name = "realesr-animevideov3"
    frames = _clip_frames(2, 20, 24, seed=11)
    jsr = JaxSR(JaxSRConfig(model_name=name, compute_dtype="float32", sharding="none",
                            weights_dir=str(weights), **kw))
    jsr.setup(20, 24)
    want = jsr.process_batch(frames)
    sr = SuperResolution(SRConfig(model_name=name, compute_dtype="float32", device="cpu",
                                  weights_dir=str(weights), **kw))
    sr.setup(20, 24)
    got = sr.materialize(sr.dispatch(frames))
    oh, ow = sr.output_size(20, 24)
    assert got.shape == want.shape == (2, oh, ow, 3) and (oh, ow) == jsr.output_size(20, 24)
    d = np.abs(got.astype(np.int16) - want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def test_cap_and_outscale_on_the_rrdb_kernel_path():
    """FW_fast6_x2 in bf16: the cap takes the float path (the kernels' bf16
    output, no fused epilogue) and lerps it in bf16; outscale alone keeps
    the fused u8 epilogue and resizes what it wrote. Both equal the parts
    computed alone, bit for bit; YUV output is refused with outscale."""
    from framewright_tpu_torch.models.layers import mul_weak, out_epilogue, resize_bilinear
    from framewright_tpu_torch.errors import ConfigError
    from framewright_tpu_torch.processors.base import to_uint8

    frames = _clip_frames(2, 24, 32, seed=12)
    x = torch.from_numpy(frames).to(torch.bfloat16) / 255.0
    plain = SuperResolution(SRConfig(model_name="FW_fast6_x2", device="cpu"))
    plain.setup(24, 32)
    capped = SuperResolution(SRConfig(model_name="FW_fast6_x2", device="cpu",
                                      enhancement_cap=0.5))
    capped.setup(24, 32)
    img = plain.model.apply_fast(x, "bf16")
    base = resize_bilinear(x.float(), img.shape[1:3]).to(img.dtype)
    want = out_epilogue(base + mul_weak(img - base, 0.5), "rgb_u8", False).numpy()
    np.testing.assert_array_equal(capped.materialize(capped.dispatch(frames)), want)
    scaled = SuperResolution(SRConfig(model_name="FW_fast6_x2", device="cpu", outscale=3.0))
    scaled.setup(24, 32)
    u8 = torch.from_numpy(plain.materialize(plain.dispatch(frames)))
    want = to_uint8(resize_bicubic(u8.float() / 255.0, (72, 96))).numpy()
    np.testing.assert_array_equal(scaled.materialize(scaled.dispatch(frames)), want)
    with pytest.raises(ConfigError, match="outscale"):
        scaled.set_output_color("yuv420")


def test_restore_with_outscale_and_cap(tmp_path):
    """Through the API (the JAX CLI has no outscale flag): x2 FW_fastvgg_x2
    to x3 with the cap at 0.5, on the RGB writer path."""
    from framewright_tpu_torch.config import Config
    from framewright_tpu_torch.io import y4m
    from framewright_tpu_torch.restorer import VideoRestorer

    src = tmp_path / "c.y4m"
    with y4m.Y4MWriter(src, 24, 16, fps=12) as w:
        for f in _clip_frames(3, 16, 24, seed=13):
            w.write_frame(f)
    cfg = Config(sr_model="FW_fastvgg_x2", device_platform="cpu", outscale=3.0,
                 max_enhancement_strength=0.5, project_dir=tmp_path / "p")
    r = VideoRestorer(cfg)
    res = r.restore_video(src, tmp_path / "o.y4m")
    assert res.frames_out == 3 and res.errors == 0
    assert (r.sr.config.outscale, r.sr.config.enhancement_cap) == (3.0, 0.5)
    assert r.sr.config.output_color == "rgb"
    with y4m.Y4MReader(tmp_path / "o.y4m") as rd:
        assert (rd.header.width, rd.header.height) == (72, 48)
