"""Frame interpolation in the port (``processors/interpolation``, the
restorer's interpolate stage) against the JAX package: the factor, IFNet
at the published widths on the JAX draw ``ifnet.init(PRNGKey(0))`` (the
weights a JAX restore without a checkpoint runs, carried across as
``rife-v4.6.npz``), the stream with its scene-cut holds, the interpolated
restore (dedup's drop mode and plain 2x) around the same SR, the missing
checkpoint, and resumes in either stage."""

from __future__ import annotations

import contextlib
import io
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import framewright_tpu.processors.interpolation as jinterp_mod
import framewright_tpu.restorer as jrestorer
from framewright_tpu.config import Config as JaxConfig
from framewright_tpu.models import ifnet as jifnet
from framewright_tpu.models.torch_port import export_npz
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import InputError, ValidationError
from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
from framewright_tpu_torch.models import registry
from framewright_tpu_torch.models.ifnet import IFNet, IFNetConfig
from framewright_tpu_torch.processors import interpolation
from framewright_tpu_torch.restorer import VideoRestorer
from test_torch_checkpoint import _fail_batch
from test_torch_film import _PortSR
from test_torch_io_formats import stub_ffmpeg  # noqa: F401 - a fixture

# uint8 outputs of the port against JAX: within 1 LSB on at most 0.1% of
# the values (the denoiser's bound, tests/test_torch_denoise.py)
LSB_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rife(tmp_path_factory):
    """(weights dir holding rife-v4.6.npz, the JAX params): the JAX
    interpolator's own draw without a checkpoint."""
    params = jax.tree_util.tree_map(np.asarray, jifnet.init(jax.random.PRNGKey(0),
                                                            jifnet.IFNetConfig()))
    wdir = tmp_path_factory.mktemp("rife")
    export_npz(params, wdir / "rife-v4.6.npz")
    return wdir, params


def _within_one_lsb(got, want):
    got, want = np.asarray(got, np.int16), np.asarray(want, np.int16)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 1 and (d > 0).mean() <= LSB_SHARE, (d.max(), (d > 0).mean())


def smooth_frame(h: int, w: int, t: int) -> np.ndarray:
    """Smooth colour waves panning 2 px a frame (a pair scores ~0.08,
    under the 0.3 scene-cut threshold; a random texture scores a cut)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    x = x + 2 * t
    rgb = [128 + 60 * np.sin(x / 5.0) + 40 * np.cos(y / 4.0),
           128 + 50 * np.sin((x + y) / 7.0),
           100 + 70 * np.cos(x / 9.0 - y / 6.0)]
    return np.clip(np.stack(rgb, -1), 0, 255).astype(np.uint8)


def pan_clip(n: int, h: int = 24, w: int = 32, cut: int = 0, pad: bool = True):
    """``smooth_frame``s; with ``pad`` every fourth frame an exact repeat
    of the one before (18 fps padded to 24); from frame ``cut`` on a
    brighter, shifted picture (a scene cut)."""
    frames = []
    for t in range(n):
        u = t - (t + 1) // 4 if pad else t
        f = smooth_frame(h, w, u)
        if cut and t >= cut:
            f = np.clip(np.roll(f, 7, axis=0).astype(np.int16) * 2 + 60, 0, 255).astype(np.uint8)
        frames.append(f)
    return frames


def _write(path: Path, frames, fps: int = 24) -> Path:
    with Y4MWriter(path, frames[0].shape[1], frames[0].shape[0], fps=fps) as w:
        for f in frames:
            w.write_frame(f)
    return path


def _planes(path: Path):
    header, rest = path.read_bytes().split(b"\n", 1)
    return header, [np.frombuffer(c, np.uint8) for c in rest.split(b"FRAME\n")[1:]]


# -- the model and the stream ---------------------------------------------------

@pytest.mark.parametrize("src,target", [(24, 0), (24, 24), (24, 20), (24, 48), (24, 50),
                                        (18, 60), (25, 120), (0, 30), (30, -1)])
def test_interpolation_factor_equals_jax(src, target):
    assert interpolation.interpolation_factor(src, target) == \
        jinterp_mod.interpolation_factor(src, target)


@pytest.mark.parametrize("hw,t", [((37, 53), 0.5), ((45, 70), 0.25)])
def test_ifnet_published_widths_equal_jax_interpolate_padded(rife, hw, t):
    """``IFNet(IFNetConfig())`` on the JAX draw against JAX
    ``interpolate_padded`` at odd sizes (padded to 64 x 64 and 64 x 96):
    max 1e-3, the JAX package's own bound against its torch reference
    (tests/test_interpolation.py)."""
    wdir, params = rife
    spec, sd, _ = registry.load_aux("rife-v4.6", wdir)
    assert spec.arch_config == IFNetConfig()
    net = IFNet.from_state_dict(spec.arch_config, sd, "cpu")
    rng = np.random.default_rng(1)
    a = rng.random((2, *hw, 3), dtype=np.float32)
    b = np.roll(a, 3, axis=2)
    with torch.no_grad():
        got = net.interpolate_padded(torch.from_numpy(a), torch.from_numpy(b), t).numpy()
    want = np.asarray(jifnet.interpolate_padded(params, a, b, t, jifnet.IFNetConfig()))
    err = np.abs(got - want).max()
    assert err < 1e-3, err


@pytest.mark.parametrize("factor,cut", [(2, 0), (2, 5), (4, 3)])
def test_interpolate_stream_equals_jax(rife, factor, cut):
    """Frame counts, scene skips (a cut holds the left frame), the source
    frames exact and the synthesized ones within 1 LSB on <= 0.1% of the
    values, against JAX's ``FrameInterpolator`` with the same weights."""
    wdir, _ = rife
    frames = pan_clip(9, cut=cut, pad=False)
    port = interpolation.FrameInterpolator(interpolation.InterpolationConfig(
        batch_pairs=3, weights_dir=str(wdir), device="cpu"))
    port.setup(24, 32)
    jax_i = jinterp_mod.FrameInterpolator(jinterp_mod.InterpolationConfig(
        batch_pairs=3, weights_dir=str(wdir)))
    jax_i.setup(24, 32)
    pres, jres = interpolation.InterpolationResult(), jinterp_mod.InterpolationResult()
    got = list(port.interpolate_stream(iter(frames), factor, pres))
    want = list(jax_i.interpolate_stream(iter(frames), factor, jres))
    assert len(got) == len(want) == 8 * factor + 1
    assert (pres.frames_in, pres.frames_out, pres.scene_skips) == \
        (jres.frames_in, jres.frames_out, jres.scene_skips)
    assert pres.scene_skips == (1 if cut else 0)
    for i in range(0, len(got), factor):
        np.testing.assert_array_equal(got[i], want[i])         # the source frames
    _within_one_lsb(np.stack(got), np.stack(want))
    if cut:                                                     # held across the cut
        k = (cut - 1) * factor
        for j in range(1, factor):
            np.testing.assert_array_equal(got[k + j], frames[cut - 1])


def test_interpolate_to_fps_factor_one_passes_frames_through(rife):
    port = interpolation.FrameInterpolator(interpolation.InterpolationConfig(
        target_fps=24, weights_dir=str(rife[0]), device="cpu"))
    port.setup(24, 32)
    frames = pan_clip(3, pad=False)
    got = list(port.interpolate_to_fps(iter(frames), 30.0))
    assert len(got) == 3 and port.result.factor == 1 and port.result.output_fps == 30.0


def test_missing_rife_checkpoint_raises_input_error(tmp_path):
    """No random IFNet: ``setup`` and a restore (before any compute) name
    the missing file."""
    empty = tmp_path / "empty"
    empty.mkdir()
    interp = interpolation.FrameInterpolator(interpolation.InterpolationConfig(
        weights_dir=str(empty), device="cpu"))
    with pytest.raises(InputError, match="rife-v4.6"):
        interp.setup(24, 32)
    src = _write(tmp_path / "a.y4m", pan_clip(4))
    cfg = Config(sr_model="FW_fast6_x2", device_platform="cpu", interpolation=True,
                 weights_dir=empty, project_dir=tmp_path / "p")
    with pytest.raises(InputError, match=str(empty / "rife-v4.6.npz")):
        VideoRestorer(cfg).restore_video(src, tmp_path / "o.y4m")
    assert not (tmp_path / "p").exists()


# -- the restore ---------------------------------------------------------------------

class _PortSRYUV(_PortSR):
    """``_PortSR`` that also takes the JAX restorer's YUV-direct path (the
    tail's 4:2:0 planes and the gate's stats from the SR pass), as the
    port's restore does without a mapping."""

    @property
    def config(self):
        return self.inner.config

    def set_output_color(self, color):
        self.inner.set_output_color(color)

    def enable_device_stats(self):
        self.inner.enable_device_stats()


def _port_interpolator(wdir):
    """The port's interpolator with JAX's config, in the JAX restorer."""

    def make(jcfg):
        return interpolation.FrameInterpolator(interpolation.InterpolationConfig(
            model_name=jcfg.model_name, target_fps=jcfg.target_fps,
            scene_change_threshold=jcfg.scene_change_threshold,
            scene_change_skip=jcfg.scene_change_skip, weights_dir=str(wdir), device="cpu"))

    return make


@pytest.mark.parametrize("dedup", [True, False], ids=["drop", "plain2x"])
def test_interpolated_restore_equals_jax_around_the_same_sr(tmp_path, monkeypatch, rife, dedup):
    """``interpolation`` (with ``deduplicate``: the 18 fps cadence of a
    padded clip, duplicates dropped, 6 unique frames to 11 at 36 fps;
    without: 8 to 15 at 48) against the JAX restore with the port's SR in
    its place: byte for byte with the port's interpolator in the JAX
    restorer too (the stages' plumbing, the intermediate, the rates, the
    gate), and with JAX's own interpolator the written planes within 1 LSB
    on <= 0.1% of the values, its source frames' planes equal."""
    wdir, _ = rife
    monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(tmp_path / "none"))
    src = _write(tmp_path / "a.y4m", pan_clip(8, cut=0))
    monkeypatch.setattr(jrestorer, "SuperResolution", _PortSRYUV)
    common = dict(sr_model="FW_fast6_x2", interpolation=True, deduplicate=dedup,
                  checkpoint_enabled=False)
    with contextlib.redirect_stdout(io.StringIO()):
        res = VideoRestorer(Config(project_dir=tmp_path / "pt", device_platform="cpu",
                                   weights_dir=wdir, **common)).restore_video(
            src, tmp_path / "port.y4m")
        jres_own = jrestorer.VideoRestorer(JaxConfig(project_dir=tmp_path / "pj", **common))\
            .restore_video(src, tmp_path / "jax.y4m")
        monkeypatch.setattr(jinterp_mod, "FrameInterpolator", _port_interpolator(wdir))
        jres = jrestorer.VideoRestorer(JaxConfig(project_dir=tmp_path / "pk", **common))\
            .restore_video(src, tmp_path / "jax_p.y4m")
    n_out, fps = (11, 36.0) if dedup else (15, 48.0)
    assert (tmp_path / "port.y4m").read_bytes() == (tmp_path / "jax_p.y4m").read_bytes()
    assert res.frames_out == jres.frames_out == jres_own.frames_out == n_out
    assert res.output_fps == fps and res.interpolation["factor"] == 2
    assert res.quality.to_dict() == jres.quality.to_dict()
    assert not (tmp_path / "pt" / "work" / "enhanced.y4m").exists()
    header, got = _planes(tmp_path / "port.y4m")
    jheader, want = _planes(tmp_path / "jax.y4m")
    assert header == jheader and f"F{int(fps)}:1".encode() in header
    for i in range(0, n_out, 2):
        np.testing.assert_array_equal(got[i], want[i])
    _within_one_lsb(np.stack(got), np.stack(want))


class _Stop(Exception):
    pass


def _cfg(tmp_path, wdir, proj, **kw):
    return Config(sr_model="FW_fast6_x2", device_platform="cpu", batch_size=2,
                  interpolation=True, weights_dir=wdir, project_dir=tmp_path / proj, **kw)


def test_resume_inside_the_interpolate_stage(tmp_path, rife):
    """Killed after 10 of 17 interpolated frames (dedup's drop mode, 9
    unique frames, 4 pairs a step): the rerun finds the enhance stage
    complete and its intermediate whole, runs no SR, resumes at output
    frame 8 and writes the straight run's bytes."""
    wdir, _ = rife
    src = _write(tmp_path / "a.y4m", pan_clip(12))
    with contextlib.redirect_stdout(io.StringIO()):
        straight = VideoRestorer(_cfg(tmp_path, wdir, "s", deduplicate=True))\
            .restore_video(src, tmp_path / "s.y4m")
        r = VideoRestorer(_cfg(tmp_path, wdir, "r", deduplicate=True))

        def stop(info):
            if info.stage == "interpolate" and info.frames_done >= 10:
                raise _Stop(info.frames_done)

        r.progress_callback = stop
        with pytest.raises(_Stop):
            r.restore_video(src, tmp_path / "r.y4m")
        assert (tmp_path / "r" / "work" / "enhanced.y4m").is_file()
        res = VideoRestorer(_cfg(tmp_path, wdir, "r", deduplicate=True))\
            .restore_video(src, tmp_path / "r.y4m")
    assert straight.frames_out == res.frames_out == 17
    assert straight.interpolation["pairs_per_step"] == 4
    assert res.batches == 0 and res.interpolation["resumed_from"] == 8
    # restored as completed by the engine (restore_completed), not run again
    st = {s["name"]: s for s in res.stage_summary["stages"]}
    assert (st["enhance"]["status"], st["enhance"]["attempts"]) == ("completed", 0)
    assert (st["dedup"]["status"], st["dedup"]["attempts"]) == ("completed", 0)
    assert (tmp_path / "r.y4m").read_bytes() == (tmp_path / "s.y4m").read_bytes()
    assert not (tmp_path / "r" / "work" / "enhanced.y4m").exists()
    assert not list((tmp_path / "r" / "checkpoints").glob("*.json"))


def _killed_in_interpolate(cfg, src, out, at: int = 10):
    r = VideoRestorer(cfg)

    def stop(info):
        if info.stage == "interpolate" and info.frames_done >= at:
            raise _Stop(info.frames_done)

    r.progress_callback = stop
    with pytest.raises(_Stop):
        r.restore_video(src, out)


def test_resume_inside_the_interpolate_stage_reports_the_straight_run(tmp_path, rife,
                                                                       monkeypatch):
    """The gate and the errors survive a kill in the interpolate stage:
    with the second SR batch out of memory (bicubic copies under
    ``continue_on_error``), the rerun reports the straight run's quality,
    ``errors``, ``resumed_from``, faces, pre-SR results and duplicates."""
    wdir, _ = rife
    src = _write(tmp_path / "a.y4m", pan_clip(12))
    kw = dict(deduplicate=True, face_restore=True, face_model="sr")
    with contextlib.redirect_stdout(io.StringIO()):
        _fail_batch(monkeypatch, 2)
        straight = VideoRestorer(_cfg(tmp_path, wdir, "s", **kw))\
            .restore_video(src, tmp_path / "s.y4m")
        _fail_batch(monkeypatch, 2)
        _killed_in_interpolate(_cfg(tmp_path, wdir, "r", **kw), src, tmp_path / "r.y4m")
        res = VideoRestorer(_cfg(tmp_path, wdir, "r", **kw))\
            .restore_video(src, tmp_path / "r.y4m")
    assert res.batches == 0 and res.interpolation["resumed_from"] == 8
    assert straight.errors == res.errors > 0
    assert straight.quality is not None and res.quality == straight.quality
    assert (res.resumed_from, res.faces_restored, res.pre_sr, res.post_sr) == \
        (straight.resumed_from, straight.faces_restored, straight.pre_sr, straight.post_sr)
    assert res.dedup.duplicates == straight.dedup.duplicates == 3
    assert (tmp_path / "r.y4m").read_bytes() == (tmp_path / "s.y4m").read_bytes()
    assert (tmp_path / "r" / "qa_report.json").is_file()


def test_resume_inside_the_interpolate_stage_gates_as_the_straight_run(tmp_path, rife):
    """Without ``continue_on_error`` a failing gate raises after the
    interpolate stage, on a rerun that resumes in it as in a straight
    run."""
    wdir, _ = rife
    src = _write(tmp_path / "a.y4m", pan_clip(8, pad=False))
    kw = dict(min_psnr=99.0, continue_on_error=False)
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(ValidationError, match="quality gates failed"):
            VideoRestorer(_cfg(tmp_path, wdir, "s", **kw)).restore_video(src, tmp_path / "s.y4m")
        _killed_in_interpolate(_cfg(tmp_path, wdir, "r", **kw), src, tmp_path / "r.y4m", at=6)
        with pytest.raises(ValidationError, match="quality gates failed"):
            VideoRestorer(_cfg(tmp_path, wdir, "r", **kw)).restore_video(src, tmp_path / "r.y4m")
    assert (tmp_path / "r.y4m").read_bytes() == (tmp_path / "s.y4m").read_bytes()


def test_failed_interpolate_stage_kills_ffmpeg(tmp_path, rife, stub_ffmpeg, monkeypatch):
    """An mp4 output that fails inside the interpolate stage: the encoder
    is killed and the stage's own exception comes out, not the
    encoder's (the stub exits 1 when it is handed EOF)."""
    wdir, _ = rife
    src = _write(tmp_path / "a.y4m", pan_clip(8, pad=False))
    monkeypatch.setenv("FW_STUB_ENCODE_RC", "1")
    with contextlib.redirect_stdout(io.StringIO()):
        _killed_in_interpolate(_cfg(tmp_path, wdir, "r"), src, tmp_path / "r.mp4", at=4)
    assert not (tmp_path / "r.mp4").exists()


def test_resume_inside_the_enhance_stage_with_interpolation(tmp_path, rife):
    """Plain 2x (no dedup): a run stopped after 4 enhanced frames resumes
    in the intermediate at frame 4 and writes the straight run's bytes;
    ``keep_intermediates`` keeps the intermediate."""
    wdir, _ = rife
    src = _write(tmp_path / "a.y4m", pan_clip(8, pad=False))

    def stop(info):
        if info.frames_done >= 4:
            raise _Stop(info.frames_done)

    with contextlib.redirect_stdout(io.StringIO()):
        VideoRestorer(_cfg(tmp_path, wdir, "s")).restore_video(src, tmp_path / "s.y4m")
        with pytest.raises(_Stop):
            VideoRestorer(_cfg(tmp_path, wdir, "r", keep_intermediates=True), stop)\
                .restore_video(src, tmp_path / "r.y4m")
        res = VideoRestorer(_cfg(tmp_path, wdir, "r", keep_intermediates=True))\
            .restore_video(src, tmp_path / "r.y4m")
    assert res.resumed_from == 4 and res.frames_out == 15
    assert (tmp_path / "r.y4m").read_bytes() == (tmp_path / "s.y4m").read_bytes()
    with Y4MReader(tmp_path / "r" / "work" / "enhanced.y4m") as r:
        assert r.count_frames() == 8


@pytest.mark.parametrize("free_gb,want", [(80, 4), (9, 2), (3, 0)])
def test_interpolation_pairs_from_free_memory(free_gb, want):
    """The interpolate stage's step: as many 4K pairs as fit the free
    memory (the planner's row: 410 B a pixel of a pair, the card's
    reading 368), at most 4; none fitting is ``HBMError``."""
    from framewright_tpu_torch import planner
    from framewright_tpu_torch.errors import HBMError

    if want == 0:
        with pytest.raises(HBMError):
            planner.interpolation_pairs(2160, 3840, free_gb * 2**30)
        return
    assert planner.interpolation_pairs(2160, 3840, free_gb * 2**30) == want
    assert planner.interpolation_bytes(2160, 3840, want) == want * 2176 * 3840 * 410
