"""Scene intelligence, HDR output and the restore's new stream stages in
the port, held to the JAX package.

``processors/scene_intelligence.py`` and ``processors/hdr.py`` are numpy
on the host, as in JAX: their analyses, maps, filtered frames, HDR frames
and the HDR10+ sidecar's JSON equal JAX's. The restore with every new
stage on (VHS, stabilization, the heat-fill watermark removal, QP
removal, the latent temporal model, the scene-adaptive filter, HDR10+)
against the JAX restore around the same SR (the port's SR processor in
the JAX restorer's place): the frames each hands its SR within 1 LSB on
at most 0.1% of the values (QP removal's f32 DCT, summed in another order
than XLA's, moves a value one step on ~0.01% of a frame; every other
stage is equal), the written output and the HDR10+ sidecar equal byte for
byte on every frame whose SR input is equal (with QP removal off: all of
them). Each stage
resumed equals a straight run: the port's pre-SR stream runs from frame 0
on a resume (the ring drops the frames before the resume point), so no
pre-SR stage carries state; the checkpoint carries the HDR10+ collector's
frames at each resume point, as it carries grain's generator.
"""

from __future__ import annotations

import contextlib
import io
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import framewright_tpu.restorer as jrestorer
from framewright_tpu.config import Config as JaxConfig
from framewright_tpu.processors import hdr as jhdr
from framewright_tpu.processors import scene_intelligence as jsi
from framewright_tpu_torch import cli
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.io.y4m import Y4MWriter
from framewright_tpu_torch.processors import hdr as phdr
from framewright_tpu_torch.processors import scene_intelligence as psi
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution
from framewright_tpu_torch.restorer import VideoRestorer

from conftest import make_gradient_frame

STAGES = dict(vhs_restore=True, stabilize=True, stabilize_smoothing=3, qp_removal=True,
              temporal_consistency=True, temporal_model="latent", scene_adaptive=True,
              hdr_output="hdr10plus", watermark_removal=True, inpaint_model="diffusion")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def scene_clip(n: int = 20, h: int = 48, w: int = 64, seed: int = 0) -> list:
    """Shaky, noisy frames with a static caption bar, a dark stretch and
    a cut."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        f = make_gradient_frame(h, w, t if t < 12 else t + 40).astype(np.float32)
        if 6 <= t < 9:
            f *= 0.3
        f = np.roll(f, (t % 3 - 1, (t * 2) % 5 - 2), axis=(0, 1))
        f[36:42, 8:40] = 235
        out.append(np.clip(f + rng.normal(0, 3, f.shape), 0, 255).astype(np.uint8))
    return out


def _write(path: Path, frames) -> Path:
    with Y4MWriter(path, frames[0].shape[1], frames[0].shape[0], fps=24) as w:
        for f in frames:
            w.write_frame(f)
    return path


# -- scene intelligence ------------------------------------------------------------

def test_scene_analysis_map_and_filter_equal_jax():
    clip = scene_clip()
    p = psi.SceneIntelligence(sample_every=4, device="cpu")
    j = jsi.SceneIntelligence(sample_every=4)
    pa, ja = p.analyze_video(iter(clip)), j.analyze_video(iter(clip))
    assert [a.to_dict() for a in pa] == [a.to_dict() for a in ja]
    pm, jm = p.generate_processing_map(pa), j.generate_processing_map(ja)
    assert {k: v.to_dict() for k, v in pm.items()} == {k: v.to_dict() for k, v in jm.items()}
    assert psi.SceneIntelligence.get_summary(pa) == jsi.SceneIntelligence.get_summary(ja)
    pf, jf = psi.SceneAdaptiveFilter(pm), jsi.SceneAdaptiveFilter(jm)
    for a, b in zip(list(pf.process_stream(iter(clip))), list(jf.process_stream(iter(clip)))):
        np.testing.assert_array_equal(a, b)
    assert pf.frames_adjusted == jf.frames_adjusted


@pytest.mark.parametrize("kind", ["text", "face", "dark", "bright"])
def test_scene_frame_classes_equal_jax(kind):
    f = make_gradient_frame(64, 96, 3).copy()
    if kind == "text":
        f[20:32, ::2] = 255
        f[20:32, 1::2] = 0
    elif kind == "face":
        f[10:50, 30:70] = (205, 150, 125)
    elif kind == "dark":
        f = (f * 0.1).astype(np.uint8)
    else:
        f = np.full_like(f, 230)
    p = psi.SceneIntelligence(device="cpu").analyze_frame(f, 0, np.roll(f, 7, 1))
    j = jsi.SceneIntelligence().analyze_frame(f, 0, np.roll(f, 7, 1))
    assert p.to_dict() == j.to_dict()
    assert (psi.SceneIntelligence.get_adaptive_settings(p).to_dict()
            == jsi.SceneIntelligence.get_adaptive_settings(j).to_dict())


# -- HDR -------------------------------------------------------------------------

@pytest.mark.parametrize("target", ["hdr10", "hdr10plus", "hlg"])
def test_hdr_expand_and_sidecar_equal_jax(target):
    clip = scene_clip(6)
    cfg = dict(mode="expand", target=target, peak_nits=1200.0, highlight_boost=0.8)
    p, j = phdr.HDRConverter(phdr.HDRConfig(**cfg)), jhdr.HDRConverter(jhdr.HDRConfig(**cfg))
    for f in clip:
        np.testing.assert_array_equal(p.expand_frame(f), j.expand_frame(f))
    if target == "hdr10plus":
        assert p.collector.to_json() == j.collector.to_json()
        assert p.collector.scenes() == j.collector.scenes()
    else:
        assert p.collector is None and j.collector is None


def test_hdr_tonemap_and_curves_equal_jax():
    f = scene_clip(1)[0]
    for mapper in ("hable", "reinhard"):
        cfg = dict(mode="tonemap", tonemapper=mapper)
        np.testing.assert_array_equal(phdr.HDRConverter(phdr.HDRConfig(**cfg)).tonemap_frame(f),
                                      jhdr.HDRConverter(jhdr.HDRConfig(**cfg)).tonemap_frame(f))
    x = np.linspace(0, 1, 257, dtype=np.float32)
    for fn in ("pq_encode", "pq_decode", "hlg_oetf", "srgb_to_linear", "linear_to_srgb",
               "hable_tonemap", "reinhard_tonemap"):
        np.testing.assert_array_equal(getattr(phdr, fn)(x), getattr(jhdr, fn)(x))


def test_hdr_config_validation():
    with pytest.raises(ConfigError, match="hdr_output"):
        Config(hdr_output="dolby")
    assert Config(hdr_output="hlg").hdr_peak_nits == 1000.0


# -- the restore ----------------------------------------------------------------------

class _PortSR:
    """The port's SR processor (on the CPU) in the JAX restorer's place,
    keeping the frames each dispatch is given."""

    def __init__(self, jax_cfg):
        self.inner = SuperResolution(SRConfig(model_name=jax_cfg.model_name, device="cpu",
                                              batch_size=jax_cfg.batch_size))
        _PortSR.fed = []

    def setup(self, h, w):
        self.inner.setup(h, w)
        self._plan = SimpleNamespace(batch=self.inner.plan.batch, tiled=False)

    def output_size(self, h, w):
        return self.inner.output_size(h, w)

    def dispatch(self, frames):
        _PortSR.fed.append(frames.copy())
        return self.inner.dispatch(frames)

    def materialize(self, handle):
        return self.inner.materialize(handle)

    def teardown(self):
        self.inner.teardown()


class _Fed(SuperResolution):
    """The port's SR processor, keeping the frames each dispatch is given."""
    fed: list = []

    def dispatch(self, frames):
        _Fed.fed.append(frames.copy())
        return super().dispatch(frames)


def _frames_of(path: Path) -> np.ndarray:
    from framewright_tpu_torch.io.y4m import Y4MReader

    with Y4MReader(path) as r:
        return np.stack(list(r))


@pytest.mark.parametrize("qp", [False, True], ids=["all-but-qp", "all"])
def test_every_new_stage_against_jax_around_the_same_sr(tmp_path, monkeypatch, qp):
    import framewright_tpu_torch.restorer as prestorer

    src = _write(tmp_path / "clip.y4m", scene_clip())
    monkeypatch.setattr(jrestorer, "SuperResolution", _PortSR)
    monkeypatch.setattr(prestorer, "SuperResolution", _Fed)
    _Fed.fed = []
    common = dict(sr_model="FW_fast6_x2", checkpoint_enabled=False, batch_size=4,
                  **{**STAGES, "qp_removal": qp})
    with contextlib.redirect_stdout(io.StringIO()):
        jrestorer.VideoRestorer(JaxConfig(project_dir=tmp_path / "pj", **common)) \
            .restore_video(src, tmp_path / "jax.y4m")
        res = VideoRestorer(Config(project_dir=tmp_path / "pt", device_platform="cpu",
                                   **common)).restore_video(src, tmp_path / "port.y4m")
    fed, jfed = np.concatenate(_Fed.fed), np.concatenate(_PortSR.fed)
    d = np.abs(fed.astype(np.int16) - jfed)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())
    same = [i for i in range(len(fed)) if np.array_equal(fed[i], jfed[i])]
    got, want = _frames_of(tmp_path / "port.y4m"), _frames_of(tmp_path / "jax.y4m")
    for i in same:
        np.testing.assert_array_equal(got[i], want[i])
    if not qp:
        assert len(same) == 20
        assert (tmp_path / "port.y4m").read_bytes() == (tmp_path / "jax.y4m").read_bytes()
        sidecar = Path(str(tmp_path / "port.y4m") + ".hdr10plus.json")
        assert sidecar.read_text() == Path(str(tmp_path / "jax.y4m")
                                           + ".hdr10plus.json").read_text()
    pre = res.pre_sr
    assert pre["inpaint"]["mask_fraction"] > 0 and pre["stabilize"]["frames"] == 20
    assert pre["temporal_consistency"] == "latent" and pre["scene_adaptive"]["segments"] >= 1
    assert res.post_sr["hdr"]["target"] == "hdr10plus"


def test_cli_flags_run_the_stages(tmp_path, capsys):
    src = _write(tmp_path / "clip.y4m", scene_clip(8))
    assert cli.main(["restore", str(src), "-o", str(tmp_path / "o.y4m"), "--model", "FW_fast6_x2",
                     "--device", "cpu", "--project-dir", str(tmp_path / "p"), "--vhs",
                     "--stabilize", "--stabilize-smoothing", "4", "--stabilize-crop", "0.9",
                     "--qp-removal", "--qp-strength", "2.5", "--temporal-consistency",
                     "--temporal-model", "latent", "--scene-adaptive", "--hdr", "hlg"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["frames"] == 8 and summary["errors"] == 0
    pre = summary["pre_sr"]
    assert set(pre) >= {"vhs", "stabilize", "qp_removal", "scene_adaptive"}
    assert pre["qp_removal"]["strength"] == 2.5 and pre["temporal_consistency"] == "latent"
    assert summary["post_sr"]["hdr"] == {"target": "hlg", "peak_nits": 1000.0, "scenes": None}
    assert not Path(str(tmp_path / "o.y4m") + ".hdr10plus.json").exists()


class _Stop(Exception):
    pass


@pytest.mark.parametrize("stage", [
    {"vhs_restore": True}, {"stabilize": True, "stabilize_smoothing": 3},
    {"watermark_removal": True, "inpaint_model": "diffusion"}, {"qp_removal": True},
    {"temporal_consistency": True, "temporal_model": "latent"}, {"scene_adaptive": True},
    {"hdr_output": "hdr10plus"}, STAGES],
    ids=["vhs", "stabilize", "inpaint", "qp", "latent", "scene-adaptive", "hdr10plus", "all"])
def test_each_stage_resumed_equals_a_straight_run(tmp_path, stage):
    src = _write(tmp_path / "clip.y4m", scene_clip(10))

    def cfg(proj):
        return Config(sr_model="FW_fast6_x2", device_platform="cpu", batch_size=2,
                      project_dir=proj, **stage)

    def stop(info):
        if info.frames_done >= 4:
            raise _Stop()

    VideoRestorer(cfg(tmp_path / "a")).restore_video(src, tmp_path / "straight.y4m")
    with pytest.raises(_Stop):
        VideoRestorer(cfg(tmp_path / "b"), stop).restore_video(src, tmp_path / "resumed.y4m")
    res = VideoRestorer(cfg(tmp_path / "b")).restore_video(src, tmp_path / "resumed.y4m")
    assert res.resumed_from == 4
    assert (tmp_path / "resumed.y4m").read_bytes() == (tmp_path / "straight.y4m").read_bytes()
    side = [Path(str(tmp_path / f"{n}.y4m") + ".hdr10plus.json") for n in ("straight", "resumed")]
    if stage.get("hdr_output") == "hdr10plus":
        assert side[1].read_text() == side[0].read_text()
        assert len(json.loads(side[0].read_text())["SceneInfo"]) == 10
    else:
        assert not side[0].exists()
