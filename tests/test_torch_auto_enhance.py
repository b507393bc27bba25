"""Content analysis and auto-enhance in the port
(``processors/analysis.py``, numpy on the host as in JAX, and the
restorer's ``_apply_auto_enhance``) held to the JAX package: the reports
and ``recommend_settings`` equal JAX's on clips that trigger each branch;
every override it can return names a field of the port's ``Config``; the
restorer applies JAX's overrides (the geometry never changes)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import framewright_tpu.restorer as jrestorer
from framewright_tpu.config import Config as JaxConfig
from framewright_tpu.processors import analysis as jan
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.io.y4m import Y4MWriter
from framewright_tpu_torch.processors import analysis as pan
from framewright_tpu_torch.restorer import VideoRestorer

from conftest import make_gradient_frame


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _clip(kind: str, n: int = 24, h: int = 48, w: int = 64) -> list:
    rng = np.random.default_rng(len(kind))
    out = []
    for t in range(n):
        f = make_gradient_frame(h, w, t).astype(np.float32)
        if kind == "noisy":
            f += rng.normal(0, 25, f.shape)
        elif kind == "blocky":
            f = np.repeat(np.repeat(f[::8, ::8], 8, 0), 8, 1)[:h, :w] + rng.normal(0, 1, f.shape)
        elif kind == "bw":
            f = np.repeat(f.mean(-1, keepdims=True), 3, -1)
        elif kind == "flicker":
            f *= 0.5 + 0.5 * (t % 2)
        elif kind == "interlaced":
            f[1::2] = np.roll(f[1::2], 6, axis=1)
        elif kind == "cartoon":
            f = np.where(f > 128, 230.0, 20.0)
            f[:, ::3] = 250.0
        elif kind == "soft":
            f = np.full_like(f, 120.0) + 10 * np.sin(np.arange(w) / 9.0)[None, :, None]
        out.append(np.clip(f, 0, 255).astype(np.uint8))
    return out


KINDS = ["clean", "noisy", "blocky", "bw", "flicker", "interlaced", "cartoon", "soft"]


@pytest.mark.parametrize("kind", KINDS)
def test_report_and_recommendations_equal_jax(kind):
    clip = _clip(kind)
    p = pan.ContentAnalyzer().analyze(iter(clip), height=96)
    j = jan.ContentAnalyzer().analyze(iter(clip), height=96)
    assert p.to_dict() == j.to_dict()
    assert dataclasses.asdict(p.stats) == dataclasses.asdict(j.stats)
    rec = pan.recommend_settings(p)
    assert rec == jan.recommend_settings(j)
    fields = {f.name for f in dataclasses.fields(Config)}
    assert set(rec) <= fields, set(rec) - fields


def test_every_override_names_a_port_field():
    """All the branches of recommend_settings and the profile's
    overrides, forced."""
    rep = pan.AnalysisReport(degradations=list(pan.DegradationType),
                             content_type=pan.ContentType.ANIMATION)
    rec = pan.recommend_settings(rep)
    rep.content_type = pan.ContentType.BW_FILM
    rec.update(pan.recommend_settings(rep))
    from framewright_tpu_torch.processors.noise_profiler import NoiseProfile

    prof = NoiseProfile()
    prof.qp_removal, prof.recommended_denoiser, prof.preserve_grain = True, "nafnet", True
    rec.update(prof.config_overrides())
    fields = {f.name for f in dataclasses.fields(Config)}
    assert set(rec) <= fields, set(rec) - fields
    assert {"denoise", "deinterlace", "temporal_consistency", "qp_removal", "grain_preserve",
            "sr_model", "scale_factor", "denoise_model"} <= set(rec)


def test_frame_scores_and_credits_equal_jax():
    clip = _clip("noisy", 12) + [np.zeros((48, 64, 3), np.uint8)] * 10
    assert pan.CreditsDetector().analyze(iter(clip)) == jan.CreditsDetector().analyze(iter(clip))
    p, j = pan.FrameQualityScorer(), jan.FrameQualityScorer()
    assert p.analyze(iter(clip)) == j.analyze(iter(clip))
    assert p.worst(3) == j.worst(3) and p.summary() == j.summary()
    assert pan.estimate_source_height(clip[0]) == jan.estimate_source_height(clip[0])


@pytest.mark.parametrize("kind", ["blocky", "flicker", "bw"])
def test_restore_applies_jax_overrides(tmp_path, kind):
    src = tmp_path / "clip.y4m"
    with Y4MWriter(src, 64, 48, fps=24) as w:
        for f in _clip(kind, 12):
            w.write_frame(f)
    common = dict(sr_model="FW_fast6_x2", auto_enhance=True, checkpoint_enabled=False)
    jcfg = jrestorer.VideoRestorer(JaxConfig(project_dir=tmp_path / "pj", **common)) \
        ._apply_auto_enhance(src)
    r = VideoRestorer(Config(project_dir=tmp_path / "pt", device_platform="cpu", **common))
    res = r.restore_video(src, tmp_path / "o.y4m")
    over = res.pre_sr["auto_enhance"]["overrides"]
    base = JaxConfig(project_dir=tmp_path / "pj", **common)
    def norm(v):        # JAX's with_overrides turns tuples into lists
        return list(v) if isinstance(v, tuple) else v

    changed = {f.name for f in dataclasses.fields(JaxConfig)
               if norm(getattr(jcfg, f.name)) != norm(getattr(base, f.name))}
    assert over and set(over) == changed
    for k, v in over.items():
        assert getattr(r.config, k) == getattr(jcfg, k) == v
    assert r.config.sr_model == "FW_fast6_x2" and r.config.scale_factor == 2
    assert res.frames_out == 12
