"""The diffusion SR's processor, guided backend and restore in the port
held to the JAX package on the packaged checkpoint; the tolerances and
the bf16 bound are ``tests/test_torch_diffusion.py``'s (float32 uint8
within 1 LSB on at most 0.1% of the values; bfloat16 within 3 LSB, mean
under 0.3). A diffusion restore's bytes depend on its batch: a frame's
noise is its slice of its dispatch chunk's draw, as in JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import framewright_tpu.restorer as jrestorer
from framewright_tpu.config import Config as JaxConfig
from framewright_tpu.processors import guided as jg
from framewright_tpu.processors.super_resolution import SRConfig as JaxSRConfig
from framewright_tpu.processors.super_resolution import SuperResolution as JaxSR
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
from framewright_tpu_torch.processors import guided as pg
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution
from framewright_tpu_torch.restorer import VideoRestorer

U8_FRAC = 1e-3
BF16_MAX_LSB, BF16_MEAN_LSB = 3, 0.3


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _u8_within(got: np.ndarray, want: np.ndarray, dtype: str) -> dict:
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    stats = {"max": int(d.max()), "mean": float(d.mean()), "frac": float((d > 0).mean())}
    if dtype == "float32":
        assert stats["max"] <= 1 and stats["frac"] <= U8_FRAC, stats
    else:
        assert stats["max"] <= BF16_MAX_LSB and stats["mean"] <= BF16_MEAN_LSB, stats
    return stats


# -- the processor, the guided backend, the restore ------------------------------------

@pytest.mark.parametrize("case", [
    dict(dtype="float32", steps=1), dict(dtype="float32", steps=0, strength=0.5),
    dict(dtype="float32", steps=2, tile=8), dict(dtype="bfloat16", steps=8),
    dict(dtype="int8", steps=1)],
    ids=["f32-1", "f32-default-steps", "f32-tiled", "bf16-8", "int8-as-bf16"])
def test_sr_processor_matches_jax(case):
    """3 frames at batch 2 (a padded last chunk in JAX, a short one here:
    the same draws); tiles of 8 with a halo of 4, 2 a chunk. JAX's
    ``diffusion_strength`` (its ``propagate_t``) changes nothing: the port
    has no such field."""
    kw = dict(model_name="DiffusionSR_x4", compute_dtype=case["dtype"], batch_size=2,
              diffusion_steps=case["steps"], tile_size=case.get("tile", 0), tile_overlap=4)
    frames = np.random.default_rng(10).integers(0, 256, (3, 12, 20, 3), dtype=np.uint8)
    j = JaxSR(JaxSRConfig(diffusion_strength=case.get("strength", 0.0), **kw))
    j.setup(12, 20)
    want = j.process_batch(frames)
    p = SuperResolution(SRConfig(device="cpu", **kw))
    p.setup(12, 20)
    got = p.materialize(p.dispatch(frames))
    assert p.plan.tiled == bool(case.get("tile")) and p.plan.batch == j._plan.batch
    assert p.arch.steps == (case["steps"] or 1)
    assert got.shape == want.shape == (3, 48, 80, 3)
    _u8_within(got, want, "float32" if case["dtype"] == "float32" else "bfloat16")


def test_guided_diffusion_backend_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(tmp_path))
    frame = np.random.default_rng(11).integers(0, 256, (16, 24, 3), dtype=np.uint8)
    kw = dict(prompt="sharp warm", backend="diffusion", guidance_scale=3.0, seed=2)
    want = jg.make_backend(jg.GuidedConfig(**kw)).enhance(frame)
    backend = pg.make_backend(pg.GuidedConfig(device="cpu", **kw))
    got = backend.enhance(frame)
    assert got.shape == want.shape == (64, 96, 3)
    assert backend.rng_states() == []
    _u8_within(got, want, "float32")


def _clip(path: Path, n: int = 4) -> Path:
    frames = np.random.default_rng(12).integers(40, 216, (n, 16, 24, 3), dtype=np.uint8)
    with Y4MWriter(path, 24, 16, fps=12) as w:
        for f in frames:
            w.write_frame(f)
    return path


def _frames(path: Path) -> np.ndarray:
    with Y4MReader(path) as r:
        return np.stack(list(r))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_matches_jax_at_the_same_batch(tmp_path, dtype):
    """The default 8 steps over the one-step checkpoint (both restorers);
    4 frames at batch 2."""
    src = _clip(tmp_path / "clip.y4m")
    common = dict(sr_model="DiffusionSR_x4", scale_factor=4, batch_size=2,
                  compute_dtype=dtype, checkpoint_enabled=False, validate_output=False)
    with contextlib.redirect_stdout(io.StringIO()):
        jrestorer.VideoRestorer(JaxConfig(project_dir=tmp_path / "pj", **common)) \
            .restore_video(src, tmp_path / "jax.y4m")
        res = VideoRestorer(Config(project_dir=tmp_path / "pt", device_platform="cpu",
                                   **common)).restore_video(src, tmp_path / "port.y4m")
    assert res.batch_size == 2 and res.batches == 2 and res.errors == 0
    _u8_within(_frames(tmp_path / "port.y4m"), _frames(tmp_path / "jax.y4m"), dtype)


def _payload(path: Path) -> bytes:
    """A Y4M file's frames (markers and planes), without its header."""
    return path.read_bytes().split(b"\n", 1)[1]


def test_cli_restore_runs_the_default_steps(tmp_path, monkeypatch):
    """The CLI's default restore (bf16, validated): its SR runs the 8
    default steps; its written planes equal the same processor run alone
    on the frames the restore handed it, in its batches; and it is within
    the bf16 bound of the JAX CLI's restore of the same clip at the same
    batch."""
    from framewright_tpu import cli as jcli
    from framewright_tpu_torch import cli, restorer

    built = []
    real_build = restorer.build_sr

    def build_sr(*a, **k):
        sr = real_build(*a, **k)
        real_dispatch, sr.inputs = sr.dispatch, []

        def dispatch(frames):
            sr.inputs.append(np.array(frames))
            return real_dispatch(frames)

        sr.dispatch = dispatch
        built.append(sr)
        return sr

    monkeypatch.setattr(restorer, "build_sr", build_sr)
    jax_batches = []
    jax_dispatch = JaxSR.dispatch
    monkeypatch.setattr(JaxSR, "dispatch", lambda self, frames: (
        jax_batches.append(len(frames)), jax_dispatch(self, frames))[1])
    src = _clip(tmp_path / "clip.y4m", 2)
    argv = ["restore", str(src), "--model", "DiffusionSR_x4", "--device", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main([*argv, "-o", str(tmp_path / "port.y4m"),
                         "--project-dir", str(tmp_path / "p")]) == 0
        assert jcli.main([*argv, "-o", str(tmp_path / "jax.y4m"),
                          "--project-dir", str(tmp_path / "pj")]) == 0
    (sr,) = built
    assert sr.arch.steps == 8 and sr.config.compute_dtype == "bfloat16"
    assert [len(b) for b in sr.inputs] == jax_batches == [2]
    alone = SuperResolution(dataclasses.replace(sr.config))
    alone.setup(16, 24)
    with Y4MWriter(tmp_path / "alone.y4m", 96, 64, fps=12,
                   full_range=sr.config.yuv_full_range) as w:
        for batch in sr.inputs:
            y, u, v = alone.materialize(alone.dispatch(batch))
            for j in range(len(batch)):
                w.write_yuv_frame(y[j], u[j], v[j])
    assert _payload(tmp_path / "port.y4m") == _payload(tmp_path / "alone.y4m")
    got, want = _frames(tmp_path / "port.y4m"), _frames(tmp_path / "jax.y4m")
    assert got.shape == want.shape == (2, 64, 96, 3)
    _u8_within(got, want, "bfloat16")


class _Stop(Exception):
    pass


def test_resumed_restore_equals_a_straight_one(tmp_path):
    src = _clip(tmp_path / "clip.y4m")

    def cfg(proj):
        return Config(sr_model="DiffusionSR_x4", scale_factor=4, batch_size=2,
                      device_platform="cpu", project_dir=proj, diffusion_steps=2)

    def stop(info):
        if info.frames_done >= 2:
            raise _Stop()

    VideoRestorer(cfg(tmp_path / "a")).restore_video(src, tmp_path / "straight.y4m")
    with pytest.raises(_Stop):
        VideoRestorer(cfg(tmp_path / "b"), stop).restore_video(src, tmp_path / "resumed.y4m")
    res = VideoRestorer(cfg(tmp_path / "b")).restore_video(src, tmp_path / "resumed.y4m")
    assert res.resumed_from == 2
    assert (tmp_path / "resumed.y4m").read_bytes() == (tmp_path / "straight.y4m").read_bytes()
