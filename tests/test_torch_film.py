"""Film restoration in the port (``processors/film``: defect repair,
grain, stock detection, gate weave) against the JAX package, and the
restore that runs it: ``--deduplicate --defect-repair --grain match``
on FW_fast6_x2 against the JAX restore, a stopped and resumed grain
restore against a straight one, and the config's new fields."""

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
from conftest import make_gradient_frame
from framewright_tpu.cli import main as jax_main
from framewright_tpu.config import Config as JaxConfig
from framewright_tpu.processors import film as jfilm
from framewright_tpu_torch import cli
from framewright_tpu_torch.config import Config, build_config
from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.io.y4m import Y4MWriter
from framewright_tpu_torch.processors import film
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution
from framewright_tpu_torch.restorer import VideoRestorer

FLAGS = ["--deduplicate", "--defect-repair", "--grain", "match"]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def film_clip(n: int = 16, h: int = 48, w: int = 64):
    """18 -> 24 fps (every fourth frame an exact repeat of the one before),
    a bright scratch in column 21 and a dust speck every fourth frame
    from frame 1 (never on a repeat)."""
    frames = []
    for t in range(n):
        f = make_gradient_frame(h, w, t - (t + 1) // 4).astype(np.int16)
        f[:, 21] += 60
        if t % 4 == 1:
            f[10:12, 30:32] = 250
        frames.append(np.clip(f, 0, 255).astype(np.uint8))
    return frames


def _write(path: Path, frames, fps: int = 24) -> Path:
    with Y4MWriter(path, frames[0].shape[1], frames[0].shape[0], fps=fps) as wr:
        for f in frames:
            wr.write_frame(f)
    return path


def _planes(path: Path):
    header, rest = path.read_bytes().split(b"\n", 1)
    return [np.frombuffer(c, np.uint8) for c in rest.split(b"FRAME\n")[1:]]


def _worst(a, b):
    assert len(a) == len(b)
    d = [np.abs(x.astype(np.int16) - y) for x, y in zip(a, b)]
    return int(max(x.max() for x in d)), float(max(x.mean() for x in d))


# -- the numpy copies: equal -------------------------------------------------

@pytest.mark.parametrize("n", [12, 5, 1])
def test_defect_repairer_equals_jax(n):
    """Scratch columns from the first 8 frames (none in a shorter clip),
    dust against the median of 5-frame windows, 3 or 4 at the ends (the
    even ones average the two middle values, as np.median does)."""
    frames = film_clip(n)
    port = film.DefectRepairer(scratch_threshold=12.0, dust_threshold=45.0)
    got = list(port.process_stream(iter(frames)))
    want = list(jfilm.DefectRepairer(12.0, 45.0).process_stream(iter(frames)))
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert port.report.scratch_columns == ([19, 21, 23] if n >= 8 else [])
    assert (port.report.dust_count > 0) == (n > 1)     # one frame is its own median
    # the scratch is gone from the repaired frames
    if n >= 8:
        assert not np.array_equal(got[0][:, 21], frames[0][:, 21])


@pytest.mark.parametrize("mode,target", [("remove", 0.2), ("synthesize", 0.2),
                                         ("match", 0.05), ("match", 0.9), ("match", None),
                                         ("preserve", 0.2)],
                         ids=["remove", "synthesize", "match-down", "match-up",
                              "match-near", "preserve"])
def test_grain_manager_equals_jax(mode, target):
    """Every mode on the same frames with the same seed: the same bytes
    and the same generator state after."""
    frames = film_clip(4, 40, 56)
    if target is None:                    # within 0.05 of the frames' level
        target = film.estimate_grain_level(frames[0])
    port = film.GrainManager(mode=mode, strength=0.3, seed=7)
    jax = jfilm.GrainManager(mode=mode, strength=0.3, seed=7)
    for f in frames:
        np.testing.assert_array_equal(port.process(f, target_level=target),
                                      jax.process(f, target_level=target))
    assert port.rng.bit_generator.state == jax._rng.bit_generator.state
    assert port.strength == jax.strength


@pytest.mark.parametrize("kind", ["colour", "grey", "faded"])
def test_film_stock_detector_equals_jax(kind):
    frames = film_clip(6, 40, 56)
    if kind == "grey":
        frames = [np.repeat(f.mean(-1, keepdims=True).astype(np.uint8), 3, -1) for f in frames]
    elif kind == "faded":
        frames = [(f * 0.6 + 60).astype(np.uint8) for f in frames]
    else:
        frames = [(f * np.array([1.0, 0.8, 0.6])).astype(np.uint8) for f in frames]
    got = film.FilmStockDetector().analyze(iter(frames), max_frames=4)
    want = jfilm.FilmStockDetector().analyze(iter(frames), max_frames=4)
    assert got.__dict__ == want.__dict__
    assert film.FILM_STOCK_PROFILES == jfilm.FILM_STOCK_PROFILES


def test_gate_weave_stabilizer_within_one_lsb():
    """Phase correlation on the host (equal), the sub-pixel translation on
    the port's flow_warp (the JAX one's f32 arithmetic may round one
    value a step away)."""
    base = make_gradient_frame(40, 56, 0)
    jitter = [(0, 0), (1, -2), (-1, 1), (2, 0), (0, 2), (-2, -1)]
    frames = [np.roll(base, j, axis=(0, 1)) for j in jitter]
    assert (film.GateWeaveStabilizer.phase_shift(frames[0], frames[1])
            == jfilm.GateWeaveStabilizer.phase_shift(frames[0], frames[1]))
    got = film.GateWeaveStabilizer(smooth_window=3).stabilize(frames)
    want = jfilm.GateWeaveStabilizer(smooth_window=3).stabilize(frames)
    assert len(got) == len(want) == len(frames)
    for a, b in zip(got, want):
        assert np.abs(a.astype(np.int16) - b).max() <= 1
    assert film.GateWeaveStabilizer().stabilize(frames[:2])[1] is frames[1]


# -- the restore ---------------------------------------------------------------

class _PortSR:
    """The port's SR processor (on the CPU) in the JAX restorer's place:
    the JAX restore then differs from the port's only where the two
    restorers do."""

    def __init__(self, jax_cfg):
        self.inner = SuperResolution(SRConfig(model_name=jax_cfg.model_name, device="cpu"))

    def setup(self, h, w):
        self.inner.setup(h, w)
        self._plan = SimpleNamespace(batch=self.inner.plan.batch, tiled=False)

    def output_size(self, h, w):
        return self.inner.output_size(h, w)

    def dispatch(self, frames):
        return self.inner.dispatch(frames)

    def materialize(self, handle):
        return self.inner.materialize(handle)

    def teardown(self):
        self.inner.teardown()


def test_film_restore_equals_jax_around_the_same_sr(tmp_path, monkeypatch):
    """The JAX restore with the port's SR in place of its own: the port's
    restore byte for byte (mapping, defect repair, the gate's RGB path,
    grain with its measured target, the host encode)."""
    src = _write(tmp_path / "film.y4m", film_clip())
    monkeypatch.setattr(jrestorer, "SuperResolution", _PortSR)
    common = dict(sr_model="FW_fast6_x2", deduplicate=True, defect_repair=True,
                  grain_mode="match", checkpoint_enabled=False)
    with contextlib.redirect_stdout(io.StringIO()):
        jres = jrestorer.VideoRestorer(JaxConfig(project_dir=tmp_path / "pj", **common)) \
            .restore_video(src, tmp_path / "jax.y4m")
        res = VideoRestorer(Config(project_dir=tmp_path / "pt", device_platform="cpu",
                                   **common)).restore_video(src, tmp_path / "port.y4m")
    assert (tmp_path / "port.y4m").read_bytes() == (tmp_path / "jax.y4m").read_bytes()
    assert res.dedup.frame_mapping == jres.dedup.frame_mapping
    assert res.quality.to_dict() == jres.quality.to_dict()
    assert res.pre_sr["defect_repair"]["scratch_columns"] == [19, 21, 23]
    assert res.post_sr["grain"]["mode"] == "match" and res.post_sr["grain"]["target"] > 0.05


def test_film_restore_cli_matches_jax_cli(tmp_path, capsys):
    """Both CLIs with ``--deduplicate --defect-repair --grain match``: the
    port's planes against the JAX ones within the SR's own difference on
    the RGB path. That difference, the same restore with ``--deduplicate``
    alone (SR on the same frames, outputs repeated, no other change), was
    max 2, mean 0.2506 LSB a frame on this clip (measured); grain scales a
    frame by up to 1 + strength from its level, so the film restore is
    held to one LSB more at the worst pixel and 0.02 more in the mean
    (measured: max 3, mean 0.2580)."""
    src = _write(tmp_path / "film.y4m", film_clip())
    base = ["--model", "FW_fast6_x2", "--device", "cpu"]
    worst = {}
    for name, extra in (("dedup", ["--deduplicate"]), ("film", FLAGS)):
        assert jax_main(["restore", str(src), "-o", str(tmp_path / f"j{name}.y4m"), *base,
                         *extra, "--project-dir", str(tmp_path / f"pj{name}")]) == 0
        capsys.readouterr()
        assert cli.main(["restore", str(src), "-o", str(tmp_path / f"p{name}.y4m"), *base,
                         *extra, "--project-dir", str(tmp_path / f"pt{name}")]) == 0
        summary = json.loads(capsys.readouterr().out)
        assert summary["duplicates_removed"] == 4 and summary["frames"] == 16
        worst[name] = _worst(_planes(tmp_path / f"p{name}.y4m"),
                             _planes(tmp_path / f"j{name}.y4m"))
    assert summary["pre_sr"]["defect_repair"]["scratch_columns"] == [19, 21, 23]
    assert summary["post_sr"]["grain"]["mode"] == "match"
    assert worst["dedup"][0] <= 2 and worst["dedup"][1] <= 0.26, worst
    assert worst["film"][0] <= worst["dedup"][0] + 1, worst
    assert worst["film"][1] <= worst["dedup"][1] + 0.02, worst


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flags", [{"grain_mode": "match"},
                                   {"grain_mode": "match", "deduplicate": True,
                                    "defect_repair": True}],
                         ids=["grain", "film"])
def test_resumed_grain_restore_equals_a_straight_one(tmp_path, flags):
    """Stopped after 4 frames (batch 2), then rerun: the checkpoint holds
    the generator's state and the measured target at the resume point,
    so the rest of the run draws the straight run's grain. The JAX
    restorer starts both anew on a resume."""
    src = _write(tmp_path / "film.y4m", film_clip(10))

    def cfg(proj):
        return Config(sr_model="FW_fast6_x2", device_platform="cpu", batch_size=2,
                      project_dir=tmp_path / proj, **flags)

    def stop(info):
        if info.frames_done >= 4:
            raise _Stop(info.frames_done)

    with contextlib.redirect_stdout(io.StringIO()):
        straight = VideoRestorer(cfg("s")).restore_video(src, tmp_path / "s.y4m")
        with pytest.raises(_Stop):
            VideoRestorer(cfg("r"), stop).restore_video(src, tmp_path / "r.y4m")
        ckpt = json.loads(next((tmp_path / "r" / "checkpoints").glob("*.json")).read_text())
        res = VideoRestorer(cfg("r")).restore_video(src, tmp_path / "r.y4m")
    assert ckpt["frames_done"] == {"enhance": 4} and "4" in ckpt["carry"]
    assert res.resumed_from == 4 and res.post_sr == straight.post_sr
    assert (tmp_path / "r.y4m").read_bytes() == (tmp_path / "s.y4m").read_bytes()


def test_resume_without_a_carried_state_starts_over(tmp_path):
    """A checkpoint that holds no grain state for any point: the rerun
    starts from frame 0 and still writes the straight run's bytes."""
    src = _write(tmp_path / "film.y4m", film_clip(8))
    cfg = Config(sr_model="FW_fast6_x2", device_platform="cpu", batch_size=2,
                 grain_mode="match", project_dir=tmp_path / "p")

    def stop(info):
        if info.frames_done >= 4:
            raise _Stop(info.frames_done)

    with contextlib.redirect_stdout(io.StringIO()):
        VideoRestorer(Config(**{**cfg.to_dict(), "project_dir": tmp_path / "s"}))\
            .restore_video(src, tmp_path / "s.y4m")
        with pytest.raises(_Stop):
            VideoRestorer(cfg, stop).restore_video(src, tmp_path / "r.y4m")
        path = next((tmp_path / "p" / "checkpoints").glob("*.json"))
        ckpt = json.loads(path.read_text())
        ckpt["carry"] = {}
        path.write_text(json.dumps(ckpt))
        res = VideoRestorer(cfg).restore_video(src, tmp_path / "r.y4m")
    assert res.resumed_from == 0
    assert (tmp_path / "r.y4m").read_bytes() == (tmp_path / "s.y4m").read_bytes()


# -- config ---------------------------------------------------------------------

def test_config_fields_defaults_and_validation():
    cfg, jcfg = Config(), JaxConfig()
    for name in ("deduplicate", "dedup_similarity", "dedup_hash_size", "defect_repair",
                 "defect_scratch_sensitivity", "defect_dust_sensitivity", "grain_preserve",
                 "grain_strength", "grain_mode", "grain_target", "seed"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    with pytest.raises(ConfigError, match="grain_mode"):
        Config(grain_mode="heavy")
    with pytest.raises(ConfigError, match="dedup_similarity"):
        Config(dedup_similarity=1.5)
    # each changes the output, so each keys the checkpoint
    for change in ({"deduplicate": True}, {"defect_repair": True}, {"grain_mode": "remove"},
                   {"seed": 3}, {"grain_target": 0.4}, {"dedup_similarity": 0.9}):
        assert Config(**change).get_hash() != cfg.get_hash(), change


@pytest.mark.parametrize("preset", ["archive", "ultimate"])
def test_waiting_presets_name_only_interpolation_and_faces(preset, tmp_path):
    """The presets build since slice 9; without checkpoints a restore
    waits for the interpolation and face models' only, naming both."""
    from framewright_tpu_torch.errors import InputError

    cfg = build_config(preset, cli_overrides={"weights_dir": tmp_path, "device_platform": "cpu",
                                "project_dir": tmp_path / "p"})
    assert cfg.deduplicate and cfg.defect_repair
    src = _write(tmp_path / "film.y4m", film_clip(4))
    with pytest.raises(InputError) as err:
        VideoRestorer(cfg).restore_video(src, tmp_path / "o.y4m")
    msg = str(err.value)
    assert "rife-v4.6.npz" in msg and "GFPGANv1.4.npz" in msg
    assert "A10" not in msg and "dedup" not in msg and "defect" not in msg
