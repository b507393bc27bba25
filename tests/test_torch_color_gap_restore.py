"""Colorization and gap filling in the port's restore, held to the JAX
restorer, and the restore verb's flags (C9).

The restore with both stages against the JAX restore around the same SR
(the port's SR processor in the JAX restorer's place): the frames each
hands its SR within 1 LSB on at most 0.1% of the values, the output equal
byte for byte on every frame whose SR input is equal; one frame more than
the source. Resumed equals straight byte for byte. What JAX does with an
inserted frame, and what the port repairs:

- the progress total: JAX's stays the source count; the port's grows by
  each inserted frame;
- dedup: JAX reads its mapping (keyed by source frame) by stream position,
  so after an insertion each frame takes another frame's unique index; the
  port maps each stream frame by its source frame and runs the SR on every
  inserted frame, so a dedup restore equals the restore without dedup on
  every frame that is not a duplicate;
- the scene-adaptive map: JAX's filter reads segments by stream position;
  the port's by source frame (an inserted frame: the frame before it);
- the checkpoint counts stream positions and the stream runs again from
  frame 0 (JAX's), and the quality gate observes inserted frames like any
  other (JAX's): both kept.

Missing ``ddcolor.npz`` or ``eccv16.npz`` raises ``InputError`` before any
frame is written; ``colorize_model="exemplar"`` in a restore raises
``ConfigError``. C9: ``--scale``, ``--tile``, ``--batch`` and
``--verbose`` parse into the ``Config`` as JAX's ``_config_from_args``
makes it, and so do ``--colorize``, ``--colorize-method`` and
``--fill-missing-frames``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import framewright_tpu.restorer as jrestorer
from framewright_tpu import cli as jcli
from framewright_tpu.config import Config as JaxConfig
from framewright_tpu.models import ddcolor as jdd
from framewright_tpu.processors import scene_intelligence as jsi
import framewright_tpu_torch.restorer as prestorer
from framewright_tpu_torch import cli
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import ConfigError, FramewrightError, InputError
from framewright_tpu_torch.io.video import open_reader
from framewright_tpu_torch.io.y4m import Y4MWriter
from framewright_tpu_torch.models import registry
from framewright_tpu_torch.processors import scene_intelligence as psi
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution
from framewright_tpu_torch.restorer import VideoRestorer


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _smooth_base(h=48, w=128):
    rng = np.random.default_rng(0)
    base = rng.random((h, w)) * 255
    for _ in range(20):
        base = (base + np.roll(base, 1, 1) + np.roll(base, -1, 1)
                + np.roll(base, 1, 0) + np.roll(base, -1, 0)) / 5
    return (base - base.min()) / (np.ptp(base) + 1e-6) * 255


def pan_clip(shifts) -> list:
    """Grey frames of a smooth texture panned by ``shifts`` px."""
    base = _smooth_base()
    return [np.stack([np.roll(base, s, axis=1)] * 3, -1).astype(np.uint8) for s in shifts]


# a 2 px pan with the frame at 12 px dropped (a gap before source frame 6)
GAP_SHIFTS = [0, 2, 4, 6, 8, 10, 14, 16, 18, 20, 22]
# the same with held frames (duplicates of sources 1, 4 and 8) around the gap
DUP_SHIFTS = [0, 2, 2, 4, 6, 6, 8, 10, 14, 16, 16, 18, 20]


def _write(path: Path, frames, fps: int = 24) -> Path:
    with Y4MWriter(path, frames[0].shape[1], frames[0].shape[0], fps=fps) as w:
        for f in frames:
            w.write_frame(f)
    return path


def _frames_of(path: Path) -> np.ndarray:
    with open_reader(path) as r:
        return np.stack(list(r))


class _PortSR:
    """The port's SR processor (on the CPU) in the JAX restorer's place,
    keeping the frames each dispatch is given."""
    fed: list = []

    def __init__(self, jax_cfg):
        self.inner = SuperResolution(SRConfig(model_name=jax_cfg.model_name, device="cpu",
                                              batch_size=jax_cfg.batch_size))

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


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's restore draw of DDColor (``PRNGKey(9)``, default config) as
    the port's ``ddcolor.npz``."""
    d = tmp_path_factory.mktemp("ddcolor_weights")
    registry.write_npz(jax.tree_util.tree_map(
        np.asarray, jdd.init(jax.random.PRNGKey(9), jdd.DDColorConfig())), d / "ddcolor.npz")
    return d


def _both(tmp_path, monkeypatch, src, weights_dir=None, progress=None, **common):
    """The JAX restore (the port's SR patched in) and the port's on ``src``,
    each into a PNG frame directory (the RGB writer path in both: the
    port's YUV-direct path rounds in another order than the JAX restorer's
    host encode) -> (port result, JAX result, port frames, JAX frames)."""
    monkeypatch.setattr(jrestorer, "SuperResolution", _PortSR)
    monkeypatch.setattr(prestorer, "SuperResolution", _Fed)
    _PortSR.fed, _Fed.fed = [], []
    jp, pp = (progress or (None, None))
    with contextlib.redirect_stdout(io.StringIO()):
        jres = jrestorer.VideoRestorer(JaxConfig(project_dir=tmp_path / "pj", **common), jp) \
            .restore_video(src, tmp_path / "jax")
        res = VideoRestorer(Config(project_dir=tmp_path / "pt", device_platform="cpu",
                                   weights_dir=weights_dir, **common), pp) \
            .restore_video(src, tmp_path / "port")
    return res, jres, _frames_of(tmp_path / "port"), _frames_of(tmp_path / "jax")


@pytest.mark.parametrize("method", ["palette", "ddcolor"])
def test_restore_with_both_stages_against_jax_around_the_same_sr(tmp_path, monkeypatch,
                                                                  weights, method):
    src = _write(tmp_path / "clip.y4m", pan_clip(GAP_SHIFTS))
    res, jres, got, want = _both(
        tmp_path, monkeypatch, src, weights_dir=weights, sr_model="FW_fast6_x2",
        checkpoint_enabled=False, batch_size=4, fill_missing_frames=True,
        gap_jump_ratio=1.5, colorize=True, colorize_model=method, colorize_keyframe_interval=4)
    assert len(got) == len(want) == len(GAP_SHIFTS) + 1 == res.frames_out
    assert res.pre_sr["fill_missing_frames"] == {"gaps": [6], "frames_inserted": 1}
    fed, jfed = np.concatenate(_Fed.fed), np.concatenate(_PortSR.fed)
    d = np.abs(fed.astype(np.int16) - jfed)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())
    same = [i for i in range(len(fed)) if np.array_equal(fed[i], jfed[i])]
    assert len(same) >= len(fed) // 2
    for i in same:
        np.testing.assert_array_equal(got[i], want[i])
    assert np.ptp(fed[0].astype(int), axis=-1).max() > 0         # coloured
    assert res.quality.to_dict() == jres.quality.to_dict()       # the same frames gated


class _Stop(Exception):
    pass


@pytest.mark.parametrize("stop_at,dedup", [(4, False), (8, False), (8, True)],
                         ids=["before-the-gap", "after-the-gap", "dedup-after-the-gap"])
def test_resumed_equals_straight(tmp_path, weights, stop_at, dedup):
    """Stopped after its first batches and resumed: byte for byte a
    straight run's. With dedup the resume point moves back to a source
    frame new to the mapping, found by the inserted positions the
    checkpoint kept."""
    src = _write(tmp_path / "clip.y4m", pan_clip(DUP_SHIFTS if dedup else GAP_SHIFTS))

    def cfg(proj):
        return Config(sr_model="FW_fast6_x2", device_platform="cpu", batch_size=2,
                      project_dir=proj, fill_missing_frames=True, gap_jump_ratio=1.5,
                      colorize=True, colorize_model="ddcolor", weights_dir=weights,
                      colorize_keyframe_interval=4, deduplicate=dedup, grain_mode="match")

    def stop(info):
        if info.frames_done >= stop_at:
            raise _Stop()

    straight = VideoRestorer(cfg(tmp_path / "a")).restore_video(src, tmp_path / "straight.y4m")
    with pytest.raises(_Stop):
        VideoRestorer(cfg(tmp_path / "b"), stop).restore_video(src, tmp_path / "resumed.y4m")
    res = VideoRestorer(cfg(tmp_path / "b")).restore_video(src, tmp_path / "resumed.y4m")
    assert 0 < res.resumed_from <= stop_at and res.frames_out == straight.frames_out
    assert (tmp_path / "resumed.y4m").read_bytes() == (tmp_path / "straight.y4m").read_bytes()
    if dedup:
        # position 8 is the inserted frame (before source 8), so the resume
        # moves back to position 6 (source 6, a new frame)
        assert res.resumed_from == 6 and straight.pre_sr["fill_missing_frames"]["gaps"] == [8]


def test_progress_total_counts_inserted_frames(tmp_path, monkeypatch):
    src = _write(tmp_path / "clip.y4m", pan_clip(GAP_SHIFTS))
    seen = {"jax": [], "port": []}
    _both(tmp_path, monkeypatch, src, sr_model="FW_fast6_x2", checkpoint_enabled=False,
          batch_size=4, fill_missing_frames=True, gap_jump_ratio=1.5,
          progress=(lambda i: seen["jax"].append((i.frames_done, i.total_frames)),
                    lambda i: seen["port"].append((i.frames_done, i.total_frames))))
    n = len(GAP_SHIFTS)
    assert seen["jax"][-1] == (n + 1, n)            # JAX: done passes the total
    assert seen["port"][-1] == (n + 1, n + 1)
    assert all(d <= t for d, t in seen["port"])


def test_dedup_maps_by_source_frame(tmp_path, monkeypatch):
    """Batch 1, so each frame's SR output does not depend on its batch:
    the port's dedup + gap-fill restore runs the SR on every inserted frame
    and every source frame that is not a duplicate, and equals the same
    restore without dedup on those frames; JAX's does neither."""
    src = _write(tmp_path / "clip.y4m", pan_clip(DUP_SHIFTS))
    common = dict(sr_model="FW_fast6_x2", checkpoint_enabled=False, batch_size=1,
                  fill_missing_frames=True, gap_jump_ratio=1.5, validate_output=False)
    res, jres, got, jgot = _both(tmp_path, monkeypatch, src, deduplicate=True, **common)
    port_fed, jax_fed = len(_Fed.fed), len(_PortSR.fed)
    _, _, plain, jplain = _both(tmp_path / "plain", monkeypatch, src, **common)
    gaps = res.pre_sr["fill_missing_frames"]["gaps"]
    assert gaps == [8] and len(got) == len(plain) == len(DUP_SHIFTS) + 1
    mapping = res.dedup.frame_mapping
    assert mapping == jres.dedup.frame_mapping and res.dedup.duplicates == 3
    # stream position -> source frame: the inserted frame sits at 8
    sources = list(range(8)) + [7] + list(range(8, len(DUP_SHIFTS)))
    fresh = [p for p, s in enumerate(sources)
             if p == 8 or s == 0 or mapping[s] != mapping[s - 1]]
    assert port_fed == len(fresh) == len(got) - 3
    for p in fresh:
        np.testing.assert_array_equal(got[p], plain[p])
    for p, s in enumerate(sources):          # a duplicate repeats its source's output
        if p not in fresh:
            np.testing.assert_array_equal(got[p], got[p - 1])
    # JAX reads position p's mapping as source p's: after the insertion,
    # position 10 (source 9, new) takes source 10's entry (a duplicate), so
    # it repeats the frame before it, and position 11 (source 10, a
    # duplicate) runs the SR instead
    assert jax_fed == port_fed
    assert [p for p in fresh if not np.array_equal(jgot[p], jplain[p])] == [10]


def test_scene_adaptive_segments_by_source_frame(tmp_path, monkeypatch):
    """Each frame takes its source frame's segment, an inserted frame the
    segment of the frame before it; JAX's filter reads stream positions."""
    src = _write(tmp_path / "clip.y4m", pan_clip(GAP_SHIFTS))
    calls = {"jax": [], "port": []}
    for mod, key in ((jsi, "jax"), (psi, "port")):
        orig = mod.SceneAdaptiveFilter._settings_for

        def spy(self, idx, orig=orig, key=key):
            calls[key].append(idx)
            return orig(self, idx)

        monkeypatch.setattr(mod.SceneAdaptiveFilter, "_settings_for", spy)
    _both(tmp_path, monkeypatch, src, sr_model="FW_fast6_x2", checkpoint_enabled=False,
          batch_size=4, fill_missing_frames=True, gap_jump_ratio=1.5, scene_adaptive=True)
    n = len(GAP_SHIFTS)
    assert calls["port"] == list(range(6)) + [5] + list(range(6, n))
    assert calls["jax"] == list(range(n + 1))


@pytest.mark.parametrize("method", ["ddcolor", "eccv16"])
def test_missing_colorize_checkpoint_raises_before_any_frame(tmp_path, method):
    src = _write(tmp_path / "clip.y4m", pan_clip(GAP_SHIFTS[:4]))
    cfg = Config(sr_model="FW_fast6_x2", device_platform="cpu", project_dir=tmp_path / "p",
                 weights_dir=tmp_path / "empty", colorize=True, colorize_model=method)
    with pytest.raises(InputError, match=f"{method}.npz"):
        VideoRestorer(cfg).restore_video(src, tmp_path / "out.y4m")
    assert not (tmp_path / "out.y4m").exists()
    with pytest.raises(ConfigError, match="exemplar"):
        Config(colorize=True, colorize_model="exemplar")


# -- the CLI ----------------------------------------------------------------------

_FLAGS = ["--scale", "2", "--tile", "256", "--batch", "3", "--verbose", "--colorize",
          "--colorize-method", "eccv16", "--fill-missing-frames"]
_FIELDS = ("scale_factor", "tile_size", "batch_size", "verbose", "colorize",
           "colorize_model", "fill_missing_frames", "gap_jump_ratio", "colorize_saturation",
           "colorize_keyframe_interval", "colorize_strength")


@pytest.mark.parametrize("flags", [[], _FLAGS, ["-v", "--batch", "1"]],
                         ids=["defaults", "all", "short"])
def test_cli_flags_parse_into_config_as_jax(tmp_path, monkeypatch, flags):
    captured = {}

    class _Capture:
        def __init__(self, cfg, *a, **k):
            captured["cfg"] = cfg
            raise FramewrightError("captured")

    monkeypatch.setattr(prestorer, "VideoRestorer", _Capture)
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["restore", "in.y4m", "--project-dir", str(tmp_path)] + flags) == 1
    parser = argparse.ArgumentParser()
    jcli._add_restore_args(parser)
    jcfg = jcli._config_from_args(parser.parse_args(["in.y4m"] + flags))
    for f in _FIELDS:
        assert getattr(captured["cfg"], f) == getattr(jcfg, f), f
    assert captured["cfg"].get_hash() == Config(
        project_dir=tmp_path, **{f: getattr(jcfg, f) for f in _FIELDS if f != "verbose"}
    ).get_hash()                                       # verbose is not hashed
    pkg = logging.getLogger("framewright_tpu_torch")     # logging_utils.setup_logging's
    assert (pkg.level == logging.DEBUG) == ("--verbose" in flags or "-v" in flags)
    pkg.setLevel(logging.INFO)


def test_cli_scale_other_than_the_models_is_refused(tmp_path, capsys):
    assert cli.main(["restore", "in.y4m", "--scale", "4", "--project-dir", str(tmp_path)]) == 1
    assert "upscales x2, scale_factor is 4" in capsys.readouterr().err


def test_cli_restore_with_both_stages(tmp_path, capsys, weights):
    src = _write(tmp_path / "clip.y4m", pan_clip(GAP_SHIFTS))
    assert cli.main(["restore", str(src), "-o", str(tmp_path / "o.y4m"), "--model",
                     "FW_fast6_x2", "--device", "cpu", "--project-dir", str(tmp_path / "p"),
                     "--weights-dir", str(weights), "--colorize", "--colorize-method",
                     "ddcolor", "--fill-missing-frames", "--batch", "4"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["batch_size"] == 4 and summary["errors"] == 0
    assert summary["pre_sr"]["colorize"] == {"method": "ddcolor"}
    assert summary["quality"]["samples"] == summary["frames"]   # inserted frames gated
    assert summary["frames"] == len(GAP_SHIFTS) + summary["pre_sr"]["fill_missing_frames"][
        "frames_inserted"]


def test_cli_extend_prints_jax_json(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(tmp_path / "empty"))
    src = _write(tmp_path / "clip.y4m", pan_clip(GAP_SHIFTS[:4]))
    assert cli.main(["extend", str(src), "--frames", "2", "--direction", "both",
                     "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == {"output": str(tmp_path / "clip_extended.y4m"), "frames": 8,
                   "added_before": 2, "added_after": 2}
    frames = _frames_of(tmp_path / "clip_extended.y4m")
    np.testing.assert_array_equal(frames[2:6], np.stack(pan_clip(GAP_SHIFTS[:4])))
    assert cli.main(["extend", str(src), "--flow-model", "raft", "--device", "cpu",
                     "-o", str(tmp_path / "r.y4m")]) == 1
    assert "raft-things.npz" in capsys.readouterr().err


def test_planner_rows_and_required_checkpoints():
    """The restore's pre-SR reserve holds the new rows (bytes a pixel of
    the propagation or the midpoint, a net's weights and activations)."""
    from framewright_tpu_torch import planner
    from framewright_tpu_torch.restorer import pre_sr_reserve, required_weights

    px = 1080 * 1920
    row = planner._PRE_SR_BYTES_PER_PX
    fixed = planner._PRE_SR_FIXED_BYTES
    assert pre_sr_reserve(Config(), 1080, 1920) == 0
    assert pre_sr_reserve(Config(fill_missing_frames=True), 1080, 1920) == px * row["gapfill"]
    for method in ("palette", "eccv16", "ddcolor"):
        cfg = Config(colorize=True, colorize_model=method, fill_missing_frames=True)
        assert pre_sr_reserve(cfg, 1080, 1920) == (
            px * max(row["colorize"], row["gapfill"]) + fixed.get(method, 0))
        assert required_weights(cfg) == ([] if method == "palette" else [method])
