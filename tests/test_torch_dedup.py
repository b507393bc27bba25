"""Deduplication in the port (``processors/deduplication``, the
restorer's ``_stage_dedup`` and its frame mapping) against the JAX
package: the same mapping on clips with exact repeats, noisy
near-repeats and a cut at three thresholds; the analysis limited to
``max_frames``; the long-form anchors teed off the dedup pass; SR on the
unique frames only; a resumed dedup restore equal to a straight one."""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from conftest import make_gradient_frame
from framewright_tpu.processors import deduplication as jdedup
from framewright_tpu_torch import cli
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.engine.temporal import GlobalAnchors
from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
from framewright_tpu_torch.processors import deduplication as dedup
from framewright_tpu_torch.restorer import VideoRestorer


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cadence_clip(n: int = 16, h: int = 48, w: int = 64):
    """18 -> 24 fps: every fourth frame an exact repeat of the one before."""
    return [make_gradient_frame(h, w, t - (t + 1) // 4) for t in range(n)]


def near_repeat_clip(n: int = 16, h: int = 48, w: int = 64, seed: int = 3):
    """Every other frame a repeat with seeded noise of growing strength."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        f = make_gradient_frame(h, w, t // 2).astype(np.float32)
        if t % 2:
            f += rng.normal(0, 1.5 * t, f.shape)
        out.append(np.clip(f, 0, 255).astype(np.uint8))
    return out


def cut_clip(n: int = 16, h: int = 48, w: int = 64):
    """A still shot (one frame repeated), then a cut to a panning one."""
    still = make_gradient_frame(h, w, 40)
    return [still] * (n // 2) + [make_gradient_frame(h, w, t) for t in range(n - n // 2)]


CLIPS = {"exact": cadence_clip, "noisy": near_repeat_clip, "cut": cut_clip}


def _write(path, frames, fps=24):
    with Y4MWriter(path, frames[0].shape[1], frames[0].shape[0], fps=fps) as wr:
        for f in frames:
            wr.write_frame(f)
    return path


@pytest.mark.parametrize("threshold", [0.9, 0.98, 1.0])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_analyze_gives_the_jax_mapping(clip, threshold):
    frames = CLIPS[clip]()
    got = dedup.FrameDeduplicator(dedup.DedupConfig(similarity_threshold=threshold)).analyze(
        iter(frames), target_fps=24.0, batch_size=5)
    want = jdedup.FrameDeduplicator(jdedup.DedupConfig(similarity_threshold=threshold)).analyze(
        iter(frames), target_fps=24.0, batch_size=5)
    for name in ("total_frames", "unique_frames", "duplicates", "unique_indices",
                 "frame_mapping", "estimated_source_fps", "target_fps"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.dedup_ratio == want.dedup_ratio
    assert (dedup.FrameDeduplicator.reconstruct_order(got)
            == jdedup.FrameDeduplicator.reconstruct_order(want))
    if clip == "exact":
        assert got.duplicates == 4 and got.estimated_source_fps == 18.0


def test_restore_runs_sr_on_unique_frames_only(tmp_path, capsys):
    """The CLI's --deduplicate: 12 of 16 frames unique, 3 a ring batch of
    4, so 4 SR dispatches; every repeat written as its unique frame's
    output, byte for byte."""
    src = _write(tmp_path / "c.y4m", cadence_clip())
    assert cli.main(["restore", str(src), "-o", str(tmp_path / "o.y4m"), "--model",
                     "FW_fast6_x2", "--device", "cpu", "--deduplicate", "--project-dir",
                     str(tmp_path / "p")]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["duplicates_removed"] == 4 and summary["frames"] == 16
    assert summary["batch_size"] == 4 and summary["batches"] == 4
    with Y4MReader(tmp_path / "o.y4m") as r:
        raw = r._f.read().split(b"FRAME\n")[1:]
    for t in (3, 7, 11, 15):
        assert raw[t] == raw[t - 1]
    assert all(raw[t] != raw[t - 1] for t in range(1, 16) if t % 4 != 3)


def test_analysis_stops_at_max_frames_and_tees_the_anchors(tmp_path):
    """The dedup pass reads frames_in frames, no more, and the long-form
    anchors taken off it equal GlobalAnchors.extract on those frames."""
    src = _write(tmp_path / "c.y4m", cadence_clip())
    cfg = Config(sr_model="FW_fast6_x2", device_platform="cpu", deduplicate=True,
                 long_form="on", anchor_interval=3, max_frames=10,
                 project_dir=tmp_path / "p")
    restorer = VideoRestorer(cfg)
    data = {"source": src, **restorer._stage_probe({"source": src})}
    out = restorer._stage_dedup(data)
    res = out["dedup_result"]
    assert data["frames_in"] == 10 and res.total_frames == 10
    assert sorted(res.frame_mapping) == list(range(10))
    with Y4MReader(src) as r:
        want = GlobalAnchors.extract(iter(list(r)[:10]), sample_every=3)
    got = out["anchors"]
    assert got.total_frames == want.total_frames == 10
    assert [p.frame_index for p in got.points] == [0, 3, 6, 9]
    for a, b in zip(got.points, want.points):
        np.testing.assert_array_equal(a.mean_rgb, b.mean_rgb)
        np.testing.assert_array_equal(a.std_rgb, b.std_rgb)
        assert (a.brightness, a.contrast, a.grain) == (b.brightness, b.contrast, b.grain)
    result = restorer.restore_video(src, tmp_path / "o.y4m")
    assert result.frames_out == 10 and result.dedup.total_frames == 10
    assert result.pre_sr["long_form"] == {"anchors": 4}


class _Stop(Exception):
    pass


@pytest.mark.parametrize("stop_at", [4, 6], ids=["at-a-duplicate", "at-a-unique-frame"])
def test_resumed_dedup_restore_equals_a_straight_one(tmp_path, stop_at):
    """Stopped after ``stop_at`` frames (batch 2), then rerun, on a clip
    whose frames 4 and 8 repeat their predecessors. A resume at frame 4
    would carry frame 3's SR output into the run (the JAX restorer, whose
    last unique index restarts at -1, runs SR on frame 4 itself), so the
    port moves it back to frame 2, a unique frame; at frame 6, a unique
    frame, it resumes there. Both outputs equal the straight run's."""
    frames = [make_gradient_frame(48, 64, t - t // 4) for t in range(12)]
    src = _write(tmp_path / "c.y4m", frames)

    def cfg(proj):
        return Config(sr_model="FW_fast6_x2", device_platform="cpu", deduplicate=True,
                      batch_size=2, project_dir=tmp_path / proj)

    def stop(info):
        if info.frames_done >= stop_at:
            raise _Stop(info.frames_done)

    with contextlib.redirect_stdout(io.StringIO()):
        straight = VideoRestorer(cfg("s")).restore_video(src, tmp_path / "s.y4m")
        with pytest.raises(_Stop):
            VideoRestorer(cfg("r"), stop).restore_video(src, tmp_path / "r.y4m")
        res = VideoRestorer(cfg("r")).restore_video(src, tmp_path / "r.y4m")
    assert straight.dedup.unique_indices == [0, 1, 2, 3, 5, 6, 7, 9, 10, 11]
    assert (tmp_path / "r.y4m").read_bytes() == (tmp_path / "s.y4m").read_bytes()
    assert res.resumed_from == (2 if stop_at == 4 else 6)
    # every ring batch of 2 holds a unique frame: one SR dispatch each,
    # from the resume point on
    assert straight.batches == 6 and res.batches == 6 - res.resumed_from // 2
