"""Previews and projects on the CPU against the JAX package: the segment
cache, the render queue and the preview server (the cases of
tests/test_preview.py), a rendered segment against the whole restore and
against JAX's preview, and versioned project restores (the case of
tests/test_project_testing.py:26-45) read by either package. The queue's
worker is waited on through its progress callbacks and joined on stop."""

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from framewright_tpu import preview as jpreview
from framewright_tpu import project as jproject
from framewright_tpu.config import Config as JaxConfig
from framewright_tpu_torch import preview, project
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import DeviceError, InputError
from framewright_tpu_torch.io.y4m import Y4MWriter
from framewright_tpu_torch.restorer import VideoRestorer

WAIT = 120.0
RESTORE_MAX, RESTORE_MEAN = 2, 0.2      # tests/test_torch_slice.py


@pytest.fixture(autouse=True)
def _setup(tmp_path, monkeypatch):
    monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(tmp_path / "no_weights"))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def smooth_clip(path: Path, n: int = 6, h: int = 24, w: int = 32) -> Path:
    y, x = np.mgrid[0:h, 0:w]
    with Y4MWriter(path, w, h, fps=12) as wr:
        for t in range(n):
            g = 127 + 100 * np.sin(x / 5 + y / 7 + t * 0.4)
            wr.write_frame(np.clip(np.stack([g, g * 0.9 + 10, 200 - g * 0.6], -1), 0, 255)
                           .astype(np.uint8))
    return path


def planes(path: Path):
    header, rest = Path(path).read_bytes().split(b"\n", 1)
    return header, [np.frombuffer(c, np.uint8) for c in rest.split(b"FRAME\n")[1:]]


def within_restore_bound(got, want) -> None:
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert d.max() <= RESTORE_MAX and d.mean() <= RESTORE_MEAN, (d.max(), d.mean())


# -- the segment cache -------------------------------------------------------------------

@pytest.mark.parametrize("mod", [preview, jpreview], ids=["port", "jax"])
def test_segment_cache_roundtrip_eviction_and_reload(tmp_path, mod):
    cache = mod.SegmentCache(tmp_path / "c", max_size_mb=10)
    src = tmp_path / "a.y4m"
    src.write_bytes(b"data")
    stored = cache.put_file(0, 10, "abc", src)
    assert cache.get(0, 10, "abc") == stored and cache.get(0, 10, "other") is None
    assert len(cache) == 1 and cache.size_bytes() == 4
    assert mod.SegmentCache(tmp_path / "c", max_size_mb=10).get(0, 10, "abc") is not None
    tight = mod.SegmentCache(tmp_path / "t", max_size_mb=0)
    for name in ("a", "b"):
        f = tmp_path / f"{name}.bin"
        f.write_bytes(b"x" * 1024)
        tight.put_file(0, 10, name, f)
    assert tight.get(0, 10, "a") is None and tight.get(0, 10, "b") is not None
    cache.clear()
    assert len(cache) == 0 and not stored.exists()


def test_segment_keys_equal_jax():
    for args in ((0, 10, "abc"), (3, 7, "0123456789ab")):
        assert preview.SegmentCache.make_key(*args) == jpreview.SegmentCache.make_key(*args)


# -- the render queue ---------------------------------------------------------------------

class _Watch:
    """Progress callback: every status a task reaches, an event a status."""

    def __init__(self):
        self.seen, self.events, self.lock = [], {}, threading.RLock()

    def __call__(self, task):
        with self.lock:
            self.seen.append((task.task_id, task.status))
            self.event(task.task_id, task.status).set()

    def event(self, tid, status):
        with self.lock:
            return self.events.setdefault((tid, status), threading.Event())


def _queue(tmp_path, render):
    q = preview.RenderQueue(render, preview.SegmentCache(tmp_path / "c", max_size_mb=10))
    watch = _Watch()
    q.on_progress(watch)
    q.start()
    return q, watch


def test_queue_renders_caches_and_reports(tmp_path):
    def render(task):
        if task.config_hash == "bad":
            raise RuntimeError("boom")
        out = tmp_path / f"r_{task.task_id}.y4m"
        out.write_bytes(b"rendered")
        return out

    q, watch = _queue(tmp_path, render)
    try:
        task = q.submit(0, 10, "cfg1")
        assert watch.event(task.task_id, "done").wait(WAIT)
        assert task.output.read_bytes() == b"rendered" and task.progress == 1.0
        again = q.submit(0, 10, "cfg1")
        assert again.status == "done" and again.output == task.output    # from the cache
        bad = q.submit(0, 10, "bad")
        assert watch.event(bad.task_id, "failed").wait(WAIT) and "boom" in bad.error
        assert (task.task_id, "rendering") in watch.seen and q.active_count() == 0
    finally:
        q.stop()
    assert q._worker is None


def test_queue_cancels_a_queued_task_and_orders_by_priority(tmp_path):
    """The first render holds the worker until the others are queued: the
    cancelled one never renders, the rest render by priority."""
    release, started = threading.Event(), []

    def render(task):
        started.append(task.config_hash)
        if task.config_hash == "first":
            assert release.wait(WAIT)
        out = tmp_path / f"{task.task_id}.y4m"
        out.write_bytes(b"r")
        return out

    q, watch = _queue(tmp_path, render)
    try:
        first = q.submit(0, 10, "first")
        assert watch.event(first.task_id, "rendering").wait(WAIT)
        low = q.submit(0, 10, "low", priority=1)
        victim = q.submit(0, 10, "victim", priority=5)
        high = q.submit(0, 10, "high", priority=9)
        assert q.cancel(victim.task_id) and not q.cancel(first.task_id)
        release.set()
        assert watch.event(low.task_id, "done").wait(WAIT)
        assert watch.event(high.task_id, "done").wait(WAIT)
        assert started == ["first", "high", "low"] and victim.status == "cancelled"
    finally:
        q.stop()


# -- the preview server --------------------------------------------------------------------

def test_preview_server_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    with pytest.raises(DeviceError, match="no CUDA device"):
        preview.PreviewServer(tmp_path / "a.y4m", tmp_path / "pv")


def _render(server, start, n, cfg):
    done = threading.Event()
    server.queue.on_progress(lambda t: done.set() if t.status in ("done", "failed") else None)
    task = server.render_segment(start, n, cfg)
    if task.status != "done":
        assert done.wait(WAIT)
    assert task.status == "done", task.error
    return task


def test_segment_equals_those_frames_of_the_whole_restore(tmp_path):
    """Frames 2..4 rendered alone equal frames 2..4 of the whole clip's
    restore at the segment's batch (the frames' bytes are cut, not
    decoded and encoded again); a second request is served from the
    cache; the status reports it."""
    src = smooth_clip(tmp_path / "clip.y4m")
    cfg = Config(sr_model="FW_fastvgg_x2", device_platform="cpu", batch_size=3,
                 project_dir=tmp_path / "p")
    ps = preview.PreviewServer(src, tmp_path / "pv", device="cpu")
    ps.start()
    try:
        task = _render(ps, 2, 3, cfg)
        again = ps.render_segment(2, 3, cfg)
        assert again.status == "done" and again.output == task.output
        st = ps.status()
        assert st["cached_segments"] == 1 and st["running"] and st["active_renders"] == 0
        assert set(st) == set(jpreview.PreviewServer(src, tmp_path / "jpv").status())
    finally:
        ps.stop()
    VideoRestorer(cfg.with_overrides(checkpoint_enabled=False)).restore_video(
        src, tmp_path / "whole.y4m")
    header, seg = planes(task.output)
    wheader, whole = planes(tmp_path / "whole.y4m")
    assert header == wheader and len(seg) == 3
    assert all(np.array_equal(a, b) for a, b in zip(seg, whole[2:5]))
    assert not (tmp_path / "pv" / f"seg_{task.task_id}.y4m").exists()


def test_segment_within_restore_bound_of_jax_preview(tmp_path):
    """The same segment under the same config (FW_fastvgg_x2, trained) from
    JAX's preview server: within the restore bound (JAX's segment is
    decoded and encoded again before its restore)."""
    src = smooth_clip(tmp_path / "clip.y4m")
    common = dict(sr_model="FW_fastvgg_x2", validate_output=False)
    ps = preview.PreviewServer(src, tmp_path / "pv", device="cpu")
    jps = jpreview.PreviewServer(src, tmp_path / "jpv")
    ps.start()
    jps.start()
    try:
        task = _render(ps, 1, 4, Config(project_dir=tmp_path / "p", **common))
        jtask = _render(jps, 1, 4, JaxConfig(project_dir=tmp_path / "jp", device_platform="cpu",
                                             **common))
    finally:
        ps.stop()
        jps.stop()
    (h, got), (jh, want) = planes(task.output), planes(jtask.output)
    assert h == jh
    within_restore_bound(got, want)


# -- projects ----------------------------------------------------------------------------

def test_versioned_project_restores_read_by_both_packages(tmp_path):
    """Two versions (the second with the flicker fix), reloaded from disk
    by the port and by JAX: the same versions, comparison table and
    project list; each version's output the restore of its config."""
    src = smooth_clip(tmp_path / "clip.y4m")
    root = tmp_path / "projects"
    proj = project.Project(root, "My Film").init(src)
    cfg = Config(sr_model="FW_fastvgg_x2", device_platform="cpu", min_psnr=0.0, min_ssim=0.0)
    rec1, res1 = proj.restore(cfg, notes="first pass")
    rec2, _ = proj.restore(cfg.with_overrides(temporal_consistency=True),
                           notes="with flicker fix")
    assert (rec1.version, rec2.version) == (1, 2)
    assert (root / "My_Film" / "v2" / "restored.y4m").exists()
    assert rec1.metrics == res1.quality.to_dict()
    for mod in (project, jproject):
        again = mod.Project(root, "My Film")
        assert [v.version for v in again.versions] == [1, 2]
        table = again.compare()
        assert [r["notes"] for r in table] == ["first pass", "with flicker fix"]
        assert mod.list_projects(root) == ["My_Film"] and again.source == str(src)
    VideoRestorer(cfg.with_overrides(project_dir=tmp_path / "p", checkpoint_enabled=False)
                  ).restore_video(src, tmp_path / "plain.y4m")
    assert (root / "My_Film" / "v1" / "restored.y4m").read_bytes() == \
        (tmp_path / "plain.y4m").read_bytes()
    assert json.loads((root / "My_Film" / "v1" / "config.json").read_text())["sr_model"] == \
        "FW_fastvgg_x2"


def test_project_version_within_restore_bound_of_jax(tmp_path):
    src = smooth_clip(tmp_path / "clip.y4m")
    _, res = project.Project(tmp_path / "a", "p").init(src).restore(
        Config(sr_model="FW_fastvgg_x2", device_platform="cpu"))
    _, jres = jproject.Project(tmp_path / "b", "p").init(src).restore(
        JaxConfig(sr_model="FW_fastvgg_x2", device_platform="cpu"))
    (h, got), (jh, want) = planes(res.output_path), planes(jres.output_path)
    assert h == jh
    within_restore_bound(got, want)


def test_project_without_source(tmp_path):
    with pytest.raises(InputError, match="source not found"):
        project.Project(tmp_path, "x").init(tmp_path / "missing.y4m")
    with pytest.raises(InputError, match="no source"):
        project.Project(tmp_path, "y").restore(Config(device_platform="cpu"))
    assert project.list_projects(tmp_path / "none") == []
    assert project.Project(tmp_path, "../evil name").name == jproject.Project(
        tmp_path, "../evil name").name
