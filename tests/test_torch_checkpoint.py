"""The port's restore bookkeeping on the CPU: checkpoint and resume, the
append-mode Y4M writer, continue-on-error and the quality gate's stage,
with FW_fast6_x2 (the repository's trained 6-block x2 RRDB, the default
model's code path) on small seeded clips.

Resume must give the output of a straight run byte for byte: after a run
stopped by an exception, and after a kill that left more whole frames on
disk than the checkpoint counted plus half a frame (the JAX restorer's
resume duplicates the former and counts the latter as whole:
ROADMAP.md, "JAX faults the port must not copy"). The bicubic fallback
is held to the JAX restorer's ``_upscale_fallback`` within 1 LSB. It is
written only for a batch that failed with a ``TransientError`` (the card
out of memory); a kernel's fault ends the restore.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from framewright_tpu.io.y4m import Y4MReader as JaxY4MReader
from framewright_tpu.io.y4m import Y4MWriter as JaxY4MWriter
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.engine.checkpoint import (
    CheckpointManager,
    PipelineCheckpoint,
    video_content_hash,
)
from framewright_tpu_torch.errors import (
    FatalError,
    HBMError,
    MediaFormatError,
    ValidationError,
)
from framewright_tpu_torch.io import y4m
from framewright_tpu_torch.processors.super_resolution import SuperResolution
from framewright_tpu_torch.restorer import VideoRestorer

MODEL = "FW_fast6_x2"
W, H, N = 32, 24, 10


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(n=N, h=H, w=W, seed=11):
    rng = np.random.default_rng(seed)
    coarse = rng.random((n, h // 4 + 1, w // 4 + 1, 3))
    big = np.repeat(np.repeat(coarse, 4, axis=1), 4, axis=2)[:, :h, :w]
    return np.clip(big * 255 + rng.normal(0, 5, big.shape), 0, 255).astype(np.uint8)


@pytest.fixture
def clip(tmp_path):
    src = tmp_path / "clip.y4m"
    with y4m.Y4MWriter(src, W, H, fps=24) as wr:
        for f in _frames():
            wr.write_frame(f)
    return src


def _cfg(tmp_path, **kw):
    kw.setdefault("batch_size", 2)
    return Config(project_dir=tmp_path / "proj", sr_model=MODEL, device_platform="cpu", **kw)


def _restore(cfg, src, out, progress=None):
    return VideoRestorer(cfg, progress).restore_video(src, out)


@pytest.fixture
def straight(tmp_path, clip):
    """A straight run's output bytes (its own project dir)."""
    res = _restore(_cfg(tmp_path / "s"), clip, tmp_path / "straight.y4m")
    assert (res.frames_out, res.errors, res.batches) == (N, 0, N // 2)
    return (tmp_path / "straight.y4m").read_bytes()


def _ckpt_files(tmp_path):
    return sorted((tmp_path / "proj" / "checkpoints").glob("ckpt_*.json"))


class _Stop(Exception):
    pass


def _stop_after(frames):
    def progress(info):
        if info.frames_done >= frames:
            raise _Stop(info.frames_done)
    return progress


# -- the default restore -------------------------------------------------

def test_default_config_writes_qa_report_and_removes_checkpoint(tmp_path, clip):
    cfg = Config(project_dir=tmp_path / "proj", sr_model=MODEL, device_platform="cpu")
    assert cfg.checkpoint_enabled and cfg.resume and cfg.validate_output
    assert cfg.continue_on_error and cfg.quality_report_format == "json"
    res = _restore(cfg, clip, tmp_path / "o.y4m")
    assert res.frames_out == N and res.errors == 0
    q = res.quality
    assert q is not None and q.samples == N and len(q.per_sample_psnr) == N
    assert np.isfinite(q.psnr) and 0.0 < q.ssim <= 1.0
    rep = json.loads((tmp_path / "proj" / "qa_report.json").read_text())
    assert rep["quality"] == q.to_dict() and rep["errors"] == 0
    assert len(rep["per_frame"]["psnr"]) == N
    # the engine's summary: every stage of the JAX restore, those not run skipped
    assert [(s["name"], s["status"]) for s in rep["stages"]] == [
        ("probe", "completed"), ("checkpoint", "completed"), ("dedup", "skipped"),
        ("enhance", "completed"), ("interpolate", "skipped"), ("validate", "completed"),
        ("finalize", "completed")]
    assert (tmp_path / "proj" / "checkpoints").is_dir() and not _ckpt_files(tmp_path)


def test_no_validate_no_checkpoint_same_planes(tmp_path, clip, straight):
    cfg = _cfg(tmp_path, validate_output=False, checkpoint_enabled=False)
    res = _restore(cfg, clip, tmp_path / "o.y4m")
    assert res.quality is None and not (tmp_path / "proj" / "qa_report.json").exists()
    assert not (tmp_path / "proj" / "checkpoints").exists()
    assert (tmp_path / "o.y4m").read_bytes() == straight


def test_html_report(tmp_path, clip):
    _restore(_cfg(tmp_path, quality_report_format="html"), clip, tmp_path / "o.y4m")
    assert "QA Report" in (tmp_path / "proj" / "qa_report.html").read_text()


# -- resume --------------------------------------------------------------

def test_stopped_run_resumes_to_the_straight_output(tmp_path, clip, straight):
    out = tmp_path / "o.y4m"
    with pytest.raises(_Stop):
        _restore(_cfg(tmp_path), clip, out, _stop_after(4))     # after its second batch
    (ck,) = _ckpt_files(tmp_path)
    assert json.loads(ck.read_text())["frames_done"] == {"enhance": 4}
    with y4m.Y4MReader(out) as r:
        assert r.count_frames() == 4
    res = _restore(_cfg(tmp_path), clip, out)
    assert res.frames_out == N and res.batches == 3          # frames 4-9 only
    assert res.resumed_from == 4 and res.quality.samples == N - 4
    q = res.quality.to_dict()
    assert q["first_frame"] == 4 and q["notes"][0].startswith("resumed run: frames 0-3")
    report = json.loads((tmp_path / "proj" / "qa_report.json").read_text())
    assert report["resumed_from"] == 4 and report["quality"]["first_frame"] == 4
    assert out.read_bytes() == straight
    assert not _ckpt_files(tmp_path)


def _checkpoint_at(tmp_path, clip, cfg, frames, config_hash=None):
    mgr = CheckpointManager(cfg.checkpoint_dir, cfg.checkpoint_interval)
    mgr.start(clip, config_hash or cfg.get_hash(), total_frames=N)
    mgr.frames_completed("enhance", frames)
    mgr.force_save()


def _cut(straight: bytes, whole: int, extra: int) -> bytes:
    """The straight output cut to ``whole`` frames and ``extra`` bytes."""
    header = straight.index(b"\n") + 1
    frame = 6 + (2 * W) * (2 * H) * 3 // 2
    return straight[:header + whole * frame + extra]


def test_kill_with_frames_past_the_checkpoint(tmp_path, clip, straight):
    """7 whole frames and half a frame on disk, a checkpoint at 4: the
    output is cut to 4 frames and the input resumes at frame 4."""
    out = tmp_path / "o.y4m"
    frame = 6 + (2 * W) * (2 * H) * 3 // 2
    out.write_bytes(_cut(straight, 7, frame // 2))
    cfg = _cfg(tmp_path)
    _checkpoint_at(tmp_path, clip, cfg, 4)
    res = _restore(cfg, clip, out)
    assert res.frames_out == N and res.batches == 3
    assert out.read_bytes() == straight


def test_checkpoint_past_the_frames_on_disk(tmp_path, clip, straight):
    """A checkpoint at 6 but 5 whole frames and a cut-off marker on disk
    (the writer had not flushed them all): min(6, 5) = 5, rounded down
    to a whole batch of 2, so every frame runs in the batch it had in the
    straight run; resume at 4."""
    out = tmp_path / "o.y4m"
    out.write_bytes(_cut(straight, 5, 3))
    cfg = _cfg(tmp_path)
    _checkpoint_at(tmp_path, clip, cfg, 6)
    res = _restore(cfg, clip, out)
    assert res.frames_out == N and res.batches == 3     # frames 4-5, 6-7, 8-9
    assert out.read_bytes() == straight


def test_config_change_discards_the_checkpoint(tmp_path, clip, straight):
    out = tmp_path / "o.y4m"
    out.write_bytes(_cut(straight, 4, 0))
    cfg = _cfg(tmp_path)
    _checkpoint_at(tmp_path, clip, cfg, 4, config_hash="0" * 16)
    res = _restore(cfg, clip, out)
    assert res.batches == N // 2                        # from frame 0
    assert out.read_bytes() == straight


def test_no_resume_starts_over(tmp_path, clip, straight):
    out = tmp_path / "o.y4m"
    out.write_bytes(_cut(straight, 4, 0))
    cfg = _cfg(tmp_path, resume=False)
    _checkpoint_at(tmp_path, clip, cfg, 4)
    assert _restore(cfg, clip, out).batches == N // 2
    assert out.read_bytes() == straight


def test_runtime_budget_stops_with_fatal_error_and_resumes(tmp_path, clip, straight):
    out = tmp_path / "o.y4m"
    with pytest.raises(FatalError, match="runtime budget"):
        _restore(_cfg(tmp_path, max_runtime_minutes=1e-9), clip, out)
    (ck,) = _ckpt_files(tmp_path)
    assert json.loads(ck.read_text())["frames_done"] == {"enhance": 0}
    # max_runtime_minutes is hashed: the rerun without a budget starts over
    _restore(_cfg(tmp_path), clip, out)
    assert out.read_bytes() == straight and not _ckpt_files(tmp_path)


# -- continue-on-error -----------------------------------------------------

def _fail_batch(monkeypatch, which, exc=HBMError("injected: device OOM after 2 downshifts"),
                where="materialize"):
    """Raise ``exc`` from ``SuperResolution.<where>`` on its ``which``-th call."""
    real = getattr(SuperResolution, where)
    calls = []

    def failing(self, arg):
        calls.append(1)
        if len(calls) == which:
            raise exc
        return real(self, arg)

    monkeypatch.setattr(SuperResolution, where, failing)


@pytest.mark.parametrize("where", ["materialize", "dispatch"])
def test_failed_batch_is_written_as_bicubic_copies(tmp_path, clip, straight, monkeypatch, where):
    from framewright_tpu.restorer import VideoRestorer as JaxRestorer
    from framewright_tpu_torch.io.y4m import rgb_to_yuv420

    _fail_batch(monkeypatch, 2, where=where)             # frames 2 and 3
    out = tmp_path / "o.y4m"
    res = _restore(_cfg(tmp_path), clip, out)
    assert (res.frames_out, res.errors) == (N, 2)
    assert res.quality.samples == N - 2                 # no stats for that batch
    with y4m.Y4MReader(clip) as r:                      # the frames the restore read
        frames = np.stack(list(r))[2:4]
    got = VideoRestorer._upscale_fallback(frames, (2 * H, 2 * W))
    want = JaxRestorer._upscale_fallback(frames, (2 * H, 2 * W))
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, 2 * H, 2 * W, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    with y4m.Y4MReader(out) as r:
        assert r.full_range
    planes = _planes(out)
    want_planes = _planes(tmp_path / "straight.y4m")
    for i in range(N):
        if i in (2, 3):
            for g, w in zip(planes[i], rgb_to_yuv420(got[i - 2], full_range=True)):
                np.testing.assert_array_equal(g, w)
        else:
            for g, w in zip(planes[i], want_planes[i]):
                np.testing.assert_array_equal(g, w)


def test_failed_batch_raises_without_continue_on_error(tmp_path, clip, monkeypatch):
    # without stage retries: a retry would resume past the failed batch
    # (tests/test_torch_engine.py holds the retried restore)
    _fail_batch(monkeypatch, 2)
    with pytest.raises(HBMError, match="injected"):
        _restore(_cfg(tmp_path, continue_on_error=False, stage_max_retries=0), clip,
                 tmp_path / "o.y4m")
    (ck,) = _ckpt_files(tmp_path)                        # kept for a resume
    assert json.loads(ck.read_text())["frames_done"] == {"enhance": 2}


@pytest.mark.parametrize("where", ["wrapper", "materialize"])
def test_kernel_fault_fails_the_restore(tmp_path, clip, monkeypatch, where):
    """A RuntimeError from a kernel wrapper (raised at its launch, or at
    the event sync where a CUDA fault shows) is no TransientError: the
    restore fails under continue_on_error, and no bicubic copy is
    written for the batch."""
    from framewright_tpu_torch.ops import fused_tail3

    exc = RuntimeError("injected: CUDA error: an illegal memory access was encountered")
    if where == "wrapper":
        real, calls = fused_tail3.conv_body_skip, []

        def conv_body_skip(*args, **kw):
            calls.append(1)
            if len(calls) == 2:
                raise exc
            return real(*args, **kw)

        monkeypatch.setattr(fused_tail3, "conv_body_skip", conv_body_skip)
    else:
        _fail_batch(monkeypatch, 2, exc=exc)
    out = tmp_path / "o.y4m"
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _restore(_cfg(tmp_path), clip, out)
    # batch 2 is dispatched while batch 1 is in flight: a fault at its
    # launch ends the run before batch 1 is written
    done = 0 if where == "wrapper" else 2
    (ck,) = _ckpt_files(tmp_path)                        # kept for a resume
    assert json.loads(ck.read_text())["frames_done"] == {"enhance": done}
    with y4m.Y4MReader(out) as r:
        assert r.count_frames() == done


def _planes(path: Path):
    data = path.read_bytes()
    rest = data[data.index(b"\n") + 1:]
    w, h = 2 * W, 2 * H
    n = w * h * 3 // 2
    out = []
    for off in range(0, len(rest), n + 6):
        buf = np.frombuffer(rest, np.uint8, n, off + 6)
        out.append((buf[:w * h].reshape(h, w), buf[w * h:w * h + n // 6].reshape(h // 2, w // 2),
                    buf[w * h + n // 6:].reshape(h // 2, w // 2)))
    return out


# -- the gate's stage ------------------------------------------------------

def test_failed_gate_warns_or_raises(tmp_path, clip):
    res = _restore(_cfg(tmp_path, min_psnr=99.0), clip, tmp_path / "o.y4m")
    assert not res.quality.passed and res.frames_out == N
    with pytest.raises(ValidationError, match="quality gates failed"):
        _restore(_cfg(tmp_path, min_psnr=99.0, continue_on_error=False), clip,
                 tmp_path / "o2.y4m")
    assert not _ckpt_files(tmp_path)                     # the output is complete


# -- the pieces ----------------------------------------------------------------

def test_checkpoint_manager(tmp_path, clip):
    mgr = CheckpointManager(tmp_path / "ck", interval=4)
    ck = mgr.start(clip, "h1", total_frames=N)
    assert ck.video_hash == video_content_hash(clip) and len(ck.video_hash) == 32
    path = mgr.path(ck.video_hash)
    mgr.frames_completed("enhance", 2)
    assert not path.exists()                             # 2 < interval
    mgr.frames_completed("enhance", 4)
    assert PipelineCheckpoint.from_json(path.read_text()).frames_done == {"enhance": 4}
    assert not list((tmp_path / "ck").glob("*.tmp"))     # renamed into place
    mgr.frames_completed("enhance", 5)
    mgr.force_save()
    again = CheckpointManager(tmp_path / "ck").start(clip, "h1")
    assert again.frames_done == {"enhance": 5} and again.created_at == ck.created_at
    fresh = CheckpointManager(tmp_path / "ck").start(clip, "h2")   # config changed
    assert fresh.frames_done == {} and not path.exists()
    path.write_text("{not json")
    assert CheckpointManager(tmp_path / "ck").start(clip, "h2").frames_done == {}
    mgr.stage_completed("enhance")
    assert mgr.checkpoint.completed_stages == ["enhance"]
    mgr.complete()
    assert not path.exists()


def test_config_hash_excludes_what_does_not_change_pixels(tmp_path):
    base = Config(sr_model=MODEL)
    for kw in (dict(project_dir=tmp_path), dict(output_path=tmp_path / "o.y4m"),
               dict(checkpoint_interval=7), dict(checkpoint_enabled=False), dict(resume=False)):
        assert Config(sr_model=MODEL, **kw).get_hash() == base.get_hash(), kw
    for kw in (dict(weights_dir=tmp_path), dict(compute_dtype="int8"), dict(min_psnr=20.0),
               dict(sr_model="FW_fastvgg_x2")):
        assert Config(**{"sr_model": MODEL, **kw}).get_hash() != base.get_hash(), kw


class TestAppend:
    def _file(self, path, n, extra=0, cs="420mpeg2"):
        rng = np.random.default_rng(n)
        with y4m.Y4MWriter(path, 8, 6, fps=25, colorspace=cs) as wr:
            for _ in range(n):
                wr.write_frame(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8))
        if extra:
            with open(path, "ab") as f:
                f.write(b"FRAME\n" + bytes(extra))
        return path

    def test_partial_frame_is_cut_not_counted(self, tmp_path):
        path = self._file(tmp_path / "a.y4m", 3, extra=20)
        with y4m.Y4MReader(path) as r:
            assert r.count_frames() == 3
        with JaxY4MReader(path) as r:          # the JAX reader counts it whole
            assert r.count_frames() == 4
        with y4m.Y4MWriter(path, 8, 6, append=True) as wr:
            assert wr.frames_written == 3
            wr.write_frame(np.zeros((6, 8, 3), np.uint8))
            assert wr.frames_written == 4
        with y4m.Y4MReader(path) as r:
            assert len(list(r)) == 4

    def test_jax_append_after_a_partial_frame_is_unreadable(self, tmp_path):
        path = self._file(tmp_path / "a.y4m", 3, extra=20)
        with JaxY4MWriter(path, 8, 6, append=True) as wr:
            assert wr.frames_written == 4
            wr.write_frame(np.zeros((6, 8, 3), np.uint8))
        with pytest.raises(Exception, match="FRAME marker"):
            with JaxY4MReader(path) as r:
                list(r)

    def test_keeps_header_and_cuts_to_keep_frames(self, tmp_path):
        path = self._file(tmp_path / "a.y4m", 5)
        head = path.read_bytes()[:path.read_bytes().index(b"\n") + 1]
        with y4m.Y4MWriter(path, 8, 6, fps=30, colorspace="420jpeg", append=True,
                           keep_frames=2) as wr:
            assert wr.frames_written == 2 and not wr.full_range
            assert wr.header.colorspace == "420mpeg2"
        assert path.read_bytes().startswith(head)
        with y4m.Y4MReader(path) as r:
            assert r.count_frames() == 2

    def test_dims_mismatch_and_fresh_file(self, tmp_path):
        path = self._file(tmp_path / "a.y4m", 1)
        with pytest.raises(MediaFormatError, match="dims mismatch"):
            y4m.Y4MWriter(path, 10, 6, append=True)
        with y4m.Y4MWriter(tmp_path / "new.y4m", 8, 6, append=True) as wr:
            assert wr.frames_written == 0
        with y4m.Y4MReader(tmp_path / "new.y4m") as r:
            assert (r.width, r.height, r.count_frames()) == (8, 6, 0)
