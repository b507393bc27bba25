"""The restore engine of the port (``errors``, ``events``,
``engine/pipeline``, ``safeguards``, the restorer on the engine, the
``ProgressInfo`` callback) held to the JAX package.

Tolerances: the engine is plain Python on both sides, so each scenario's
summary (every stage's name, status, attempts and error, durations left
out) and its event types in order are equal; so are the event bus's and
the hook manager's deliveries and the preflight's verdicts. A restore
retried after a ``TransientError``, cancelled, or paused equals a straight
run byte for byte; a restore's event types equal the JAX restore's on
the same clip (the monitor loop's resource events left out: they depend
on the machine's free disk and memory).
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
import time
from collections import namedtuple
from pathlib import Path

import pytest
import torch

from framewright_tpu import errors as jerrors
from framewright_tpu import events as jevents
from framewright_tpu import safeguards as jsafeguards
from framewright_tpu.config import Config as JaxConfig
from framewright_tpu.engine import pipeline as jpipeline
from framewright_tpu.io import y4m as jy4m
from framewright_tpu.restorer import ProgressInfo as JaxProgressInfo
from framewright_tpu.restorer import VideoRestorer as JaxRestorer
from framewright_tpu_torch import cli, errors, events, safeguards
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.engine import pipeline
from framewright_tpu_torch.io import y4m
from framewright_tpu_torch.restorer import ProgressInfo, VideoRestorer, _EtaTracker

MODEL = "FW_fast6_x2"
N, H, W = 6, 24, 32
RESOURCE_EVENTS = {"disk_space_low", "host_memory_low", "hbm_pressure"}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- the DAG engine: every scenario through both packages -----------------

def _boom(_d):
    raise ValueError("x")


def _scenarios(mod, err):
    """name -> (stages, PipelineContext or None, exception the run raises
    or None); ``mod`` is either package's pipeline module, ``err`` its
    errors module."""
    calls = {"n": 0}

    def flaky(_d):
        calls["n"] += 1
        if calls["n"] < 2:
            raise err.TransientError("again")
        return {"ok": True}

    def always_transient(_d):
        raise err.TransientError("still failing")

    ctx = mod.PipelineContext()
    S = mod.Stage
    return {
        "topo_order": ([S("c", lambda d: None, depends_on=("b",)), S("a", lambda d: None),
                        S("b", lambda d: None, depends_on=("a",))], None, None),
        "context_flows": ([S("a", lambda d: {"x": 1}),
                           S("b", lambda d: {"y": d["x"] + 1}, depends_on=("a",))], None, None),
        "disabled_skipped": ([S("a", lambda d: None, enabled=False), S("b", lambda d: None)],
                             None, None),
        "dependent_of_failed_noncritical": (
            [S("a", _boom, critical=False), S("b", lambda d: None, depends_on=("a",)),
             S("c", lambda d: None)], None, None),
        "critical_failure": ([S("a", _boom), S("b", lambda d: None)], None, err.StageError),
        "transient_retry": ([S("a", flaky, max_retries=2, retry_delay=0)], None, None),
        "retries_exhausted": ([S("a", always_transient, max_retries=1, retry_delay=0),
                               S("b", lambda d: None, depends_on=("a",))], None,
                              err.StageError),
        "noncritical_transient": ([S("a", always_transient, max_retries=2, retry_delay=0,
                                     critical=False), S("b", lambda d: None)], None, None),
        "timeout": ([S("slow", lambda d: time.sleep(0.5), timeout_s=0.05)], None,
                    err.StageError),
        "cancel": ([S("a", lambda d: ctx.cancel()), S("b", lambda d: None, depends_on=("a",))],
                   ctx, err.CancelledError),
    }


def _run(mod, err, evmod, name, restore=()):
    stages, ctx, raises = _scenarios(mod, err)[name]
    bus = evmod.EventBus()
    hooks = evmod.HookManager()
    fired = []
    for point in evmod.HookPoint:
        hooks.register(point, lambda c, point=point: fired.append(
            (point.value, c.get("stage"))))
    p = mod.Pipeline(stages, events=bus, hooks=hooks, completed_stages=restore)
    ran = None
    if raises is None:
        ran = p.run(ctx).data
    else:
        with pytest.raises(raises):
            p.run(ctx)
    summary = [{k: v for k, v in s.items() if k != "duration_s"}
               for s in p.summary()["stages"]]
    data = None if ran is None else {k: v for k, v in ran.items()}
    return (p.execution_order(), summary, [e.type.value for e in bus.history()], fired, data)


@pytest.mark.parametrize("name", list(_scenarios(pipeline, errors)))
def test_pipeline_scenarios_equal_jax(name):
    want = _run(jpipeline, jerrors, jevents, name)
    got = _run(pipeline, errors, events, name)
    assert got == want


def test_restore_completed_equal_jax():
    assert (_run(pipeline, errors, events, "topo_order", restore=("a",))
            == _run(jpipeline, jerrors, jevents, "topo_order", restore=("a",)))


@pytest.mark.parametrize("kind", ["cycle", "unknown", "duplicate"])
def test_build_errors_equal_jax(kind):
    def stages(S):
        return {"cycle": [S("a", None, depends_on=("b",)), S("b", None, depends_on=("a",))],
                "unknown": [S("a", None, depends_on=("zz",))],
                "duplicate": [S("a", None), S("a", None)]}[kind]

    with pytest.raises(jerrors.StageError) as j:
        jpipeline.Pipeline(stages(jpipeline.Stage))
    with pytest.raises(errors.StageError) as p:
        pipeline.Pipeline(stages(pipeline.Stage))
    assert str(p.value) == str(j.value)


def test_builder_and_failed_stage_keep_the_error():
    bus = events.EventBus()
    p = (pipeline.PipelineBuilder("x").events(bus)
         .stage("a", lambda d: {"v": 1})
         .stage("b", _boom, depends_on=("a",), critical=False).build())
    ctx = p.run()
    assert ctx.get("v") == 1 and p.completed_stage_names() == ["a"]
    assert isinstance(p.stages[1].exception, ValueError)
    assert p.summary()["name"] == "x"


def test_pause_blocks_until_resumed():
    ctx = pipeline.PipelineContext()
    ctx.pause()
    assert ctx.paused
    threading.Timer(0.2, ctx.resume).start()
    t0 = time.time()
    ctx.checkpoint_wait()
    assert time.time() - t0 >= 0.15 and not ctx.paused


def test_classify_error_maps_only_oom_and_its_own():
    e = errors.DiskSpaceError("full")
    assert errors.classify_error(e) is e and isinstance(e, errors.TransientError)
    oom = errors.classify_error(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert isinstance(oom, errors.HBMError)
    # the JAX classifier reads the text: "http 500" becomes a compile error,
    # "timed out" a transient one; the port leaves both fatal
    for msg in ("HTTP 500 from a server", "connection timed out", "out of memory (text)"):
        assert not isinstance(errors.classify_error(RuntimeError(msg)), errors.TransientError)
    assert isinstance(jerrors.classify_error(RuntimeError("connection timed out")),
                      jerrors.TransientError)
    assert issubclass(errors.CancelledError, errors.FramewrightError)


# -- the event bus and the hooks -------------------------------------------

def _bus_trace(mod):
    bus = mod.EventBus()
    got = []
    un = bus.subscribe(lambda e: got.append(("all", e.type.value)))
    bus.subscribe(lambda e: got.append(("stage", e.data["stage"])),
                  mod.EventType.STAGE_STARTED)
    bus.subscribe(lambda e: got.append(("pred", e.data["stage"])),
                  predicate=lambda e: e.data.get("stage") == "b")
    bus.subscribe(lambda e: 1 / 0, mod.EventType.STAGE_STARTED)   # isolated
    bus.emit(mod.EventType.STAGE_STARTED, stage="a")
    bus.emit(mod.EventType.STAGE_STARTED, stage="b")
    un()
    un()
    bus.emit(mod.EventType.JOB_COMPLETED)
    hist = [(e.type.value, e.data) for e in bus.history()]
    only = [e.data for e in bus.history(mod.EventType.STAGE_STARTED)]
    bus.clear()
    hooks = mod.HookManager()
    order = []
    hooks.register(mod.HookPoint.PRE_STAGE, lambda c: order.append("late"), priority=90)
    hooks.register(mod.HookPoint.PRE_STAGE, lambda c: order.append("early"), priority=10)
    hooks.register(mod.HookPoint.PRE_STAGE, lambda c: 1 / 0)
    hooks.register(mod.HookPoint.PRE_STAGE, lambda c: c.update(seen=True), priority=60)
    ctx = hooks.fire(mod.HookPoint.PRE_STAGE, {})
    return (got, hist, only, bus.history(), order, ctx, hooks.count(),
            hooks.count(mod.HookPoint.PRE_STAGE), mod.get_event_bus() is mod.get_event_bus(),
            [t.value for t in mod.EventType], [p.value for p in mod.HookPoint])


def test_event_bus_and_hooks_equal_jax():
    assert _bus_trace(events) == _bus_trace(jevents)


# -- safeguards -------------------------------------------------------------

Meta = namedtuple("Meta", "width height nb_frames")
_Usage = namedtuple("_Usage", "total used free")


def _preflight(mod, cfg, src, meta, free_gb=None, monkeypatch=None):
    if free_gb is not None:
        monkeypatch.setattr(mod.shutil, "disk_usage",
                            lambda p: _Usage(2**40, 0, int(free_gb * 2**30)))
    return mod.preflight_check(cfg, src, meta=meta).to_dict()


@pytest.mark.parametrize("case", ["ok", "missing_source", "no_disk", "half_disk", "no_meta"])
def test_preflight_equals_jax_on_the_cpu(tmp_path, monkeypatch, case):
    """On the CPU (``device_platform="cpu"`` in the port; JAX's check on a
    host without a TPU with its CPU fallback): the same blockers and the
    same warnings, the weights warning aside (the JAX check looks in its
    default directory only; the port's registry also finds the packaged
    FW_fast6_x2, so it warns of a model without weights)."""
    src = tmp_path / "c.y4m"
    if case != "missing_source":
        src.write_bytes(b"x")
    meta = None if case == "no_meta" else Meta(1920, 1080, 100)
    free = {"no_disk": 0.5, "half_disk": 2.0, "no_meta": 1.0}.get(case, 500.0)
    common = dict(project_dir=tmp_path / "p", device_platform="cpu")
    want = _preflight(jsafeguards, JaxConfig(sr_model=MODEL, **common), src, meta, free,
                      monkeypatch)
    got = _preflight(safeguards, Config(sr_model=MODEL, **common), src, meta, free,
                     monkeypatch)
    drop = [w for w in want["warnings"] if w.startswith("no weights")]
    assert got == {**want, "warnings": [w for w in want["warnings"] if w not in drop]}
    assert got["ok"] == (case in ("ok", "half_disk", "no_meta"))
    seeded = _preflight(safeguards, Config(sr_model="RealESRGAN_x2plus",
                                           weights_dir=tmp_path / "none", **common),
                        src, meta, free, monkeypatch)
    assert any(w.startswith("no weights for RealESRGAN_x2plus") for w in seeded["warnings"])


def test_preflight_blocks_cuda_without_a_card(tmp_path):
    """JAX's ``allow_cpu_fallback`` is not copied: ``cuda`` (or ``auto``)
    with no card is a blocker, not a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = tmp_path / "c.y4m"
    src.write_bytes(b"x")
    res = safeguards.preflight_check(Config(project_dir=tmp_path), src)
    assert not res.ok and res.blockers[0].startswith("no CUDA device")
    jres = jsafeguards.preflight_check(JaxConfig(project_dir=tmp_path), src)
    assert jres.ok and "running on CPU: expect low throughput" in jres.warnings


def test_monitors_and_keep_awake(tmp_path):
    bus = events.EventBus()
    d = safeguards.DiskSpaceMonitor(tmp_path, min_free_gb=10**9, events=bus).check()
    jd = jsafeguards.DiskSpaceMonitor(tmp_path, min_free_gb=10**9).check()
    assert (d.ok, d.total_gb) == (jd.ok, jd.total_gb) == (False, jd.total_gb)
    assert [e.type for e in bus.history()] == [events.EventType.DISK_SPACE_LOW]
    m = safeguards.HostMemoryMonitor(min_free_gb=10**9, events=bus).check()
    assert set(m) == set(jsafeguards.HostMemoryMonitor().check()) and not m["ok"]
    assert safeguards.DiskSpaceMonitor(tmp_path).estimate_output_gb(3840, 2160, 10) == \
        jsafeguards.DiskSpaceMonitor(tmp_path).estimate_output_gb(3840, 2160, 10)
    loop = safeguards.SafeguardLoop(tmp_path, bus, interval_s=0.01)
    loop.start()
    time.sleep(0.05)
    loop.stop()
    assert not loop._thread.is_alive()
    with safeguards.KeepAwake() as k:
        pass
    assert k._proc is None


def test_device_memory_monitor_reads_the_card(monkeypatch):
    """JAX's HBMMonitor over ``torch.cuda.mem_get_info`` (faked here: the
    CPU has no card): utilization, the pressure event above the
    threshold, the peak sample."""
    bus = events.EventBus()
    mon = safeguards.DeviceMemoryMonitor(threshold=0.9, events=bus)
    for free in (60 * 2**30, 4 * 2**30):
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None, f=free: (f, 80 * 2**30))
        got = mon.check()
    assert got == {"utilization": 0.95, "used_gb": 76.0, "limit_gb": 80.0, "ok": False}
    assert mon.peak == 0.95 and len(mon.samples) == 2
    assert [e.data for e in bus.history(events.EventType.HBM_PRESSURE)] == [{"utilization": 0.95}]


# -- the restorer on the engine ---------------------------------------------

def _clip(path: Path, n: int = N) -> Path:
    from conftest import make_gradient_frame

    with jy4m.Y4MWriter(path, W, H, fps=12) as w:
        for t in range(n):
            w.write_frame(make_gradient_frame(H, W, t))
    return path


def _cfg(tmp_path, proj="proj", **kw):
    return Config(sr_model=MODEL, device_platform="cpu", batch_size=2,
                  project_dir=tmp_path / proj, **kw)


def _restore(cfg, src, out, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return VideoRestorer(cfg, **kw).restore_video(src, out)


@pytest.fixture
def clip(tmp_path):
    return _clip(tmp_path / "c.y4m")


@pytest.fixture
def straight(tmp_path, clip):
    _restore(_cfg(tmp_path, "straight"), clip, tmp_path / "straight.y4m")
    return (tmp_path / "straight.y4m").read_bytes()


def _fail_write_once(monkeypatch, at: int, exc):
    """The writer raises ``exc`` on its ``at``-th frame, once."""
    real = y4m.Y4MWriter.write_yuv_frame
    calls = []

    def failing(self, *planes):
        calls.append(1)
        if len(calls) == at:
            raise exc
        return real(self, *planes)

    monkeypatch.setattr(y4m.Y4MWriter, "write_yuv_frame", failing)
    return calls


def test_retried_enhance_stage_equals_a_straight_run(tmp_path, clip, straight, monkeypatch):
    """A disk error (a ``TransientError``) on the writer's fourth frame:
    the enhance stage fails, its writer, ring, threads and SR processor
    are shut down, and the retry resumes from the checkpoint, cutting the
    output back to a batch start: the bytes of a straight run."""
    _fail_write_once(monkeypatch, 4, errors.DiskSpaceError("injected: no space left"))
    bus = events.EventBus()
    res = _restore(_cfg(tmp_path, checkpoint_interval=1), clip, tmp_path / "o.y4m",
                   events=bus)
    assert (tmp_path / "o.y4m").read_bytes() == straight
    st = {s["name"]: s for s in res.stage_summary["stages"]}
    assert (st["enhance"]["status"], st["enhance"]["attempts"]) == ("completed", 2)
    assert res.frames_out == N and res.errors == 0 and res.resumed_from == 2
    types = [e.type.value for e in bus.history()]
    assert types.count("stage_retrying") == 1 and "job_completed" in types
    # FRAME_PROCESSED is emitted when a batch is submitted to the 4-frame
    # writer drain, so the fault on frame 4 surfaces at one of the next
    # submits: the failed attempt reports [2, 4] or, when the writer thread
    # lags (a loaded machine), [2, 4, 6]; the retry 4 and 6 from its resume
    # point either way
    frames = [e.data["frames"] for e in bus.history(events.EventType.FRAME_PROCESSED)]
    assert frames[-2:] == [4, 6] and frames[:-2] in ([2, 4], [2, 4, 6])


def test_retry_without_checkpoints_rewrites_from_frame_0(tmp_path, clip, straight,
                                                         monkeypatch):
    _fail_write_once(monkeypatch, 3, errors.DiskSpaceError("injected"))
    res = _restore(_cfg(tmp_path, checkpoint_enabled=False), clip, tmp_path / "o.y4m")
    assert (tmp_path / "o.y4m").read_bytes() == straight
    assert res.resumed_from == 0 and res.stage_summary["stages"][3]["attempts"] == 2


def test_a_fatal_error_is_not_retried(tmp_path, clip, monkeypatch):
    calls = _fail_write_once(monkeypatch, 3, OSError("injected: bad sector"))
    with pytest.raises(OSError, match="bad sector"):
        _restore(_cfg(tmp_path), clip, tmp_path / "o.y4m")
    assert len(calls) < N


def test_preflight_blocker_stops_before_the_sr_processor(tmp_path, clip, monkeypatch):
    from framewright_tpu_torch import restorer as rmod

    built = []
    monkeypatch.setattr(rmod.SuperResolution, "__init__",
                        lambda self, *a, **k: built.append(1) or None)
    monkeypatch.setattr(safeguards.shutil, "disk_usage", lambda p: _Usage(2**40, 0, 1))
    out = tmp_path / "o.y4m"
    with pytest.raises(errors.InputError, match="preflight blocked: insufficient disk"):
        _restore(_cfg(tmp_path), clip, out)
    assert not built and not out.exists()
    assert not (tmp_path / "proj" / "checkpoints").exists()


def test_dry_run_writes_nothing(tmp_path, clip, capsys):
    out = tmp_path / "o.y4m"
    res = _restore(_cfg(tmp_path, dry_run=True), clip, out)
    plan = res.stage_summary["dry_run"]
    assert plan["stages"] == ["probe", "checkpoint", "enhance", "validate", "finalize"]
    assert plan["input"] == f"{W}x{H}@12.00 ({N} frames)"
    assert plan["output"] == f"{2 * W}x{2 * H} -> {out}" and plan["model"] == MODEL
    assert plan["preflight"]["ok"] and plan["missing_weights"] == []
    assert res.frames_out == 0 and not out.exists() and not (tmp_path / "proj").exists()
    rc = cli.main(["restore", str(clip), "-o", str(out), "--model", MODEL, "--device", "cpu",
                   "--project-dir", str(tmp_path / "p2"), "--dry-run"])
    printed = json.loads(capsys.readouterr().out)
    assert rc == 0 and printed["dry_run"]["stages"] == plan["stages"]
    assert not out.exists() and not (tmp_path / "p2").exists()
    # the JAX dry run's plan: the same stages, input and output
    jres = JaxRestorer(JaxConfig(sr_model=MODEL, device_platform="cpu", dry_run=True,
                                 project_dir=tmp_path / "pj")).restore_video(clip, out)
    jplan = jres.stage_summary["dry_run"]
    assert {k: plan[k] for k in jplan} == jplan


def test_restore_event_types_equal_jax(tmp_path, clip):
    """The same clip, config and batch through both restorers: the same
    event types in the same order (lifecycle, stages, frames, the gate)."""
    common = dict(sr_model=MODEL, device_platform="cpu", batch_size=2, min_psnr=0.0,
                  min_ssim=0.0)
    jbus, bus = jevents.EventBus(), events.EventBus()
    with contextlib.redirect_stdout(io.StringIO()):
        JaxRestorer(JaxConfig(project_dir=tmp_path / "pj", **common), events=jbus)\
            .restore_video(clip, tmp_path / "jax.y4m")
        VideoRestorer(Config(project_dir=tmp_path / "pt", **common), events=bus)\
            .restore_video(clip, tmp_path / "port.y4m")

    def types(b):
        return [e.type.value for e in b.history() if e.type.value not in RESOURCE_EVENTS]

    assert types(bus) == types(jbus)
    assert types(bus).count("frame_processed") == 3 and "quality_check_passed" in types(bus)


def test_progress_callback_receives_progress_info_as_jax(tmp_path, clip):
    """C6: the callback gets a ``ProgressInfo`` with the stage, frames and
    total, and JAX's rounding of fps, ETA and percent."""
    assert [f for f in ProgressInfo.__dataclass_fields__] == \
        [f for f in JaxProgressInfo.__dataclass_fields__]
    common = dict(sr_model=MODEL, device_platform="cpu", batch_size=2)
    got, want = [], []
    with contextlib.redirect_stdout(io.StringIO()):
        JaxRestorer(JaxConfig(project_dir=tmp_path / "pj", **common),
                    progress_callback=want.append).restore_video(clip, tmp_path / "j.y4m")
        VideoRestorer(Config(project_dir=tmp_path / "pt", **common),
                      progress_callback=got.append).restore_video(clip, tmp_path / "p.y4m")
    assert all(isinstance(i, ProgressInfo) for i in got)

    def key(i):
        return (i.stage, i.frames_done, i.total_frames, i.percent)

    assert [key(i) for i in got] == [key(i) for i in want] == [
        ("enhance", 2, N, 33.3), ("enhance", 4, N, 66.7), ("enhance", 6, N, 100.0)]
    for i in got:
        assert i.fps == round(i.fps, 2) and i.eta_s == round(i.eta_s, 1) and i.fps >= 0


def test_eta_tracker_follows_jax():
    from framewright_tpu.restorer import _EtaTracker as JaxTracker

    a, b = _EtaTracker(window=5), JaxTracker(window=5)
    for t in (a, b):
        t.times = [0.0, 1.0, 2.0, 3.0]
        t.tick(3)
        t.times = [float(v) for v in range(len(t.times))]
    assert (a.times, a.fps, a.eta(10)) == (b.times, b.fps, b.eta(10))
    assert _EtaTracker().fps == 0.0 and _EtaTracker().eta(5) == 0.0


def test_cli_prints_progress_by_stage(tmp_path, clip, capsys):
    assert cli.main(["restore", str(clip), "-o", str(tmp_path / "o.y4m"), "--model", MODEL,
                     "--device", "cpu", "--project-dir", str(tmp_path / "p")]) == 0
    err = capsys.readouterr().err
    assert "[enhance]" in err and f"{N}/{N} frames (100.0%)" in err and "ETA" in err


def test_cancel_between_batches_then_resume(tmp_path, clip, straight):
    r = VideoRestorer(_cfg(tmp_path, checkpoint_interval=1))

    def cancel_after_first(info):
        if info.frames_done >= 2:
            r.cancel()

    r.progress_callback = cancel_after_first
    with contextlib.redirect_stdout(io.StringIO()), pytest.raises(errors.CancelledError):
        r.restore_video(clip, tmp_path / "o.y4m")
    res = _restore(_cfg(tmp_path, checkpoint_interval=1), clip, tmp_path / "o.y4m")
    assert res.resumed_from in (2, 4) and (tmp_path / "o.y4m").read_bytes() == straight


def test_pause_and_resume_between_batches(tmp_path, clip, straight):
    r = VideoRestorer(_cfg(tmp_path))
    paused = []

    def pause_once(info):
        if info.frames_done == 2 and not paused:
            paused.append(time.time())
            r.pause()
            threading.Timer(0.3, r.resume).start()

    r.progress_callback = pause_once
    with contextlib.redirect_stdout(io.StringIO()):
        res = r.restore_video(clip, tmp_path / "o.y4m")
    assert paused and res.frames_out == N and res.duration_s >= 0.25
    assert (tmp_path / "o.y4m").read_bytes() == straight


def test_failed_gate_reaches_the_caller_after_finalize(tmp_path, clip):
    """JAX's validate stage is not critical, so its ValidationError under
    continue_on_error=False disappears there; the port raises it, after
    the finalize stage removed the checkpoint."""
    bus = events.EventBus()
    with pytest.raises(errors.ValidationError, match="quality gates failed"):
        _restore(_cfg(tmp_path, min_psnr=99.0, continue_on_error=False), clip,
                 tmp_path / "o.y4m", events=bus)
    types = [e.type.value for e in bus.history()]
    assert "quality_check_failed" in types and "stage_failed" in types
    assert types.index("stage_failed") < len(types) - 1     # finalize ran after it
    assert not list((tmp_path / "proj" / "checkpoints").glob("*.json"))
    jres = JaxRestorer(JaxConfig(sr_model=MODEL, device_platform="cpu", min_psnr=99.0,
                                 continue_on_error=False, project_dir=tmp_path / "pj"))
    with contextlib.redirect_stdout(io.StringIO()):
        out = jres.restore_video(clip, tmp_path / "j.y4m")
    assert out.quality is None      # swallowed


def test_config_engine_fields_follow_jax():
    ours, theirs = Config(), JaxConfig()
    for name in ("stage_max_retries", "dry_run", "tile_size", "tile_overlap", "min_vmaf"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert Config(dry_run=True).get_hash() == Config().get_hash()
    assert Config(stage_max_retries=3).get_hash() != Config().get_hash()
    with pytest.raises(errors.ConfigError):
        Config(stage_max_retries=-1)
