"""The job surfaces on the CPU against the JAX package: ``JobStore`` (one
schema: each package reads the other's database), ``JobScheduler``
(priorities, retries, cancel, pause), ``BatchQueueProcessor`` (its
default process is the port's restore), ``WatchFolder``, ``ScheduledJob``
and ``BatchScheduler``, and the ``batch`` and ``watch`` verbs. The tests
wait on events and join threads, or inject the clock; none polls a
wall-clock deadline."""

import contextlib
import io
import threading
import time

import numpy as np
import pytest

from framewright_tpu import batch as jbatch
from framewright_tpu import cli as jcli
from framewright_tpu import persistence as jpersistence
from framewright_tpu.engine.scheduler import JobScheduler as JaxJobScheduler
from framewright_tpu.events import EventType as JaxEventType
from framewright_tpu_torch import batch, cli, persistence
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.engine.scheduler import JobScheduler
from framewright_tpu_torch.events import EventType
from framewright_tpu_torch.io.y4m import Y4MWriter

WAIT = 60.0          # an event's timeout: the test fails, it does not hang


def _clip(path, n=4, h=24, w=32, seed=3):
    """A progressive clip (no frame reads as combed)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    with Y4MWriter(path, w, h, fps=12) as wr:
        for t in range(n):
            ph = rng.random(3) * 6
            g = 127 + 100 * np.sin(x / 5 + y / 7 + ph[0] + t * 0.3)
            wr.write_frame(np.clip(np.stack([g, g * 0.9 + 10, g * 0.8 + 20], -1), 0, 255
                                   ).astype(np.uint8))
    return path


def _run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


# -- the store ---------------------------------------------------------------------

def test_job_store_reads_and_writes_jax_databases(tmp_path):
    db = tmp_path / "jobs.db"
    jstore = jpersistence.JobStore(db)
    a = jstore.create_job("a.y4m", "a_out.y4m", config={"crf": 20}, config_hash="h")
    store = persistence.JobStore(db)
    b = store.create_job("b.y4m", total_frames=9)
    store.update_progress(a, 5, stage="enhance", total_frames=10)
    store.record_range(a, "enhance", 0, 5)
    jstore.set_state(b, "running")
    for s in (store, jstore):
        ja, jb = s.get_job(a), s.get_job(b)
        assert (ja.config, ja.config_hash, ja.frames_done, ja.stage, ja.total_frames) == (
            {"crf": 20}, "h", 5, "enhance", 10)
        assert jb.state == "running" and [j.job_id for j in s.resumable_jobs()] == [b]
        assert s.completed_ranges(a, "enhance") == [(0, 5)]
        assert [j.job_id for j in s.list_jobs()] == [a, b]
    with pytest.raises(ValueError, match="bad state"):
        store.set_state(a, "lost")
    store.delete_job(a)
    assert jstore.get_job(a) is None and [j.job_id for j in jstore.list_jobs()] == [b]
    store.close()
    jstore.close()


# -- the scheduler ------------------------------------------------------------------

class _Recorder:
    """A process function that records the order and fails on request;
    ``done`` is set once ``expect`` jobs ended (completed or failed)."""

    def __init__(self, expect, fail=()):
        self.order, self.fail, self.expect = [], dict(fail), expect
        self.done = threading.Event()
        self.ended = 0
        self.lock = threading.Lock()

    def __call__(self, job):
        self.order.append(job.source)
        if self.fail.get(job.source, 0) > 0:
            self.fail[job.source] -= 1
            raise RuntimeError(f"boom {job.source}")

    def on_end(self, _event):
        with self.lock:
            self.ended += 1
            if self.ended >= self.expect:
                self.done.set()


def test_scheduler_runs_by_priority_with_retries_as_jax(tmp_path):
    """Held before start: priorities 10, 90, 50, 90 run high first, FIFO
    within a level; 'flaky' fails once and is retried, 'bad' fails twice
    and fails; a cancelled job never runs. The same order, states and
    stats as JAX's scheduler on the same submissions."""
    results = {}
    for name, sched_cls, store_mod, etype in (
            ("port", JobScheduler, persistence, EventType),
            ("jax", JaxJobScheduler, jpersistence, JaxEventType)):
        rec = _Recorder(expect=4, fail={"flaky": 1, "bad": 2})
        store = store_mod.JobStore(tmp_path / f"{name}.db")
        sched = sched_cls(store, process_fn=rec, max_retries=1)
        for t in (etype.JOB_COMPLETED, etype.JOB_FAILED):
            sched.events.subscribe(rec.on_end, t)
        ids = {src: sched.submit(src, priority=p) for src, p in
               (("low", 10), ("flaky", 90), ("mid", 50), ("bad", 90), ("gone", 95))}
        sched.cancel(ids["gone"])
        sched.start()
        assert rec.done.wait(WAIT)
        if name == "port":
            assert sched.wait_idle(WAIT)
        sched.stop(wait=True)
        assert not sched._thread.is_alive()
        results[name] = (rec.order, {s: store.get_job(j).state for s, j in ids.items()},
                         dict(sched.stats))
        store.close()
    assert results["port"] == results["jax"]
    order, states, stats = results["port"]
    assert order == ["flaky", "bad", "flaky", "bad", "mid", "low"]   # a retry keeps its level
    assert states == {"low": "completed", "flaky": "completed", "mid": "completed",
                      "bad": "failed", "gone": "cancelled"}
    assert stats == {"completed": 3, "failed": 1, "cancelled": 1, "retried": 2}


def test_scheduler_pause_holds_jobs_until_resume(tmp_path):
    store = persistence.JobStore(tmp_path / "p.db")
    started = threading.Event()
    sched = JobScheduler(store, process_fn=lambda job: None)
    sched.events.subscribe(lambda e: started.set(), EventType.JOB_STARTED)
    sched.pause()
    sched.start()
    jid = sched.submit("x.y4m")
    assert not started.wait(0.3) and store.get_job(jid).state == "pending"
    sched.resume()
    assert started.wait(WAIT) and sched.wait_idle(WAIT)
    assert store.get_job(jid).state == "completed"
    sched.stop()
    assert not sched._thread.is_alive()
    assert JobScheduler(store).wait_idle(0.0)


# -- the batch queue, the watch folder and the time windows ---------------------------

def test_queue_default_process_is_the_port_restore(tmp_path):
    """Two jobs with a CPU config: each output equals the CLI restore of
    the same clip with the same flags, byte for byte; ``batch list`` of the
    database prints the lines JAX's ``batch list`` prints of it."""
    clips = [_clip(tmp_path / f"c{i}.y4m", seed=i) for i in range(2)]
    cfg = Config(sr_model="FW_fastvgg_x2", device_platform="cpu",
                 project_dir=tmp_path / "proj", checkpoint_enabled=False)
    db = tmp_path / "jobs.db"
    q = batch.BatchQueueProcessor(persistence.JobStore(db))
    ids = [q.submit(str(c), str(tmp_path / f"out{i}.y4m"), cfg) for i, c in enumerate(clips)]
    rc, out = _run_cli(cli.main, ["batch", "run", "--db", str(db)])
    assert rc == 0 and out == "processed 2 jobs\n"
    for i, c in enumerate(clips):
        ref = tmp_path / f"ref{i}.y4m"
        rc, _ = _run_cli(cli.main, ["restore", str(c), "-o", str(ref), "--model",
                                    "FW_fastvgg_x2", "--device", "cpu", "--no-checkpoint",
                                    "--project-dir", str(tmp_path / f"rp{i}")])
        assert rc == 0 and (tmp_path / f"out{i}.y4m").read_bytes() == ref.read_bytes()
    rc, listed = _run_cli(cli.main, ["batch", "list", "--db", str(db)])
    rc_j, listed_j = _run_cli(jcli.main, ["batch", "list", "--db", str(db)])
    assert rc == rc_j == 0 and listed == listed_j
    assert [ln.split()[:2] for ln in listed.splitlines()] == [[j, "completed"] for j in ids]


def test_batch_verbs_print_as_jax(tmp_path, monkeypatch):
    """``batch submit`` prints a job id, ``list`` JAX's line, ``run`` requeues
    a crashed job and prints the count; a failing job is recorded failed."""
    calls = []

    def fake(self, job):
        calls.append(job.source)
        if job.source == "bad.y4m":
            raise RuntimeError("no such clip")

    monkeypatch.setattr(batch.BatchQueueProcessor, "_default_process", fake)
    db = tmp_path / "v.db"
    outs = []
    for src in ("a.y4m", "bad.y4m"):
        rc, out = _run_cli(cli.main, ["batch", "submit", src, "-o", "o.y4m", "--db", str(db)])
        assert rc == 0 and len(out.strip()) == 12
        outs.append(out.strip())
    jstore = jpersistence.JobStore(db)
    crashed = jstore.create_job("c.y4m")
    jstore.set_state(crashed, "running")
    for main in (cli.main, jcli.main):
        assert _run_cli(main, ["batch", "list", "--db", str(db)]) == _run_cli(
            cli.main, ["batch", "list", "--db", str(db)])
    rc, out = _run_cli(cli.main, ["batch", "run", "--db", str(db)])
    assert rc == 0 and out == "processed 3 jobs\n" and calls == ["a.y4m", "bad.y4m", "c.y4m"]
    states = {j.source: (j.state, j.error) for j in jstore.list_jobs()}
    assert states == {"a.y4m": ("completed", ""), "bad.y4m": ("failed", "no such clip"),
                      "c.y4m": ("completed", "")}
    jstore.close()


def test_watch_folder_enqueues_stable_files_as_jax(tmp_path, monkeypatch):
    """A file is enqueued on the poll that finds its size unchanged, once,
    with JAX's output name; the ``watch`` verb with ``--cycles 2`` restores
    a clip dropped in the folder."""
    wdir = tmp_path / "in"
    wdir.mkdir()
    (wdir / "a.y4m").write_bytes(b"x" * 10)
    (wdir / "notes.txt").write_text("skip")
    got = {}
    for name, mod, pmod in (("port", batch, persistence), ("jax", jbatch, jpersistence)):
        q = mod.BatchQueueProcessor(pmod.JobStore(tmp_path / f"{name}.db"),
                                    process_fn=lambda job: None)
        wf = mod.WatchFolder(wdir, q, poll_s=0.0)
        first = wf.scan_once()
        second = wf.scan_once()
        third = wf.scan_once()
        jobs = q.store.list_jobs()
        got[name] = (len(first), len(second), len(third),
                     [(j.source, j.output) for j in jobs])
    assert got["port"] == got["jax"]
    assert got["port"][:3] == (0, 1, 0)
    assert got["port"][3] == [(str(wdir / "a.y4m"), str(wdir / "restored" / "a_restored.y4m"))]

    seen = []
    monkeypatch.setattr(batch.BatchQueueProcessor, "_default_process",
                        lambda self, job: seen.append((job.source, job.output)))
    clip_dir = tmp_path / "clips"
    clip_dir.mkdir()
    _clip(clip_dir / "c.y4m")
    rc, _ = _run_cli(cli.main, ["watch", str(clip_dir), "--db", str(tmp_path / "w.db"),
                                "--poll", "0", "--cycles", "2", "--output-dir",
                                str(tmp_path / "outs")])
    assert rc == 0 and seen == [(str(clip_dir / "c.y4m"), str(tmp_path / "outs" / "c_restored.y4m"))]


def test_scheduled_jobs_open_their_windows_as_jax():
    """The clock is injected: windows with and without the midnight wrap."""
    def at(hour):
        return time.struct_time((2026, 1, 1, hour, 0, 0, 3, 1, 0))

    for start, end in ((0, 24), (9, 17), (22, 6)):
        for hour in (0, 5, 9, 16, 17, 23):
            want = jbatch.ScheduledJob("s", start_hour=start, end_hour=end).runnable_now(at(hour))
            assert batch.ScheduledJob("s", start_hour=start, end_hour=end).runnable_now(
                at(hour)) == want
    submitted = []

    class Q:
        def submit(self, source, output=""):
            submitted.append(source)
            return source

    sch = batch.BatchScheduler(Q())
    sch.add(batch.ScheduledJob("night.y4m", start_hour=22, end_hour=6))
    sch.add(batch.ScheduledJob("day.y4m", start_hour=9, end_hour=17))
    assert sch.tick(at(23)) == ["night.y4m"] and sch.tick(at(23)) == []
    assert sch.tick(at(10)) == ["day.y4m"] and submitted == ["night.y4m", "day.y4m"]
    assert sch.scheduled == []
