"""The port's scale-out (``framewright_tpu_torch/parallel``): scene chunks
and the chunk queue, the mesh and the frames split, the
``ShardedFrameProcessor``, the SR processor split over a mesh of several
``cpu`` entries, the process group (a ``gloo`` group of two CPU
processes), and the render farm with the two JAX faults it does not
copy, held to the JAX package.

Tolerances: the host code (chunks, queue, spec parsing, errors) equals
JAX's; the ``ShardedFrameProcessor`` within 1e-5 of JAX's on the same
function; the split SR restore equals the unsplit one byte for byte
(each card's part runs in a batch of the unsplit run's size). No test
waits on a wall clock: the farm's clocks are injected, threads and
processes are joined, and a heartbeat is awaited on its event.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framewright_tpu.errors import ShardingError as JShardingError
from framewright_tpu.parallel import dcn as jdcn
from framewright_tpu.parallel import distributor as jdist
from framewright_tpu.parallel import mesh as jmesh
from framewright_tpu.parallel import multihost as jmh
from framewright_tpu_torch import cli as pcli
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import FramewrightError, ShardingError
from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
from framewright_tpu_torch.parallel import dcn, distributor, mesh, multihost
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(n, h, w, seed=0):
    return (np.random.default_rng(seed).random((n, h, w, 3)) * 255).astype(np.uint8)


# -- chunks and the queue: JAX's host code ---------------------------------------------


@pytest.mark.parametrize("total,size,bounds", [(250, 100, None), (300, 100, [90, 215]),
                                               (7, 3, [1, 2, 6]), (0, 10, None)])
def test_scene_chunks_equal_jax(total, size, bounds):
    def key(cs):
        return [(c.index, c.start, c.end, c.state.value, c.n_frames) for c in cs]

    assert key(distributor.make_scene_chunks(total, size, bounds)) == \
        key(jdist.make_scene_chunks(total, size, bounds))


def test_chunk_queue_equals_jax():
    qs = [m.ChunkQueue(m.make_scene_chunks(50, 10), max_attempts=2) for m in (distributor, jdist)]
    trace = []
    for q in qs:
        t = []
        a = q.next_pending("w1")
        b = q.next_pending("w2")
        q.complete(a.index)
        q.fail(b.index)
        c = q.next_pending("w3")
        q.fail(c.index)
        t.append(q.requeue_stale({q.next_pending("w4").index: 1.0}, timeout_s=5.0))
        t.append((q.done, q.progress, [(x.state.value, x.worker, x.attempts) for x in q.chunks]))
        trace.append(t)
    assert trace[0] == trace[1]


# -- the mesh ----------------------------------------------------------------------


def test_mesh_as_jax():
    m = mesh.build_mesh((4, 2), ["cpu"] * 8)
    assert m.shape == dict(jmesh.build_mesh((4, 2)).shape) == {"frames": 4, "space": 2}
    assert len(m.frame_devices) == 4
    assert mesh.build_mesh(devices=["cpu"] * 3).shape == {"frames": 3}
    assert mesh.build_mesh().shape["frames"] == (torch.cuda.device_count() or 1)
    for args in (((64,), ["cpu"] * 8), ((2, 2), ["cpu"] * 4, ("frames",))):
        with pytest.raises(ShardingError) as got:
            mesh.build_mesh(*args)
        with pytest.raises(JShardingError) as want:
            jmesh.build_mesh(*args[:1], None, *args[2:])
        assert str(got.value).split(",")[0] == str(want.value).split(",")[0]
    m8 = mesh.build_mesh((8,), ["cpu"] * 8)
    assert mesh.pad_batch_for_mesh(11, m8) == jmesh.pad_batch_for_mesh(11, jmesh.build_mesh((8,)))
    with pytest.raises(ShardingError) as got:
        mesh.shard_frames(np.zeros((3, 4, 4, 3)), m8)
    with pytest.raises(JShardingError) as want:
        jmesh.shard_frames(np.zeros((3, 4, 4, 3)), jmesh.build_mesh((8,)))
    assert str(got.value) == str(want.value)
    parts = mesh.shard_frames(np.arange(16 * 3).reshape(16, 1, 1, 3), m8)
    assert [p.shape[0] for p in parts] == [2] * 8 and int(parts[7][1, 0, 0, 2]) == 47
    # spatial: each device's band of its frames' rows, as JAX places them
    m42, jm42 = mesh.build_mesh((4, 2), ["cpu"] * 8), jmesh.build_mesh((4, 2))
    xs = np.arange(8 * 4 * 2 * 3).reshape(8, 4, 2, 3)
    bands = mesh.shard_frames(xs, m42, spatial=True)
    placed = {s.device: np.asarray(s.data)
              for s in jmesh.shard_frames(xs, jm42, spatial=True).addressable_shards}
    assert [b.numpy().tolist() for b in bands] == [placed[d].tolist()
                                                   for d in jm42.devices.flat]
    with pytest.raises(ShardingError, match="space axis"):
        mesh.shard_frames(np.zeros((8, 3, 4, 3)), m42, spatial=True)
    assert mesh.frame_split(7, mesh.build_mesh((3,), ["cpu"] * 3)) == [(0, 0, 3), (1, 3, 5),
                                                                      (2, 5, 7)]
    assert mesh.frame_split(1, mesh.build_mesh((3,), ["cpu"] * 3)) == [(0, 0, 1)]


def test_sharded_frame_processor_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 3)).astype(np.float32)
    batch = rng.standard_normal((11, 16, 16, 3)).astype(np.float32)   # pads to 12

    def jfn(p, x):
        return jnp.tanh(x @ p) * 2.0

    def pfn(p, x):
        return torch.tanh(x @ p) * 2.0

    want = jdist.ShardedFrameProcessor(jfn, w, mesh=jmesh.build_mesh((4,))).process(batch)
    proc = distributor.ShardedFrameProcessor(pfn, w, mesh=mesh.build_mesh((4,), ["cpu"] * 4))
    got = proc.process(batch)
    assert got.shape == want.shape == (11, 16, 16, 3)
    assert np.abs(got - want).max() <= 1e-5
    assert proc.n_shards == 4
    assert distributor.ShardedFrameProcessor.estimate_speedup(8) == \
        jdist.ShardedFrameProcessor.estimate_speedup(8)


# -- the SR processor's frame split ----------------------------------------------------


def _sr_run(sr, batches, color="rgb", stats=False):
    sr.setup(*batches[0].shape[1:3])
    if color == "yuv420":
        sr.set_output_color("yuv420", full_range=True)
    if stats:
        sr.enable_device_stats()
    outs, st = [], []
    handles = [sr.dispatch(b) for b in batches]
    for h in handles:
        outs.append(sr.materialize(h))
        st.append(h.get("stats_np"))
    plan = sr.plan
    sr.teardown()
    return outs, st, plan


@pytest.mark.parametrize("model,dtype,color,stats", [
    ("FW_fastvgg_x2", "bfloat16", "rgb", True),
    ("FW_fastvgg_x2", "int8", "rgb", False),
    ("FW_fast6_x2", "bfloat16", "yuv420", True)], ids=["vgg", "vgg-int8", "rrdb-yuv"])
def test_sr_split_over_a_cpu_mesh_equals_the_unsplit_path(model, dtype, color, stats):
    """``ShardedSR`` over three ``cpu`` entries (parts of 2, 2, 1 and 2, 2, 2
    frames) equals the unsplit processor run in batches of 2, byte for byte,
    with the same stats; ``batch_size`` 6 is the dispatch's, each member
    plans for 2 (JAX's global batch)."""
    batches = [_frames(5, 24, 32, seed=2), _frames(6, 24, 32, seed=3)]
    base = dict(model_name=model, compute_dtype=dtype, device="cpu")
    want, wst, wplan = _sr_run(SuperResolution(SRConfig(**base, batch_size=2)), batches,
                               color, stats)
    split = distributor.ShardedSR(SRConfig(**base, batch_size=6),
                                  mesh.build_mesh((3,), ["cpu"] * 3))
    got, gst, gplan = _sr_run(split, batches, color, stats)
    assert [m.config.batch_size for m in split.members] == [2] * 3
    assert gplan.frames == 3 * wplan.frames == 6 and split.dispatches == 2
    assert all(m.config.yuv_full_range == (color == "yuv420") for m in split.members)
    for g, w in zip(got, want):
        if color == "yuv420":
            assert all(np.array_equal(a, b) for a, b in zip(g, w))
        else:
            assert np.array_equal(g, w)
    for g, w in zip(gst, wst):
        assert (g is None) == (w is None)
        if g is not None:
            assert all(np.array_equal(g[k], w[k]) for k in w)


def test_sr_one_device_is_not_split(monkeypatch):
    """The restore's SR is the one-device processor with one local device
    of its kind, a frames axis of one, ``sharding_strategy="none"``, or the
    CPU asked for on a host whose devices are cards; ``--batch`` below the
    cards stays the dispatch's frames. The diffusion SR splits frames too
    (its noise drawn once a dispatch, ``tests/test_torch_split_models.py``)."""
    from framewright_tpu_torch.restorer import build_sr

    cfg = dict(sr_model="FW_fastvgg_x2", device_platform="cpu")
    monkeypatch.setattr(mesh, "local_devices", lambda: [torch.device("cpu")])
    assert type(build_sr(Config(**cfg))) is SuperResolution
    monkeypatch.setattr(mesh, "local_devices", lambda: [torch.device("cpu")] * 3)
    for over in ({"sharding_strategy": "none"}, {"mesh_shape": (1,)}):
        assert type(build_sr(Config(**{**cfg, **over}))) is SuperResolution, over
    diffusion = build_sr(Config(**{**cfg, "sr_model": "DiffusionSR_x4", "scale_factor": 4}))
    assert isinstance(diffusion, distributor.ShardedSR) and len(diffusion.members) == 3
    monkeypatch.setattr(mesh, "local_devices", lambda: [torch.device("cuda", i) for i in range(2)])
    assert type(build_sr(Config(**cfg))) is SuperResolution
    monkeypatch.setattr(mesh, "local_devices", lambda: [torch.device("cpu")] * 3)
    sr = build_sr(Config(**cfg, batch_size=2))
    sr.setup(16, 16)
    assert sr.plan.frames == 2 and [m.plan.frames for m in sr.members] == [1] * 3
    assert [p[0] for p in sr.dispatch(_frames(2, 16, 16))["parts"]] == sr.members[:2]
    sr.teardown()


def test_restorer_maps_sharding_and_mesh(monkeypatch, tmp_path):
    """With three local ``cpu`` entries the restore's SR is ``ShardedSR``
    over them (``mesh_shape`` (2,): over two), and its restore with
    ``--batch 3`` writes the bytes of the one-device restore
    (``sharding_strategy="none"``) with ``--batch 1``: each frame runs
    alone in both (the CPU's convolutions sum in another order at
    another batch size), and the YUV output reaches every member."""
    from framewright_tpu_torch.restorer import VideoRestorer, build_sr

    monkeypatch.setattr(mesh, "local_devices", lambda: [torch.device("cpu")] * 3)
    cfg = dict(sr_model="FW_fast6_x2", device_platform="cpu",
               checkpoint_enabled=False, validate_output=False)
    sr = build_sr(Config(**cfg))
    assert isinstance(sr, distributor.ShardedSR) and len(sr.members) == 3
    assert len(build_sr(Config(**cfg, mesh_shape=(2,))).members) == 2
    src = tmp_path / "clip.y4m"
    _clip(src, n=5, h=24, w=32)
    outs = {}
    for strategy, batch in (("auto", 3), ("none", 1)):
        r = VideoRestorer(Config(**cfg, sharding_strategy=strategy, batch_size=batch,
                                 project_dir=tmp_path / strategy))
        res = r.restore_video(src, output=tmp_path / f"{strategy}.y4m")
        assert res.errors == 0 and res.frames_out == 5 and res.batches == -(-5 // batch)
        assert isinstance(r.sr, distributor.ShardedSR) == (strategy == "auto")
        if strategy == "auto":
            assert all(m.config.output_color == "yuv420" for m in r.sr.members)
        outs[strategy] = (tmp_path / f"{strategy}.y4m").read_bytes()
    assert outs["auto"] == outs["none"]


def test_config_fields_as_jax():
    from framewright_tpu.config import Config as JConfig
    from framewright_tpu.errors import ConfigError as JConfigError
    from framewright_tpu_torch.errors import ConfigError

    names = ("mesh_shape", "sharding_strategy", "scene_chunk_frames", "chunk_overlap_frames",
             "multihost", "subtitle_region", "subtitle_ocr_engine", "subtitle_languages",
             "inverse_telecine", "crop_letterbox", "aspect_correction", "process_audio",
             "audio_denoise", "audio_sync_correction")
    assert {k: getattr(Config(), k) for k in names} == {k: getattr(JConfig(), k) for k in names}
    for bad in ({"sharding_strategy": "rows"}, {"mesh_shape": (2, 0)},
                {"subtitle_region": "left"}, {"subtitle_ocr_engine": "easyocr"}):
        with pytest.raises(ConfigError) as got:
            Config(**bad)
        with pytest.raises(JConfigError) as want:
            JConfig(**bad)
        assert str(got.value) == str(want.value)


# -- the process group -----------------------------------------------------------------


def test_distributed_spec_as_jax():
    env = {"FRAMEWRIGHT_COORDINATOR": "10.0.0.2:8476", "FRAMEWRIGHT_NUM_PROCESSES": "4",
           "FRAMEWRIGHT_PROCESS_ID": "1"}
    got, want = dcn.DistributedSpec.from_env(env), jdcn.DistributedSpec.from_env(env)
    assert (got.coordinator, got.num_processes, got.process_id, got.explicit) == \
        (want.coordinator, want.num_processes, want.process_id, want.explicit)
    assert got.init_method == "tcp://10.0.0.2:8476"
    assert not dcn.DistributedSpec.from_env({}).explicit
    for bad in ({"FRAMEWRIGHT_COORDINATOR": "no-port"}, {"FRAMEWRIGHT_NUM_PROCESSES": "4"},
                {"FRAMEWRIGHT_NUM_PROCESSES": "2", "FRAMEWRIGHT_PROCESS_ID": "2"}):
        with pytest.raises(ValueError) as g:
            dcn.DistributedSpec.from_env(bad)
        with pytest.raises(ValueError) as w:
            jdcn.DistributedSpec.from_env(bad)
        assert str(g.value) == str(w.value)
    assert dcn.ensure_distributed(environ={}) is False
    with pytest.raises(ValueError, match="needs the coordinator"):
        dcn.ensure_distributed(dcn.DistributedSpec(num_processes=2, process_id=0), environ={})


_RANK = """
import sys, torch, torch.distributed as dist
from framewright_tpu_torch.parallel import dcn
up = dcn.ensure_distributed(backend="gloo")
t = torch.tensor([float(dist.get_rank() + 1)])
dist.all_reduce(t)
dist.barrier()
print(up, dist.get_rank(), dist.get_world_size(), float(t))
dcn.shutdown_distributed()
"""


def test_gloo_group_of_two_cpu_processes():
    port = dcn.free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, FRAMEWRIGHT_COORDINATOR=f"127.0.0.1:{port}",
                   FRAMEWRIGHT_NUM_PROCESSES="2", FRAMEWRIGHT_PROCESS_ID=str(rank),
                   PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen([sys.executable, "-c", _RANK], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert sorted(o.split() for o, _ in outs) == [["True", "0", "2", "3.0"],
                                                     ["True", "1", "2", "3.0"]]


def test_group_of_one_in_process():
    assert dcn.ensure_distributed(force=True, backend="gloo", environ={}) is False
    try:
        assert torch.distributed.is_initialized() and torch.distributed.get_world_size() == 1
        assert dcn.ensure_distributed(environ={}) is False        # already up
    finally:
        dcn.shutdown_distributed()
    assert not torch.distributed.is_initialized()


# -- the farm ----------------------------------------------------------------------------


def _job(tmp_path, total=6, chunk=2):
    return multihost.RenderJob(job_id="j", source="src.y4m", output=str(tmp_path / "out.y4m"),
                               config={}, total_frames=total, chunk_frames=chunk)


def _writer(h=8, w=8):
    def process_chunk(chunk, part_path):
        with Y4MWriter(part_path, w, h, fps=24) as wr:
            for t in range(chunk.start, chunk.end):
                wr.write_frame(np.full((h, w, 3), 10 * t, np.uint8))
    return process_chunk


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def test_failed_chunk_stops_the_merge_and_is_named(tmp_path):
    """JAX calls a chunk with an ``ok: false`` result done and merges
    without it; the port raises naming the chunk, its worker and error."""
    job = _job(tmp_path)
    coord = multihost.SharedDirCoordinator(tmp_path / "farm")
    coord.submit(job)
    ok = _writer()

    def process_chunk(chunk, part_path):
        if chunk.index == 1:
            ok(chunk, part_path)              # a whole part, then a failure
            raise ValueError("decoder lost sync")
        ok(chunk, part_path)

    w = multihost.SharedDirWorker(tmp_path / "farm", "w1")
    with pytest.raises(ValueError):
        w.work_loop(coord.load_job(), process_chunk)
    w.work_loop(coord.load_job(), process_chunk)             # the rest of the chunks
    assert coord.chunk_status(3) == {0: "done", 1: "failed", 2: "done"}
    assert not coord.is_complete(3)
    for fn in (lambda: coord.merge(job), lambda: coord.check_failures(3)):
        with pytest.raises(FramewrightError, match="chunk 1 failed on worker w1: "
                                                   "ValueError: decoder lost sync"):
            fn()
    assert not (tmp_path / "farm" / "parts" / "chunk_1.y4m").exists()
    assert jmh.SharedDirCoordinator(tmp_path / "farm").is_complete(3)    # JAX's fault


def test_long_chunk_is_not_reassigned_while_its_worker_lives(tmp_path):
    """The heartbeat runs in a thread while a chunk runs: with the clock
    past the timeout mid-chunk, the chunk stays with its worker. The part
    is written under a temporary name and moved into place."""
    clock = _Clock()
    job = _job(tmp_path, total=2)
    coord = multihost.SharedDirCoordinator(tmp_path / "farm", heartbeat_timeout=60.0, clock=clock)
    coord.submit(job)
    w = multihost.SharedDirWorker(tmp_path / "farm", "slow", clock=clock, beat_s=0.01)
    seen = {}

    def process_chunk(chunk, part_path):
        seen["path"] = part_path
        clock.now += 600.0                                     # ten timeouts later
        w.beat_event.clear()
        seen["beat"] = w.beat_event.wait(timeout=30)
        seen["reassigned"] = coord.reassign_stale()
        seen["live"] = coord.live_workers()
        _writer()(chunk, part_path)

    assert w.work_loop(job, process_chunk) == 1
    assert seen["beat"] and seen["reassigned"] == 0 and seen["live"] == ["slow"]
    assert seen["path"].name != "chunk_0.y4m" and not seen["path"].exists()
    assert sorted(p.name for p in (tmp_path / "farm" / "parts").iterdir()) == ["chunk_0.y4m"]
    assert coord.is_complete(1)


class _Stop(BaseException):
    """The worker stops mid-chunk: nothing reported, no more beats."""


def test_stopped_workers_chunk_is_reassigned_and_the_merge_is_complete(tmp_path):
    clock = _Clock()
    job = _job(tmp_path)
    coord = multihost.SharedDirCoordinator(tmp_path / "farm", heartbeat_timeout=60.0, clock=clock)
    coord.submit(job)
    dead = multihost.SharedDirWorker(tmp_path / "farm", "dead", clock=clock)

    def stops(chunk, part_path):
        with Y4MWriter(part_path, 8, 8, fps=24) as wr:
            wr.write_frame(np.zeros((8, 8, 3), np.uint8))   # half a part
        raise _Stop

    with pytest.raises(_Stop):
        dead.work_loop(job, stops)
    assert coord.chunk_status(3)[0] == "assigned" and coord.reassign_stale() == 0
    clock.now += 61.0
    assert coord.reassign_stale() == 1
    live = multihost.SharedDirWorker(tmp_path / "farm", "live", clock=clock)
    assert live.work_loop(job, _writer()) == 3
    assert coord.is_complete(3)
    with Y4MReader(coord.merge(job)) as r:
        assert [int(f[0, 0, 0]) for f in r] == [0, 10, 20, 30, 40, 50]


def test_two_workers_split_the_chunks(tmp_path):
    job = _job(tmp_path, total=12)
    coord = multihost.SharedDirCoordinator(tmp_path / "farm")
    coord.submit(job)
    counts = {}

    def run(wid):
        counts[wid] = multihost.SharedDirWorker(tmp_path / "farm", wid).work_loop(job, _writer())

    threads = [threading.Thread(target=run, args=(f"w{i}",)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(counts.values()) == 6 and coord.is_complete(6)


def _smooth(n, h, w, seed):
    """A progressive clip (combing score ~0.05: no chunk reads as
    interlaced, so no chunk is deinterlaced at its boundary)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        ph = rng.random(3) * 6
        g = 127 + 100 * np.sin(x / 5 + y / 7 + ph[0] + t * 0.3)
        f = np.stack([g, g * 0.9 + 10, g * 0.8 + 20], -1)
        out.append(np.clip(f, 0, 255).astype(np.uint8))
    return np.stack(out)


def _clip(path, n=6, h=24, w=32):
    frames = _smooth(n, h, w, seed=9)
    with Y4MWriter(path, w, h, fps=24) as wr:
        for f in frames:
            wr.write_frame(f)
    return frames


def test_farm_verb_two_worker_processes_equal_the_in_process_restore(tmp_path, capsys):
    """``farm run`` with two ``farm work --device cpu`` processes on chunks
    of 2 frames: the merged output equals the restore of the whole clip
    (FW_fastvgg_x2 in bf16, batches of 2, checkpoint and gate off)."""
    from framewright_tpu_torch.restorer import VideoRestorer

    src = tmp_path / "clip.y4m"
    _clip(src)
    farm = tmp_path / "farm"
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    workers = [subprocess.Popen(
        [sys.executable, "-m", "framewright_tpu_torch.cli", "farm", "work", str(farm),
         "--worker-id", f"w{i}", "--device", "cpu"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in range(2)]
    try:
        rc = pcli.main(["farm", "run", str(src), str(farm), "-o", str(tmp_path / "out.y4m"),
                        "--model", "FW_fastvgg_x2", "--scale", "2", "--chunk-frames", "2",
                        "--device", "cpu"])
    finally:
        outs = [p.communicate(timeout=300) for p in workers]
    assert rc == 0, outs
    assert json.loads(capsys.readouterr().out) == {"output": str(tmp_path / "out.y4m")}
    done = [json.loads(o.strip().splitlines()[-1])["worker_chunks_done"] for o, _ in outs]
    assert sum(done) == 3, outs
    res = [json.loads((farm / "results" / f"chunk_{i}.json").read_text()) for i in range(3)]
    assert all(r["ok"] and r["frames"] == 2 and "peak_bytes" in r for r in res)
    straight = tmp_path / "straight.y4m"
    VideoRestorer(Config(sr_model="FW_fastvgg_x2", device_platform="cpu", batch_size=2,
                         checkpoint_enabled=False, validate_output=False,
                         project_dir=tmp_path / "p")).restore_video(src, output=straight)
    with Y4MReader(tmp_path / "out.y4m") as a, Y4MReader(straight) as b:
        fa, fb = list(a), list(b)
    assert len(fa) == len(fb) == 6 and all(np.array_equal(x, y) for x, y in zip(fa, fb))
    assert pcli.main(["farm", "status", str(farm)]) == 0
    status = json.loads(capsys.readouterr().out)
    assert status["complete"] is True and status["chunks"] == {"0": "done", "1": "done",
                                                                "2": "done"}


def test_farm_burst_is_refused(tmp_path, capsys):
    """``--burst gcp-tpu`` (JAX's TPU VM provider) is refused before any file
    is written: a TPU VM has no CUDA card for the port's workers (the other
    providers run: tests/test_torch_cloud.py)."""
    src = tmp_path / "clip.y4m"
    _clip(src, n=2)
    rc = pcli.main(["farm", "run", str(src), str(tmp_path / "farm"), "-o",
                    str(tmp_path / "o.y4m"), "--burst", "gcp-tpu"])
    err = capsys.readouterr().err
    assert rc == 1 and "--burst gcp-tpu" in err and "CUDA card" in err
    assert not (tmp_path / "farm" / "job.json").exists()
