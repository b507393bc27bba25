"""The render farm: chunk mailboxes over a shared directory, the port of
``framewright_tpu/parallel/multihost.py``.

Layout under work_dir/:
    job.json                     job spec (source, config, chunks)
    assignments/chunk_<i>.json   chunk -> worker claims (atomic create)
    results/chunk_<i>.json       completion records (``ok`` and the error)
    heartbeats/<worker>.json     liveness (``ts``: the worker's clock)
    parts/chunk_<i>.y4m          chunk outputs, concatenated at the end

A worker restores each claimed chunk with the port's ``VideoRestorer``
(``make_chunk_processor``). Three JAX faults are not copied:

- JAX calls a chunk done when its result file exists, and a worker
  writes ``ok: false`` there before it re-raises, so JAX's coordinator
  merges without that chunk (or with a partial part). Here a chunk is done
  only when its result is ``ok``; ``run_coordinator`` and ``merge`` raise
  ``FramewrightError`` naming a failed chunk, its worker and its error.
- JAX's merge decodes each part to RGB and encodes it again, which moves
  4:2:0 chroma by a few LSB; here the frames' bytes are copied, so the
  merged output equals a restore of the whole clip.
- JAX's worker beats only between chunks, so a chunk longer than the
  heartbeat timeout is taken from a live worker and two workers write
  one part. Here the worker beats from a thread while a chunk runs, and
  writes each part under a temporary name moved into place with
  ``os.replace``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import socket
import tempfile
import threading
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

from framewright_tpu_torch.errors import FramewrightError
from framewright_tpu_torch.parallel.distributor import ChunkState, FrameChunk, make_scene_chunks

logger = logging.getLogger(__name__)

Clock = Callable[[], float]


@dataclass
class RenderJob:
    job_id: str
    source: str
    output: str
    config: Dict
    total_frames: int
    chunk_frames: int = 100
    scene_boundaries: List[int] = field(default_factory=list)

    def chunks(self) -> List[FrameChunk]:
        return make_scene_chunks(self.total_frames, self.chunk_frames, self.scene_boundaries)


def _read_json(path: Path) -> Optional[dict]:
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None


def _write_json(path: Path, obj: dict) -> None:
    """Written whole or not at all (a temporary file, then ``os.replace``)."""
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, path)


class SharedDirCoordinator:
    """Coordinator side: publish the job, watch results, reassign the
    chunks of workers whose heartbeat went stale, merge the parts."""

    def __init__(self, work_dir: Path, heartbeat_timeout: float = 60.0,
                 clock: Clock = time.time):
        self.work_dir = Path(work_dir)
        self.heartbeat_timeout = heartbeat_timeout
        self.clock = clock
        for sub in ("assignments", "results", "heartbeats", "parts"):
            (self.work_dir / sub).mkdir(parents=True, exist_ok=True)

    def submit(self, job: RenderJob) -> None:
        """Publish the job, whole or not at all: a worker may read it at
        any time."""
        _write_json(self.work_dir / "job.json", asdict(job))

    def load_job(self) -> RenderJob:
        p = self.work_dir / "job.json"
        if not p.exists():
            raise FramewrightError(f"no farm job published in {self.work_dir} (missing job.json)")
        return RenderJob(**json.loads(p.read_text()))

    def result(self, index: int) -> Optional[dict]:
        return _read_json(self.work_dir / "results" / f"chunk_{index}.json")

    def chunk_status(self, n_chunks: int) -> Dict[int, str]:
        """done (an ``ok`` result), failed (a result that is not ``ok``),
        assigned or pending."""
        status = {}
        for i in range(n_chunks):
            res = self.result(i)
            if res is not None:
                status[i] = "done" if res.get("ok") else "failed"
            elif (self.work_dir / "assignments" / f"chunk_{i}.json").exists():
                status[i] = "assigned"
            else:
                status[i] = "pending"
        return status

    def live_workers(self) -> List[str]:
        now = self.clock()
        out = []
        for p in (self.work_dir / "heartbeats").glob("*.json"):
            beat = _read_json(p)
            ts = beat.get("ts") if beat else None
            if ts is None:
                ts = p.stat().st_mtime
            if now - ts < self.heartbeat_timeout:
                out.append(p.stem)
        return out

    def reassign_stale(self) -> int:
        """Delete the claims of chunks without a result whose worker's
        heartbeat went stale."""
        live = set(self.live_workers())
        n = 0
        for p in (self.work_dir / "assignments").glob("chunk_*.json"):
            idx = p.stem.split("_")[1]
            if (self.work_dir / "results" / f"chunk_{idx}.json").exists():
                continue
            claim = _read_json(p)
            if claim is not None and claim.get("worker") not in live:
                p.unlink(missing_ok=True)
                n += 1
        if n:
            logger.info("reassigned %d stale chunks", n)
        return n

    def is_complete(self, n_chunks: int) -> bool:
        return all(v == "done" for v in self.chunk_status(n_chunks).values())

    def check_failures(self, n_chunks: int) -> None:
        """``FramewrightError`` naming the first chunk whose result is not ``ok``."""
        for i, state in self.chunk_status(n_chunks).items():
            if state == "failed":
                res = self.result(i) or {}
                raise FramewrightError(
                    f"farm chunk {i} failed on worker {res.get('worker', '?')}: "
                    f"{res.get('error', 'no error recorded')}",
                    details={"chunk": i, "result": res})

    def merge(self, job: RenderJob) -> Path:
        """Concatenate the chunk outputs in order, frame bytes copied as
        they are (``io.y4m.concat_y4m``; JAX decodes each part to RGB and
        encodes it again, which moves 4:2:0 chroma); every chunk's result
        must be ``ok``."""
        from framewright_tpu_torch.io.y4m import concat_y4m

        chunks = job.chunks()
        self.check_failures(len(chunks))
        parts = []
        for c in chunks:
            part = self.work_dir / "parts" / f"chunk_{c.index}.y4m"
            res = self.result(c.index)
            if res is None or not res.get("ok") or not part.exists():
                raise FramewrightError(f"missing part for chunk {c.index}")
            parts.append(part)
        out = Path(job.output)
        concat_y4m(parts, out)
        return out


class SharedDirWorker:
    """Worker side: claim chunks atomically, process, report; the
    heartbeat runs in a thread while a chunk is processed."""

    def __init__(self, work_dir: Path, worker_id: Optional[str] = None,
                 clock: Clock = time.time, beat_s: float = 5.0):
        self.work_dir = Path(work_dir)
        self.worker_id = worker_id or f"{socket.gethostname()}-{os.getpid()}"
        self.clock = clock
        self.beat_s = beat_s
        self.beat_event = threading.Event()      # set by every heartbeat

    def heartbeat(self) -> None:
        _write_json(self.work_dir / "heartbeats" / f"{self.worker_id}.json",
                    {"worker": self.worker_id, "ts": self.clock()})
        self.beat_event.set()

    @contextlib.contextmanager
    def beating(self) -> Iterator[None]:
        """A heartbeat every ``beat_s`` seconds while the block runs."""
        stop = threading.Event()

        def loop():
            while not stop.wait(self.beat_s):
                self.heartbeat()

        t = threading.Thread(target=loop, name=f"heartbeat-{self.worker_id}", daemon=True)
        t.start()
        try:
            yield
        finally:
            stop.set()
            t.join()

    def claim_chunk(self, chunks: List[FrameChunk]) -> Optional[FrameChunk]:
        """Atomic claim via O_CREAT|O_EXCL: the first writer wins."""
        for c in chunks:
            if (self.work_dir / "results" / f"chunk_{c.index}.json").exists():
                continue
            path = self.work_dir / "assignments" / f"chunk_{c.index}.json"
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                continue
            with os.fdopen(fd, "w") as f:
                json.dump({"worker": self.worker_id, "ts": self.clock(), "chunk": c.index}, f)
            c.state = ChunkState.ASSIGNED
            c.worker = self.worker_id
            return c
        return None

    def report(self, chunk: FrameChunk, ok: bool, **info) -> None:
        _write_json(self.work_dir / "results" / f"chunk_{chunk.index}.json",
                    {"chunk": chunk.index, "worker": self.worker_id, "ok": ok,
                     "ts": self.clock(), **info})

    def part_path(self, chunk: FrameChunk) -> Path:
        return self.work_dir / "parts" / f"chunk_{chunk.index}.y4m"

    def work_loop(self, job: RenderJob,
                  process_chunk: Callable[[FrameChunk, Path], Optional[dict]],
                  poll_s: float = 0.5, max_chunks: Optional[int] = None) -> int:
        """Claim, process, report until no chunk is left. ``process_chunk``
        writes the chunk's frames to the path it is given (moved into
        place after it returns) and may return a dict for the result."""
        chunks = job.chunks()
        done = 0
        while max_chunks is None or done < max_chunks:
            self.heartbeat()
            c = self.claim_chunk(chunks)
            if c is None:
                results = list((self.work_dir / "results").glob("chunk_*.json"))
                if len(results) >= len(chunks):
                    break
                time.sleep(poll_s)
                continue
            part = self.part_path(c)
            tmp = part.with_name(f"chunk_{c.index}.{self.worker_id}.tmp.y4m")
            try:
                with self.beating():
                    info = process_chunk(c, tmp)
                os.replace(tmp, part)
                self.report(c, ok=True, frames=c.n_frames, **(info or {}))
                done += 1
            except Exception as exc:  # noqa: BLE001 - recorded, then raised
                logger.exception("chunk %d failed", c.index)
                tmp.unlink(missing_ok=True)
                self.report(c, ok=False, error=f"{type(exc).__name__}: {exc}")
                raise
        return done


def make_chunk_processor(job: RenderJob, device: Optional[str] = None):
    """``process_chunk(chunk, part_path)`` for farm workers: the chunk's
    frames copied byte for byte from the (shared) Y4M source into a
    temporary Y4M (JAX decodes and encodes them again), restored
    with the job's config (checkpoint and quality gate off unless the job
    sets them; ``device`` overrides ``device_platform``), written to the
    part. Returns the restore's ``errors``, its peak card memory above what
    was allocated before it, the SR plan's estimate and the SR's device."""
    from framewright_tpu_torch.config import Config
    from framewright_tpu_torch.io.y4m import concat_y4m

    def process_chunk(chunk: FrameChunk, part_path: Path) -> dict:
        import torch

        from framewright_tpu_torch.restorer import VideoRestorer

        part_path.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="fw_chunk_") as td:
            slice_path = Path(td) / f"slice_{chunk.index}.y4m"
            concat_y4m([job.source], slice_path, start=chunk.start, end=chunk.end)
            cfg_dict = dict(job.config)
            cfg_dict.setdefault("checkpoint_enabled", False)
            cfg_dict.setdefault("validate_output", False)
            if device is not None:
                cfg_dict["device_platform"] = device
            cfg_dict["project_dir"] = str(Path(td) / "proj")
            cuda = torch.cuda.is_available() and cfg_dict.get("device_platform") != "cpu"
            base = 0
            if cuda:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            restorer = VideoRestorer(Config(**cfg_dict))
            result = restorer.restore_video(slice_path, output=part_path)
            plan = getattr(restorer.sr, "plan", None)
            return {"errors": result.errors,
                    "peak_bytes": torch.cuda.max_memory_allocated() - base if cuda else 0,
                    "plan_bytes": plan.est_bytes if plan is not None else 0,
                    "device": str(getattr(restorer.sr, "device", None))}

    return process_chunk


def run_worker(work_dir: Path, worker_id: Optional[str] = None, poll_s: float = 0.5,
               wait_job_s: float = 30.0, device: Optional[str] = None) -> int:
    """A farm worker process: wait for job.json, then claim and restore
    chunks until the job is drained."""
    coord = SharedDirCoordinator(work_dir)
    t0 = time.time()
    while not (Path(work_dir) / "job.json").exists():
        if time.time() - t0 > wait_job_s:
            raise FramewrightError(f"no job.json in {work_dir}")
        time.sleep(poll_s)
    job = coord.load_job()
    worker = SharedDirWorker(work_dir, worker_id)
    return worker.work_loop(job, make_chunk_processor(job, device), poll_s=poll_s)


def run_coordinator(work_dir: Path, job: RenderJob, timeout: float = 86400.0,
                    poll_s: float = 1.0,
                    progress: Optional[Callable[[Dict[int, str]], None]] = None,
                    heartbeat_timeout: float = 60.0) -> Path:
    """Publish the job, watch and reassign until every chunk is done,
    merge. A failed chunk raises ``FramewrightError`` naming it."""
    coord = SharedDirCoordinator(work_dir, heartbeat_timeout)
    coord.submit(job)
    n = len(job.chunks())
    t0 = time.time()
    while True:
        coord.check_failures(n)
        if coord.is_complete(n):
            break
        coord.reassign_stale()
        if progress is not None:
            progress(coord.chunk_status(n))
        if time.time() - t0 > timeout:
            raise FramewrightError(f"farm job timed out with {coord.chunk_status(n)}")
        time.sleep(poll_s)
    return coord.merge(job)
