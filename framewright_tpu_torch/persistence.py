"""Job persistence: the SQLite job and frame-range store, the port's copy
of ``framewright_tpu/persistence.py`` (the same schema, so either package
reads the other's database): jobs with their config, state, progress and
stage; frame ranges done per stage; the crashed-job query."""

from __future__ import annotations

import json
import logging
import sqlite3
import threading
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    job_id TEXT PRIMARY KEY,
    source TEXT NOT NULL,
    output TEXT,
    config_json TEXT,
    config_hash TEXT,
    state TEXT NOT NULL DEFAULT 'pending',
    total_frames INTEGER DEFAULT 0,
    frames_done INTEGER DEFAULT 0,
    stage TEXT DEFAULT '',
    error TEXT,
    created_at REAL,
    updated_at REAL
);
CREATE TABLE IF NOT EXISTS frame_ranges (
    job_id TEXT NOT NULL,
    stage TEXT NOT NULL,
    start INTEGER NOT NULL,
    end INTEGER NOT NULL,
    state TEXT NOT NULL DEFAULT 'done',
    updated_at REAL,
    PRIMARY KEY (job_id, stage, start)
);
CREATE INDEX IF NOT EXISTS idx_jobs_state ON jobs(state);
"""

JOB_STATES = ("pending", "running", "paused", "completed", "failed", "cancelled")


@dataclass
class JobRecord:
    job_id: str
    source: str
    output: str = ""
    state: str = "pending"
    total_frames: int = 0
    frames_done: int = 0
    stage: str = ""
    config: Dict = field(default_factory=dict)
    config_hash: str = ""
    error: str = ""
    created_at: float = 0.0
    updated_at: float = 0.0


class JobStore:
    """Thread-safe SQLite store (WAL mode)."""

    def __init__(self, db_path: Path):
        self.db_path = Path(db_path)
        self.db_path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(self.db_path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row   # name-based rows: the
        # stage column sits at a different position in fresh vs
        # migrated databases
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.executescript(_SCHEMA)
        # the stage column (live per-stage progress): migrate older databases
        cols = [r[1] for r in self._conn.execute("PRAGMA table_info(jobs)")]
        if "stage" not in cols:
            self._conn.execute("ALTER TABLE jobs ADD COLUMN stage TEXT "
                               "DEFAULT ''")
        self._conn.commit()

    def close(self) -> None:
        self._conn.close()

    # ------------------------------------------------------------------
    def create_job(self, source: str, output: str = "", config: Optional[Dict] = None,
                   config_hash: str = "", total_frames: int = 0,
                   job_id: Optional[str] = None) -> str:
        jid = job_id or uuid.uuid4().hex[:12]
        now = time.time()
        with self._lock:
            self._conn.execute(
                "INSERT INTO jobs (job_id, source, output, config_json, config_hash,"
                " state, total_frames, created_at, updated_at)"
                " VALUES (?,?,?,?,?,?,?,?,?)",
                (jid, source, output, json.dumps(config or {}), config_hash,
                 "pending", total_frames, now, now),
            )
            self._conn.commit()
        return jid

    def set_state(self, job_id: str, state: str, error: str = "") -> None:
        if state not in JOB_STATES:
            raise ValueError(f"bad state {state}")
        with self._lock:
            self._conn.execute(
                "UPDATE jobs SET state=?, error=?, updated_at=? WHERE job_id=?",
                (state, error, time.time(), job_id))
            self._conn.commit()

    def update_progress(self, job_id: str, frames_done: int,
                        stage: str = None, total_frames: int = None) -> None:
        sets = ["frames_done=?", "updated_at=?"]
        args = [frames_done, time.time()]
        if stage is not None:
            sets.append("stage=?")
            args.append(stage)
        if total_frames is not None:
            sets.append("total_frames=?")
            args.append(total_frames)
        args.append(job_id)
        with self._lock:
            self._conn.execute(
                f"UPDATE jobs SET {', '.join(sets)} WHERE job_id=?",
                tuple(args))
            self._conn.commit()

    def record_range(self, job_id: str, stage: str, start: int, end: int) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO frame_ranges (job_id, stage, start, end,"
                " state, updated_at) VALUES (?,?,?,?,'done',?)",
                (job_id, stage, start, end, time.time()))
            self._conn.commit()

    def completed_ranges(self, job_id: str, stage: str) -> List[tuple]:
        with self._lock:
            cur = self._conn.execute(
                "SELECT start, end FROM frame_ranges WHERE job_id=? AND stage=?"
                " ORDER BY start", (job_id, stage))
            return [tuple(r) for r in cur.fetchall()]

    def get_job(self, job_id: str) -> Optional[JobRecord]:
        with self._lock:
            cur = self._conn.execute("SELECT * FROM jobs WHERE job_id=?", (job_id,))
            row = cur.fetchone()
            return self._to_record(row) if row else None

    def list_jobs(self, state: Optional[str] = None) -> List[JobRecord]:
        with self._lock:
            if state:
                cur = self._conn.execute(
                    "SELECT * FROM jobs WHERE state=? ORDER BY created_at", (state,))
            else:
                cur = self._conn.execute("SELECT * FROM jobs ORDER BY created_at")
            return [self._to_record(r) for r in cur.fetchall()]

    def resumable_jobs(self) -> List[JobRecord]:
        """Jobs interrupted mid-run (the crash-recovery query)."""
        with self._lock:
            cur = self._conn.execute(
                "SELECT * FROM jobs WHERE state IN ('running','paused')"
                " ORDER BY created_at")
            return [self._to_record(r) for r in cur.fetchall()]

    def delete_job(self, job_id: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM jobs WHERE job_id=?", (job_id,))
            self._conn.execute("DELETE FROM frame_ranges WHERE job_id=?", (job_id,))
            self._conn.commit()

    @staticmethod
    def _to_record(row) -> JobRecord:
        keys = row.keys()
        return JobRecord(
            job_id=row["job_id"], source=row["source"],
            output=row["output"] or "",
            config=json.loads(row["config_json"] or "{}"),
            config_hash=row["config_hash"] or "",
            state=row["state"], total_frames=row["total_frames"],
            frames_done=row["frames_done"],
            stage=(row["stage"] or "") if "stage" in keys else "",
            error=row["error"] or "", created_at=row["created_at"],
            updated_at=row["updated_at"],
        )
