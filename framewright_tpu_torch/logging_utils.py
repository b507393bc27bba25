"""Structured logging (the port of ``framewright_tpu.logging_utils``):
JSON or text formatters on the package's root logger
``framewright_tpu_torch``, per-module levels, an optional log file, and
an append-only JSONL metrics stream. The standard library only."""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

_ROOT = "framewright_tpu_torch"


class JsonFormatter(logging.Formatter):
    """One JSON object a record: ts, level, logger, msg (and exc, and a
    record's ``extra_fields``), JAX's keys."""

    def format(self, record: logging.LogRecord) -> str:
        payload: Dict[str, Any] = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "extra_fields", None)
        if extra:
            payload.update(extra)
        return json.dumps(payload)


class _StderrHandler(logging.StreamHandler):
    """Writes to the ``sys.stderr`` of the moment (a test's capture, a
    redirect made after the set-up)."""

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, _value) -> None:
        pass


def setup_logging(level: int = logging.INFO, json_format: bool = False,
                  log_file: Optional[Path] = None,
                  module_levels: Optional[Dict[str, int]] = None) -> logging.Logger:
    """The package's root logger at ``level``, with one handler on stderr
    (and one on ``log_file``), its earlier handlers removed."""
    root = logging.getLogger(_ROOT)
    root.setLevel(level)
    root.handlers.clear()
    fmt: logging.Formatter = (JsonFormatter() if json_format else logging.Formatter(
        "%(asctime)s %(levelname)-7s %(name)s: %(message)s", "%H:%M:%S"))
    sh = _StderrHandler()
    sh.setFormatter(fmt)
    root.addHandler(sh)
    if log_file is not None:
        log_file = Path(log_file)
        log_file.parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    for mod, lvl in (module_levels or {}).items():
        logging.getLogger(mod).setLevel(lvl)
    return root


class MetricsLog:
    """Append-only JSONL metrics stream (stage timings, throughput, peak
    card memory): a record a ``log`` call, in memory and in ``path``."""

    def __init__(self, path: Optional[Path] = None):
        self.path = Path(path) if path else None
        self.records: list[Dict[str, Any]] = []
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, metric: str, value: float, **tags: Any) -> None:
        rec = {"ts": round(time.time(), 3), "metric": metric, "value": value, **tags}
        self.records.append(rec)
        if self.path:
            with self.path.open("a") as f:
                f.write(json.dumps(rec) + "\n")

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per metric: count, sum, min, max, mean."""
        out: Dict[str, Dict[str, float]] = {}
        for rec in self.records:
            s = out.setdefault(rec["metric"], {"count": 0, "sum": 0.0, "min": float("inf"),
                                               "max": float("-inf")})
            v = float(rec["value"])
            s["count"] += 1
            s["sum"] += v
            s["min"] = min(s["min"], v)
            s["max"] = max(s["max"], v)
        for s in out.values():
            s["mean"] = s["sum"] / max(s["count"], 1)
        return out
