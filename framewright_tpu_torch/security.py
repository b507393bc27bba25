"""Input security: path validation and sanitization (the port's copy of
``framewright_tpu/security.py``): ``PathValidator`` against traversal
outside allowed roots, ``sanitize_filename``, ``validate_url``, a
token-bucket ``RateLimiter`` and an in-memory ``SecurityLog``."""

from __future__ import annotations

import logging
import re
import threading
import time
from pathlib import Path
from typing import List, Optional

from framewright_tpu_torch.errors import InputError

logger = logging.getLogger(__name__)

_CTRL = re.compile(r"[\x00-\x1f\x7f]")
_SHELLISH = re.compile(r"[;&|`$<>]")


class PathValidator:
    """Reject traversal outside allowed roots and suspicious names."""

    def __init__(self, allowed_roots: Optional[List[Path]] = None):
        self.allowed_roots = [Path(p).resolve() for p in (allowed_roots or [])]

    def validate(self, path, must_exist: bool = False) -> Path:
        raw = str(path)
        if _CTRL.search(raw):
            raise InputError("path contains control characters")
        resolved = Path(raw).expanduser().resolve()
        if self.allowed_roots and not any(
                resolved == root or root in resolved.parents for root in self.allowed_roots):
            raise InputError(f"path {resolved} escapes allowed roots "
                             f"{[str(r) for r in self.allowed_roots]}")
        if must_exist and not resolved.exists():
            raise InputError(f"path does not exist: {resolved}")
        return resolved


def sanitize_filename(name: str, replacement: str = "_") -> str:
    """Make a safe basename from arbitrary input."""
    name = _CTRL.sub("", name)
    name = name.replace("/", replacement).replace("\\", replacement)
    name = _SHELLISH.sub(replacement, name)
    name = re.sub(r"\s+", replacement, name.strip(". "))
    return name[:200] or "unnamed"


def validate_url(url: str, allowed_schemes=("http", "https")) -> str:
    from urllib.parse import urlparse

    parsed = urlparse(url)
    if parsed.scheme not in allowed_schemes:
        raise InputError(f"URL scheme {parsed.scheme!r} not allowed")
    if not parsed.netloc:
        raise InputError("URL has no host")
    if _CTRL.search(url):
        raise InputError("URL contains control characters")
    return url


class RateLimiter:
    """Token bucket: ``burst`` tokens, refilled at ``rate_per_s``."""

    def __init__(self, rate_per_s: float = 10.0, burst: int = 20):
        self.rate = rate_per_s
        self.burst = burst
        self._tokens = float(burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def allow(self, cost: float = 1.0) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= cost:
                self._tokens -= cost
                return True
            return False


class SecurityLog:
    """Append-only in-memory security event log (the last ``limit``)."""

    def __init__(self, limit: int = 1000):
        self.events: List[dict] = []
        self.limit = limit
        self._lock = threading.Lock()

    def record(self, kind: str, detail: str) -> None:
        with self._lock:
            self.events.append({"ts": time.time(), "kind": kind, "detail": detail})
            if len(self.events) > self.limit:
                self.events = self.events[-self.limit:]
        logger.warning("security event [%s]: %s", kind, detail)
