"""Frame and model caches (the port of ``framewright_tpu.cache``): a
size-bounded cache with LRU, LFU or FIFO eviction and an optional time
to live, a frame cache keyed by (stage, the frame's dHash, its shape),
and a loaded-model cache with pinning."""

from __future__ import annotations

import sys
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional

import numpy as np


class LRUCache:
    """Thread-safe cache bounded by ``max_bytes`` (an array's ``nbytes``,
    else ``sys.getsizeof``), evicting by ``policy``: lru, lfu or fifo;
    an entry older than ``ttl_s`` (when set) is a miss."""

    def __init__(self, max_bytes: int = 256 * 2**20, policy: str = "lru",
                 ttl_s: float = 0.0):
        if policy not in ("lru", "lfu", "fifo"):
            raise ValueError(f"policy must be lru|lfu|fifo, got {policy!r}")
        self.max_bytes = max_bytes
        self.policy = policy
        self.ttl_s = ttl_s
        self._lock = threading.RLock()
        self._data: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._meta: Dict[Hashable, Dict] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _size_of(v: Any) -> int:
        if isinstance(v, np.ndarray):
            return v.nbytes
        try:
            return sys.getsizeof(v)
        except TypeError:
            return 1024

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            if key not in self._data:
                self.misses += 1
                return None
            meta = self._meta[key]
            if self.ttl_s and time.time() - meta["t"] > self.ttl_s:
                self._evict_key(key)
                self.misses += 1
                return None
            meta["hits"] += 1
            if self.policy == "lru":
                self._data.move_to_end(key)
            self.hits += 1
            return self._data[key]

    def put(self, key: Hashable, value: Any) -> None:
        """Store ``value``; evicts until it fits, and stores nothing
        larger than the whole budget."""
        size = self._size_of(value)
        with self._lock:
            if key in self._data:
                self._evict_key(key)
            while self._bytes + size > self.max_bytes and self._data:
                self._evict_one()
            if size > self.max_bytes:
                return
            self._data[key] = value
            self._meta[key] = {"t": time.time(), "hits": 0, "size": size}
            self._bytes += size

    def _evict_one(self) -> None:
        if self.policy == "lfu":
            key = min(self._meta, key=lambda k: self._meta[k]["hits"])
        else:        # lru: the least recent is first; fifo: the oldest is first
            key = next(iter(self._data))
        self._evict_key(key)

    def _evict_key(self, key: Hashable) -> None:
        self._bytes -= self._meta[key]["size"]
        del self._data[key]
        del self._meta[key]

    def __len__(self) -> int:
        return len(self._data)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._meta.clear()
            self._bytes = 0


class FrameCache(LRUCache):
    """Results of a stage keyed by the frame's content: a multi-pass
    pipeline reuses them."""

    @staticmethod
    def frame_key(stage: str, frame: np.ndarray) -> Hashable:
        """(stage, the 8x8 dHash's bits as bytes, shape): JAX's key for the
        same frame."""
        from framewright_tpu_torch.ops.dhash import dhash_batch

        bits = dhash_batch(frame[None], hash_size=8)[0]
        return (stage, bits.tobytes(), frame.shape)

    def get_or_compute(self, stage: str, frame: np.ndarray,
                       fn: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
        key = self.frame_key(stage, frame)
        hit = self.get(key)
        if hit is not None:
            return hit
        out = fn(frame)
        self.put(key, out)
        return out


class ModelCache:
    """Loaded models by name, at most ``max_models``: the least recent
    one that is not pinned is evicted first."""

    def __init__(self, max_models: int = 4):
        self.max_models = max_models
        self._lock = threading.RLock()
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._pinned: set = set()

    def get(self, name: str, loader: Optional[Callable[[], Any]] = None) -> Any:
        with self._lock:
            if name in self._models:
                self._models.move_to_end(name)
                return self._models[name]
            if loader is None:
                return None
            value = loader()
            while len(self._models) >= self.max_models:
                victim = next((k for k in self._models if k not in self._pinned), None)
                if victim is None:
                    break
                del self._models[victim]
            self._models[name] = value
            return value

    def pin(self, name: str) -> None:
        with self._lock:
            self._pinned.add(name)

    def unpin(self, name: str) -> None:
        with self._lock:
            self._pinned.discard(name)

    def evict(self, name: str) -> None:
        with self._lock:
            self._models.pop(name, None)

    def __contains__(self, name: str) -> bool:
        return name in self._models

    def __len__(self) -> int:
        return len(self._models)
