"""Host-side frame rings: the port's own copy of
``framewright_tpu.io.ring``.

``PrefetchRing`` decodes frames on a producer thread and packs them into
fixed-size batches; ``WriterDrain`` writes finished frames on a consumer
thread, so the device loop never waits on media I/O.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np


@dataclass
class FrameBatch:
    """A fixed-shape batch of frames. ``valid`` <= batch size; frames at
    index >= valid are padding (repeats of the last real frame so model
    statistics stay sane)."""

    index: int                 # batch sequence number
    frames: np.ndarray         # (B, H, W, 3) uint8
    valid: int
    start_frame: int           # global index of frames[0]

    @property
    def batch_size(self) -> int:
        return self.frames.shape[0]


class PrefetchRing:
    """Producer thread that turns a frame iterator into FrameBatches.

    depth bounds host memory: depth * batch * H * W * 3 bytes.
    """

    def __init__(
        self,
        reader: Iterator[np.ndarray],
        batch_size: int,
        depth: int = 4,
        start_frame: int = 0,
        skip_frames: int = 0,
    ):
        self.batch_size = batch_size
        self._q: "queue.Queue[Optional[FrameBatch]]" = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._start_frame = start_frame
        self._skip = skip_frames
        self._reader = reader
        self._thread = threading.Thread(target=self._produce, daemon=True, name="fw-prefetch")
        self._thread.start()

    def _produce(self) -> None:
        try:
            it = iter(self._reader)
            for _ in range(self._skip):
                if next(it, None) is None:
                    break
            buf: list[np.ndarray] = []
            batch_idx = 0
            frame_idx = self._start_frame
            for frame in it:
                if self._stop.is_set():
                    return
                buf.append(frame)
                if len(buf) == self.batch_size:
                    self._emit(batch_idx, buf, frame_idx)
                    frame_idx += len(buf)
                    batch_idx += 1
                    buf = []
            if buf:
                self._emit(batch_idx, buf, frame_idx, pad=True)
            self._q.put(None)
        except BaseException as exc:  # noqa: BLE001 - surfaced to consumer
            self._error = exc
            try:
                self._q.put(None, timeout=1)
            except queue.Full:
                pass

    def _emit(self, idx: int, frames: list, start: int, pad: bool = False) -> None:
        valid = len(frames)
        if pad and valid < self.batch_size:
            frames = frames + [frames[-1]] * (self.batch_size - valid)
        batch = np.stack(frames, axis=0)
        while not self._stop.is_set():
            try:
                self._q.put(FrameBatch(idx, batch, valid, start), timeout=0.2)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[FrameBatch]:
        while True:
            item = self._q.get()
            if item is None:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


class WriterDrain:
    """Consumer thread that writes processed frames without blocking the
    device loop. ``submit`` enqueues (frames, valid); close() flushes."""

    def __init__(self, write_frame: Callable[[np.ndarray], None], depth: int = 4):
        self._write = write_frame
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._drain, daemon=True, name="fw-writer")
        self._thread.start()
        self.frames_written = 0

    def _drain(self) -> None:
        try:
            while True:
                item = self._q.get()
                if item is None:
                    return
                frames, valid = item
                for i in range(valid):
                    self._write(frames[i])
                    self.frames_written += 1
        except BaseException as exc:  # noqa: BLE001
            self._error = exc
            # unblock producer
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break

    def submit(self, frames: np.ndarray, valid: int) -> None:
        if self._error is not None:
            raise self._error
        self._q.put((frames, valid))

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        if self._error is not None:
            raise self._error
