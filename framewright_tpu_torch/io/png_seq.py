"""Frame directories (PNG sequences): the port's copy of
``framewright_tpu.io.png_seq``.

Layout ``frame_%06d.png`` from 1; a reader lists ``frame_<n>`` files of
the same suffixes as the JAX one, in numeric order, and decodes them
through Pillow (``convert("RGB")``); the writer saves with Pillow at
``compress_level=1``, so its files are the JAX writer's bytes. Pillow is
imported when a frame is read or written: without it those raise
``DependencyError``. The port's writer saves each file under a temporary
name and renames it, so a frame on disk is always whole and a resume can
count them (``whole_frames``).
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from framewright_tpu_torch.errors import DependencyError, InputError

_FRAME_RE = re.compile(r"frame_(\d+)\.(png|jpg|jpeg|bmp|tiff?)$", re.IGNORECASE)


def _pil_image():
    try:
        from PIL import Image
    except ImportError as exc:
        raise DependencyError("Pillow is not installed: PNG frame directories need it "
                              "(use .y4m, or install Pillow)") from exc
    return Image


def pillow_available() -> bool:
    try:
        _pil_image()
    except DependencyError:
        return False
    return True


def list_frames(directory: Path) -> List[Path]:
    directory = Path(directory)
    if not directory.is_dir():
        raise InputError(f"Frame directory not found: {directory}")
    frames = [p for p in directory.iterdir() if _FRAME_RE.search(p.name)]
    frames.sort(key=lambda p: int(_FRAME_RE.search(p.name).group(1)))  # type: ignore[union-attr]
    return frames


def whole_frames(directory: Path) -> int:
    """How many frames ``frame_000001.png`` on are on disk without a gap
    (what a ``FrameDirWriter`` wrote); 0 when the directory is missing."""
    directory = Path(directory)
    n = 0
    while (directory / f"frame_{n + 1:06d}.png").is_file():
        n += 1
    return n


def load_frame(path: Path) -> np.ndarray:
    with _pil_image().open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def save_frame(path: Path, rgb: np.ndarray, compress_level: int = 1) -> None:
    """Save ``rgb`` as a PNG at ``path``: written to a temporary name in
    the same directory, then renamed."""
    image = _pil_image()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".part")
    image.fromarray(np.ascontiguousarray(rgb), "RGB").save(tmp, format="PNG",
                                                           compress_level=compress_level)
    os.replace(tmp, path)


class FrameDirReader:
    """Reads a frame directory as a video source."""

    def __init__(self, directory: Path, fps: float = 25.0):
        self.directory = Path(directory)
        self.paths = list_frames(self.directory)
        if not self.paths:
            raise InputError(f"No frames in {directory}")
        self.fps = fps
        first = load_frame(self.paths[0])
        self.height, self.width = first.shape[:2]
        self._first_cache: Optional[np.ndarray] = first
        self._idx = 0

    def __len__(self) -> int:
        return len(self.paths)

    def count_frames(self) -> int:
        return len(self.paths)

    def read_frame(self) -> Optional[np.ndarray]:
        if self._idx >= len(self.paths):
            return None
        if self._idx == 0 and self._first_cache is not None:
            frame, self._first_cache = self._first_cache, None
        else:
            frame = load_frame(self.paths[self._idx])
        self._idx += 1
        return frame

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            f = self.read_frame()
            if f is None:
                return
            yield f

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FrameDirWriter:
    """Writes frames as frame_%06d.png, numbered from ``start_index`` (1:
    the JAX layout; a resume continues after the frames it keeps)."""

    def __init__(self, directory: Path, fps: float = 25.0, width: int = 0,
                 height: int = 0, compress_level: int = 1, start_index: int = 1):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.fps = fps
        self.compress_level = compress_level
        self._next = start_index
        self.frames_written = 0

    def write_frame(self, rgb: np.ndarray) -> Path:
        path = self.directory / f"frame_{self._next:06d}.png"
        save_frame(path, rgb, self.compress_level)
        self._next += 1
        self.frames_written += 1
        return path

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
