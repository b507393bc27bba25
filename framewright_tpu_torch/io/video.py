"""One API over Y4M, PNG frame directories and ffmpeg containers: the
port's copy of ``framewright_tpu.io.video``.

Readers yield RGB uint8 (H, W, 3) frames through ``read_frame()`` or
iteration and have ``width``, ``height``, ``fps`` and ``count_frames()``;
writers take ``write_frame(rgb)`` and are closed. The format follows the
suffix: ``.y4m``, a directory (or a path without a suffix, for a
writer), else ffmpeg (mp4, mkv, ...; ``DependencyError`` without it).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

from framewright_tpu_torch.errors import InputError
from framewright_tpu_torch.io import ffmpeg as _ff
from framewright_tpu_torch.io.png_seq import (
    FrameDirReader,
    FrameDirWriter,
    list_frames,
    load_frame,
)
from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter


@dataclass
class VideoMeta:
    width: int
    height: int
    fps: float                    # of a Y4M file its header's exact Fraction
    nb_frames: int
    has_audio: bool = False
    container: str = ""


def probe(path: Union[str, Path]) -> VideoMeta:
    path = Path(path)
    if path.is_dir():
        frames = list_frames(path)
        if not frames:
            raise InputError(f"No frames in directory {path}")
        h, w = load_frame(frames[0]).shape[:2]
        return VideoMeta(w, h, 25.0, len(frames), container="frames")
    if path.suffix.lower() == ".y4m":
        with Y4MReader(path) as r:
            return VideoMeta(r.width, r.height, r.header.fps, r.count_frames(),
                             container="y4m")
    p = _ff.probe_video(path)
    return VideoMeta(p.width, p.height, p.fps, p.nb_frames, p.has_audio,
                     container=path.suffix.lstrip("."))


def open_reader(path: Union[str, Path], fps_hint: float = 25.0):
    path = Path(path)
    if not path.exists():
        raise InputError(f"Input not found: {path}")
    if path.is_dir():
        return FrameDirReader(path, fps=fps_hint)
    if path.suffix.lower() == ".y4m":
        return Y4MReader(path)
    return _ff.FFmpegPipeReader(path)


def is_frame_dir(path: Union[str, Path]) -> bool:
    """Whether ``open_writer`` writes ``path`` as a frame directory."""
    path = Path(path)
    return path.suffix == "" or path.is_dir()


def open_writer(
    path: Union[str, Path],
    width: int,
    height: int,
    fps: float = 25.0,
    codec: str = "libx265",
    crf: int = 18,
    preset: str = "medium",
    pix_fmt: str = "yuv420p",
    audio_source: Optional[Path] = None,
):
    path = Path(path)
    if is_frame_dir(path):
        return FrameDirWriter(path, fps=fps)
    if path.suffix.lower() == ".y4m":
        return Y4MWriter(path, width, height, fps=fps)
    return _ff.FFmpegPipeWriter(
        path, width, height, fps=fps, codec=codec, crf=crf,
        preset=preset, pix_fmt=pix_fmt, audio_source=audio_source,
    )
