"""ffmpeg and ffprobe over pipes: the port's copy of
``framewright_tpu.io.ffmpeg``, used only when both binaries are on
``PATH`` (``ffmpeg_available``; otherwise ``DependencyError``).

Frames cross the pipes as raw RGB24 in both directions, with the JAX
module's command lines. Where the JAX module leaves ffmpeg's stderr in a
pipe that nobody reads while frames flow, so a chatty decode of a
damaged file fills the pipe's 64 KB and both processes wait on each
other, the port drains stderr in a thread of its own and keeps its tail
(``_StderrTail``) for the error message.
"""

from __future__ import annotations

import collections
import json
import shutil
import subprocess
import threading
from dataclasses import dataclass
from fractions import Fraction
from pathlib import Path
from typing import Iterator, List, Optional, Union

import numpy as np

from framewright_tpu_torch.errors import DependencyError, InputError, MediaFormatError

_TAIL_BYTES = 64 * 1024


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None


def _require() -> None:
    if not ffmpeg_available():
        raise DependencyError(
            "ffmpeg/ffprobe not found on PATH. Use .y4m or PNG-sequence "
            "inputs, or install ffmpeg for mp4/mkv support."
        )


class _StderrTail:
    """Reads a process's stderr to its end in a daemon thread, keeping
    the last ``_TAIL_BYTES``."""

    def __init__(self, stream):
        self._chunks: collections.deque = collections.deque()
        self._size = 0
        self._thread = threading.Thread(target=self._drain, args=(stream,), daemon=True)
        self._thread.start()

    def _drain(self, stream) -> None:
        for chunk in iter(lambda: stream.read1(8192), b""):
            self._chunks.append(chunk)
            self._size += len(chunk)
            while self._size - len(self._chunks[0]) >= _TAIL_BYTES:
                self._size -= len(self._chunks.popleft())
        stream.close()

    def text(self, timeout: float = 10.0) -> str:
        """The tail, once the process closed its stderr (or ``timeout``)."""
        self._thread.join(timeout)
        return b"".join(self._chunks)[-_TAIL_BYTES:].decode(errors="replace")


@dataclass
class ProbeResult:
    width: int
    height: int
    fps: float
    duration: float
    nb_frames: int
    codec: str
    pix_fmt: str
    has_audio: bool
    raw: dict


def probe_video(path: Union[str, Path]) -> ProbeResult:
    _require()
    cmd = [
        "ffprobe", "-v", "error", "-print_format", "json",
        "-show_streams", "-show_format", str(path),
    ]
    out = subprocess.run(cmd, capture_output=True, timeout=120)
    if out.returncode != 0:
        raise InputError(f"ffprobe failed: {out.stderr.decode(errors='replace')[:500]}")
    info = json.loads(out.stdout)
    vstreams = [s for s in info.get("streams", []) if s.get("codec_type") == "video"]
    if not vstreams:
        raise MediaFormatError(f"No video stream in {path}")
    v = vstreams[0]
    rate = v.get("avg_frame_rate") or v.get("r_frame_rate") or "25/1"
    try:
        fps = float(Fraction(rate))
    except ZeroDivisionError:
        fps = 25.0
    duration = float(info.get("format", {}).get("duration", 0) or 0)
    nb = int(v.get("nb_frames", 0) or 0)
    if nb == 0 and duration > 0:
        nb = int(round(duration * fps))
    return ProbeResult(
        width=int(v["width"]),
        height=int(v["height"]),
        fps=fps,
        duration=duration,
        nb_frames=nb,
        codec=v.get("codec_name", ""),
        pix_fmt=v.get("pix_fmt", ""),
        has_audio=any(s.get("codec_type") == "audio" for s in info.get("streams", [])),
        raw=info,
    )


class FFmpegPipeReader:
    """Decode any container to a stream of RGB24 frames over a pipe. A
    decode that ends with a non-zero exit raises ``MediaFormatError``
    with the tail of ffmpeg's stderr."""

    def __init__(self, path: Union[str, Path], vf: Optional[str] = None):
        _require()
        self.meta = probe_video(path)
        self.width, self.height, self.fps = self.meta.width, self.meta.height, self.meta.fps
        cmd = ["ffmpeg", "-v", "error", "-i", str(path)]
        if vf:
            cmd += ["-vf", vf]
        cmd += ["-f", "rawvideo", "-pix_fmt", "rgb24", "-"]
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        self._stderr = _StderrTail(self._proc.stderr)
        self._frame_bytes = self.width * self.height * 3
        self.frames_read = 0

    def count_frames(self) -> int:
        return self.meta.nb_frames

    def read_frame(self) -> Optional[np.ndarray]:
        assert self._proc.stdout is not None
        raw = self._proc.stdout.read(self._frame_bytes)
        if not raw:
            if self._proc.wait(timeout=60) != 0:
                raise MediaFormatError(f"ffmpeg decode failed: {self._stderr.text()[-500:]}")
            return None
        if len(raw) != self._frame_bytes:
            raise MediaFormatError("Truncated rawvideo frame from ffmpeg: "
                                   f"{self._stderr.text()[-500:]}")
        self.frames_read += 1
        return np.frombuffer(raw, np.uint8).reshape(self.height, self.width, 3)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            f = self.read_frame()
            if f is None:
                return
            yield f

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
        if self._proc.stdout:
            self._proc.stdout.close()
        self._proc.wait(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FFmpegPipeWriter:
    """Encode RGB24 frames piped to ffmpeg (libx265 CRF by default). It
    cannot append: a resumed restore writes it from frame 0."""

    def __init__(
        self,
        path: Union[str, Path],
        width: int,
        height: int,
        fps: float = 25.0,
        codec: str = "libx265",
        crf: int = 18,
        preset: str = "medium",
        pix_fmt: str = "yuv420p",
        audio_source: Optional[Path] = None,
        extra_args: Optional[List[str]] = None,
    ):
        _require()
        self.width, self.height, self.fps = width, height, fps
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        cmd = [
            "ffmpeg", "-y", "-v", "error",
            "-f", "rawvideo", "-pix_fmt", "rgb24",
            "-s", f"{width}x{height}", "-r", f"{fps:.6f}",
            "-i", "-",
        ]
        if audio_source is not None:
            cmd += ["-i", str(audio_source), "-map", "0:v", "-map", "1:a?",
                    "-c:a", "copy"]
        cmd += ["-c:v", codec, "-crf", str(crf), "-preset", preset,
                "-pix_fmt", pix_fmt]
        if extra_args:
            cmd += list(extra_args)
        cmd += [str(path)]
        self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stderr=subprocess.PIPE)
        self._stderr = _StderrTail(self._proc.stderr)
        self.frames_written = 0

    def write_frame(self, rgb: np.ndarray) -> None:
        if rgb.shape[:2] != (self.height, self.width):
            raise MediaFormatError(
                f"Frame shape {rgb.shape[:2]} != writer dims {(self.height, self.width)}"
            )
        assert self._proc.stdin is not None
        try:
            self._proc.stdin.write(np.ascontiguousarray(rgb, dtype=np.uint8).tobytes())
        except BrokenPipeError as exc:
            raise MediaFormatError(f"ffmpeg encode failed: {self._stderr.text()[-500:]}") from exc
        self.frames_written += 1

    def close(self) -> None:
        if self._proc.stdin:
            self._proc.stdin.close()
        rc = self._proc.wait(timeout=600)
        if rc != 0:
            raise MediaFormatError(f"ffmpeg encode failed: {self._stderr.text()[-500:]}")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        elif self._proc.poll() is None:
            self._proc.kill()


def extract_audio(video: Path, out_audio: Path) -> bool:
    """Copy the audio track to a standalone file; False when no audio."""
    _require()
    out_audio.parent.mkdir(parents=True, exist_ok=True)
    cmd = ["ffmpeg", "-y", "-v", "error", "-i", str(video), "-vn",
           "-c:a", "copy", str(out_audio)]
    rc = subprocess.run(cmd, capture_output=True, timeout=600)
    return rc.returncode == 0 and out_audio.exists() and out_audio.stat().st_size > 0
