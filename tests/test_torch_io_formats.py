"""Video I/O beyond Y4M in the port (``io/png_seq``, ``io/ffmpeg``,
``io/video``, ``io/color``) against the JAX package's modules, and
restores that read and write PNG frame directories and ffmpeg
containers. There is no ffmpeg here: a stub ``ffmpeg``/``ffprobe`` (a
Python script put first on ``PATH``) speaks the rawvideo and JSON
protocol over a toy container (a JSON header line, then raw RGB24
frames), logs its command lines, and can flood its stderr."""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import make_gradient_frame
from framewright_tpu.io import color as jcolor
from framewright_tpu.io import ffmpeg as jff
from framewright_tpu.io import png_seq as jpng
from framewright_tpu.io import video as jvideo
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import DependencyError
from framewright_tpu_torch.io import color, ffmpeg, png_seq, video
from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution
from framewright_tpu_torch.restorer import VideoRestorer

STUB = r'''#!{python}
import json, os, sys
name = os.path.basename(sys.argv[0])
args = sys.argv[1:]
log = os.environ.get("FW_STUB_LOG")
if log:
    with open(log, "a") as f:
        f.write(json.dumps([name] + args) + "\n")
flood = int(os.environ.get("FW_STUB_FLOOD", "0"))


def read_container(path):
    with open(path, "rb") as f:
        head = json.loads(f.readline())
        return head, f.read()


if name == "ffprobe":
    head, data = read_container(args[-1])
    num, den = (int(v) for v in head["rate"].split("/"))
    n = len(data) // (head["width"] * head["height"] * 3)
    v = {"codec_type": "video", "codec_name": "stub", "pix_fmt": "yuv420p",
         "width": head["width"], "height": head["height"], "avg_frame_rate": head["rate"]}
    if not head.get("no_nb_frames"):
        v["nb_frames"] = str(n)
    streams = [v] + ([{"codec_type": "audio"}] if head.get("audio") else [])
    print(json.dumps({"streams": streams, "format": {"duration": str(n * den / num)}}))
    sys.exit(0)
if flood:
    sys.stderr.buffer.write(b"w" * flood)
    sys.stderr.flush()
if "-vn" in args:                                   # extract_audio
    head, _ = read_container(args[args.index("-i") + 1])
    if not head.get("audio"):
        sys.exit(1)
    with open(args[-1], "wb") as f:
        f.write(b"audio")
    sys.exit(0)
if args[args.index("-i") + 1] == "-":               # encode rawvideo from stdin
    w, h = (int(v) for v in args[args.index("-s") + 1].split("x"))
    rate = args[args.index("-r") + 1]
    data = sys.stdin.buffer.read()
    with open(args[-1], "wb") as f:
        f.write(json.dumps({"width": w, "height": h, "rate": rate + "/1" if "/" not in rate
                            else rate, "codec": args[args.index("-c:v") + 1]}).encode() + b"\n")
        f.write(data)
    sys.exit(int(os.environ.get("FW_STUB_ENCODE_RC", "0")))
head, data = read_container(args[args.index("-i") + 1])  # decode to rawvideo
sys.stdout.buffer.write(data)
sys.exit(0)
'''


@pytest.fixture
def stub_ffmpeg(tmp_path, monkeypatch):
    """``ffmpeg`` and ``ffprobe`` stubs first on PATH; their command lines
    go to the returned log file."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for name in ("ffmpeg", "ffprobe"):
        p = bindir / name
        p.write_text(STUB.replace("{python}", sys.executable))
        p.chmod(0o755)
    log = tmp_path / "stub.log"
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FW_STUB_LOG", str(log))
    return log


def write_container(path: Path, frames, rate: str = "24/1", **extra) -> Path:
    h, w = frames[0].shape[:2]
    with open(path, "wb") as f:
        f.write(json.dumps({"width": w, "height": h, "rate": rate, **extra}).encode() + b"\n")
        for fr in frames:
            f.write(np.ascontiguousarray(fr, np.uint8).tobytes())
    return path


def read_container(path: Path):
    with open(path, "rb") as f:
        head = json.loads(f.readline())
        data = np.frombuffer(f.read(), np.uint8)
    return head, data.reshape(-1, head["height"], head["width"], 3)


def clip(n: int = 6, h: int = 24, w: int = 32):
    return [make_gradient_frame(h, w, t) for t in range(n)]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- colour, frame directories --------------------------------------------------

def test_color_equals_jax():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (8, 12, 3), np.uint8)
    for full in (False, True):
        got, want = color.rgb_to_yuv420(rgb, full), jcolor.rgb_to_yuv420(rgb, full)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(color.yuv420_to_rgb(*got, full_range=full),
                                      jcolor.yuv420_to_rgb(*want, full_range=full))
        yuv = torch.from_numpy(rng.random((2, 8, 12, 3), np.float32) * 255)
        back = color.yuv_to_rgb(yuv, full)
        np.testing.assert_allclose(back.numpy(), np.asarray(jcolor.yuv_to_rgb_jax(
            yuv.numpy(), full)), atol=1e-6)
        np.testing.assert_allclose(color.rgb_to_yuv(back, full).numpy(), np.asarray(
            jcolor.rgb_to_yuv_jax(back.numpy(), full)), atol=1e-4)


def test_list_frames_order_equals_jax(tmp_path):
    names = ["frame_10.png", "frame_2.png", "frame_000001.png", "frame_3.JPG", "notes.txt",
             "frame_4.png.part", "frame_7.tiff"]
    for n in names:
        (tmp_path / n).write_bytes(b"")
    got = [p.name for p in png_seq.list_frames(tmp_path)]
    assert got == [p.name for p in jpng.list_frames(tmp_path)]
    assert got == ["frame_000001.png", "frame_2.png", "frame_3.JPG", "frame_7.tiff",
                   "frame_10.png"]


def test_frame_dir_round_trip_equals_jax(tmp_path):
    frames = clip(3)
    with png_seq.FrameDirWriter(tmp_path / "port", fps=24) as w:
        for f in frames:
            w.write_frame(f)
    with jpng.FrameDirWriter(tmp_path / "jax", fps=24) as w:
        for f in frames:
            w.write_frame(f)
    for a, b in zip(sorted((tmp_path / "port").iterdir()), sorted((tmp_path / "jax").iterdir())):
        assert a.name == b.name and a.read_bytes() == b.read_bytes()
    assert png_seq.whole_frames(tmp_path / "port") == 3
    got = list(png_seq.FrameDirReader(tmp_path / "port"))
    want = list(jpng.FrameDirReader(tmp_path / "jax"))
    for g, w_, f in zip(got, want, frames):
        np.testing.assert_array_equal(g, w_)
        np.testing.assert_array_equal(g, f)
    # a writer continued after frame 2 numbers its files from 3
    with png_seq.FrameDirWriter(tmp_path / "port", start_index=3) as w:
        assert w.write_frame(frames[0]).name == "frame_000003.png"


@pytest.mark.parametrize("kind", ["y4m", "dir", "mp4", "mp4-duration"])
def test_probe_equals_jax(tmp_path, stub_ffmpeg, kind):
    frames = clip(5)
    if kind == "y4m":
        path = tmp_path / "a.y4m"
        with Y4MWriter(path, 32, 24, fps=30) as w:
            for f in frames:
                w.write_frame(f)
    elif kind == "dir":
        path = tmp_path / "frames"
        with png_seq.FrameDirWriter(path) as w:
            for f in frames:
                w.write_frame(f)
    else:
        path = write_container(tmp_path / "a.mp4", frames, rate="30000/1001", audio=True,
                               no_nb_frames=kind == "mp4-duration")
    got, want = video.probe(path), jvideo.probe(path)
    assert got.__dict__ == want.__dict__
    assert got.nb_frames == 5


# -- ffmpeg pipes ------------------------------------------------------------------

def _log(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []


def test_ffmpeg_command_lines_equal_jax(tmp_path, stub_ffmpeg):
    """The reader's, the writer's (codec, crf, preset, pix_fmt, the audio
    map) and the audio extraction's command lines are the JAX module's;
    the frames cross the pipes unchanged."""
    frames = clip(4)
    src = write_container(tmp_path / "in.mp4", frames, audio=True)
    for mod, tag in ((ffmpeg, "port"), (jff, "jax")):
        with mod.FFmpegPipeReader(src) as r:
            got = list(r)
        assert len(got) == 4 and all(np.array_equal(a, b) for a, b in zip(got, frames))
        with mod.FFmpegPipeWriter(tmp_path / "out.mkv", 32, 24, fps=23.976, codec="libx264",
                                  crf=14, preset="slow", pix_fmt="yuv420p10le",
                                  audio_source=tmp_path / "a.aac") as w:
            for f in frames:
                w.write_frame(f)
        _, back = read_container(tmp_path / "out.mkv")
        np.testing.assert_array_equal(back, np.stack(frames))
        assert mod.extract_audio(src, tmp_path / "a.aac")
        (stub_ffmpeg.rename(tmp_path / f"{tag}.log"))
    port, jax = _log(tmp_path / "port.log"), _log(tmp_path / "jax.log")
    assert port == jax and [c[0] for c in port] == ["ffprobe", "ffmpeg", "ffmpeg", "ffmpeg"]
    assert ["ffmpeg", "-y", "-v", "error", "-f", "rawvideo", "-pix_fmt", "rgb24", "-s",
            "32x24", "-r", "23.976000", "-i", "-", "-i", str(tmp_path / "a.aac"), "-map",
            "0:v", "-map", "1:a?", "-c:a", "copy", "-c:v", "libx264", "-crf", "14",
            "-preset", "slow", "-pix_fmt", "yuv420p10le", str(tmp_path / "out.mkv")] in port


@pytest.mark.parametrize("side", ["decode", "encode"])
def test_stderr_flood_does_not_hang(tmp_path, stub_ffmpeg, monkeypatch, side):
    """ffmpeg writing 256 KB to stderr before its frames (4x the pipe's
    64 KB): the JAX module's reader and writer would wait on each other;
    the port drains stderr and finishes."""
    monkeypatch.setenv("FW_STUB_FLOOD", str(256 * 1024))
    frames = clip(40, 48, 64)                  # 368 KB of frames through the pipe
    src = write_container(tmp_path / "in.mp4", frames)
    out = {}

    def run():
        if side == "decode":
            with ffmpeg.FFmpegPipeReader(src) as r:
                out["frames"] = len(list(r))
        else:
            with ffmpeg.FFmpegPipeWriter(tmp_path / "o.mp4", 64, 48) as w:
                for f in frames:
                    w.write_frame(f)
            out["frames"] = len(read_container(tmp_path / "o.mp4")[1])

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the pipe hung"
    assert out["frames"] == 40


def test_missing_ffmpeg_raises_dependency_error(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    src = write_container(tmp_path / "in.mp4", clip(2))
    assert not ffmpeg.ffmpeg_available()
    for call in (lambda: ffmpeg.probe_video(src), lambda: ffmpeg.FFmpegPipeReader(src),
                 lambda: ffmpeg.FFmpegPipeWriter(tmp_path / "o.mp4", 32, 24),
                 lambda: video.open_reader(src), lambda: video.probe(src),
                 lambda: ffmpeg.extract_audio(src, tmp_path / "a.aac")):
        with pytest.raises(DependencyError, match="ffmpeg/ffprobe not found"):
            call()
    with pytest.raises(jff.DependencyError) as jerr:
        jff.probe_video(src)
    with pytest.raises(DependencyError) as perr:
        ffmpeg.probe_video(src)
    assert str(perr.value) == str(jerr.value)


# -- restores ------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _restore(src, out, proj, stop_at=0, **kw):
    cfg = Config(sr_model="FW_fast6_x2", device_platform="cpu", batch_size=2,
                 project_dir=proj, **kw)

    def stop(info):
        if stop_at and info.frames_done >= stop_at:
            raise _Stop(info.frames_done)

    with contextlib.redirect_stdout(io.StringIO()):
        return VideoRestorer(cfg, stop if stop_at else None).restore_video(src, out)


def _decoded_sources(tmp_path):
    """The same frames as a Y4M file and as a frame directory (the Y4M's
    decoded frames)."""
    y4m = tmp_path / "src.y4m"
    with Y4MWriter(y4m, 32, 24, fps=25) as w:
        for f in clip(6):
            w.write_frame(f)
    with Y4MReader(y4m) as r:
        decoded = list(r)
    with png_seq.FrameDirWriter(tmp_path / "src") as w:
        for f in decoded:
            w.write_frame(f)
    return y4m, tmp_path / "src", decoded


def test_png_dir_restore_equals_the_y4m_restore(tmp_path):
    """A frame-directory source restores to the Y4M source's bytes; a
    frame-directory output holds the RGB path's frames (the SR
    processor's ``rgb`` output on the same frames, in the same batches);
    stopped after 4 frames and rerun, its files equal a straight run's."""
    y4m, frames_dir, decoded = _decoded_sources(tmp_path)
    _restore(y4m, tmp_path / "a.y4m", tmp_path / "pa")
    res = _restore(frames_dir, tmp_path / "b.y4m", tmp_path / "pb")
    assert (tmp_path / "a.y4m").read_bytes() == (tmp_path / "b.y4m").read_bytes()
    assert res.frames_out == 6 and res.output_fps == 25.0
    straight = _restore(y4m, tmp_path / "out_s", tmp_path / "ps")
    assert straight.pre_sr["host_codec"]["encode"] == "FrameDirWriter"
    sr = SuperResolution(SRConfig(model_name="FW_fast6_x2", device="cpu", batch_size=2))
    sr.setup(24, 32)
    want = np.concatenate([sr.materialize(sr.dispatch(np.stack(decoded[i:i + 2])))
                           for i in range(0, 6, 2)])
    got = np.stack(list(png_seq.FrameDirReader(tmp_path / "out_s")))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(_Stop):
        _restore(y4m, tmp_path / "out_r", tmp_path / "pr", stop_at=4)
    (tmp_path / "out_r" / "frame_000005.png.part").write_bytes(b"cut short")
    res = _restore(y4m, tmp_path / "out_r", tmp_path / "pr")
    assert res.resumed_from == 4
    files = sorted(p.name for p in (tmp_path / "out_s").iterdir())
    assert files == [f"frame_{i:06d}.png" for i in range(1, 7)]
    for name in files:
        assert (tmp_path / "out_r" / name).read_bytes() == \
            (tmp_path / "out_s" / name).read_bytes()


def test_ffmpeg_restore_and_resume_from_zero(tmp_path, stub_ffmpeg):
    """An mp4 source and output through the stub: the output's frames are
    the frame-directory restore's; a rerun after a stop cannot append to
    it and writes it from frame 0 (``resumed_from`` 0), equal again."""
    _, frames_dir, decoded = _decoded_sources(tmp_path)
    src = write_container(tmp_path / "src.mp4", decoded, rate="25/1")
    _restore(frames_dir, tmp_path / "ref", tmp_path / "p0")
    res = _restore(src, tmp_path / "out.mp4", tmp_path / "p1", codec="libx264", crf=20)
    head, got = read_container(tmp_path / "out.mp4")
    want = np.stack(list(png_seq.FrameDirReader(tmp_path / "ref")))
    np.testing.assert_array_equal(got, want)
    assert head["codec"] == "libx264" and res.pre_sr["host_codec"] == {
        "decode": "FFmpegPipeReader", "encode": "FFmpegPipeWriter"}
    with pytest.raises(_Stop):
        _restore(src, tmp_path / "out2.mp4", tmp_path / "p2", stop_at=4)
    res = _restore(src, tmp_path / "out2.mp4", tmp_path / "p2")
    assert res.resumed_from == 0
    np.testing.assert_array_equal(read_container(tmp_path / "out2.mp4")[1], want)


def test_failed_restore_kills_ffmpeg_and_raises_its_own_error(tmp_path, stub_ffmpeg,
                                                              monkeypatch):
    """A restore to mp4 that fails mid-stage kills the encoder (the
    writer's ``__exit__``): its exception comes out, not the encoder's
    ``MediaFormatError`` (the stub exits 1 when it is handed EOF), and no
    truncated output is finalised."""
    y4m, _, _ = _decoded_sources(tmp_path)
    monkeypatch.setenv("FW_STUB_ENCODE_RC", "1")
    with pytest.raises(_Stop):
        _restore(y4m, tmp_path / "out.mp4", tmp_path / "p", stop_at=2)
    assert not (tmp_path / "out.mp4").exists()


@pytest.mark.parametrize("fmt,suffix", [("auto", ".y4m"), ("png", ""), ("mkv", ".mkv")])
def test_output_format_names_the_output(tmp_path, fmt, suffix):
    """``_resolve_output`` as the JAX restorer's: the source's suffix, or
    ``output_format``'s (png: a frame directory)."""
    cfg = Config(project_dir=tmp_path, output_format=fmt)
    assert VideoRestorer(cfg)._resolve_output(Path("clip.y4m")) == \
        tmp_path / f"clip_restored{suffix}"
