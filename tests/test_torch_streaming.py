"""The port's streaming chunked restore (``framewright_tpu_torch/
streaming.py``) held to the JAX package's (``framewright_tpu/streaming.py``,
``tests/test_streaming.py``).

Tolerances: the chunks, the callbacks' order and the frame counts equal
JAX's; the streamed output equals the port's straight restore of the
clip byte for byte (chunks of 2 frames, the straight restore in batches
of 2, so every frame runs in a batch of the same size on the CPU). JAX's
streamed bytes are not the reference: JAX decodes every chunk and
segment to RGB and encodes it again, which moves 4:2:0 chroma.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from framewright_tpu.config import Config as JConfig
from framewright_tpu.streaming import StreamingRestorer as JStreamingRestorer
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import InputError
from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter, concat_y4m
from framewright_tpu_torch.parallel.distributor import FrameChunk
from framewright_tpu_torch.restorer import VideoRestorer
from framewright_tpu_torch.streaming import StreamingRestorer

MODEL = "FW_fastvgg_x2"


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(tmp_path / "w"))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _clip(path, n=5, h=24, w=32, seed=3):
    """A progressive clip: its decoded frames score ~0.04 for combing, so
    no chunk is deinterlaced."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    with Y4MWriter(path, w, h, fps=12) as wr:
        for t in range(n):
            ph = rng.random(3) * 6
            g = 127 + 100 * np.sin(x / 5 + y / 7 + ph[0] + t * 0.3)
            wr.write_frame(np.clip(np.stack([g, g * 0.9 + 10, g * 0.8 + 20], -1), 0, 255
                                   ).astype(np.uint8))
    return path


def _cfg(tmp_path, **kw):
    return Config(project_dir=tmp_path / "proj", sr_model=MODEL, device_platform="cpu",
                  batch_size=2, **kw)


def _frames(path):
    with Y4MReader(path) as r:
        return list(r)


def test_streamed_equals_straight_and_resumes_one_chunk(tmp_path):
    src = _clip(tmp_path / "c.y4m")
    straight = VideoRestorer(_cfg(tmp_path)).restore_video(src, output=tmp_path / "s.y4m")
    ready = []
    cfg = _cfg(tmp_path, keep_intermediates=True)
    res = StreamingRestorer(cfg, on_chunk_ready=lambda i, p: ready.append((i, p.name)),
                            chunk_frames=2).restore_video_streaming(src, tmp_path / "o.y4m")
    assert (res.chunks, res.frames_out, res.restored) == (3, 5, [0, 1, 2])
    assert ready == [(0, "seg_00000.y4m"), (1, "seg_00001.y4m"), (2, "seg_00002.y4m")]
    assert straight.frames_out == 5
    assert (tmp_path / "o.y4m").read_bytes() == (tmp_path / "s.y4m").read_bytes()
    # a rerun without the last segment restores that chunk only
    res.chunk_paths[-1].unlink()
    again = []
    res2 = StreamingRestorer(cfg, on_chunk_ready=lambda i, p: again.append(i),
                             chunk_frames=2).restore_video_streaming(src, tmp_path / "o2.y4m")
    assert again == [2] and res2.restored == [2] and res2.frames_out == 5
    assert (tmp_path / "o2.y4m").read_bytes() == (tmp_path / "s.y4m").read_bytes()


def test_segment_cut_short_is_restored_again_where_jax_takes_it_as_done(tmp_path):
    src = _clip(tmp_path / "c.y4m", n=4)
    seg = tmp_path / "seg.y4m"
    concat_y4m([src], seg, start=0, end=2)
    data = seg.read_bytes()
    seg.write_bytes(data[:-100])                     # the second frame cut short
    chunk = FrameChunk(0, 0, 2)
    assert not StreamingRestorer._segment_complete(seg, chunk)
    assert JStreamingRestorer(JConfig())._segment_complete(seg, chunk, JConfig())
    seg.write_bytes(data)
    assert StreamingRestorer._segment_complete(seg, chunk)
    seg.write_bytes(b"not a y4m")
    assert not StreamingRestorer._segment_complete(seg, chunk)


@pytest.mark.parametrize("chunk_frames,bounds", [(2, None), (3, [2]), (0, None)])
def test_chunks_and_callbacks_as_jax(tmp_path, chunk_frames, bounds):
    """The chunks, the callbacks and the frame counts of JAX's streaming
    restore (JAX runs its ``sr_model="none"``; the port has no such row and
    restores with FW_fastvgg_x2); ``chunk_frames=0`` takes
    ``scene_chunk_frames``."""
    src = _clip(tmp_path / "c.y4m", n=7)
    got, want = [], []
    pres = StreamingRestorer(_cfg(tmp_path, scene_chunk_frames=4),
                             on_chunk_ready=lambda i, p: got.append(i),
                             chunk_frames=chunk_frames).restore_video_streaming(
        src, tmp_path / "p.y4m", scene_boundaries=bounds)
    jcfg = JConfig(project_dir=tmp_path / "jproj", scale_factor=1, sr_model="none",
                   validate_output=False, scene_chunk_frames=4)
    jres = JStreamingRestorer(jcfg, on_chunk_ready=lambda i, p: want.append(i),
                              chunk_frames=chunk_frames).restore_video_streaming(
        src, tmp_path / "j.y4m", scene_boundaries=bounds)
    assert got == want and (pres.chunks, pres.frames_out) == (jres.chunks, jres.frames_out)
    assert len(_frames(tmp_path / "p.y4m")) == 7
    assert not any((tmp_path / "proj" / "work" / "segments").glob("seg_*"))


def test_missing_source_raises(tmp_path):
    with pytest.raises(InputError, match="source not found"):
        StreamingRestorer(_cfg(tmp_path)).restore_video_streaming(tmp_path / "none.y4m")


def test_concat_copies_frames_and_refuses_mixed_parts(tmp_path):
    a = _clip(tmp_path / "a.y4m", n=3)
    b = _clip(tmp_path / "b.y4m", n=2, seed=4)
    assert concat_y4m([a, b], tmp_path / "ab.y4m", fps=30) == 5
    with Y4MReader(tmp_path / "ab.y4m") as r:
        assert r.fps == 30.0
    body = (tmp_path / "ab.y4m").read_bytes().split(b"\n", 1)[1]
    assert body == a.read_bytes().split(b"\n", 1)[1] + b.read_bytes().split(b"\n", 1)[1]
    c = _clip(tmp_path / "c.y4m", n=1, h=16)
    with pytest.raises(Exception, match="the first part"):
        concat_y4m([a, c], tmp_path / "ac.y4m")
