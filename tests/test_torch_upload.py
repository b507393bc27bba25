"""The port's uploads do not block the host (ROADMAP.md C5), checked on
the CPU with the CUDA calls mocked: the SR processor uploads each batch
from one of two pinned staging buffers with ``non_blocking=True`` and
refills a buffer only after the event of the copy that last read it,
copies its result back into pinned memory without blocking, and waits
only in ``materialize``; the ring's producer thread runs the pre-SR
stream with a CUDA stream of its own current."""

from __future__ import annotations

import contextlib
import io
import threading

import numpy as np
import pytest
import torch

from conftest import make_gradient_frame
from framewright_tpu_torch import hw
from framewright_tpu_torch import restorer as restorer_mod
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.io.y4m import Y4MWriter
from framewright_tpu_torch.processors import super_resolution as sr_mod
from framewright_tpu_torch.processors.temporal_denoise import TemporalDenoiser


class _Log(list):
    pass


class _FakeEvent:
    def __init__(self, log: _Log):
        self.log, self.id = log, sum(1 for e in log if e[0] == "new event")
        log.append(("new event", self.id))

    def record(self, stream):
        self.log.append(("record", self.id, stream))

    def synchronize(self):
        self.log.append(("sync", self.id))


class _FakePinned:
    """A host buffer standing in for pinned memory: logs its allocation,
    its fills (a ``numpy()`` view taken to write into) and its copies,
    under the id of the buffer a view was taken from."""

    def __init__(self, log: _Log, shape, dtype, base=None):
        self.log = log
        if base is None:
            self.t = torch.zeros(tuple(shape), dtype=dtype)
            self.id = sum(1 for e in log if e[0] == "pinned")
            log.append(("pinned", self.id, tuple(shape)))
        else:
            self.t, self.id = base
        self.shape = self.t.shape

    def narrow(self, dim, start, length):
        return _FakePinned(self.log, None, None, (self.t.narrow(dim, start, length), self.id))

    def view(self, shape):
        return _FakePinned(self.log, None, None, (self.t.view(shape), self.id))

    def numpy(self):
        self.log.append(("fill", self.id))
        return self.t.numpy()

    def to(self, device, non_blocking=False):
        self.log.append(("upload", self.id, non_blocking))
        return self.t.clone()

    def copy_(self, src, non_blocking=False):
        self.log.append(("download", self.id, non_blocking))
        self.t.copy_(src)
        return self


@pytest.fixture
def cuda_mocked(monkeypatch):
    log = _Log()
    monkeypatch.setattr(torch.cuda, "Event", lambda: _FakeEvent(log))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(sr_mod, "_pinned_empty", lambda shape, dtype: _FakePinned(log, shape,
                                                                                   dtype))
    return log


def test_staging_buffer_waits_for_its_last_copy(cuda_mocked):
    log = cuda_mocked
    staging = sr_mod.HostStaging()
    # the third batch smaller (a batch of unique frames): a view of buffer 0
    xs = [np.full((n, 4, 6, 3), i, np.uint8) for i, n in enumerate((2, 2, 1))]
    for x in xs:
        np.testing.assert_array_equal(staging.upload(x, torch.device("cpu")).numpy(), x)
    assert [e for e in log if e[0] == "pinned"] == [("pinned", 0, (144,)),
                                                     ("pinned", 1, (144,))]
    assert all(e[2] is True for e in log if e[0] == "upload")
    # the third batch refills buffer 0 only after the event of its first copy
    third = max(i for i, e in enumerate(log) if e == ("fill", 0))
    assert ("sync", 0) in log[:third] and log.index(("sync", 0)) > log.index(("upload", 1, True))
    assert ("sync", 1) not in log
    # each upload's event is recorded right after its copy
    for k, (i, e) in enumerate((i, e) for i, e in enumerate(log) if e[0] == "upload"):
        assert log[i + 2][0] == "record"


@pytest.mark.parametrize("color", ["rgb", "yuv420"])
def test_sr_processor_stages_uploads_and_copies_back(cuda_mocked, color):
    """FW_fast6_x2 on the CPU through the mocked staging: the bytes of the
    plain CPU path; two dispatches before the first materialize (the
    restorer's one batch in flight) wait on nothing; the copies back are
    non-blocking and materialize waits on the batch's event."""
    log = cuda_mocked
    frames = np.stack([make_gradient_frame(16, 24, t) for t in range(4)])

    def processor():
        sr = sr_mod.SuperResolution(sr_mod.SRConfig(model_name="FW_fast6_x2", device="cpu",
                                                    output_color=color))
        sr.setup(16, 24)
        return sr

    plain = processor()
    assert plain._staging is None                  # the CPU uses the batch in place
    want = [plain.materialize(plain.dispatch(frames[i:i + 2])) for i in (0, 2)]
    sr = processor()
    sr._staging = sr_mod.HostStaging()
    h0 = sr.dispatch(frames[:2])
    h1 = sr.dispatch(frames[2:])
    assert not any(e[0] == "sync" for e in log)
    assert {e[2] for e in log if e[0] in ("upload", "download")} == {True}
    got = [sr.materialize(h0), sr.materialize(h1)]
    assert [e for e in log if e[0] == "sync"] == [("sync", h0["event"].id),
                                                 ("sync", h1["event"].id)]
    for g, w in zip(got, want):
        for a, b in zip(g if color == "yuv420" else [g], w if color == "yuv420" else [w]):
            np.testing.assert_array_equal(a, b)
    # two staging buffers and two output slots, allocated once: a third
    # batch reuses them (an allocation of pinned memory waits for the card)
    pinned = sum(1 for e in log if e[0] == "pinned")
    assert pinned == 4
    h2 = sr.dispatch(frames[:2])       # into the slot batch 1 came back in
    assert sum(1 for e in log if e[0] == "pinned") == pinned and h2["slot"] in (0, 1)
    sr.materialize(h2)
    # the results handed out are the caller's own, not views of a slot
    for g, w in zip(got, want):
        for a, b in zip(g if color == "yuv420" else [g], w if color == "yuv420" else [w]):
            np.testing.assert_array_equal(a, b)


def test_side_stream_helpers_on_the_cpu():
    assert hw.side_stream(torch.device("cpu")) is None
    items = iter([1, 2, 3])
    assert list(hw.on_stream(items, None)) == [1, 2, 3]


def test_pre_sr_stream_runs_on_its_own_stream_in_the_producer_thread(tmp_path, monkeypatch):
    """A bilateral-denoise restore with a stream handed to the pre-SR
    stream: every denoiser upload runs in the ring's producer thread with
    that stream current; the output is the unmocked restore's."""
    frames = [make_gradient_frame(16, 24, t) for t in range(6)]
    src = tmp_path / "c.y4m"
    with Y4MWriter(src, 24, 16, fps=24) as wr:
        for f in frames:
            wr.write_frame(f)
    cfg = dict(sr_model="FW_fast6_x2", device_platform="cpu", denoise=True,
               denoise_model="bilateral", checkpoint_enabled=False, validate_output=False)
    with contextlib.redirect_stdout(io.StringIO()):
        restorer_mod.VideoRestorer(Config(project_dir=tmp_path / "a", **cfg)).restore_video(
            src, tmp_path / "plain.y4m")

    current = threading.local()
    side, seen = object(), []

    @contextlib.contextmanager
    def fake_stream(stream):
        prev = getattr(current, "stream", None)
        current.stream = stream
        try:
            yield
        finally:
            current.stream = prev

    real_upload = TemporalDenoiser.upload

    def upload(self, frame):
        seen.append((threading.current_thread().name, getattr(current, "stream", None)))
        return real_upload(self, frame)

    monkeypatch.setattr(restorer_mod, "side_stream", lambda device: side)
    monkeypatch.setattr(torch.cuda, "stream", fake_stream)
    monkeypatch.setattr(TemporalDenoiser, "upload", upload)
    with contextlib.redirect_stdout(io.StringIO()):
        restorer_mod.VideoRestorer(Config(project_dir=tmp_path / "b", **cfg)).restore_video(
            src, tmp_path / "streamed.y4m")
    assert len(seen) == len(frames)
    assert set(seen) == {("fw-prefetch", side)}
    assert getattr(current, "stream", None) is None      # the main thread's is untouched
    assert (tmp_path / "streamed.y4m").read_bytes() == (tmp_path / "plain.y4m").read_bytes()
