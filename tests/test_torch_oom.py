"""A device out-of-memory retry counts its batch once.

The SR processor reruns a batch after a ``torch.cuda.OutOfMemoryError``
at a smaller batch; the rerun is not a second dispatch, so
``SuperResolution.dispatches``, ``RestoreResult.batches`` and the CLI's
``batches`` count the batches the restorer sent. The OOM is raised once
by a stand-in for ``SuperResolution._run``, since the CPU has no device
memory to exhaust.

The retry runs at batch 1. On the CPU the plain convolutions of a batch
of 2 round a few values 1 LSB away from those of a batch of 1 (measured:
0.8% and 0.4% of the Y and U samples of this clip), while the kernels on
the card sum each pixel in one fixed order at any batch. So each frame
is compared with a run without the OOM at the batch it ran at, and the
counts with one at batch 2.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from framewright_tpu_torch import cli
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.io import y4m
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution
from framewright_tpu_torch.restorer import VideoRestorer

MODEL = "FW_fastvgg_x2"


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _oom_once(monkeypatch) -> list:
    """Make the first ``_run`` raise a device OOM; return the batch sizes
    that ``_run`` was called with."""
    real = SuperResolution._run
    calls = []

    def run(self, xt):
        calls.append(xt.shape[0])
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("device out of memory")
        return real(self, xt)

    monkeypatch.setattr(SuperResolution, "_run", run)
    return calls


def _clip(path, gradient_frame, n: int, h: int = 16, w: int = 16):
    with y4m.Y4MWriter(path, w, h, fps=12) as wr:
        for t in range(n):
            wr.write_frame(gradient_frame(h, w, t))
    return path


def _frames(path) -> list:
    """The frames of a Y4M file as bytes, the header checked to be 32x32."""
    header, rest = path.read_bytes().split(b"\n", 1)
    assert b" W32 H32 " in header
    return rest.split(b"FRAME\n")[1:]


def test_processor_counts_a_retried_batch_once(monkeypatch, gradient_frame):
    frames = np.stack([gradient_frame(16, 16, t) for t in range(2)])

    def processor(batch):
        sr = SuperResolution(SRConfig(model_name=MODEL, device="cpu", batch_size=batch,
                                      output_color="yuv420"))
        sr.setup(16, 16)
        assert sr.plan.batch == batch
        return sr

    ref = processor(1)
    want = ref.materialize(ref.dispatch(frames))
    sr = processor(2)
    calls = _oom_once(monkeypatch)
    got = sr.materialize(sr.dispatch(frames))
    assert calls == [2, 2] and sr.plan.batch == 1
    assert sr.dispatches == ref.dispatches == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("frames,batches", [(2, 1), (5, 3)])
def test_restore_reports_the_batches_sent(tmp_path, monkeypatch, gradient_frame, capsys,
                                          frames, batches):
    """One OOM on the first batch of a batch-2 restore: the planner
    downshifts to 1, and every batch the restorer sent counts once, in
    ``RestoreResult.batches``, as in a restore at batch 2 without the
    OOM; each frame equals that of a restore without the OOM at the batch
    it ran at.
    The CLI (the planner's batch) reports the batches of a run without
    the OOM."""
    src = _clip(tmp_path / "clip.y4m", gradient_frame, frames)

    def restore(out, batch):
        cfg = Config(project_dir=tmp_path / "p", sr_model=MODEL, batch_size=batch,
                     device_platform="cpu")
        return VideoRestorer(cfg).restore_video(src, tmp_path / out)

    ref = restore("ref2.y4m", 2)
    assert (ref.batches, ref.frames_out) == (batches, frames)
    assert restore("ref.y4m", 1).batches == frames
    calls = _oom_once(monkeypatch)
    res = restore("oom.y4m", 2)
    assert calls[:2] == [2, 2] and len(calls) == batches + 1
    assert (res.batches, res.frames_out) == (batches, frames)
    # the first batch reran at batch 1; the second had been dispatched at
    # batch 2 before the first was materialized (one batch in flight)
    got, ref1, ref2 = (_frames(tmp_path / f) for f in ("oom.y4m", "ref.y4m", "ref2.y4m"))
    assert got == ref1[:2] + ref2[2:]

    def cli_restore(out):
        assert cli.main(["restore", str(src), "-o", str(tmp_path / out), "--model", MODEL,
                         "--device", "cpu", "--project-dir", str(tmp_path / "c")]) == 0
        return json.loads(capsys.readouterr().out)

    calls.clear()
    got = cli_restore("cli_oom.y4m")
    assert len(calls) == got["batches"] + 1
    monkeypatch.undo()
    want = cli_restore("cli.y4m")
    assert (got["frames"], got["batches"]) == (want["frames"], want["batches"]) == (
        frames, -(-frames // want["batch_size"]))
