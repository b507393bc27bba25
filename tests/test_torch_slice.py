"""Slice 1 of the PyTorch port as a whole, on the CPU: the restore
entry point against the JAX package's, the port's own Y4M, ring,
planner and config pieces, and the rule that the port imports neither
jax nor framewright_tpu."""

import ast
import json
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from framewright_tpu.cli import main as jax_main
from framewright_tpu.io import y4m as jy4m
from framewright_tpu_torch import cli, planner
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import ConfigError, DeviceError, HBMError, InputError
from framewright_tpu_torch.hw import resolve_device
from framewright_tpu_torch.io import y4m
from framewright_tpu_torch.io.ring import PrefetchRing, WriterDrain

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _clip(path: Path, gradient_frame, n=3, w=64, h=48):
    with jy4m.Y4MWriter(path, w, h, fps=12) as wr:
        for t in range(n):
            wr.write_frame(gradient_frame(h, w, t))
    return path


def _planes(path: Path):
    data = path.read_bytes()
    header, rest = data.split(b"\n", 1)
    w = int(re.search(rb" W(\d+)", header).group(1))
    h = int(re.search(rb" H(\d+)", header).group(1))
    n = w * h * 3 // 2
    frames = []
    for chunk in rest.split(b"FRAME\n")[1:]:
        assert len(chunk) == n
        frames.append(np.frombuffer(chunk, np.uint8))
    return header, frames


class TestRestoreParity:
    @pytest.mark.parametrize("w,h,cs", [(64, 48, "420jpeg"), (33, 25, "mono")])
    def test_cli_restore_matches_jax_cli(self, tmp_path, gradient_frame, capsys,
                                         w, h, cs):
        """FW_fast6_x2 (the repository's trained weights, the default
        model's RRDB code path at 6 blocks) on a 4:2:0 clip, and on an
        odd-sized mono clip that the SR stage pads to the body divisor and
        crops back. Tolerance: max 2 LSB, mean 0.2 LSB. Measured since the
        port decodes 4:2:0 with the JAX reader's fixed-point arithmetic:
        max 2, mean 0.1267-0.1675 per frame on these clips (the remaining
        difference is the bf16 kernel paths' rounding, not the decode)."""
        src = tmp_path / "clip.y4m"
        with jy4m.Y4MWriter(src, w, h, fps=12, colorspace=cs) as wr:
            for t in range(3):
                wr.write_frame(gradient_frame(h, w, t))
        flags = ["--model", "FW_fast6_x2", "--device", "cpu"]
        assert jax_main(["restore", str(src), "-o", str(tmp_path / "jax.y4m"), *flags,
                         "--project-dir", str(tmp_path / "pj")]) == 0
        capsys.readouterr()
        assert cli.main(["restore", str(src), "-o", str(tmp_path / "port.y4m"), *flags,
                         "--project-dir", str(tmp_path / "pt")]) == 0
        summary = json.loads(capsys.readouterr().out)
        assert summary["frames"] == 3 and summary["batches"] >= 1
        hj, fj = _planes(tmp_path / "jax.y4m")
        hp, fp = _planes(tmp_path / "port.y4m")
        assert hj == hp == f"YUV4MPEG2 W{2 * w} H{2 * h} F12:1 Ip A1:1 C420jpeg".encode()
        assert len(fj) == len(fp) == 3
        for a, b in zip(fj, fp):
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 2 and d.mean() <= 0.2, (d.max(), d.mean())

    def test_max_frames_and_batches(self, tmp_path, gradient_frame, capsys):
        # 6 frames cut to 5: one batch of 4 (the default cap) and one of 1,
        # so the one-in-flight pipeline hands over between batches
        src = _clip(tmp_path / "clip.y4m", gradient_frame, n=6, w=32, h=24)
        out = tmp_path / "o.y4m"
        assert cli.main(["restore", str(src), "-o", str(out), "--model", "FW_fast6_x2",
                         "--device", "cpu", "--max-frames", "5",
                         "--project-dir", str(tmp_path / "p")]) == 0
        summary = json.loads(capsys.readouterr().out)
        assert (summary["frames"], summary["batches"], summary["batch_size"]) == (5, 2, 4)
        with y4m.Y4MReader(out) as r:
            assert (r.width, r.height, r.count_frames()) == (64, 48, 5)

    def test_rgb_path_for_a_writer_that_is_not_420(self, tmp_path, gradient_frame,
                                                   monkeypatch):
        """A writer that is not 4:2:0 gets uint8 RGB from the SR stage
        (``write_frame``), the same path as the YUV-direct one otherwise."""
        import functools

        from framewright_tpu_torch import restorer

        monkeypatch.setattr(restorer, "Y4MWriter",
                            functools.partial(y4m.Y4MWriter, colorspace="444"))
        src = _clip(tmp_path / "clip.y4m", gradient_frame, n=2, w=32, h=24)
        cfg = Config(sr_model="FW_fast6_x2", device_platform="cpu",
                     project_dir=tmp_path)
        res = restorer.VideoRestorer(cfg).restore_video(src, tmp_path / "rgb.y4m")
        assert res.frames_out == 2
        with y4m.Y4MReader(tmp_path / "rgb.y4m") as r:
            assert r.header.colorspace == "444" and (r.width, r.height) == (64, 48)
            rgb = np.stack(list(r))
        # the same frames through the YUV-direct path, decoded to RGB
        res = restorer.VideoRestorer(Config(sr_model="FW_fast6_x2", device_platform="cpu",
                                            project_dir=tmp_path)).restore_video(
            src, tmp_path / "yuv.y4m")
        with jy4m.Y4MReader(tmp_path / "yuv.y4m") as r:
            yuv_rgb = np.stack(list(r))
        d = np.abs(rgb.astype(int) - yuv_rgb.astype(int))
        assert d.mean() < 4.0      # 4:4:4 vs 4:2:0 chroma, the same picture

    def test_errors_exit_1(self, tmp_path, gradient_frame, capsys):
        assert cli.main(["restore", str(tmp_path / "nope.y4m"), "--device", "cpu",
                         "--project-dir", str(tmp_path / "p")]) == 1
        assert "source not found" in capsys.readouterr().err
        src = _clip(tmp_path / "clip.y4m", gradient_frame, n=1)
        assert cli.main(["restore", str(src), "--model", "nope", "--device", "cpu"]) == 1
        assert "Unknown model" in capsys.readouterr().err

    def test_cuda_without_a_card_raises(self, tmp_path, gradient_frame, capsys):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks the refusal without one")
        with pytest.raises(DeviceError):
            resolve_device("cuda")
        src = _clip(tmp_path / "clip.y4m", gradient_frame, n=1)
        assert cli.main(["restore", str(src), "-o", str(tmp_path / "o.y4m"),
                         "--model", "FW_fast6_x2", "--project-dir", str(tmp_path)]) == 1
        assert "no CUDA device" in capsys.readouterr().err


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_and_nothing_of_framewright_tpu():
    files = sorted((ROOT / "framewright_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    # the pre-SR stream's modules among them
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {f"framewright_tpu_torch/{m}.py" for m in (
        "processors/base", "processors/scene_detection", "processors/noise_profiler",
        "processors/format", "processors/film", "processors/temporal_denoise",
        "processors/temporal_attention", "engine/temporal", "models/ifnet",
        "models/nafnet", "ops/warp")} <= names
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "framewright_tpu"), (path, name)
        # and no importlib trick naming them
        text = path.read_text()
        assert not re.search(r"import_module\(\s*['\"](jax|framewright_tpu)\b", text), path


class TestY4M:
    def test_port_writer_read_by_jax_reader(self, tmp_path, gradient_frame):
        frames = [gradient_frame(24, 32, t) for t in range(2)]
        with y4m.Y4MWriter(tmp_path / "a.y4m", 32, 24, fps=Fraction(30000, 1001)) as w:
            for f in frames:
                w.write_frame(f)
        with jy4m.Y4MWriter(tmp_path / "b.y4m", 32, 24, fps=Fraction(30000, 1001)) as w:
            for f in frames:
                w.write_frame(f)
        a, b = (tmp_path / "a.y4m").read_bytes(), (tmp_path / "b.y4m").read_bytes()
        # the JAX package encodes with its native library, the port with
        # the same integer arithmetic in numpy: the files are equal
        assert a == b

    def test_colour_math_is_the_jax_numpy_math(self, gradient_frame):
        """Chroma that is not 4:2:0 at even sizes decodes with the float
        math of framewright_tpu.io.color, as the JAX reader does."""
        from framewright_tpu.io import color

        rgb = gradient_frame(24, 32, 3)
        for full in (False, True):
            y, u, v = color.rgb_to_yuv420(rgb, full_range=full)
            u444, v444 = (np.repeat(np.repeat(c, 2, 0), 2, 1) for c in (u, v))
            np.testing.assert_array_equal(y4m.yuv_to_rgb(y, u444, v444, full_range=full),
                                          color.yuv420_to_rgb(y, u444, v444, full_range=full))

    @staticmethod
    def _native():
        from framewright_tpu import native

        if not native.available():
            pytest.skip("framewright_tpu.native did not load (native/libfwcore.so)")
        return native

    @pytest.mark.parametrize("full", [False, True])
    def test_420_decode_is_the_native_decode(self, full):
        """640x480 random legal-range planes: the port's 4:2:0 decode
        equals native/fwcore.cpp's fixed-point one exactly."""
        native = self._native()
        rng = np.random.default_rng(1)
        y = rng.integers(16, 236, (480, 640), dtype=np.uint8)
        u, v = (rng.integers(16, 241, (240, 320), dtype=np.uint8) for _ in range(2))
        np.testing.assert_array_equal(y4m.yuv_to_rgb(y, u, v, full_range=full),
                                      native.yuv420_to_rgb(y, u, v, full_range=full))

    @pytest.mark.parametrize("full", [False, True])
    def test_420_encode_is_the_native_encode(self, full):
        native = self._native()
        rgb = np.random.default_rng(1).integers(0, 256, (480, 640, 3), dtype=np.uint8)
        for a, b in zip(y4m.rgb_to_yuv420(rgb, full_range=full),
                        native.rgb_to_yuv420(rgb, full_range=full)):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("cs", ["420jpeg", "420mpeg2", "444", "mono"])
    def test_reader_matches_jax_reader(self, tmp_path, gradient_frame, cs):
        path = tmp_path / "c.y4m"
        with jy4m.Y4MWriter(path, 32, 24, fps=25, colorspace=cs) as w:
            for t in range(3):
                w.write_frame(gradient_frame(24, 32, t))
        with jy4m.Y4MReader(path) as a, y4m.Y4MReader(path) as b:
            assert a.header.to_line() == b.header.to_line() and b.count_frames() == 3
            for fa, fb in zip(a, b):
                np.testing.assert_array_equal(fa, fb)   # the native decode's arithmetic

    def test_write_yuv_frame_checks_shapes(self, tmp_path):
        with y4m.Y4MWriter(tmp_path / "d.y4m", 8, 4) as w:
            w.write_yuv_frame(np.zeros((4, 8), np.uint8), np.zeros((2, 4), np.uint8),
                              np.zeros((2, 4), np.uint8))
            with pytest.raises(InputError):
                w.write_yuv_frame(np.zeros((4, 8), np.uint8), np.zeros((4, 4), np.uint8),
                                  np.zeros((2, 4), np.uint8))
        with pytest.raises(InputError):
            y4m.Y4MWriter(tmp_path / "e.y4m", 7, 4)

    def test_bad_stream(self, tmp_path):
        (tmp_path / "bad.y4m").write_bytes(b"NOTY4M W2 H2\n")
        with pytest.raises(InputError):
            y4m.Y4MReader(tmp_path / "bad.y4m")


class TestRing:
    def test_batches_and_padding(self):
        frames = [np.full((2, 2, 3), i, np.uint8) for i in range(7)]
        ring = PrefetchRing(iter(frames), batch_size=3)
        got = list(ring)
        ring.close()
        assert [b.valid for b in got] == [3, 3, 1]
        assert [b.start_frame for b in got] == [0, 3, 6]
        assert got[-1].frames.shape[0] == 3 and int(got[-1].frames[-1, 0, 0, 0]) == 6

    def test_drain_writes_in_order(self):
        out = []
        drain = WriterDrain(out.append, depth=2)
        for i in range(5):
            drain.submit([i, i + 100], 1)
        drain.close()
        assert out == [0, 1, 2, 3, 4]

    def test_producer_error_surfaces(self):
        def bad():
            yield np.zeros((2, 2, 3), np.uint8)
            raise InputError("decode failed")

        ring = PrefetchRing(bad(), batch_size=4)
        with pytest.raises(InputError, match="decode failed"):
            list(ring)
        ring.close()


class TestPlanner:
    def test_body_divisor(self):
        assert [planner.body_divisor("rrdb", s) for s in (1, 2, 4)] == [4, 2, 1]

    def test_batch_from_free_memory(self):
        per = planner.frame_bytes(1080, 1920, 2)
        p = planner.plan(1080, 1920, 2, free_bytes=int(per * 5.5), utilization=1.0)
        assert p.batch == 5 and p.body_divisor == 2
        assert planner.plan(1080, 1920, 2, free_bytes=per * 100, max_batch=4).batch == 4

    def test_downshift_and_refusal(self):
        p = planner.plan(64, 64, 2, free_bytes=10**12, max_batch=4)
        assert p.downshift().batch == 2 and p.downshift().downshift().batch == 1
        with pytest.raises(HBMError):
            p.downshift().downshift().downshift()
        with pytest.raises(HBMError):
            planner.plan(2160, 3840, 2, free_bytes=2**20)


class TestConfig:
    def test_defaults_follow_the_jax_config(self):
        from framewright_tpu.config import Config as JaxConfig

        ours, theirs = Config(), JaxConfig()
        for name in ("scale_factor", "sr_model", "batch_size",
                     "compute_dtype", "device_platform", "hbm_utilization",
                     "project_dir", "output_path", "checkpoint_enabled",
                     "checkpoint_interval", "resume", "max_runtime_minutes",
                     "validate_output", "min_ssim", "min_psnr", "min_vmaf",
                     "continue_on_error", "quality_report_format", "checkpoint_dir"):
            assert getattr(ours, name) == getattr(theirs, name), name

    @pytest.mark.parametrize("kw", [dict(sr_model="nope"), dict(compute_dtype="float16"),
                                    dict(scale_factor=4), dict(max_frames=-1),
                                    dict(device_platform="tpu"), dict(hbm_utilization=0),
                                    dict(checkpoint_interval=0), dict(min_vmaf=1.0),
                                    dict(quality_report_format="xml")])
    def test_rejects(self, kw):
        with pytest.raises(ConfigError):
            Config(**kw)


class TestOOMDownshift:
    """A device out-of-memory halves the batch and reruns the frames;
    at batch 1 it raises HBMError. The OOM is raised by a stand-in for
    the model, since the CPU has no device memory to exhaust."""

    @pytest.fixture
    def sr(self):
        from framewright_tpu_torch.processors.super_resolution import (
            SRConfig,
            SuperResolution,
        )

        sr = SuperResolution(SRConfig(model_name="FW_fast6_x2", device="cpu",
                                      batch_size=4, output_color="yuv420"))
        sr.setup(24, 32)
        assert sr.plan.batch == 4
        return sr

    def _oom_above(self, sr, monkeypatch, limit):
        real = sr.model.apply_fast
        calls = []

        def apply_fast(x, *a, **k):
            calls.append(x.shape[0])
            if x.shape[0] > limit:
                raise torch.cuda.OutOfMemoryError("device out of memory")
            return real(x, *a, **k)

        monkeypatch.setattr(sr.model, "apply_fast", apply_fast)
        return calls

    def test_halves_batch_and_reruns(self, sr, monkeypatch, gradient_frame):
        frames = np.stack([gradient_frame(24, 32, t) for t in range(4)])
        want = sr.materialize(sr.dispatch(frames))
        calls = self._oom_above(sr, monkeypatch, 2)
        got = sr.materialize(sr.dispatch(frames))
        assert sr.plan.batch == 2 and calls == [4, 2, 2]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_raises_at_batch_one(self, sr, monkeypatch, gradient_frame):
        frames = np.stack([gradient_frame(24, 32, t) for t in range(2)])
        self._oom_above(sr, monkeypatch, 0)
        with pytest.raises(HBMError):
            sr.materialize(sr.dispatch(frames))
