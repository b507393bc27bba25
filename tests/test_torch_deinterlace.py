"""The default restore's pre-SR work that the port lacked (ROADMAP.md C3
and C4), on the CPU against the JAX package: auto-deinterlace
(``InterlaceDetector``, ``YadifDeinterlacer``) and long-form drift
correction (``GlobalAnchors``, ``ColorConsistencyEnforcer``).

The port's copies are the JAX numpy code, so their frames are equal.
Through the restore the bound is ``test_cli_restore_matches_jax_cli``'s
(FW_fast6_x2 on the CPU: max 2 LSB, mean 0.2 LSB a frame). Without the
repair the interlaced clip misses it (the restore with
``deinterlace="off"`` is what the port wrote before) and the long-form
restore cannot be configured."""

import io
import json
import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from framewright_tpu.cli import main as jax_main
from framewright_tpu.config import Config as JaxConfig
from framewright_tpu.engine import temporal as jtemporal
from framewright_tpu.io import y4m as jy4m
from framewright_tpu.processors import film as jfilm
from framewright_tpu.processors import format as jformat
from framewright_tpu.restorer import VideoRestorer as JaxRestorer
from framewright_tpu_torch import cli
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.engine import temporal
from framewright_tpu_torch.processors import film
from framewright_tpu_torch.processors import format as fmt
from framewright_tpu_torch.restorer import VideoRestorer

MAX_LSB, MEAN_LSB = 2, 0.2      # tests/test_torch_slice.py::test_cli_restore_matches_jax_cli
# the drifting clip brightens to outputs in [0.5, 1), where one bf16 step
# of the SR is ~1 LSB (ROADMAP.md C, "uint8 rounding in [0.5, 1)"): the
# SR alone, on the same frames with no pre-SR stage in either package,
# differs by max 2, mean 0.133-0.239 LSB a frame (measured), so the
# long-form restores are held to max 2, mean 0.25
LONG_FORM_MEAN_LSB = 0.25


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _textured(rng, h=48, w=64):
    base = rng.random((h, w)) * 255
    for _ in range(2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                + np.roll(base, (1, 1), (0, 1))) / 4
    return np.stack([base] * 3, -1).astype(np.uint8)


def interlaced_clip(n=8, seed=5):
    """Two fields of a pattern moving 4 px a field (tests/test_format_film.py)."""
    tex = _textured(np.random.default_rng(seed))
    frames = []
    for t in range(n):
        a = np.roll(tex, t * 4, axis=1)
        f = a.copy()
        f[1::2] = np.roll(a, 4, axis=1)[1::2]
        frames.append(f)
    return frames


def progressive_clip(n=8, seed=6):
    tex = _textured(np.random.default_rng(seed))
    return [np.roll(tex, t * 2, axis=1) for t in range(n)]


def drifting_clip(n=40, h=24, w=32, seed=7):
    """Levels and colour drifting over the clip, with seeded noise."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((h // 4 + 1, w // 4 + 1, 3))
    big = np.repeat(np.repeat(coarse, 4, 0), 4, 1)[:h, :w] * 160 + 40
    return [np.clip(big * (0.7 + 0.6 * t / n) + np.array([t, -t / 2, 0.0])
                    + rng.normal(0, 3, big.shape), 0, 255).astype(np.uint8)
            for t in range(n)]


def _write(path: Path, frames) -> Path:
    with jy4m.Y4MWriter(path, frames[0].shape[1], frames[0].shape[0], fps=12) as w:
        for f in frames:
            w.write_frame(f)
    return path


def _planes(path: Path):
    header, rest = path.read_bytes().split(b"\n", 1)
    w, h = (int(re.search(rb" %s(\d+)" % k, header).group(1)) for k in (b"W", b"H"))
    frames = [np.frombuffer(c, np.uint8) for c in rest.split(b"FRAME\n")[1:]]
    assert all(len(f) == w * h * 3 // 2 for f in frames)
    return frames


def _worst(a, b):
    assert len(a) == len(b)
    d = [np.abs(x.astype(np.int16) - y) for x, y in zip(a, b)]
    return max(x.max() for x in d), max(x.mean() for x in d)


# -- the numpy copies: equal ---------------------------------------------

@pytest.mark.parametrize("mode", ["yadif", "bwdif"])
@pytest.mark.parametrize("kind", ["interlaced", "progressive"])
def test_yadif_and_detector_equal_jax(mode, kind):
    frames = interlaced_clip() if kind == "interlaced" else progressive_clip()
    for every in (1, 5):
        want = jformat.InterlaceDetector(sample_every=every).analyze(iter(frames))
        got = fmt.InterlaceDetector(sample_every=every).analyze(iter(frames))
        assert got.__dict__ == want.__dict__
    assert got.interlaced == (kind == "interlaced")
    want = list(jformat.YadifDeinterlacer(mode=mode).process_stream(iter(frames)))
    got = list(fmt.YadifDeinterlacer(mode=mode).process_stream(iter(frames)))
    assert len(got) == len(want) == len(frames)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert fmt.combing_score(got[3]) < fmt.combing_score(frames[3]) or kind == "progressive"


def test_anchors_and_enforcer_equal_jax():
    frames = drifting_clip()
    want = jtemporal.GlobalAnchors.extract(iter(frames), sample_every=8)
    got = temporal.GlobalAnchors.extract(iter(frames), sample_every=8)
    assert got.total_frames == want.total_frames == 40 and len(got.points) == 5
    for g, w in zip(got.points, want.points):
        for k in ("frame_index", "brightness", "contrast", "grain"):
            assert getattr(g, k) == getattr(w, k)
        np.testing.assert_array_equal(g.mean_rgb, w.mean_rgb)
        np.testing.assert_array_equal(g.std_rgb, w.std_rgb)
    je = jtemporal.ColorConsistencyEnforcer(want, 0.5)
    pe = temporal.ColorConsistencyEnforcer(got, 0.5)
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(pe.correct(f, i), je.correct(f, i))
    assert film.estimate_grain_level(frames[3]) == jfilm.estimate_grain_level(frames[3])


# -- through the restore ---------------------------------------------------

def test_default_restore_deinterlaces_like_jax(tmp_path, capsys):
    """Both CLIs with the default flags on the interlaced clip: the
    port's planes within the bound, the report says yadif engaged; the
    same restore without deinterlacing (the port before the repair)
    misses the bound by far."""
    src = _write(tmp_path / "il.y4m", interlaced_clip())
    flags = ["--model", "FW_fast6_x2", "--device", "cpu"]
    assert jax_main(["restore", str(src), "-o", str(tmp_path / "jax.y4m"), *flags,
                     "--project-dir", str(tmp_path / "pj")]) == 0
    capsys.readouterr()
    assert cli.main(["restore", str(src), "-o", str(tmp_path / "port.y4m"), *flags,
                     "--project-dir", str(tmp_path / "pt")]) == 0
    summary = json.loads(capsys.readouterr().out)
    deint = summary["pre_sr"]["deinterlace"]
    assert deint["mode"] == "yadif" and deint["interlaced"] and deint["frames_sampled"] == 2
    report = json.loads((tmp_path / "pt" / "qa_report.json").read_text())
    assert report["pre_sr"]["deinterlace"]["mode"] == "yadif"
    want = _planes(tmp_path / "jax.y4m")
    mx, mean = _worst(_planes(tmp_path / "port.y4m"), want)
    assert mx <= MAX_LSB and mean <= MEAN_LSB, (mx, mean)
    cfg = Config(sr_model="FW_fast6_x2", device_platform="cpu", deinterlace="off",
                 project_dir=tmp_path / "off")
    with contextlib.redirect_stdout(io.StringIO()):
        VideoRestorer(cfg).restore_video(src, tmp_path / "off.y4m")
    mx, mean = _worst(_planes(tmp_path / "off.y4m"), want)
    assert mx > 50 and mean > 5, (mx, mean)


@pytest.mark.parametrize("long_form", [{"long_form": "on", "anchor_interval": 8},
                                       {"long_form": "auto", "long_form_threshold": 30}],
                         ids=["on", "auto"])
def test_long_form_restore_matches_jax(tmp_path, long_form):
    """Both packages' ``VideoRestorer`` on the 40-frame drifting clip
    (the JAX CLI has no ``--anchor-interval``): drift-corrected at each
    frame's global index, planes within max 2 LSB, mean 0.25 (see
    ``LONG_FORM_MEAN_LSB``). ``auto`` at a
    threshold of 30 engages on 40 frames with the default interval of 50:
    one anchor."""
    src = _write(tmp_path / "drift.y4m", drifting_clip())
    common = dict(sr_model="FW_fast6_x2", device_platform="cpu", checkpoint_enabled=False,
                  validate_output=False, **long_form)
    JaxRestorer(JaxConfig(project_dir=tmp_path / "pj", **common)).restore_video(
        src, tmp_path / "jax.y4m")
    res = VideoRestorer(Config(project_dir=tmp_path / "pt", **common)).restore_video(
        src, tmp_path / "port.y4m")
    anchors = 5 if long_form["long_form"] == "on" else 1
    assert res.frames_out == 40 and res.pre_sr["long_form"] == {"anchors": anchors}
    assert res.pre_sr["deinterlace"]["mode"] == "off"
    mx, mean = _worst(_planes(tmp_path / "port.y4m"), _planes(tmp_path / "jax.y4m"))
    assert mx <= MAX_LSB and mean <= LONG_FORM_MEAN_LSB, (mx, mean)
    # the correction changed the frames: a restore without it differs
    off = VideoRestorer(Config(project_dir=tmp_path / "po", **{**common, "long_form": "off"}))
    off.restore_video(src, tmp_path / "off.y4m")
    mx, _ = _worst(_planes(tmp_path / "off.y4m"), _planes(tmp_path / "jax.y4m"))
    assert mx > 10
