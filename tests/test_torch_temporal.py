"""The ``quality`` preset's pre-SR stream as a whole, on the CPU against
the JAX package: cross-frame attention, the flicker reducer, the config
fields and presets (and what the port refuses), the two CLIs with
``--preset quality``, the planner's reservation for the stream, and
resume with the stream on (byte-equal to a straight run)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from framewright_tpu import config as jconfig
from framewright_tpu.cli import main as jax_main
from framewright_tpu.io import y4m as jy4m
from framewright_tpu.processors import temporal_attention as jta
from framewright_tpu.processors import temporal_denoise as jtd
from framewright_tpu_torch import cli, planner
from framewright_tpu_torch.config import PRESETS, Config, build_config, get_preset
from framewright_tpu_torch.engine.checkpoint import CheckpointManager
from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.processors import temporal_attention as ta
from framewright_tpu_torch.processors import temporal_denoise as td
from framewright_tpu_torch.restorer import VideoRestorer, pre_sr_reserve

from test_torch_denoise import noisy_clip

W, H, N = 56, 40, 10


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write(path: Path, frames) -> Path:
    with jy4m.Y4MWriter(path, frames[0].shape[1], frames[0].shape[0], fps=12) as w:
        for f in frames:
            w.write_frame(f)
    return path


def _planes(path: Path):
    header, rest = path.read_bytes().split(b"\n", 1)
    return [np.frombuffer(c, np.uint8) for c in rest.split(b"FRAME\n")[1:]]


# -- cross-frame attention and the flicker reducer -------------------------------

def test_cfa_window_matches_jax():
    """One 3-frame window of 37x53 (edge-padded to 40x56): uint8 within
    1 LSB of JAX's on at most 0.1% of the values (measured: equal)."""
    frames = np.stack([f[:37, :53] for f in noisy_clip(n=3)])
    want = jta.CrossFrameAttention(jta.CFAConfig(radius=1)).process_window(frames)
    got = ta.CrossFrameAttention(ta.CFAConfig(radius=1), device="cpu").process_window(frames)
    assert got.shape == want.shape == (37, 53, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_cfa_stream_and_flicker_reducer_match_jax():
    """Edge-clamped windows over a 12-frame clip with a cut: every frame
    once, within the same bound; the flicker reducer (numpy) exactly."""
    frames = [f[:37, :53] for f in noisy_clip()]
    want = list(jta.CrossFrameAttention(jta.CFAConfig(radius=1)).reduce_stream(iter(frames)))
    got = list(ta.CrossFrameAttention(ta.CFAConfig(radius=1),
                                      device="cpu").reduce_stream(iter(frames)))
    assert len(got) == len(want) == 12
    d = np.abs(np.stack(got).astype(np.int16) - np.stack(want))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    want = list(jtd.FlickerReducer().reduce_stream(iter(frames)))
    got = list(td.FlickerReducer().reduce_stream(iter(frames)))
    assert len(got) == 12 and all(np.array_equal(g, w) for g, w in zip(got, want))


# -- config and presets ---------------------------------------------------------

@pytest.mark.parametrize("name", ["fast", "quality"])
def test_presets_are_jax_presets(name):
    assert get_preset(name) == jconfig.get_preset(name)
    cfg = build_config(name)
    jcfg = jconfig.build_config(preset=name)
    for k in get_preset(name):
        assert getattr(cfg, k) == getattr(jcfg, k), k
    for k in ("denoise_model", "denoise_strength", "temporal_window", "flow_model",
              "scene_threshold", "temporal_model", "long_form", "long_form_threshold",
              "anchor_interval", "long_form_strength", "deinterlace", "preset"):
        assert getattr(cfg, k) == getattr(jcfg, k), k


def test_flags_override_the_preset():
    args = cli.build_parser().parse_args(
        ["restore", "in.y4m", "--preset", "quality", "--denoise-method", "nafnet",
         "--temporal-model", "ema", "--model", "FW_fastvgg_x2", "--device", "cpu"])
    assert (args.preset, args.denoise_model, args.temporal_model) == ("quality", "nafnet", "ema")
    cfg = build_config("quality", cli_overrides={"denoise_model": "nafnet", "temporal_model": "ema",
                                   "sr_model": "FW_fastvgg_x2", "scale_factor": None})
    assert (cfg.denoise, cfg.denoise_model, cfg.temporal_consistency, cfg.temporal_model,
            cfg.sr_model) == (True, "nafnet", True, "ema", "FW_fastvgg_x2")
    assert build_config("", cli_overrides={}).get_hash() == Config().get_hash()


@pytest.mark.parametrize("kwargs,match", [
    # codeformer runs since A9b: an unknown face model is refused instead
    pytest.param({"preset": "archive", "face_restore": True, "face_model": "codeformer2"},
                 "face_model", id="kwargs0-A9"),
    # restormer and raft run since A6c, the ensemble, the cap and guided
    # enhancement since A7: their unknown values are refused instead
    pytest.param({"preset": "ultimate", "denoise": True, "flow_model": "farneback"},
                 "flow_model", id="kwargs1-A6"),
    pytest.param({"denoise": True, "denoise_model": "restormer2"}, "denoise_model",
                 id="kwargs2-A6"),
    pytest.param({"ensemble_strategy": "mean", "sr_ensemble": "FW_fast6_x2"},
                 "ensemble_strategy", id="kwargs3-A6"),
    # the latent model runs since A10b (tests/test_torch_qp_latent.py): an
    # unknown model is refused instead
    pytest.param({"temporal_model": "vae"}, "temporal_model", id="kwargs4-A10"),
    pytest.param({"face_restore": True, "face_model": "restoreformer"}, "face_model",
                 id="kwargs5-A9"),
    pytest.param({"interpolation": True, "max_enhancement_strength": 1.5},
                 "max_enhancement_strength", id="kwargs6-A6"),
    ({"temporal_window": 4}, "odd"),
    ({"deinterlace": "weave"}, "deinterlace"), ({"long_form": "always"}, "long_form"),
])
def test_refusals(kwargs, match):
    with pytest.raises(ConfigError, match=match):
        Config(**kwargs)


def test_archive_preset_refused_by_name():
    """The archive preset runs since slice 9, and with its CodeFormer face
    model since A9b (a missing CodeFormer.npz is an InputError at restore
    time, tests/test_torch_faces.py); an unknown preset is refused by its
    name."""
    assert get_preset("archive")["face_restore"] is True
    cfg = build_config("archive", cli_overrides={"face_model": "codeformer"})
    assert (cfg.face_restore, cfg.face_model, cfg.preset) == (True, "codeformer", "archive")
    with pytest.raises(ConfigError, match="'restore'"):
        build_config("restore", cli_overrides={})
    assert set(PRESETS) == {"fast", "quality", "archive", "ultimate"}


def test_hash_covers_the_new_fields():
    base = Config().get_hash()
    for k, v in (("denoise", True), ("denoise_model", "auto"), ("denoise_strength", 0.6),
                 ("temporal_window", 5), ("scene_threshold", 0.4),
                 ("temporal_consistency", True), ("temporal_model", "ema"),
                 ("deinterlace", "off"), ("long_form", "on"), ("anchor_interval", 8),
                 ("long_form_threshold", 30), ("long_form_strength", 0.3), ("crf", 23),
                 ("preset", "quality")):
        assert Config(**{k: v}).get_hash() != base, k


def test_plan_keeps_the_stream_off_the_sr_batch():
    """The quality stream's reservation at 1080p (the flow net on six
    slots) is taken off the budget before the SR batch is chosen."""
    cfg = build_config("quality")
    res = pre_sr_reserve(cfg, 1080, 1920)
    assert res == planner.pre_sr_bytes(1080, 1920, "auto", "attention") > 0
    assert pre_sr_reserve(Config(), 1080, 1920) == 0
    free = 4 * planner.frame_bytes(1080, 1920, 2, stats=True) // 0.85 + 1
    full = planner.plan(1080, 1920, 2, free_bytes=free, stats=True)
    cut = planner.plan(1080, 1920, 2, free_bytes=free, stats=True, reserved_bytes=res)
    assert (full.batch, cut.batch) == (4, 3)


# -- the restore --------------------------------------------------------------------

@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("clip") / "clip.y4m", noisy_clip(n=N))


def test_cli_quality_preset_matches_jax_cli(tmp_path, clip, capsys):
    """``--preset quality --model FW_fastvgg_x2 --device cpu`` through
    both CLIs: the auto profile picks the temporal denoiser, a scene
    reset at the cut, cross-frame attention, then the SR. Planes within
    the CLI bound of tests/test_torch_slice.py (max 2 LSB, mean 0.2 a
    frame; measured max 1, mean 0.09-0.10)."""
    flags = ["--preset", "quality", "--model", "FW_fastvgg_x2", "--device", "cpu"]
    assert jax_main(["restore", str(clip), "-o", str(tmp_path / "jax.y4m"), *flags,
                     "--project-dir", str(tmp_path / "pj")]) == 0
    capsys.readouterr()
    assert cli.main(["restore", str(clip), "-o", str(tmp_path / "port.y4m"), *flags,
                     "--project-dir", str(tmp_path / "pt")]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["frames"] == N and summary["errors"] == 0
    pre = summary["pre_sr"]
    assert pre["denoise"]["method"] == "temporal" and pre["denoise"]["frames"] == N
    assert pre["denoise"]["scene_resets"] == 1
    assert pre["denoise"]["profile"]["recommended_denoiser"] == "temporal"
    assert pre["temporal_consistency"] == "attention"
    report = json.loads((tmp_path / "pt" / "qa_report.json").read_text())
    assert report["pre_sr"]["denoise"]["profile"] == pre["denoise"]["profile"]
    a, b = _planes(tmp_path / "jax.y4m"), _planes(tmp_path / "port.y4m")
    assert len(a) == len(b) == N
    for x, y in zip(a, b):
        d = np.abs(x.astype(np.int16) - y)
        assert d.max() <= 2 and d.mean() <= 0.2, (d.max(), d.mean())


def _cfg(tmp_path, **kw):
    return Config(project_dir=tmp_path / "proj", sr_model="FW_fastvgg_x2",
                  device_platform="cpu", batch_size=2, denoise=True, denoise_model="auto",
                  temporal_consistency=True, **kw)


class _Stop(Exception):
    pass


def _stop_after(frames):
    def progress(info):
        if info.frames_done >= frames:
            raise _Stop(info.frames_done)
    return progress


@pytest.fixture(scope="module")
def straight(tmp_path_factory, clip):
    tmp = tmp_path_factory.mktemp("straight")
    res = VideoRestorer(_cfg(tmp)).restore_video(clip, tmp / "straight.y4m")
    assert res.frames_out == N and res.pre_sr["denoise"]["scene_resets"] == 1
    return (tmp / "straight.y4m").read_bytes()


def test_stopped_run_resumes_to_the_straight_output(tmp_path, clip, straight):
    """The stream runs from frame 0 on the rerun too (same profile, same
    cut, same attention windows); the ring drops the first 4 frames."""
    out = tmp_path / "o.y4m"
    with pytest.raises(_Stop):
        VideoRestorer(_cfg(tmp_path), _stop_after(4)).restore_video(clip, out)
    res = VideoRestorer(_cfg(tmp_path)).restore_video(clip, out)
    assert res.resumed_from == 4 and res.batches == 3 and res.frames_out == N
    assert res.pre_sr["denoise"]["frames"] == N
    assert out.read_bytes() == straight


def test_kill_with_frames_past_the_checkpoint(tmp_path, clip, straight):
    """7 whole frames and half a frame on disk, a checkpoint at 4."""
    header = straight.index(b"\n") + 1
    frame = 6 + (2 * W) * (2 * H) * 3 // 2
    out = tmp_path / "o.y4m"
    out.write_bytes(straight[:header + 7 * frame + frame // 2])
    cfg = _cfg(tmp_path)
    mgr = CheckpointManager(cfg.checkpoint_dir, cfg.checkpoint_interval)
    mgr.start(clip, cfg.get_hash(), total_frames=N)
    mgr.frames_completed("enhance", 4)
    mgr.force_save()
    res = VideoRestorer(cfg).restore_video(clip, out)
    assert res.resumed_from == 4 and res.frames_out == N
    assert out.read_bytes() == straight
