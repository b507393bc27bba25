"""The ``archive`` and ``ultimate`` presets in the port against the JAX
package: the configs they build, an archive restore through the CLI
(RealESRGAN_x4plus with dedup's drop mode, the auto-profiled denoiser,
cross-frame attention, defect repair, faces and interpolation) held to
the JAX restore around the same SR, an ultimate restore (grain after the
gate), and the refusal without the checkpoints."""

from __future__ import annotations

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

import framewright_tpu.restorer as jrestorer
from framewright_tpu.config import Config as JaxConfig
from framewright_tpu.models import gfpgan as jgfpgan
from framewright_tpu.models import ifnet as jifnet
from framewright_tpu.models.torch_port import export_npz
from framewright_tpu_torch import cli
from framewright_tpu_torch.config import PRESETS, Config, build_config
from framewright_tpu_torch.errors import InputError
from framewright_tpu_torch.restorer import VideoRestorer
from test_torch_film import _PortSR
from test_torch_interpolation import _planes, _write, smooth_frame

TINY = dict(out_size=64, num_style_feat=64, channel_multiplier=1, num_mlp=2, narrow=0.25)


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch, tmp_path):
    # the JAX package's default weights directory: empty (its random
    # stand-ins, the skin detector)
    monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(tmp_path / "default_weights"))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The draws a JAX restore without checkpoints runs, as the port's
    checkpoints: IFNet ``ifnet.init(PRNGKey(0))``, GFPGAN's 64-pixel
    stand-in ``gfpgan.init(PRNGKey(6), ...)``."""
    wdir = tmp_path_factory.mktemp("weights")
    tree = lambda p: jax.tree_util.tree_map(np.asarray, p)      # noqa: E731
    export_npz(tree(jifnet.init(jax.random.PRNGKey(0), jifnet.IFNetConfig())),
               wdir / "rife-v4.6.npz")
    export_npz(tree(jgfpgan.init(jax.random.PRNGKey(6), jgfpgan.GFPGANConfig(**TINY))),
               wdir / "GFPGANv1.4.npz")
    return wdir


def archive_clip(n: int = 8, h: int = 16, w: int = 24):
    """18 fps padded to 24 (every fourth frame a repeat), smooth waves
    panning, a skin-coloured patch moving 1 px a unique frame."""
    frames = []
    for t in range(n):
        u = t - (t + 1) // 4
        f = smooth_frame(h, w, u).copy()
        f[3:12, 4 + u:11 + u] = (205, 150, 125)
        frames.append(f)
    return frames


@pytest.mark.parametrize("preset", ["archive", "ultimate"])
def test_presets_build_the_jax_config(preset):
    """Every field the port has takes the JAX preset's value, and the
    port's restore runs what the preset switches on."""
    cfg, jcfg = build_config(preset), JaxConfig.from_preset(preset)
    port_fields = set(cfg.to_dict()) - {"weights_dir", "max_frames", "device_platform"}
    for name in port_fields:
        want = getattr(jcfg, name)
        got = getattr(cfg, name)
        assert (str(got) if hasattr(want, "parts") else got) == \
            (str(want) if hasattr(want, "parts") else want), name
    assert cfg.interpolation and cfg.face_restore and cfg.deduplicate
    assert cfg.sr_model == "RealESRGAN_x4plus" and cfg.face_model == "gfpgan"
    assert set(PRESETS) == {"fast", "quality", "archive", "ultimate"}


def test_archive_without_checkpoints_raises_input_error(tmp_path):
    """No random IFNet or GFPGAN: both missing files named, nothing run."""
    src = _write(tmp_path / "a.y4m", archive_clip(4))
    cfg = build_config("archive", cli_overrides={"weights_dir": tmp_path / "none", "device_platform": "cpu",
                                   "project_dir": tmp_path / "p"})
    with pytest.raises(InputError) as err:
        VideoRestorer(cfg).restore_video(src, tmp_path / "o.y4m")
    assert "rife-v4.6.npz" in str(err.value) and "GFPGANv1.4.npz" in str(err.value)
    assert not (tmp_path / "p").exists()


def test_archive_cli_restore_against_jax(tmp_path, monkeypatch, capsys, weights):
    """``--preset archive`` through the port's CLI (RealESRGAN_x4plus,
    seeded random weights) against the JAX restore of the same config
    with the port's SR in its place: the same frames, rate and dedup; the
    written planes within the modules' own bound (the denoiser's, the
    attention's and IFNet's: 1 LSB on <= 0.1% of the values; measured:
    max 1 on 0.001% of the values)."""
    src = _write(tmp_path / "a.y4m", archive_clip())
    rc = cli.main(["restore", str(src), "-o", str(tmp_path / "port.y4m"), "--preset", "archive",
                   "--device", "cpu", "--weights-dir", str(weights),
                   "--project-dir", str(tmp_path / "pt")])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    monkeypatch.setattr(jrestorer, "SuperResolution", _PortSR)
    with contextlib.redirect_stdout(io.StringIO()):
        jres = jrestorer.VideoRestorer(JaxConfig.from_preset(
            "archive", project_dir=tmp_path / "pj", checkpoint_enabled=False))\
            .restore_video(src, tmp_path / "jax.y4m")
    assert summary["frames"] == jres.frames_out == 11
    assert summary["output_fps"] == 36.0 and summary["duplicates_removed"] == 2
    # random x4plus outputs hold no skin for the detector: faces run, find none
    assert summary["interpolation"]["factor"] == 2 and summary["faces_restored"] == 0
    assert summary["pre_sr"]["denoise"]["method"] and summary["errors"] == 0
    header, got = _planes(tmp_path / "port.y4m")
    jheader, want = _planes(tmp_path / "jax.y4m")
    assert header == jheader and b"W96 H64" in header
    d = np.abs(np.stack(got).astype(np.int16) - np.stack(want))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def test_ultimate_restore_runs_with_grain_after_faces(tmp_path, weights):
    """``ultimate`` (FW_fast6_x2 in place of x4plus, for time): grain
    ``match`` after the gate, faces and interpolation; the intermediate
    removed, the checkpoint too."""
    src = _write(tmp_path / "a.y4m", archive_clip(), fps=24)
    cfg = build_config("ultimate", cli_overrides={"sr_model": "FW_fast6_x2", "scale_factor": 2,
                                    "device_platform": "cpu", "weights_dir": weights,
                                    "project_dir": tmp_path / "p"})
    with contextlib.redirect_stdout(io.StringIO()):
        res = VideoRestorer(cfg).restore_video(src, tmp_path / "o.y4m")
    assert res.post_sr["grain"]["mode"] == "match" and res.faces_restored > 0
    assert res.frames_out == 11 and res.output_fps == 36.0
    assert not (tmp_path / "p" / "work" / "enhanced.y4m").exists()
    assert json.loads((tmp_path / "p" / "qa_report.json").read_text())["faces_restored"] > 0
