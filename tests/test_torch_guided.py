"""Guided enhancement in the port (``processors/guided.py``; ``sr_prompt``,
``sr_style_preset``, ``reference_images_dir``; ``--prompt``, ``--style``,
``--reference-dir``) held to ``framewright_tpu.processors.guided``.

The style vectors, presets and every backend's frames equal JAX's bit
for bit (numpy on the host in both, the same seeded generators). A
restore with a prompt writes the SR processor's frames, each through the
backend in order; stopped and resumed, it writes the straight run's
bytes (the backend's generator is carried).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from framewright_tpu.processors import guided as jg
from framewright_tpu_torch import cli
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import ConfigError, InputError
from framewright_tpu_torch.io import y4m
from framewright_tpu_torch.io.png_seq import save_frame
from framewright_tpu_torch.processors import guided as pg
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution
from framewright_tpu_torch.restorer import VideoRestorer

PROMPTS = ["sharp warm cinematic grain", "soft cool muted dark flat clean",
           "vivid bright contrasty anime portrait detail", "grainy golden unknownword"]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(n=3, h=20, w=28, seed=0):
    rng = np.random.default_rng(seed)
    coarse = rng.random((n, h // 4 + 1, w // 4 + 1, 3))
    return (np.repeat(np.repeat(coarse, 4, 1), 4, 2)[:, :h, :w] * 255).astype(np.uint8)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_style_vector_equals_jax(prompt):
    np.testing.assert_array_equal(pg.parse_style(prompt), jg.parse_style(prompt))
    assert pg.STYLE_PRESETS == jg.STYLE_PRESETS and pg.STYLE_DIM == jg.STYLE_DIM


@pytest.mark.parametrize("preset,prompt", [("", PROMPTS[0]), ("vintage", ""),
                                           ("natural", PROMPTS[1]), ("anime", PROMPTS[2])])
def test_classical_backend_equals_jax(preset, prompt):
    """Three frames in turn (the grain generator advances per frame)."""
    kw = dict(prompt=prompt, preset=preset, strength=0.7, seed=5)
    jb, pb = jg.ClassicalGuidedBackend(jg.GuidedConfig(**kw)), \
        pg.ClassicalGuidedBackend(pg.GuidedConfig(**kw))
    for f in _frames():
        np.testing.assert_array_equal(pb.enhance(f), jb.enhance(f))


@pytest.fixture
def stills(tmp_path):
    d = tmp_path / "refs"
    for i, f in enumerate(_frames(3, 24, 20, seed=9)):
        save_frame(d / f"ref_{i}.png", f)
    return d


def test_reference_chain_equals_jax(stills):
    cfg = dict(prompt="warm grain", strength=0.5, seed=2)
    jb = jg.make_backend(jg.GuidedConfig(**cfg), reference_dir=str(stills))
    pb = pg.make_backend(pg.GuidedConfig(**cfg), reference_dir=str(stills))
    for f in _frames(seed=4):
        np.testing.assert_array_equal(pb.enhance(f), jb.enhance(f))
    ref = pg.ReferenceGuidedBackend(stills, strength=0.5, seed=2)
    jref = jg.ReferenceGuidedBackend(stills, strength=0.5, seed=2)
    np.testing.assert_allclose(ref.ref_mean, jref.ref_mean, rtol=0, atol=0)
    assert ref.ref_grain == jref.ref_grain


def test_refusals(tmp_path):
    # the diffusion backend runs since A8 (tests/test_torch_diffusion.py);
    # colorize runs since A10b-1, but not with exemplar in a restore
    assert Config(colorize=True).colorize_model == "ddcolor"
    with pytest.raises(ConfigError, match="exemplar needs a reference image"):
        Config(colorize=True, colorize_model="exemplar")
    with pytest.raises(InputError, match="no reference images"):
        pg.ReferenceGuidedBackend(tmp_path)
    with pytest.raises(ConfigError, match="sr_style_preset"):
        Config(sr_style_preset="noir")
    with pytest.raises(ConfigError, match="guidance_scale"):
        Config(guidance_scale=0.0)


def _clip(path: Path, n: int = 6) -> Path:
    frames = _frames(n, 16, 24, seed=1)
    with y4m.Y4MWriter(path, 24, 16, fps=12) as w:
        for f in frames:
            w.write_frame(f)
    return path


def _cli(tmp_path, src, out, *extra):
    return cli.main(["restore", str(src), "-o", str(out), "--model", "FW_fastvgg_x2",
                     "--device", "cpu", "--project-dir", str(tmp_path / out.stem), *extra])


def test_cli_prompt_restore_is_the_backend_on_the_sr_frames(tmp_path, stills, capsys):
    """``--prompt`` (``--style``, ``--reference-dir``) on the CPU: the
    output frames are the SR processor's RGB frames of the source, each
    through the backend (seeded by the config's seed) in order, written
    by the Y4M writer."""
    src = _clip(tmp_path / "c.y4m")
    assert _cli(tmp_path, src, tmp_path / "g.y4m", "--prompt", "sharp warm cinematic grain",
                "--style", "vintage", "--reference-dir", str(stills)) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["frames"] == 6 and out["post_sr"]["guided"]["preset"] == "vintage"
    assert out["pre_sr"]["deinterlace"]["mode"] == "off"
    backend = pg.make_backend(pg.GuidedConfig(prompt="sharp warm cinematic grain",
                                              preset="vintage", strength=0.5),
                              reference_dir=str(stills))
    sr = SuperResolution(SRConfig(model_name="FW_fastvgg_x2", device="cpu"))
    sr.setup(16, 24)
    with y4m.Y4MReader(src) as r:
        frames = np.stack(list(r))
    n = sr.plan.frames
    with y4m.Y4MWriter(tmp_path / "want.y4m", 48, 32, fps=12) as w:
        for i in range(0, len(frames), n):
            for f in sr.materialize(sr.dispatch(frames[i:i + n])):
                w.write_frame(backend.enhance(f))
    assert (tmp_path / "g.y4m").read_bytes() == (tmp_path / "want.y4m").read_bytes()


class _Stop(Exception):
    pass


def test_guided_grain_resumes_to_the_straight_output(tmp_path):
    """A prompt with grain draws from the backend's generator each frame;
    a run stopped after its first batch resumes with the straight run's
    generator state (carried in the checkpoint)."""
    src = _clip(tmp_path / "c.y4m", 8)

    def cfg(proj):
        return Config(sr_model="FW_fastvgg_x2", device_platform="cpu", batch_size=2,
                      sr_prompt="film grain", project_dir=tmp_path / proj)

    VideoRestorer(cfg("s")).restore_video(src, tmp_path / "straight.y4m")

    def stop(info):
        if info.frames_done >= 4:
            raise _Stop()

    out = tmp_path / "o.y4m"
    with pytest.raises(_Stop):
        VideoRestorer(cfg("r"), stop).restore_video(src, out)
    res = VideoRestorer(cfg("r")).restore_video(src, out)
    assert res.resumed_from == 4 and res.frames_out == 8
    assert out.read_bytes() == (tmp_path / "straight.y4m").read_bytes()
