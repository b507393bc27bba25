"""The recipe table and executor's pre-stages, the natural-language
parser and the setup wizard on the CPU against the JAX package: the same
table, the same configs (every field both packages have; the port's
``scale_factor`` is the model's), the same parsed phrases and plans, the
same staged frames, the same wizard configs for the same answers."""

import dataclasses
import json

import numpy as np
import pytest

import framewright_tpu.recipes as jrecipes
from framewright_tpu import config as jconfig
from framewright_tpu import nlp as jnlp
from framewright_tpu import wizard as jwizard
from framewright_tpu.io import open_reader as jopen_reader
from framewright_tpu.io import open_writer as jopen_writer
from framewright_tpu_torch import nlp, recipes, wizard
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.io.y4m import Y4MWriter
from framewright_tpu_torch.models.registry import MODEL_SPECS

SHARED = sorted({f.name for f in dataclasses.fields(jconfig.Config)}
                & {f.name for f in dataclasses.fields(Config)} - {"work_dir", "checkpoint_dir"})


def _norm(v):
    return json.loads(json.dumps(str(v) if hasattr(v, "__fspath__") else v))


def assert_same_config(cfg: Config, jcfg) -> None:
    """Every field both packages have alike; ``scale_factor`` is the
    model's in the port (JAX keeps another and writes the model's)."""
    for name in SHARED:
        if name == "scale_factor":
            assert cfg.scale_factor == MODEL_SPECS[cfg.sr_model].scale
            if jcfg.scale_factor != MODEL_SPECS[jcfg.sr_model].scale:
                continue
        assert _norm(getattr(cfg, name)) == _norm(getattr(jcfg, name)), name


# -- recipes -----------------------------------------------------------------------------

def jax_description(name: str) -> str:
    """JAX's description as the port words it: no TPU rate."""
    return jrecipes.RECIPES[name].description.replace("(22 fps/chip; ", "(")


def test_recipe_table_equals_jax():
    """JAX's table; ``realtime_preview``'s description without JAX's TPU
    rate."""
    assert list(recipes.RECIPES) == list(jrecipes.RECIPES)
    for name, r in recipes.RECIPES.items():
        want = dataclasses.replace(jrecipes.RECIPES[name], description=jax_description(name))
        assert dataclasses.asdict(r) == dataclasses.asdict(want), name
    assert "fps" not in recipes.RECIPES["realtime_preview"].description


@pytest.mark.parametrize("name", sorted(jrecipes.RECIPES))
def test_recipe_config_equals_jax(name):
    assert_same_config(recipes.recipe_config(name, crf=21), jrecipes.recipe_config(name, crf=21))


def test_youtube_ready_runs_at_its_models_scale():
    cfg, jcfg = recipes.recipe_config("youtube_ready"), jrecipes.recipe_config("youtube_ready")
    assert (cfg.scale_factor, jcfg.scale_factor, cfg.outscale) == (4, 2, 2.0)


def test_unknown_recipe_and_stage():
    with pytest.raises(ConfigError, match="Unknown recipe 'nope'"):
        recipes.get_recipe("nope")
    with pytest.raises(ConfigError, match="pre-stage 'warp'"):
        recipes.RecipeExecutor._wrap_stage("warp", iter([]))


def _vhs_clip(path, n=6, h=32, w=48, seed=5):
    """Texture with a bright tracking line, a dropout streak and combing
    (VHS repair, yadif and the telecine detector all have work)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    with Y4MWriter(path, w, h, fps=24) as wr:
        for t in range(n):
            base = 110 + 60 * np.sin(x / 4 + t) * np.cos(y / 5)
            f = np.stack([base, base * 0.9 + 15, base * 0.7 + 30], -1)
            f[1::2] += 25 * np.sin(x[1::2] / 2 + t)[..., None]    # combing
            f[(7 * t) % h] = 250                                  # a tracking line
            f[5, (3 * t) % w:(3 * t) % w + 6] = 255               # a dropout
            f += rng.normal(0, 3, f.shape)
            wr.write_frame(np.clip(f, 0, 255).astype(np.uint8))
    return path


def _jax_prestaged(recipe, source, dst):
    """The JAX executor's pre-stage stream into ``dst`` (its ``execute``
    without the restore)."""
    with jopen_reader(source) as r:
        stream = iter(r)
        for stage in recipe.pre_stages:
            stream = jrecipes.RecipeExecutor._wrap_stage(stage, stream)
        w = jopen_writer(dst, r.width, r.height, fps=r.fps)
        for frame in stream:
            w.write_frame(frame)
        w.close()
    return dst


@pytest.mark.parametrize("name", sorted(n for n, r in jrecipes.RECIPES.items() if r.pre_stages))
def test_prestaged_file_equals_jax(tmp_path, name):
    """Each recipe's pre-stages into the staged Y4M (JAX's 4:2:0 round
    trip): equal to JAX's file; after the gate-weave stabilizer, whose
    frames are within 1 LSB of JAX's (tests/test_torch_film.py), the
    file's planes within 1 LSB."""
    src = _vhs_clip(tmp_path / "src.y4m")
    got = recipes.RecipeExecutor(recipes.get_recipe(name), tmp_path / "p",
                                 device="cpu").prestage(src)
    assert got == tmp_path / "p" / "work" / "prestaged.y4m"
    want = _jax_prestaged(jrecipes.RECIPES[name], src, tmp_path / "jax.y4m")
    if "gate_weave" not in recipes.RECIPES[name].pre_stages:
        assert got.read_bytes() == want.read_bytes()
        return
    a, b = (np.frombuffer(p.read_bytes(), np.uint8).astype(np.int16) for p in (got, want))
    assert a.shape == b.shape and np.abs(a - b).max() <= 1


def test_recipe_without_prestages_restores_the_source(tmp_path):
    ex = recipes.RecipeExecutor(recipes.get_recipe("realtime_preview"), tmp_path, device="cpu")
    assert ex.prestage(tmp_path / "a.y4m") == tmp_path / "a.y4m"
    cfg = ex.config()
    assert (cfg.device_platform, cfg.project_dir, cfg.sr_model) == ("cpu", tmp_path,
                                                                     "FW_fastvgg_x2")


# -- the natural-language parser ---------------------------------------------------------

PHRASES = [
    # tests/test_presets_nlp.py:69-128
    "please restore my old VHS tape recording.mp4",
    "upscale 4x and interpolate to 60fps",
    "colorize this black and white film and fix faces",
    "clean it up but preserve the film grain",
    "quick 2x upscale of video.y4m with denoising",
    "remaster this anime series",
    "restore movie.y4m with hdr10+ output",
    "remove the compression artifacts from dvd.y4m",
    "fix faces with codeformer in old.y4m",
    "scene-aware restore with accurate flow",
    # more
    "make the anime cartoon 2x sharper",
    "double the resolution of holiday.mkv and stabilize the shaky parts",
    "restore my super 8 home movie film.avi",
    "silent film from the 1920s, remove duplicate frames and flicker",
    "deinterlace the combing in tape.mov then upscale to 4k",
    "best quality archival master at 1080p",
    "remove the watermark and logo, then ensemble upscale x4",
    "fast draft in hdr of clip.webm at 30 fps",
    "nothing to parse here",
    "denoise the grainy dvd rip and adapt per scene",
]


@pytest.mark.parametrize("text", PHRASES)
def test_parse_command_equals_jax(text):
    got, want = nlp.parse_command(text), jnlp.parse_command(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.describe() == want.describe()


@pytest.mark.parametrize("text", PHRASES)
def test_build_config_from_text_equals_jax(text, tmp_path):
    cfg, cmd = nlp.build_config_from_text(text, project_dir=str(tmp_path))
    jcfg, jcmd = jnlp.build_config_from_text(text, project_dir=str(tmp_path))
    assert dataclasses.asdict(cmd) == dataclasses.asdict(jcmd)
    assert_same_config(cfg, jcfg)


# -- the wizard --------------------------------------------------------------------------

ANSWERS = [
    [""] * 5,                              # every default
    ["1", "3", "2", "2", "3"],             # old film, 4x, double rate, faces, archival
    ["2", "2", "3", "1", "1"],             # VHS, 2x, 60 fps, fast draft
    ["4", "", "", "", ""],                 # animation, then the 2x default's model
    ["4", "3", "1", "1", "2"],             # animation at 4x
    ["x", "9", "3", "2", "", "", "2"],     # two bad entries, then DVD at 2x
]


def _scripted(mod, answers):
    it, printed = iter(answers), []
    wiz = mod.Wizard(input_fn=lambda prompt: next(it), print_fn=printed.append)
    return wiz, printed


@pytest.mark.parametrize("answers", ANSWERS)
def test_wizard_scripted_answers_give_jax_config(answers, tmp_path):
    wiz, printed = _scripted(wizard, answers)
    jwiz, jprinted = _scripted(jwizard, answers)
    cfg = wiz.run(project_dir=str(tmp_path))
    jcfg = jwiz.run(project_dir=str(tmp_path))
    assert wiz.answers == jwiz.answers
    assert_same_config(cfg, jcfg)
    assert printed == jprinted


def test_wizard_keep_resolution_has_no_port_model(tmp_path):
    """JAX's "Keep resolution" names ``sr_model="none"`` (SR off); the port
    has no such model and says so."""
    wiz, _ = _scripted(wizard, ["", "1", "", "", ""])
    jwiz, _ = _scripted(jwizard, ["", "1", "", "", ""])
    assert jwiz.run().sr_model == "none"
    with pytest.raises(ConfigError, match="Unknown model 'none'"):
        wiz.run(project_dir=str(tmp_path))
