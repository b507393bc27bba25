"""The CLI verbs of slice 16 on the CPU against the JAX package's: every
JAX verb but ``bench`` and ``suite`` (refused, naming why)
exists in the port with JAX's option strings, choices and defaults
(``--device`` takes ``cuda`` for ``tpu``; restore's ``--temporal-model``
also takes ``latent``); each verb's output on the same clip matches JAX's
within the bound its kind allows."""

import contextlib
import dataclasses
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import framewright_tpu.recipes as jrecipes
from framewright_tpu import cli as jcli
from framewright_tpu.models import ifnet as jifnet
from framewright_tpu.models.torch_port import export_npz
from framewright_tpu.reports import QualityTrends as JaxTrends
from framewright_tpu_torch import cli, recipes
from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter

REFUSED = ("bench", "suite")
# the restore's bound against JAX's (tests/test_torch_slice.py)
RESTORE_MAX, RESTORE_MEAN = 2, 0.2
# uint8 interpolated frames against JAX's (tests/test_torch_interpolation.py)
LSB_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_weights(tmp_path, monkeypatch):
    """An empty weights directory for both packages."""
    (tmp_path / "weights").mkdir()
    monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(tmp_path / "weights"))


def smooth_clip(path: Path, n: int = 4, h: int = 24, w: int = 32, fps: int = 12,
                seed: int = 3) -> Path:
    """Smooth colour waves (progressive; no pair reads as a scene cut)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    with Y4MWriter(path, w, h, fps=fps) as wr:
        for t in range(n):
            ph = rng.random(3) * 6
            g = 127 + 100 * np.sin(x / 5 + y / 7 + ph[0] + t * 0.3)
            wr.write_frame(np.clip(np.stack([g, g * 0.9 + 10, g * 0.8 + 20 + 10 * np.cos(
                x / 3 + ph[1])], -1), 0, 255).astype(np.uint8))
    return path


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def planes_of(path: Path):
    header, rest = path.read_bytes().split(b"\n", 1)
    return header, [np.frombuffer(c, np.uint8) for c in rest.split(b"FRAME\n")[1:]]


def within_restore_bound(a: Path, b: Path) -> None:
    ha, pa = planes_of(a)
    hb, pb = planes_of(b)
    assert ha == hb and len(pa) == len(pb) > 0
    for x, y in zip(pa, pb):
        d = np.abs(x.astype(np.int16) - y.astype(np.int16))
        assert d.max() <= RESTORE_MAX and d.mean() <= RESTORE_MEAN, (d.max(), d.mean())


# -- the parsers ----------------------------------------------------------------------

def _subparsers(parser):
    return next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")


def _options(parser) -> dict:
    """option strings (or a positional's dest) -> (choices, default), and
    nested sub-verbs under their names."""
    out = {}
    for a in parser._actions:
        kind = a.__class__.__name__
        if kind in ("_HelpAction", "_VersionAction"):
            continue
        if kind == "_SubParsersAction":
            for name, sp in a.choices.items():
                out[f"<{name}>"] = _options(sp)
            continue
        key = tuple(a.option_strings) or a.dest
        out[key] = (list(a.choices) if a.choices is not None else None, a.default)
    return out


JAX_VERBS = sorted(_subparsers(jcli.build_parser()).choices)


def test_known_verbs_are_jax_verbs_but_the_refused():
    assert cli.KNOWN_VERBS == jcli.KNOWN_VERBS - set(REFUSED)
    assert set(JAX_VERBS) - set(_subparsers(cli.build_parser()).choices) == set(REFUSED)


def _expect(jax_opts: dict, key) -> tuple:
    choices, default = jax_opts[key]
    if choices is not None:
        choices = ["cuda" if c == "tpu" else c for c in choices]
        if key == ("--temporal-model",):
            choices = choices + ["latent"]
    return choices, default


def _compare(jax_opts: dict, port_opts: dict, where: str) -> None:
    for key in jax_opts:
        assert key in port_opts, f"{where}: the port lacks {key}"
        if isinstance(jax_opts[key], dict):
            _compare(jax_opts[key], port_opts[key], f"{where} {key}")
            continue
        assert port_opts[key] == _expect(jax_opts, key), (where, key)


@pytest.mark.parametrize("verb", [v for v in JAX_VERBS if v not in REFUSED])
def test_verb_has_jax_options_choices_and_defaults(verb):
    jax_opts = _options(_subparsers(jcli.build_parser()).choices[verb])
    port_opts = _options(_subparsers(cli.build_parser()).choices[verb])
    _compare(jax_opts, port_opts, verb)


@pytest.mark.parametrize("verb,why", [("bench", "A4"), ("suite", "A4")])
def test_refused_verbs_name_why(verb, why):
    rc, out, err = run(cli.main, [verb, "x"])
    assert rc == 1 and out == "" and why in err and verb in err


def test_one_word_verbs_pin_their_presets():
    parser = cli.build_parser()
    for verb, preset in (("quick", "fast"), ("best", "ultimate"), ("archive", "archive")):
        args = parser.parse_args([verb, "a.y4m"])
        assert args.preset == preset and args.func is cli.cmd_restore
        assert parser.parse_args([verb, "a.y4m", "--preset", "quality"]).preset == "quality"


def test_path_first_argument_means_restore(tmp_path):
    """``framewright-torch clip.y4m`` restores (JAX's sugar): without a card
    the restore refuses with the device error, before any work."""
    src = smooth_clip(tmp_path / "a.y4m")
    rc, out, err = run(cli.main, [str(src), "-o", str(tmp_path / "o.y4m"),
                                  "--project-dir", str(tmp_path / "p")])
    assert rc == 1 and "no CUDA device" in err and not (tmp_path / "o.y4m").exists()


# -- listings --------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["recipes"], ["export-presets"]])
def test_listings_equal_jax(argv):
    """JAX's lines; ``realtime_preview``'s without JAX's TPU rate."""
    rc, out, err = run(jcli.main, argv)
    assert run(cli.main, argv) == (rc, out.replace("(22 fps/chip; ", "("), err)


def test_completion_equals_jax_less_the_refused_verbs():
    rc, out, _ = run(cli.main, ["completion"])
    rc_j, jout, _ = run(jcli.main, ["completion"])
    jverbs = " ".join(sorted(jcli.KNOWN_VERBS))
    assert rc == rc_j == 0 and jverbs in jout
    assert out == jout.replace(jverbs, " ".join(sorted(jcli.KNOWN_VERBS - set(REFUSED))))


@pytest.mark.parametrize("intelligence", [False, True])
def test_analyze_equals_jax(tmp_path, intelligence):
    src = smooth_clip(tmp_path / "a.y4m", n=6)
    argv = ["analyze", str(src)] + (["--intelligence"] if intelligence else [])
    rc, out, _ = run(cli.main, argv + ["--device", "cpu"])
    rc_j, jout, _ = run(jcli.main, argv)
    assert rc == rc_j == 0 and json.loads(out) == json.loads(jout)


@pytest.mark.parametrize("suffix", [".html", ".json"])
def test_qa_report_equals_jax(tmp_path, suffix):
    """The printed path is JAX's; the skeleton report holds the fields both
    reports have with JAX's values (the port's has more: its restore
    writes the per-frame stats, the resume point and the pre-SR stream;
    JAX's ``dedup`` is not in it) and JAX's quality and stage sections."""
    outs = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        report = tmp_path / name / f"qa{suffix}"
        rc, out, _ = run(main, ["qa-report", "src.y4m", "--output", "o.y4m", "--report",
                                str(report)])
        assert rc == 0 and out == f"{report}\n"
        outs[name] = report.read_text()
    if suffix == ".json":
        port, jax_ = json.loads(outs["port"]), json.loads(outs["jax"])
        common = (set(port) & set(jax_)) - {"created_at"}
        assert common == set(jax_) - {"created_at", "dedup"}
        assert {k: port[k] for k in common} == {k: jax_[k] for k in common}
    else:
        assert "<title>framewright QA report</title>" in outs["port"]
        assert outs["port"].split("<h2>Quality")[1] == outs["jax"].split("<h2>Quality")[1]


def test_report_trends_reads_jax_database_as_jax(tmp_path):
    db = tmp_path / "trends.db"
    jt = JaxTrends(db)
    for i in range(3):
        jt.record(f"c{i}.y4m", 30.0 + i, 0.9 + i / 100, 10.0 * (i + 1), 4, i != 1)
    jt.close()
    argv = ["report", "trends", "--db", str(db), "--limit", "2"]
    rc, out, _ = run(cli.main, argv)
    rc_j, jout, _ = run(jcli.main, argv)
    assert rc == rc_j == 0 and out == jout
    assert json.loads(out)["summary"]["runs"] == 3


def test_report_estimate_keeps_jax_keys_and_scaling(tmp_path):
    """JAX's keys less its two TPU prices; the estimate scales with the
    pixels, the cards and the overhead as JAX's does (the figures are the
    card's own)."""
    small = smooth_clip(tmp_path / "s.y4m", n=4, h=24, w=32)
    big = smooth_clip(tmp_path / "b.y4m", n=4, h=48, w=64)
    got, want = {}, {}
    for src in (small, big):
        for chips in (1, 4):
            argv = ["report", "estimate", str(src), "--chips", str(chips)]
            got[src.name, chips] = json.loads(run(cli.main, argv)[1])
            want[src.name, chips] = json.loads(run(jcli.main, argv)[1])
    for key in got:
        g, w = got[key], want[key]
        assert set(g) == set(w) and set(g["assumptions"]) == set(w["assumptions"])
        assert set(g["est_cost_usd"]) == set(w["est_cost_usd"]) - {"tpu_v5e_single",
                                                                   "tpu_v5e_pod8"}
        assert g["frames"] == w["frames"] and g["assumptions"]["resolution"] == \
            w["assumptions"]["resolution"]
    for (name, chips), g in got.items():
        # fps: times the cards, over the pixels (the big clip has 4x)
        scale = chips * (1.0 if name == "s.y4m" else 0.25)
        for d in (got, want):
            assert d[name, chips]["est_fps_per_chip"] / d["s.y4m", 1]["est_fps_per_chip"] == \
                pytest.approx(scale, rel=1e-2)
    from framewright_tpu_torch.reports import _FAMILY_FPS_1080P, estimate_cost

    e = estimate_cost(100, 1920, 1080, "srvgg", n_chips=2, overhead_factor=1.5)
    assert e.est_fps == 2 * _FAMILY_FPS_1080P["srvgg"]
    assert e.est_seconds == pytest.approx(100 / e.est_fps * 1.5)
    assert e.est_cost_usd == {"reference_gpu": pytest.approx(e.est_seconds / 3600 * 0.79 * 2)}


# -- the frame tools ------------------------------------------------------------------

def test_extract_frames_and_reassemble_byte_equal_jax(tmp_path):
    src = smooth_clip(tmp_path / "a.y4m")
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        d = tmp_path / f"{name}_frames"
        rc, out, _ = run(main, ["extract-frames", str(src), str(d)])
        assert rc == 0 and json.loads(out) == {"directory": str(d), "frames": 4, "fps": 12.0}
        rc, out, _ = run(main, ["reassemble", str(d), "-o", str(tmp_path / f"{name}.y4m"),
                                "--fps", "12"])
        assert rc == 0 and json.loads(out)["frames"] == 4
    pf, jf = sorted((tmp_path / "port_frames").iterdir()), sorted((tmp_path / "jax_frames")
                                                                 .iterdir())
    assert [p.name for p in pf] == [p.name for p in jf]
    assert all(a.read_bytes() == b.read_bytes() for a, b in zip(pf, jf))
    assert (tmp_path / "port.y4m").read_bytes() == (tmp_path / "jax.y4m").read_bytes()


def test_proxy_create_byte_equal_jax(tmp_path):
    src = smooth_clip(tmp_path / "a.y4m", h=48, w=64)
    outs = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        px = tmp_path / f"{name}_px.y4m"
        rc, out, _ = run(main, ["proxy", "create", str(src), "-o", str(px), "--height", "20"])
        assert rc == 0
        outs[name] = (px.read_bytes(), json.loads(px.with_suffix(".proxy.json").read_text()),
                      json.loads(out))
    assert outs["port"][0] == outs["jax"][0]
    for i in (1, 2):
        a, b = dict(outs["port"][i]), dict(outs["jax"][i])
        for key in ("proxy", "sidecar"):
            a.pop(key, None), b.pop(key, None)
        assert a == b
    with Y4MReader(tmp_path / "port_px.y4m") as r:
        assert (r.height, r.width) == (20, 26)


def test_proxy_apply_restores_the_original(tmp_path):
    """``proxy apply`` restores the proxy's source with the flags given:
    the output equals the CLI restore of the original."""
    src = smooth_clip(tmp_path / "a.y4m")
    px = tmp_path / "px.y4m"
    assert run(cli.main, ["proxy", "create", str(src), "-o", str(px), "--height", "12"])[0] == 0
    flags = ["--model", "FW_fastvgg_x2", "--device", "cpu", "--no-checkpoint"]
    rc, _, _ = run(cli.main, ["proxy", "apply", str(px), "-o", str(tmp_path / "ap.y4m"),
                              "--project-dir", str(tmp_path / "p1"), *flags])
    rc2, _, _ = run(cli.main, ["restore", str(src), "-o", str(tmp_path / "ref.y4m"),
                               "--project-dir", str(tmp_path / "p2"), *flags])
    assert rc == rc2 == 0
    assert (tmp_path / "ap.y4m").read_bytes() == (tmp_path / "ref.y4m").read_bytes()
    rc, _, err = run(cli.main, ["proxy", "apply", str(tmp_path / "none.y4m"), *flags])
    assert rc == 1 and "no proxy sidecar" in err


@pytest.mark.parametrize("same", [True, False])
def test_compare_within_jax_bounds(tmp_path, same):
    """PSNR within 0.01 dB (capped at 99 for equal clips), SSIM within 1e-4,
    the VMAF proxy within 0.01 (tests/test_torch_vmaf.py)."""
    a = smooth_clip(tmp_path / "a.y4m", h=32, w=48)
    b = a if same else smooth_clip(tmp_path / "b.y4m", h=32, w=48, seed=4)
    argv = ["compare", str(a), str(b)]
    rc, out, _ = run(cli.main, argv + ["--device", "cpu"])
    rc_j, jout, _ = run(jcli.main, argv)
    got, want = json.loads(out), json.loads(jout)
    assert rc == rc_j == 0 and set(got) == set(want)
    assert got["frames_compared"] == want["frames_compared"] == 4
    for k in ("psnr_mean", "psnr_min"):
        assert abs(got[k] - want[k]) <= 0.01, k
    assert abs(got["ssim_mean"] - want["ssim_mean"]) <= 1e-4
    assert abs(got["vmaf_proxy"] - want["vmaf_proxy"]) <= 0.01
    if same:
        assert (got["psnr_mean"], got["ssim_mean"]) == (99.0, 1.0)


def test_interpolate_within_jax_bound(tmp_path, monkeypatch):
    """``interpolate --factor 2`` reads rife-v4.6.npz where the restore
    does: the same frames as JAX's verb with the same weights, within 1
    LSB on <= 0.1% of the values; without the file, ``InputError``."""
    wdir = tmp_path / "weights"
    src = smooth_clip(tmp_path / "a.y4m", n=3)
    rc, _, err = run(cli.main, ["interpolate", str(src), "--device", "cpu"])
    assert rc == 1 and str(wdir / "rife-v4.6.npz") in err
    params = jax.tree_util.tree_map(np.asarray, jifnet.init(jax.random.PRNGKey(0),
                                                            jifnet.IFNetConfig()))
    export_npz(params, wdir / "rife-v4.6.npz")
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        out = tmp_path / f"{name}.y4m"
        rc, text, _ = run(main, ["interpolate", str(src), "-o", str(out), "--factor", "2",
                                 *extra])
        assert rc == 0
        outs[name] = (json.loads(text), planes_of(out))
    (gj, (gh, gp)), (wj, (wh, wp)) = outs["port"], outs["jax"]
    gj.pop("output"), wj.pop("output")
    assert gj == wj == {"frames": 5, "factor": 2, "fps": 24.0} and gh == wh
    d = np.abs(np.stack(gp).astype(np.int16) - np.stack(wp).astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= LSB_SHARE, (d.max(), (d > 0).mean())


# -- the restores -----------------------------------------------------------------------

def test_quick_within_jax_restore_bound_and_equal_to_preset_fast(tmp_path):
    src = smooth_clip(tmp_path / "a.y4m")
    common = ["--device", "cpu", "--no-checkpoint"]
    rc, out, _ = run(cli.main, ["quick", str(src), "-o", str(tmp_path / "q.y4m"),
                                "--project-dir", str(tmp_path / "p1"), *common])
    assert rc == 0 and json.loads(out)["frames"] == 4
    rc, _, _ = run(cli.main, ["restore", str(src), "-o", str(tmp_path / "f.y4m"), "--preset",
                              "fast", "--project-dir", str(tmp_path / "p2"), *common])
    rc_j, _, _ = run(jcli.main, ["quick", str(src), "-o", str(tmp_path / "j.y4m"),
                                 "--project-dir", str(tmp_path / "p3"), *common])
    assert rc == rc_j == 0
    assert (tmp_path / "q.y4m").read_bytes() == (tmp_path / "f.y4m").read_bytes()
    within_restore_bound(tmp_path / "q.y4m", tmp_path / "j.y4m")


@pytest.mark.parametrize("name", ["realtime_preview", "vhs_family_video"])
def test_recipe_within_jax_restore_bound(tmp_path, monkeypatch, name):
    """``realtime_preview`` as it stands (FW_fastvgg_x2); ``vhs_family_video``
    (VHS repair and yadif pre-stages, then the denoiser and cross-frame
    attention) with the trained FW_fast6_x2 in both tables for its
    23-block model, whose seeded draws differ between the packages."""
    if name == "vhs_family_video":
        for mod in (recipes, jrecipes):
            r = mod.RECIPES[name]
            monkeypatch.setitem(mod.RECIPES, name, dataclasses.replace(
                r, config_overrides={**r.config_overrides, "sr_model": "FW_fast6_x2"}))
    src = smooth_clip(tmp_path / "a.y4m")
    outs = {}
    for tag, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        out = tmp_path / f"{tag}.y4m"
        rc, text, _ = run(main, ["recipe", name, str(src), "-o", str(out), "--project-dir",
                                 str(tmp_path / f"p_{tag}"), *extra])
        assert rc == 0, text
        outs[tag] = json.loads(text)
        assert outs[tag]["frames"] == 4
    within_restore_bound(tmp_path / "port.y4m", tmp_path / "jax.y4m")
    staged = tmp_path / "p_port" / "work" / "prestaged.y4m"
    assert staged.is_file() == (name == "vhs_family_video")


def test_do_within_jax_restore_bound_and_dry_run_equal(tmp_path):
    """A phrase naming the fast preset: the dry-run configs equal JAX's (the
    port's two fields aside), the restores within the restore bound."""
    src = smooth_clip(tmp_path / "a.y4m")
    text = f"quick draft of {src}"
    dry = {}
    for tag, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        rc, out, err = run(main, ["do", text, "--dry-run", "--project-dir",
                                  str(tmp_path / "p"), *extra])
        assert rc == 0 and err.startswith("plan: preset 'fast'")
        dry[tag] = json.loads(out)
    port, jax_ = dry["port"], dry["jax"]
    assert port.pop("device_platform") == "cpu" and jax_.pop("device_platform") == "auto"
    assert {k: v for k, v in port.items() if k in jax_} == \
        {k: v for k, v in jax_.items() if k in port}
    for tag, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        rc, out, _ = run(main, ["do", text, "-o", str(tmp_path / f"{tag}.y4m"),
                                "--project-dir", str(tmp_path / f"p_{tag}"), *extra])
        assert rc == 0 and json.loads(out)["frames"] == 4
    within_restore_bound(tmp_path / "port.y4m", tmp_path / "jax.y4m")
    rc, _, err = run(cli.main, ["do", "make it pretty", "--device", "cpu"])
    assert rc == 1 and "no input file" in err


def test_auto_picks_jax_preset(tmp_path):
    """``auto``'s analysis and the selector's preset are JAX's on the same
    clip (the restore runs on the CPU here)."""
    src = smooth_clip(tmp_path / "a.y4m")
    rc, out, err = run(cli.main, ["auto", str(src), "-o", str(tmp_path / "a_out.y4m"),
                                  "--project-dir", str(tmp_path / "p"), "--device", "cpu"])
    from framewright_tpu.io import open_reader as jopen, probe as jprobe
    from framewright_tpu.presets import PresetRegistry, SmartPresetSelector
    from framewright_tpu.processors.analysis import ContentAnalyzer

    meta = jprobe(src)
    with jopen(src) as r:
        rep = ContentAnalyzer().analyze(iter(r), height=meta.height)
    want = SmartPresetSelector(PresetRegistry()).select(rep, meta.nb_frames)
    assert rc == 0, err
    assert json.loads(out)["preset"] == want.preset
    assert json.loads(err.split("analysis:", 1)[1].split("\n}\n")[0] + "\n}") == rep.to_dict()
    from framewright_tpu_torch.io.video import open_reader, probe
    from framewright_tpu_torch.presets import PresetRegistry as PortRegistry
    from framewright_tpu_torch.presets import SmartPresetSelector as PortSelector
    from framewright_tpu_torch.processors.analysis import ContentAnalyzer as PortAnalyzer

    with open_reader(src) as r:
        prep = PortAnalyzer().analyze(iter(r), height=probe(src).height)
    got = PortSelector(PortRegistry()).select(prep, meta.nb_frames).to_dict()
    for key, value in json.loads(json.dumps(want.to_dict(), default=str)).items():
        if key in got and key not in ("project_dir", "device_platform"):
            assert json.loads(json.dumps(got[key], default=str)) == value, key


def test_wizard_verb_prints_the_scripted_config(tmp_path, monkeypatch):
    answers = iter(["5", "2", "1", "1", "2"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    rc, out, _ = run(cli.main, ["wizard", "--project-dir", str(tmp_path / "p"),
                                "--device", "cpu"])
    cfg = json.loads(out[out.index("\n{") + 1:])
    assert rc == 0 and (cfg["sr_model"], cfg["scale_factor"], cfg["crf"],
                        cfg["device_platform"]) == ("RealESRGAN_x2plus", 2, 18, "cpu")


def test_verbs_without_a_card_raise_device_error(tmp_path):
    """On a machine without a card the device verbs fail with the device
    error unless ``--device cpu`` is given."""
    src = smooth_clip(tmp_path / "a.y4m")
    for argv in (["quick", str(src), "-o", str(tmp_path / "q.y4m")],
                 ["compare", str(src), str(src)],
                 ["recipe", "vhs_family_video", str(src), "--project-dir",
                  str(tmp_path / "p")]):
        rc, out, err = run(cli.main, argv)
        assert rc == 1 and "no CUDA device" in err, (argv, err)
    assert not (tmp_path / "p").exists()          # refused before the pre-stages
    (tmp_path / "weights" / "rife-v4.6.npz").write_bytes(b"")
    rc, _, err = run(cli.main, ["interpolate", str(src)])
    assert rc == 1 and "no CUDA device" in err


# -- notify -------------------------------------------------------------------------------

class _Sink(BaseHTTPRequestHandler):
    received: list = []

    def do_POST(self):
        n = int(self.headers["Content-Length"])
        self.received.append((self.headers["authorization"], json.loads(self.rfile.read(n))))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


def test_notify_sms_to_a_local_gateway_as_jax():
    _Sink.received = []
    httpd = HTTPServer(("127.0.0.1", 0), _Sink)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        argv = ["notify", "sms", "--to", "+100", "--body", "x" * 200, "--gateway",
                f"http://127.0.0.1:{httpd.server_port}/sms", "--api-key", "k"]
        assert run(cli.main, argv) == run(jcli.main, argv) == (0, '{"sent": true}\n', "")
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join()
    assert _Sink.received[0] == _Sink.received[1] == ("Bearer k", {"to": "+100",
                                                                    "body": "x" * 160})
    argv = ["notify", "sms", "--to", "+1", "--gateway", "http://127.0.0.1:9/none"]
    assert run(cli.main, argv)[:2] == run(jcli.main, argv)[:2] == (1, '{"sent": false}\n')


def test_notify_email_sends_jax_message(monkeypatch):
    """The verb's message through a stand-in ``smtplib.SMTP``: the same
    calls and message as JAX's (the Date-free MIME text)."""
    import smtplib

    calls = []

    class FakeSMTP:
        def __init__(self, host, port, timeout=None):
            calls.append(("connect", host, port))

        def starttls(self):
            calls.append(("starttls",))

        def login(self, user, password):
            calls.append(("login", user, password))

        def sendmail(self, sender, rcpts, text):
            calls.append(("sendmail", sender, tuple(rcpts), text))

        def quit(self):
            calls.append(("quit",))

    monkeypatch.setattr(smtplib, "SMTP", FakeSMTP)
    argv = ["notify", "email", "--to", "a@b.c", "--smtp-host", "mail.local", "--smtp-port",
            "2525", "--username", "u", "--password", "p", "--subject", "s", "--body", "hi"]
    assert run(cli.main, argv) == (0, '{"sent": true}\n', "")
    port_calls = list(calls)
    calls.clear()
    assert run(jcli.main, argv) == (0, '{"sent": true}\n', "")
    assert port_calls == calls and calls[0] == ("connect", "mail.local", 2525)
