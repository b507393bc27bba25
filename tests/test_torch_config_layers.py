"""The restore's config layers (C10), profiles, config files, presets with
the hardware adjustment, the hardware check and the warmup, on the CPU
against the JAX package."""

import dataclasses
import json
import logging
import sys

import pytest

from framewright_tpu import cli as jcli
from framewright_tpu import config as jconfig
from framewright_tpu import presets as jpresets
from framewright_tpu import profiles as jprofiles
from framewright_tpu import security as jsecurity
from framewright_tpu.hw import DeviceInfo as JDeviceInfo
from framewright_tpu.hw import HardwareInfo as JHardwareInfo
from framewright_tpu.hw import HardwareTier as JTier
from framewright_tpu_torch import cli, hw, presets, profiles, security
from framewright_tpu_torch.config import Config, build_config
from framewright_tpu_torch.errors import ConfigError, DeviceError, InputError
from framewright_tpu_torch.models.registry import MODEL_SPECS

SHARED = sorted({f.name for f in dataclasses.fields(jconfig.Config)}
                & {f.name for f in dataclasses.fields(Config)} - {"work_dir", "checkpoint_dir"})


def _norm(v):
    return json.loads(json.dumps(str(v) if hasattr(v, "__fspath__") else v))


def _assert_same_fields(cfg: Config, jcfg) -> None:
    """Every field both packages have resolves alike. ``scale_factor``: the
    port's Config takes the model's scale (it refuses another), JAX keeps
    the one it resolved and writes the model's."""
    for name in SHARED:
        if name == "scale_factor":
            assert cfg.scale_factor == MODEL_SPECS[cfg.sr_model].scale
            if jcfg.scale_factor != MODEL_SPECS[jcfg.sr_model].scale:
                continue
        assert _norm(getattr(cfg, name)) == _norm(getattr(jcfg, name)), name


def _both(argv):
    """The port's and JAX's restore config for the same restore flags."""
    args = ["restore", "in.y4m"] + argv
    cfg = cli._config_from_args(cli.build_parser().parse_args(args))
    jcfg = jcli._config_from_args(jcli.build_parser().parse_args(args))
    return cfg, jcfg


@pytest.fixture
def jax_file(tmp_path):
    """A config file JAX's ``Config.save`` wrote: FW_fast6_x2, crf 20,
    batch 5, languages (eng, deu)."""
    path = tmp_path / "cfg.json"
    jconfig.Config(sr_model="FW_fast6_x2", crf=20, batch_size=5,
                   subtitle_languages=("eng", "deu")).save(path)
    return path


ENV_CASES = {
    "bool": ({"FRAMEWRIGHT_DEDUPLICATE": "true"}, [], {"deduplicate": True}),
    "int": ({"FRAMEWRIGHT_BATCH_SIZE": "2"}, [], {"batch_size": 2}),
    "tuple": ({"FRAMEWRIGHT_MESH_SHAPE": "1,1", "FRAMEWRIGHT_SUBTITLE_LANGUAGES": "eng,fra"}, [],
              {"mesh_shape": (1, 1), "subtitle_languages": ("eng", "fra")}),
    "string": ({"FRAMEWRIGHT_SR_MODEL": "realesr-animevideov3"}, [],
               {"sr_model": "realesr-animevideov3", "scale_factor": 4}),
    "file": ({}, ["--config-file", "{file}"], {"sr_model": "FW_fast6_x2", "crf": 20,
                                               "batch_size": 5}),
    "env_over_file": ({"FRAMEWRIGHT_BATCH_SIZE": "2", "FRAMEWRIGHT_CRF": "30"},
                      ["--config-file", "{file}"], {"batch_size": 2, "crf": 30,
                                                   "sr_model": "FW_fast6_x2"}),
    "file_over_preset": ({}, ["--preset", "quality", "--config-file", "{file}"],
                         {"sr_model": "FW_fast6_x2", "denoise": False}),
    "cli_over_env": ({"FRAMEWRIGHT_BATCH_SIZE": "2", "FRAMEWRIGHT_DEDUPLICATE": "0"},
                     ["--batch", "3", "--deduplicate"], {"batch_size": 3, "deduplicate": True}),
    "cli_over_file": ({}, ["--config-file", "{file}", "--model", "FW_fastvgg_x2", "--dtype",
                           "int8"], {"sr_model": "FW_fastvgg_x2", "compute_dtype": "int8",
                                     "crf": 20}),
    "cli_over_preset": ({"FRAMEWRIGHT_TEMPORAL_MODEL": "ema"},
                        ["--preset", "fast", "--device", "cpu"],
                        {"sr_model": "FW_fastvgg_x2", "device_platform": "cpu",
                         "temporal_model": "ema", "preset": "fast"}),
}


@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_env_overrides_reach_the_restore_as_jax(case, monkeypatch, jax_file):
    """C10: ``FRAMEWRIGHT_*`` variables, ``--config-file`` and the flags over
    each layer resolve the restore's config as JAX's ``_config_from_args``
    does (a bool, an int, tuples, a string; CLI > env > file > preset)."""
    env, argv, want = ENV_CASES[case]
    for k in [k for k in list(__import__("os").environ) if k.startswith("FRAMEWRIGHT_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg, jcfg = _both([a.format(file=jax_file) for a in argv])
    _assert_same_fields(cfg, jcfg)
    for name, value in want.items():
        assert getattr(cfg, name) == value, name


def test_bad_env_value_is_a_config_error():
    with pytest.raises(ConfigError, match="FRAMEWRIGHT_BATCH_SIZE"):
        Config.env_overrides({"FRAMEWRIGHT_BATCH_SIZE": "two"})
    with pytest.raises(jconfig.ConfigError, match="FRAMEWRIGHT_BATCH_SIZE"):
        jconfig.Config.env_overrides({"FRAMEWRIGHT_BATCH_SIZE": "two"})
    assert Config.env_overrides({"FRAMEWRIGHT_NO_NATIVE": "1", "OTHER": "x"}) == {}


@pytest.mark.parametrize("suffix", [".json", ".yaml"])
def test_config_files_cross_load(suffix, tmp_path, caplog):
    """A file either package saves loads in the other; JAX's XLA-only
    fields are read and logged as ignored."""
    jcfg = jconfig.Config(sr_model="realesr-animevideov3", scale_factor=4, denoise=True,
                          mesh_shape=(1,), xla_cache_dir=tmp_path / "xla", crf=22)
    jcfg.save(tmp_path / f"j{suffix}")
    with caplog.at_level(logging.INFO, logger="framewright_tpu_torch.config"):
        cfg = Config.load(tmp_path / f"j{suffix}")
    assert "xla_cache_dir" in caplog.text and "allow_cpu_fallback" in caplog.text
    _assert_same_fields(cfg, jcfg)
    cfg = Config(sr_model="FW_fast6_x2", batch_size=3, weights_dir=tmp_path,
                 subtitle_languages=("eng", "fra"), watermark_regions=((1, 2, 3, 4),))
    cfg.save(tmp_path / f"p{suffix}")
    assert Config.load(tmp_path / f"p{suffix}").to_dict() == cfg.to_dict()
    back = jconfig.Config.load(tmp_path / f"p{suffix}")
    _assert_same_fields(cfg, back)


def test_yaml_without_pyyaml_names_the_module(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ConfigError, match="PyYAML"):
        Config().save(tmp_path / "c.yaml")
    (tmp_path / "c.yml").write_text("crf: 20\n")
    with pytest.raises(ConfigError, match="yaml"):
        build_config("", tmp_path / "c.yml", environ={})


def test_profiles_cross_load(tmp_path, monkeypatch):
    """A profile either package saves loads in the other (the same
    directory and format); ``--profile`` sits under the flags and over the
    environment, ``--save-profile`` writes the resolved config, in both
    CLIs."""
    monkeypatch.setenv("FRAMEWRIGHT_PROFILES_DIR", str(tmp_path))
    jprofiles.save_profile("j prof", jconfig.Config(sr_model="FW_fastvgg_x2", crf=25))
    profiles.save_profile("p/prof", Config(sr_model="FW_fast6_x2", batch_size=4))
    assert profiles.list_profiles() == jprofiles.list_profiles() == ["j_prof", "p_prof"]
    _assert_same_fields(profiles.load_profile("j prof"), jprofiles.load_profile("j prof"))
    _assert_same_fields(profiles.load_profile("p/prof"), jprofiles.load_profile("p/prof"))
    monkeypatch.setenv("FRAMEWRIGHT_BATCH_SIZE", "7")
    cfg, jcfg = _both(["--profile", "p/prof", "--save-profile", "saved"])
    _assert_same_fields(cfg, jcfg)
    assert cfg.batch_size == 4 and cfg.sr_model == "FW_fast6_x2"
    assert profiles.load_profile("saved").to_dict() == cfg.to_dict()
    with pytest.raises(ConfigError, match="not found"):
        profiles.load_profile("nope")
    assert profiles.delete_profile("saved") and not profiles.delete_profile("saved")


def test_security_copies_behave_as_jax(tmp_path):
    for name in ("a/b\\c;d e", "..hidden. ", "x\x00y", "", "ok.mp4"):
        assert security.sanitize_filename(name) == jsecurity.sanitize_filename(name)
    v, jv = security.PathValidator([tmp_path]), jsecurity.PathValidator([tmp_path])
    assert v.validate(tmp_path / "a") == jv.validate(tmp_path / "a")
    for bad in (tmp_path / ".." / "x", "a\x01b"):
        with pytest.raises(InputError):
            v.validate(bad)
        with pytest.raises(jsecurity.InputError):
            jv.validate(bad)
    for url in ("https://h/x", "ftp://h/x", "http://"):
        try:
            want = jsecurity.validate_url(url)
        except jsecurity.InputError:
            with pytest.raises(InputError):
                security.validate_url(url)
        else:
            assert security.validate_url(url) == want
    rl = security.RateLimiter(rate_per_s=0.0, burst=2)
    assert [rl.allow() for _ in range(3)] == [True, True, False]
    log = security.SecurityLog(limit=2)
    for i in range(3):
        log.record("k", str(i))
    assert [e["detail"] for e in log.events] == ["1", "2"]


# -- presets, the hardware check and the warmup --------------------------------------

def _hardware(platform, gb, n=1):
    """A faked report for each package: ``platform`` cuda or cpu (JAX's
    counterpart of a card is a TPU chip), ``gb`` of memory a device."""
    mem = int(gb * 2**30)
    cards = [hw.CardInfo(i, platform, "card" if platform == "cuda" else "cpu", mem, mem)
             for i in range(n)]
    tier = (hw.HardwareTier.CPU_ONLY if platform == "cpu" else
            hw.HardwareTier.GPU_MULTI if n > 1 else hw.HardwareTier.GPU_SINGLE)
    jplat = "tpu" if platform == "cuda" else "cpu"
    jtier = (JTier.CPU_ONLY if platform == "cpu" else
             JTier.TPU_POD_SLICE if n > 1 else JTier.TPU_SINGLE)
    jdevs = [JDeviceInfo(i, jplat, "chip", mem, mem) for i in range(n)]
    return (hw.HardwareInfo(platform, cards, 1, tier),
            JHardwareInfo(jplat, jdevs, 1, jtier))


@pytest.mark.parametrize("platform,gb", [("cuda", 80), ("cuda", 6), ("cpu", 31), ("cpu", 4)])
def test_presets_adjust_for_hardware_as_jax(platform, gb):
    """The same presets available and the same downshifts as JAX's on the
    counterpart hardware: none on an 80 GB card; 256-pixel tiles under
    8 GB; on the CPU the compact x4 model in float32 (at its own scale)."""
    info, jinfo = _hardware(platform, gb)
    reg, jreg = presets.PresetRegistry(info), jpresets.PresetRegistry(jinfo)
    assert [p.name for p in reg.available()] == [p.name for p in jreg.available()]
    for name in sorted(jconfig.PRESETS):
        cfg, jcfg = reg.build_config(name), jreg.build_config(name)
        _assert_same_fields(cfg, jcfg)
        if platform == "cuda" and gb >= 8:
            assert cfg.to_dict() == build_config(name, environ={}).to_dict()
    reg.register(presets.PresetInfo("gpu", "accelerator only", accelerator_only=True,
                                    overrides={"sr_model": "FW_fast6_x2"}))
    jreg.register(jpresets.PresetInfo("gpu", "accelerator only", tpu_only=True,
                                      overrides={"sr_model": "FW_fast6_x2"}))
    assert [p.name for p in reg.available()] == [p.name for p in jreg.available()]
    assert ("gpu" in [p.name for p in reg.available()]) == (platform == "cuda")
    _assert_same_fields(reg.build_config("gpu", crf=30),                # the port keeps
                        jreg.build_config("gpu", crf=30).with_overrides(preset=""))  # built-ins' names
    with pytest.raises(ConfigError, match="Unknown preset"):
        reg.build_config("nope")


@pytest.mark.parametrize("score", [30.0, 60.0, 90.0])
def test_smart_selector_picks_as_jax(score):
    from framewright_tpu.processors import analysis as janalysis
    from framewright_tpu_torch.processors import analysis

    info, jinfo = _hardware("cuda", 80)
    name, over, cfg = presets.SmartPresetSelector(presets.PresetRegistry(info)).select_with_info(
        analysis.AnalysisReport(quality_score=score, grain_level=0.3), 200_000)
    jname, jover, jcfg = jpresets.SmartPresetSelector(
        jpresets.PresetRegistry(jinfo)).select_with_info(
            janalysis.AnalysisReport(quality_score=score, grain_level=0.3), 200_000)
    assert (name, over) == (jname, jover)
    _assert_same_fields(cfg, jcfg)


def test_check_hardware_reports_the_card():
    info, _ = _hardware("cuda", 80)
    rep = hw.check_hardware(info)
    assert rep["status"] == "ok" and rep["recommendations"] == []
    assert (rep["tier"], rep["memory_gb_per_device"], rep["device_kind"]) == (
        "gpu_single", 80.0, "card")
    assert hw.check_hardware(_hardware("cuda", 6, n=2)[0])["tier"] == "gpu_multi"
    here = hw.detect_hardware()
    if here.platform == "cpu":
        rep = hw.check_hardware()
        assert here.tier is hw.HardwareTier.CPU_ONLY and rep["status"] == "degraded"
        assert rep["recommendations"][0].startswith("No CUDA device")


def test_warmup_on_the_cpu_then_the_restore(tmp_path, monkeypatch, capsys):
    """``warmup_sr`` runs the restore's SR processor on the planner's batch
    and on 1; the ``warmup`` verb prints JAX's line; without a card and
    without ``--device cpu`` it is a ``DeviceError``."""
    from framewright_tpu_torch.warmup import warmup_sr

    cfg = Config(sr_model="FW_fastvgg_x2", device_platform="cpu", batch_size=3)
    res = warmup_sr(24, 32, cfg)
    assert res["cache_dir"] is None and res["plan_batch"] == 3
    assert [p["batch"] for p in res["programs"]] == [3, 1]
    msgs = []
    assert warmup_sr(24, 32, cfg, output_color="rgb", batches=[2],
                     progress=msgs.append)["programs"][0]["batch"] == 2
    assert any("FW_fastvgg_x2" in m for m in msgs)
    assert cli.main(["warmup", "--height", "24", "--width", "32", "--model", "FW_fastvgg_x2",
                     "--device", "cpu", "--batches", "2"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "cache: None  plan batch: 4"
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(DeviceError):
        warmup_sr(24, 32, Config(sr_model="FW_fastvgg_x2"))
    assert cli.main(["warmup", "--height", "24", "--width", "32"]) == 1
