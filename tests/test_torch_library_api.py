"""The JAX package's public API that the port lacked, on the CPU against
JAX's: the rest of ``errors`` (the taxonomy's last classes, ``to_dict``,
``is_transient``, ``RetryPolicy``, ``with_retry``, ``ErrorReport``),
``testing.ABTestRunner``, ``engine.temporal.ChunkedProcessor`` and
``LongFormConsistencyManager``, ``ops.metrics.ms_ssim``, ``psnr_np``,
``ssim_np`` and ``quality_gate``, ``noise_profiler.profile_frames``,
``codeformer.encode_indices``, ``CheckpointManager.stage_started`` and
``is_stage_complete``, ``processors.base``' ``FrameProcessor``,
``ProcessorResult``, ``Timer`` and ``require_shape``, and the
``process_batch`` / ``process_stream`` methods over the port's own
paths.

Tolerances: host code (errors, chunking, anchors, checkpoints, the
profile, the base class) equals JAX's; ``ms_ssim``, ``ssim_np`` and the
gate's SSIM within 1e-5, its PSNR within 1e-3 dB (the bound of
``tests/test_torch_quality.py``); restores within max 2, mean 0.2 LSB of JAX's
(``tests/test_torch_slice.py``), their QA scores within 0.05 dB and 1e-3."""

from __future__ import annotations

import json
import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framewright_tpu import errors as jerr
from framewright_tpu import testing as jtesting
from framewright_tpu.config import Config as JConfig
from framewright_tpu.engine import checkpoint as jckpt
from framewright_tpu.engine import temporal as jtemporal
from framewright_tpu.models import codeformer as jcf
from framewright_tpu.ops import metrics as jmetrics
from framewright_tpu.processors import base as jbase
from framewright_tpu.processors import noise_profiler as jprof
from framewright_tpu_torch import cli, errors, testing
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.engine import checkpoint, temporal
from framewright_tpu_torch.io.y4m import Y4MWriter
from framewright_tpu_torch.models import codeformer as cf
from framewright_tpu_torch.models import registry
from framewright_tpu_torch.ops import metrics
from framewright_tpu_torch.processors import base, noise_profiler

RESTORE_MAX, RESTORE_MEAN = 2, 0.2


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _smooth(n, h, w, seed=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        g = 127 + 100 * np.sin(x / 5 + y / 7 + rng.random() * 6 + t * 0.3)
        out.append(np.clip(np.stack([g, g * 0.9 + 10, g * 0.8 + 20], -1), 0, 255)
                   .astype(np.uint8))
    return np.stack(out)


def _clip(path, n=3, h=24, w=32):
    with Y4MWriter(path, w, h, fps=12) as wr:
        for f in _smooth(n, h, w):
            wr.write_frame(f)
    return path


# -- errors ------------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["CompilationError", "DeviceUnavailableError", "ModelError",
                                  "HBMError", "ConfigError", "CheckpointError"])
def test_taxonomy_and_to_dict_equal_jax(name):
    cls, jcls = getattr(errors, name), getattr(jerr, name)
    assert [c.__name__ for c in cls.__mro__] == [c.__name__ for c in jcls.__mro__]
    e, je = cls("boom", details={"k": 1}), jcls("boom", details={"k": 1})
    assert e.to_dict() == je.to_dict() == {"type": name, "message": "boom", "details": {"k": 1}}
    assert errors.is_transient(e) == jerr.is_transient(je)


def test_is_transient_reads_the_type_not_the_text():
    """JAX's classifier reads the message ("timed out" is transient, "not
    found" an input error); the port's maps only its own errors and a
    device out-of-memory (ROADMAP, behaviour the port does not keep)."""
    assert jerr.is_transient(RuntimeError("connection timed out"))
    assert not errors.is_transient(RuntimeError("connection timed out"))
    assert type(jerr.classify_error(OSError("no such file"))).__name__ == "InputError"
    assert type(errors.classify_error(OSError("no such file"))) is errors.FatalError
    assert errors.is_transient(errors.HBMError("oom")) and errors.is_transient(
        errors.DiskSpaceError("full"))


@pytest.mark.parametrize("kw", [{}, {"base_delay": 0.1, "backoff": 3.0, "max_delay": 2.0},
                                {"jitter": 0.0}, {"jitter": 0.5, "base_delay": 1.0}])
def test_delay_for_equals_jax_with_the_seed_fixed(kw):
    got, want = [], []
    for pol, out in ((errors.RetryPolicy(**kw), got), (jerr.RetryPolicy(**kw), want)):
        random.seed(1234)
        out.extend(pol.delay_for(a) for a in range(8))
    assert got == want


def _retry_trace(mod, exc_types, max_attempts=3):
    """The attempts, on_retry calls and outcome of ``RetryPolicy.run`` on a
    function raising ``exc_types`` in turn, then returning 7."""
    seen, retried = [], []

    def fn():
        seen.append(len(seen))
        if len(seen) <= len(exc_types):
            raise getattr(mod, exc_types[len(seen) - 1])("x")
        return 7

    pol = mod.RetryPolicy(max_attempts=max_attempts, base_delay=0.0,
                          on_retry=lambda a, e: retried.append((a, type(e).__name__)))
    try:
        out = pol.run(fn)
    except Exception as exc:  # noqa: BLE001 - compared below
        out = type(exc).__name__
    return len(seen), retried, out


@pytest.mark.parametrize("raised", [[], ["TransientError"], ["HBMError", "CheckpointError"],
                                    ["TransientError"] * 3, ["ConfigError"],
                                    ["TransientError", "InputError"]])
def test_retry_policy_run_equals_jax(raised):
    assert _retry_trace(errors, raised) == _retry_trace(jerr, raised)


def test_with_retry_and_error_report_equal_jax():
    for mod in (errors, jerr):
        calls = []

        @mod.with_retry(mod.RetryPolicy(base_delay=0.0))
        def flaky(x):
            """doc"""
            calls.append(x)
            if len(calls) < 2:
                raise mod.TransientError("again")
            return x * 2

        assert flaky(4) == 8 and calls == [4, 4] and flaky.__doc__ == "doc"
    reports = []
    for mod in (errors, jerr):
        rep = mod.ErrorReport()
        for i, name in enumerate(["HBMError", "ConfigError", "HBMError", "ValidationError"]):
            rep.record(getattr(mod, name)(f"e{i}"), stage="sr", frame=i)
        reports.append((rep.count, rep.errors, rep.summary()))
    assert reports[0] == reports[1]
    assert reports[0][2] == {"total": 4, "by_type": {"HBMError": 2, "ConfigError": 1,
                                                     "ValidationError": 1}}


# -- testing.ABTestRunner ----------------------------------------------------------------

def _planes(path):
    header, rest = path.read_bytes().split(b"\n", 1)
    return header, [np.frombuffer(c, np.uint8) for c in rest.split(b"FRAME\n")[1:]]


def test_ab_runner_equals_jax_and_each_variant_its_cli_restore(tmp_path, monkeypatch, capsys):
    """Two variants (bf16 and float32 FW_fastvgg_x2) on a 3-frame clip: each
    port output byte-equal to the CLI restore of its config, within the
    restore bound of JAX's runner's output; the QA scores within 0.05 dB
    and 1e-3 of JAX's; the same winner."""
    monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(tmp_path / "w"))
    src = _clip(tmp_path / "clip.y4m")
    names = [("bf16", {"compute_dtype": "bfloat16"}), ("f32", {"compute_dtype": "float32"})]
    res = testing.ABTestRunner(Config(sr_model="FW_fastvgg_x2", device_platform="cpu"),
                               tmp_path / "port").run(
        src, [testing.ABVariant(n, o) for n, o in names])
    jres = jtesting.ABTestRunner(JConfig(sr_model="FW_fastvgg_x2"), tmp_path / "jax").run(
        src, [jtesting.ABVariant(n, o) for n, o in names])
    assert [r.variant for r in res] == [r.variant for r in jres] == ["bf16", "f32"]
    for r, jr in zip(res, jres):
        assert abs(r.psnr - jr.psnr) < 0.05 and abs(r.ssim - jr.ssim) < 1e-3, (r, jr)
        assert r.fps > 0 and r.seconds >= 0
        hp, fp = _planes(tmp_path / "port" / f"{r.variant}.y4m")
        hj, fj = _planes(tmp_path / "jax" / f"{r.variant}.y4m")
        assert hp == hj and len(fp) == len(fj) == 3
        for a, b in zip(fp, fj):
            d = np.abs(a.astype(np.int16) - b.astype(np.int16))
            assert d.max() <= RESTORE_MAX and d.mean() <= RESTORE_MEAN
    for (n, o), r in zip(names, res):
        out = tmp_path / f"cli_{n}.y4m"
        assert cli.main(["restore", str(src), "-o", str(out), "--model", "FW_fastvgg_x2",
                         "--dtype", o["compute_dtype"], "--device", "cpu", "--no-checkpoint",
                         "--project-dir", str(tmp_path / f"cli_{n}")]) == 0
        assert json.loads(capsys.readouterr().out)["quality"]["psnr"] == pytest.approx(r.psnr,
                                                                                      abs=0.01)
        assert out.read_bytes() == (tmp_path / "port" / f"{n}.y4m").read_bytes()
    for metric in ("psnr", "ssim"):
        assert testing.ABTestRunner.winner(res, metric).variant == \
            jtesting.ABTestRunner.winner(jres, metric).variant


# -- engine.temporal ---------------------------------------------------------------------

def _chunker(mod, frames, cs, ov):
    calls = []

    def process(chunk):
        calls.append(len(chunk))
        k = len(calls)
        return [np.clip(f.astype(np.int16) + 7 * k - 10, 0, 255).astype(np.uint8)
                for f in chunk]

    out = list(mod.ChunkedProcessor(process, cs, ov).process_stream(iter(frames)))
    return out, calls


@pytest.mark.parametrize("n,cs,ov", [(0, 4, 1), (3, 4, 1), (5, 4, 1), (12, 4, 2), (13, 5, 4),
                                     (8, 3, 0)])
def test_chunked_processor_equals_jax(n, cs, ov):
    frames = list(_smooth(n, 6, 8)) if n else []
    got, calls = _chunker(temporal, frames, cs, ov)
    want, jcalls = _chunker(jtemporal, frames, cs, ov)
    assert calls == jcalls and len(got) == len(want) == n
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_chunked_processor_refuses_an_overlap_of_a_whole_chunk():
    with pytest.raises(ValueError, match="overlap"):
        temporal.ChunkedProcessor(lambda c: c, 4, 4)


def test_long_form_manager_equals_jax():
    frames = [np.clip(f.astype(np.int16) + 3 * t, 0, 255).astype(np.uint8)
              for t, f in enumerate(_smooth(11, 16, 24, seed=5))]
    outs = []
    for mod in (temporal, jtemporal):
        mgr = mod.LongFormConsistencyManager(chunk_size=4, overlap=2, anchor_every=3,
                                             color_strength=0.7)
        with pytest.raises(ValueError, match="analyze"):
            next(mgr.process_stream(iter(frames), lambda c: c))
        anchors = mgr.analyze(iter(frames))
        assert anchors.total_frames == 11 and len(anchors.points) == 4
        outs.append(list(mgr.process_stream(iter(frames), lambda c: [f[::-1] for f in c])))
    assert len(outs[0]) == len(outs[1]) == 11
    assert all(np.array_equal(a, b) for a, b in zip(*outs))


# -- ops.metrics -------------------------------------------------------------------------

@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("shape", [(64, 80, 3), (2, 48, 96, 3)])
def test_ms_ssim_equals_jax(levels, shape):
    rng = np.random.default_rng(levels)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape).astype(np.float32), 0, 1)
    got = float(metrics.ms_ssim(torch.from_numpy(a), torch.from_numpy(b), levels=levels))
    want = float(jmetrics.ms_ssim(jnp.asarray(a), jnp.asarray(b), levels=levels))
    assert abs(got - want) < 1e-5 and 0 < got < 1


def test_host_metrics_and_gate_equal_jax():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    b = np.clip(a.astype(np.int16) + rng.integers(-6, 7, a.shape), 0, 255).astype(np.uint8)
    assert metrics.psnr_np(a, b) == jmetrics.psnr_np(a, b)
    assert metrics.psnr_np(a, a) == jmetrics.psnr_np(a, a) == float("inf")
    assert abs(metrics.ssim_np(a, b) - jmetrics.ssim_np(a, b)) < 1e-5
    x = a[None].astype(np.float32) / 255
    for y, thresholds in ((b[None].astype(np.float32) / 255, {}),
                          (np.clip(x + 0.2, 0, 1), {}),
                          (b[None].astype(np.float32) / 255, {"min_psnr": 40.0})):
        ok, m = metrics.quality_gate(torch.from_numpy(x), torch.from_numpy(y), **thresholds)
        jok, jm = jmetrics.quality_gate(jnp.asarray(x), jnp.asarray(y), **thresholds)
        assert ok == jok and m.keys() == jm.keys()
        # PSNR within 1e-3 dB, as tests/test_torch_quality.py holds ``psnr``
        assert abs(m["psnr"] - jm["psnr"]) < 1e-3 and abs(m["ssim"] - jm["ssim"]) < 1e-5
        assert (m["min_psnr"], m["min_ssim"]) == (jm["min_psnr"], jm["min_ssim"])


# -- single functions and methods --------------------------------------------------------

def test_profile_frames_equals_jax():
    rng = np.random.default_rng(4)
    clip = [np.clip(f + rng.normal(0, 9.0, f.shape[:2])[..., None], 0, 255).astype(np.uint8)
            for f in _smooth(14, 48, 64).astype(np.float32)]
    for n in (4, 12):
        assert noise_profiler.profile_frames(clip, n).to_dict() == \
            jprof.profile_frames(clip, n).to_dict()


def test_encode_indices_equals_jax():
    cfg_kw = dict(img_size=64, nf=8, ch_mult=(1, 2, 4), res_blocks=1, attn_resolution=16,
                  emb_dim=16, codebook_size=32, dim_embd=32, n_head=4, n_layers=2,
                  connect=(32,))
    jcfg = jcf.CodeFormerConfig(**cfg_kw)
    params = jax.tree_util.tree_map(np.asarray, jcf.init(jax.random.PRNGKey(9), jcfg))
    tree = {**params, "n_head": np.asarray(4)}
    pcfg = cf.config_from_params(tree)
    net = cf.CodeFormer.from_state_dict(pcfg, registry.from_jax_params(tree, torch.float32),
                                        "cpu")
    x = np.random.default_rng(5).random((2, 64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        got = cf.encode_indices(net, torch.from_numpy(x)).numpy()
    want = np.asarray(jcf.encode_indices(params, jnp.asarray(x), jcfg))
    assert got.shape == want.shape == (2, 16, 16)
    assert (got == want).mean() >= 0.99 and len(np.unique(got)) > 1


def test_checkpoint_stage_methods_equal_jax(tmp_path):
    src = _clip(tmp_path / "c.y4m")
    states = []
    for mod, d in ((checkpoint, "p"), (jckpt, "j")):
        m = mod.CheckpointManager(tmp_path / d)
        m.start(src, "cfg", total_frames=3)
        trace = [m.is_stage_complete("sr")]
        m.stage_started("sr")
        ck = json.loads(next((tmp_path / d).glob("*.json")).read_text())
        trace += [ck["current_stage"], m.is_stage_complete("sr")]
        m.stage_completed("sr")
        ck = json.loads(next((tmp_path / d).glob("*.json")).read_text())
        trace += [ck["current_stage"], ck["completed_stages"], m.is_stage_complete("sr"),
                  m.is_stage_complete("encode")]
        states.append(trace)
    assert states[0] == states[1] == [False, "sr", False, "", ["sr"], True, False]


# -- processors.base and the process methods ---------------------------------------------

def _doubler(mod):
    class Doubler(mod.FrameProcessor):
        name, scale = "doubler", 2

        def __init__(self):
            self.log = []

        def setup(self, h, w):
            self.log.append(("setup", h, w))

        def process_batch(self, frames):
            self.log.append(("batch", len(frames)))
            return frames.repeat(2, 1).repeat(2, 2) // 2

        def teardown(self):
            self.log.append(("teardown",))

    return Doubler()


@pytest.mark.parametrize("n,bs", [(5, 2), (4, 4), (1, 8)])
def test_frame_processor_streams_as_jax(n, bs):
    frames = list(_smooth(n, 4, 6))
    p, jp = _doubler(base), _doubler(jbase)
    got = list(p.process_video(iter(frames), bs))
    want = list(jp.process_video(iter(frames), bs))
    assert p.log == jp.log and len(got) == len(want) == n
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert p.output_size(4, 6) == jp.output_size(4, 6) == (8, 12)
    assert base.FrameProcessor.fps_factor == jbase.FrameProcessor.fps_factor == 1.0
    with pytest.raises(NotImplementedError):
        base.FrameProcessor().process_batch(frames[0][None])


def test_result_timer_and_shape_check_equal_jax():
    for mod, err in ((base, errors.StageError), (jbase, jerr.StageError)):
        r = mod.ProcessorResult("sr", frames_processed=12, duration_s=3.0)
        assert r.fps == 4.0 and mod.ProcessorResult("x").fps == 0.0 and r.metrics == {}
        with mod.Timer() as t:
            time.sleep(0)
        assert t.dt >= 0
        mod.require_shape(np.zeros((1, 2, 2, 3)), "sr")
        with pytest.raises(err) as info:
            mod.require_shape(np.zeros((2, 2, 3)), "enhance")
        assert info.value.stage == "enhance" and "(B, H, W, 3)" in str(info.value)


def test_sr_process_batch_is_dispatch_then_materialize_and_near_jax():
    from framewright_tpu.processors import super_resolution as jsr
    from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution

    frames = _smooth(2, 20, 28)
    sr = SuperResolution(SRConfig(model_name="FW_fastvgg_x2", compute_dtype="float32",
                                  device="cpu"))
    sr.setup(20, 28)
    got = sr.process_batch(frames)
    assert np.array_equal(got, sr.materialize(sr.dispatch(frames)))
    jproc = jsr.SuperResolution(jsr.SRConfig(model_name="FW_fastvgg_x2", compute_dtype="float32",
                                             sharding="none"))
    jproc.setup(20, 28)
    want = jproc.process_batch(frames)
    assert got.shape == want.shape == (2, 40, 56, 3)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= RESTORE_MAX and d.mean() <= RESTORE_MEAN


def test_attention_process_stream_is_reduce_stream():
    from framewright_tpu_torch.processors.temporal_attention import CFAConfig, CrossFrameAttention

    frames = list(_smooth(5, 16, 24))
    a = list(CrossFrameAttention(CFAConfig(), device="cpu").process_stream(iter(frames)))
    b = list(CrossFrameAttention(CFAConfig(), device="cpu").reduce_stream(iter(frames)))
    assert len(a) == len(b) == 5 and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_guided_process_stream_equals_jax(tmp_path):
    from PIL import Image

    from framewright_tpu.processors import guided as jg
    from framewright_tpu_torch.processors import guided as pg

    stills = tmp_path / "stills"
    stills.mkdir()
    Image.fromarray(_smooth(1, 20, 24, seed=8)[0]).save(stills / "a.png")
    frames = list(_smooth(3, 16, 20))
    kw = dict(prompt="warm cinematic grain", seed=3)
    for ref in (None, str(stills)):
        got = list(pg.make_backend(pg.GuidedConfig(**kw), ref).process_stream(iter(frames)))
        want = list(jg.make_backend(jg.GuidedConfig(**kw), ref).process_stream(iter(frames)))
        assert len(got) == 3 and all(np.array_equal(a, b) for a, b in zip(got, want))
    jb = jg.ReferenceGuidedBackend(str(stills), strength=0.5, seed=2)
    pb = pg.ReferenceGuidedBackend(str(stills), strength=0.5, seed=2)
    assert all(np.array_equal(a, b) for a, b in zip(pb.process_stream(iter(frames)),
                                                    jb.process_stream(iter(frames))))
