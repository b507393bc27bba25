"""The port's audio chain (``framewright_tpu_torch/audio.py``), mask net
(``models/audio_net.py``), separation (``audio_separation.py``) and the
``audio`` and ``audio-sync`` verbs, held to the JAX package on the same
seeded numpy signals.

Tolerances: the numpy stages (WAV I/O, hum, clicks, spectral
subtraction, loudness, sync, DSP separation, dialog) equal JAX's. The
device stages in f32: the percentile within 1e-6 relative, the mask
net's gains within 1e-5, the Wiener float output within 1e-5 of the
output's peak, and the written 16-bit PCM within 1 LSB on at most 0.1%
of the samples (``write_wav`` truncates, so a value within ~1e-6 of an
integer code flips under any FFT difference).
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framewright_tpu import audio as ja
from framewright_tpu import audio_separation as jsep
from framewright_tpu import cli as jcli
from framewright_tpu.models import audio_net as jnet
from framewright_tpu_torch import audio as pa
from framewright_tpu_torch import audio_separation as psep
from framewright_tpu_torch import cli as pcli
from framewright_tpu_torch.errors import InputError
from framewright_tpu_torch.models import audio_net as pnet

SR = 48000
GAIN_TOL = 1e-5
PCM_FRAC = 1e-3


def _signal(seconds=2.0, seed=0, channels=2):
    """Speech-like harmonics plus white and hum noise, stereo, in [-1, 1]."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    cols = []
    for c in range(channels):
        clean = jnet.synth_clean(rng, n, SR)
        noise = jnet.synth_noise(rng, n, SR)
        cols.append(0.6 * clean + 0.15 * noise)
    x = np.stack(cols, 1).astype(np.float32)
    x[n // 3, 0] += 0.5                      # a click
    return np.clip(x, -1, 1)


def _pcm_within(got: np.ndarray, want: np.ndarray) -> dict:
    g = np.clip(got * 32767.0, -32768, 32767).astype(np.int16).astype(np.int32)
    w = np.clip(want * 32767.0, -32768, 32767).astype(np.int16).astype(np.int32)
    d = np.abs(g - w)
    stats = {"max": int(d.max()), "frac": float((d > 0).mean())}
    assert stats["max"] <= 1 and stats["frac"] <= PCM_FRAC, stats
    return stats


# -- numpy stages: equal -----------------------------------------------------------


def test_wav_io_equals_jax(tmp_path):
    x = _signal(0.5)
    ja.write_wav(tmp_path / "j.wav", x, SR)
    pa.write_wav(tmp_path / "p.wav", x, SR)
    assert (tmp_path / "j.wav").read_bytes() == (tmp_path / "p.wav").read_bytes()
    jx, jsr = ja.read_wav(tmp_path / "j.wav")
    px, psr = pa.read_wav(tmp_path / "j.wav")
    assert jsr == psr == SR and np.array_equal(jx, px)
    pa.write_wav(tmp_path / "m.wav", x[:, 0], SR)
    assert pa.read_wav(tmp_path / "m.wav")[0].shape == (len(x), 1)


@pytest.mark.parametrize("stage", ["hum", "click", "spectral", "normalize"])
def test_numpy_filters_equal_jax(stage):
    x = _signal(1.0, seed=1)
    j, p = {"hum": (ja.HumRemover(60.0), pa.HumRemover(60.0)),
            "click": (ja.ClickRemover(), pa.ClickRemover()),
            "spectral": (ja.SpectralDenoiser(0.8), pa.SpectralDenoiser(0.8)),
            "normalize": (ja.Normalizer(-20.0), pa.Normalizer(-20.0))}[stage]
    assert np.array_equal(p.process(x, SR), j.process(x, SR))


def test_sync_analyzer_and_corrector_equal_jax():
    rng = np.random.default_rng(3)
    base = rng.normal(0, 0.1, SR * 12).astype(np.float32)
    test = np.concatenate([np.zeros(int(0.25 * SR), np.float32), base])[: len(base)]
    kw = dict(window_s=1.0, step_s=3.0)
    want = ja.AudioSyncAnalyzer(**kw).analyze(base[:, None], test[:, None], SR)
    got = pa.AudioSyncAnalyzer(**kw).analyze(base[:, None], test[:, None], SR)
    assert got == want and abs(abs(got["offset_s"]) - 0.25) < 0.02
    for off, drift in ((0.1, 0.0), (-0.05, 0.004)):
        assert np.array_equal(pa.AudioSyncCorrector.correct(test[:, None], SR, off, drift),
                              ja.AudioSyncCorrector.correct(test[:, None], SR, off, drift))


def test_band_matrix_equals_jax():
    for bins in (481, 513):
        assert np.array_equal(pa.band_matrix(bins), ja.WienerMaskDenoiser()._band_matrix(bins))


# -- the device stages ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 32), (300, 32), (2 ** 19 + 1, 32)],
                         ids=["tiny", "clip", "over-2**24"])
def test_percentile_is_jax_linear_rule(shape):
    """JAX's ``percentile(x, 20, axis=0)``, also above 2**24 elements (a
    (T, 32) track of ~87 minutes at hop 480), where ``torch.quantile``
    refuses the whole tensor."""
    x = np.random.default_rng(4).gamma(1.5, 2.0, shape).astype(np.float32)
    if x.size > 2 ** 24:
        with pytest.raises(RuntimeError, match="too large"):
            torch.quantile(torch.from_numpy(x).flatten(), 0.2)
    want = np.asarray(jnp.percentile(jnp.asarray(x), 20.0, axis=0))
    got = pa.percentile_linear(torch.from_numpy(x), 20.0, 0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_wiener_matches_jax():
    x = _signal(2.0, seed=5)
    want = ja.WienerMaskDenoiser(0.9).process(x, SR)
    got = pa.WienerMaskDenoiser(0.9, device="cpu").process(x, SR)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    _pcm_within(got, want)


@pytest.mark.parametrize("which", ["mask", "sep", "seeded"])
def test_mask_net_gains_match_jax(which):
    params = {"mask": lambda: jnet.load_params(),
              "sep": lambda: jnet.load_params(jnet._SEP_CKPT),
              "seeded": lambda: jnet.init_params(11)}[which]()
    if which == "seeded":
        assert all(np.array_equal(v, pnet.init_params(11)[k]) for k, v in params.items())
        params["gru_b"] = np.random.default_rng(12).normal(0, 0.3, 144).astype(np.float32)
    band_pow = np.random.default_rng(6).gamma(1.2, 1e-3, (250, 32)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(band_pow)))
    got = pnet.apply(params, torch.from_numpy(band_pow)).numpy()
    assert got.shape == (250, 32)
    assert np.abs(got - want).max() <= GAIN_TOL
    fn = pnet.make_mask_fn(params, device="cpu")
    assert isinstance(fn(band_pow), np.ndarray)
    assert torch.equal(fn(torch.from_numpy(band_pow)), torch.from_numpy(fn(band_pow)))


def test_gru_module_carries_jax_gates():
    """One step of ``nn.GRU`` with the reordered weights and zero
    ``bias_hh`` is JAX's step (gates z, r, n; r inside the n gate's hidden
    product, no hidden bias)."""
    rng = np.random.default_rng(13)
    p = pnet.init_params(2)
    p["gru_b"] = rng.normal(0, 0.5, 144).astype(np.float32)
    x = rng.normal(0, 1, (48,)).astype(np.float32)
    h = rng.normal(0, 1, (48,)).astype(np.float32)
    nh = 48
    gi, gh = x @ p["gru_wi"] + p["gru_b"], h @ p["gru_wh"]

    def sig(v):
        return 1 / (1 + np.exp(-v))

    z = sig(gi[:nh] + gh[:nh])
    r = sig(gi[nh:2 * nh] + gh[nh:2 * nh])
    n = np.tanh(gi[2 * nh:] + r * gh[2 * nh:])
    want = (1 - z) * n + z * h
    gru = pnet.gru_module(p, torch.device("cpu"))
    with torch.no_grad():
        got, _ = gru(torch.from_numpy(x)[None, None], torch.from_numpy(h)[None, None])
    assert float(gru.bias_hh_l0.abs().max()) == 0.0
    np.testing.assert_allclose(got[0, 0].numpy(), want, atol=1e-6)


def test_ai_enhancer_matches_jax():
    x = _signal(2.0, seed=7)
    cfg = dict(denoise_model="ai", hum_freq=60.0)
    want = ja.AudioEnhancer(ja.AudioEnhanceConfig(**cfg)).process(x, SR)
    got = pa.AudioEnhancer(pa.AudioEnhanceConfig(**cfg, device="cpu")).process(x, SR)
    _pcm_within(got, want)


def test_ai_without_its_checkpoint_raises_before_any_compute(tmp_path, monkeypatch):
    """JAX falls back to the Wiener estimator without a word
    (``framewright_tpu/audio.py:296-317``); the port names the file and
    computes nothing."""
    def never(*a, **k):
        raise AssertionError("computed before the checkpoint was read")

    monkeypatch.setattr(pa.ClickRemover, "process", never)
    monkeypatch.setattr(pa.WienerMaskDenoiser, "process", never)
    bad = tmp_path / "corrupt.npz"
    bad.write_bytes(b"PK\x03\x04 not a zip")
    for path in (tmp_path / "missing.npz", bad):
        with pytest.raises(InputError, match=str(path.name)):
            pa.AudioEnhancer(pa.AudioEnhanceConfig(denoise_model="ai", ai_checkpoint=path,
                                                   device="cpu")).process(_signal(0.2), SR)
    half = tmp_path / "half.npz"
    np.savez(half, conv_w=np.zeros((5, 32, 48), np.float32))
    with pytest.raises(InputError, match="half.npz"):
        pnet.load_params(half)


@pytest.mark.parametrize("backend", ["dsp", "auto"])
def test_separator_matches_jax(backend):
    x = _signal(2.0, seed=8)
    want = jsep.AudioSeparator(jsep.SeparationConfig(backend=backend)).separate(x, SR)
    got = psep.AudioSeparator(psep.SeparationConfig(backend=backend, device="cpu")).separate(x, SR)
    for k in ("vocals", "background"):
        if backend == "dsp":
            assert np.array_equal(got[k], want[k]), k
        else:
            assert np.abs(got[k] - want[k]).max() <= 1e-5 * np.abs(want[k]).max(), k
            _pcm_within(np.clip(got[k], -1, 1), np.clip(want[k], -1, 1))
    np.testing.assert_allclose(got["vocals"] + got["background"], x, atol=1e-6)


def test_dialog_enhancer_equals_jax():
    x = _signal(1.0, seed=9)
    assert np.array_equal(psep.DialogEnhancer().process(x, SR),
                          jsep.DialogEnhancer().process(x, SR))
    assert np.array_equal(psep.DialogEnhancer().process(x[:, 0], SR),
                          jsep.DialogEnhancer().process(x[:, 0], SR))


# -- the verbs ----------------------------------------------------------------------


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("flags", [["--denoise-model", "ai"], ["--denoise-model", "spectral"],
                                   ["--dialog"], ["--separate"]],
                         ids=["ai", "spectral", "dialog", "separate"])
def test_audio_verb_prints_and_writes_as_jax(tmp_path, capsys, flags):
    src = tmp_path / "in.wav"
    pa.write_wav(src, _signal(1.5, seed=10), SR)
    outs = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", pcli.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        if flags == ["--separate"]:
            argv = ["audio", str(src), "--separate", str(d)]
        else:
            argv = ["audio", str(src), str(d / "out.wav"), *flags]
        rc, out, _ = _run(main, argv + extra, capsys)
        assert rc == 0
        outs[name] = (out.replace(str(d), "<d>"), d)
    assert outs["port"][0] == outs["jax"][0]
    for f in sorted(p.name for p in outs["jax"][1].iterdir()):
        want, _ = ja.read_wav(outs["jax"][1] / f)
        got, _ = pa.read_wav(outs["port"][1] / f)
        if flags[-1] in ("spectral", "--dialog"):
            assert np.array_equal(got, want), f
        else:
            _pcm_within(got, want)


def test_audio_verb_refusals(tmp_path, capsys):
    src = tmp_path / "in.wav"
    pa.write_wav(src, _signal(0.2), SR)
    rc, _, err = _run(pcli.main, ["audio", str(src)], capsys)
    assert rc == 1 and err.strip() == "error: output path required (or use --separate DIR)"


def test_audio_sync_verb_prints_jax_json(tmp_path, capsys):
    rng = np.random.default_rng(14)
    base = rng.normal(0, 0.1, SR * 4).astype(np.float32)
    test = np.concatenate([np.zeros(int(0.25 * SR), np.float32), base])[: len(base)]
    pa.write_wav(tmp_path / "ref.wav", base, SR)
    pa.write_wav(tmp_path / "test.wav", test, SR)
    res = {}
    for name, main in (("jax", jcli.main), ("port", pcli.main)):
        fix = tmp_path / f"{name}_fixed.wav"
        rc, out, _ = _run(main, ["audio-sync", str(tmp_path / "ref.wav"),
                                 str(tmp_path / "test.wav"), "--fix", str(fix)], capsys)
        assert rc == 0
        res[name] = json.loads(out)
        res[name].pop("fixed")
        res[name + "_wav"] = fix.read_bytes()
    assert res["port"] == res["jax"] and abs(abs(res["port"]["offset_s"]) - 0.25) < 0.02
    assert res["port_wav"] == res["jax_wav"]
    pa.write_wav(tmp_path / "other.wav", base, 16000)
    rc, _, err = _run(pcli.main, ["audio-sync", str(tmp_path / "ref.wav"),
                                  str(tmp_path / "other.wav")], capsys)
    assert rc == 1 and "sample-rate mismatch" in err
