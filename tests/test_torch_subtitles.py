"""The port's format tools (``processors/format.py``: ``Deinterlacer``,
``InverseTelecine``, ``LetterboxDetector``, ``AspectCorrector``), OCR
(``processors/ocr.py``), subtitles (``processors/subtitles.py``) and the
``subtitles`` verb, held to the JAX package on the same seeded frames.

Tolerances: everything is the JAX package's numpy and equals it, but
``AspectCorrector``'s bicubic resize, which runs in f32 through the
port's ``layers.resize_bicubic``: within 1e-5 before the uint8 cast (the
quality gate's bound), so uint8 within 1 LSB. Tesseract runs only as the
stand-in script these tests put on ``PATH``.
"""

from __future__ import annotations

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framewright_tpu import cli as jcli
from framewright_tpu.models.layers import resize_bicubic as jresize
from framewright_tpu.processors import format as jfmt
from framewright_tpu.processors import ocr as jocr
from framewright_tpu.processors import subtitles as jsub
from framewright_tpu_torch import cli as pcli
from framewright_tpu_torch.io.y4m import Y4MWriter
from framewright_tpu_torch.models import layers
from framewright_tpu_torch.processors import format as pfmt
from framewright_tpu_torch.processors import ocr as pocr
from framewright_tpu_torch.processors import subtitles as psub

FPS = 25.0


def _textured(rng, h=48, w=64):
    return (rng.random((h, w, 3)) * 200 + 20).astype(np.uint8)


def _subtitle_clip(n=40, h=48, w=64, seed=0):
    """Noise frames with a bright stroked block in the bottom band on
    frames 10-21 and 28-35."""
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(n):
        f = (rng.random((h, w, 3)) * 90).astype(np.uint8)
        if 10 <= t < 22 or 28 <= t < 36:
            y0 = int(h * 0.84)
            f[y0:y0 + max(2, h // 8), w // 5:w * 4 // 5] = 245
            f[y0 + 1:y0 + max(2, h // 8) - 1, w // 5 + 1:w * 4 // 5 - 1:3] = 30
        frames.append(f)
    return frames


@pytest.fixture
def fake_tess(tmp_path, monkeypatch):
    exe = tmp_path / "bin" / "tesseract"
    exe.parent.mkdir()
    exe.write_text("#!/bin/sh\ncat > /dev/null\necho 'HELLO ,, WORLD ..'\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{exe.parent}:{os.environ['PATH']}")
    return exe


# -- format ------------------------------------------------------------------------


@pytest.mark.parametrize("method,order", [("blend", "tff"), ("skip", "bff")])
def test_deinterlacer_equals_jax(method, order):
    rng = np.random.default_rng(1)
    frames = [_textured(rng) for _ in range(3)]
    got = list(pfmt.Deinterlacer(method, order).process_stream(iter(frames)))
    want = list(jfmt.Deinterlacer(method, order).process_stream(iter(frames)))
    assert all(np.array_equal(g, w) for g, w in zip(got, want)) and len(got) == 3


@pytest.mark.parametrize("cadence", [True, False])
def test_inverse_telecine_equals_jax(cadence):
    rng = np.random.default_rng(2)
    frames = []
    for i in range(30):
        if cadence and i % 5 == 3:
            frames.append(frames[-1].copy())
        else:
            frames.append(_textured(rng, 32, 48))
    pres, jres = pfmt.TelecineResult(), jfmt.TelecineResult()
    got = list(pfmt.InverseTelecine().process_stream(iter(frames), pres))
    want = list(jfmt.InverseTelecine().process_stream(iter(frames), jres))
    assert pfmt.InverseTelecine().detect_cadence(frames) == \
        jfmt.InverseTelecine().detect_cadence(frames)
    assert (pres.pattern_found, pres.frames_in, pres.frames_out) == \
        (jres.pattern_found, jres.frames_in, jres.frames_out)
    assert pres.pattern_found == cadence and len(got) == len(want)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("bars", [(6, 6, 0, 0), (0, 0, 9, 9), (30, 0, 0, 0), (0, 0, 0, 0)])
def test_letterbox_equals_jax(bars):
    rng = np.random.default_rng(3)
    top, bottom, left, right = bars
    frames = []
    for _ in range(12):
        f = _textured(rng, 64, 96)
        f[:top] = 5
        f[64 - bottom:] = 5
        f[:, :left] = 3
        f[:, 96 - right:] = 3
        frames.append(f)
    got = pfmt.LetterboxDetector().detect(iter(frames))
    want = jfmt.LetterboxDetector().detect(iter(frames))
    assert (got.top, got.bottom, got.left, got.right) == \
        (want.top, want.bottom, want.left, want.right)
    assert got.any == want.any
    assert np.array_equal(got.crop(frames[0]), want.crop(frames[0]))


@pytest.mark.parametrize("dar", [16 / 9, 4 / 3, 64 / 48])
def test_aspect_corrector_matches_jax(dar):
    frame = _textured(np.random.default_rng(4), 48, 64)
    want = jfmt.AspectCorrector(dar).correct(frame)
    got = pfmt.AspectCorrector(dar, device="cpu").correct(frame)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    if got.shape != frame.shape:
        x = frame[None].astype(np.float32) / 255.0
        jf = np.asarray(jresize(jnp.asarray(x), got.shape[:2]))
        pf = layers.resize_bicubic(torch.from_numpy(x), got.shape[:2]).numpy()
        assert np.abs(pf - jf).max() <= 1e-5


# -- OCR ---------------------------------------------------------------------------


def test_ppm_and_preprocess_equal_jax():
    rng = np.random.default_rng(5)
    rgb = _textured(rng, 40, 60)
    assert pocr._to_ppm(rgb) == jocr._to_ppm(rgb)
    assert pocr._to_ppm(rgb[..., 0]) == jocr._to_ppm(rgb[..., 0])
    for band in (0.28, 0.5):
        assert np.array_equal(pocr.preprocess_subtitle_band(rgb, band),
                              jocr.preprocess_subtitle_band(rgb, band))


def test_no_tesseract_no_ocr(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    assert pocr.find_tesseract() is None and pocr.default_ocr_fn() is None
    with pytest.raises(RuntimeError, match="tesseract binary not found"):
        pocr.TesseractOCR()


def test_tesseract_protocol_as_jax(fake_tess, tmp_path, monkeypatch):
    frame = _textured(np.random.default_rng(6), 64, 96)
    assert pocr.find_tesseract() == str(fake_tess) == jocr.find_tesseract()
    assert pocr.TesseractOCR()(frame) == jocr.TesseractOCR()(frame) == "HELLO ,, WORLD .."
    bad = tmp_path / "bad" / "tesseract"
    bad.parent.mkdir()
    bad.write_text("#!/bin/sh\nexit 3\n")
    bad.chmod(bad.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bad.parent))
    assert pocr.TesseractOCR()(frame) == ""


# -- subtitles ----------------------------------------------------------------------


def _events(mod, frames, **kw):
    return [(e.index, e.start_frame, e.end_frame, e.text)
            for e in mod.SubtitleTimingExtractor(**kw).analyze(iter(frames))]


@pytest.mark.parametrize("region", ["bottom", "top", "full"])
def test_timing_extractor_equals_jax(region):
    frames = _subtitle_clip(seed=7)
    calls = []

    def ocr(f):
        calls.append(f.shape)
        return f"text {len(calls)}"

    got = _events(psub, frames, min_frames=4, region=region, ocr_fn=ocr)
    n = len(calls)
    calls.clear()
    assert got == _events(jsub, frames, min_frames=4, region=region, ocr_fn=ocr)
    assert n == len(calls)
    if region == "bottom":
        assert [e[1:3] for e in got] == [(10, 22), (28, 36)]
    assert psub.export_srt([psub.SubtitleEvent(*e) for e in got], FPS) == \
        jsub.export_srt([jsub.SubtitleEvent(*e) for e in got], FPS)
    assert [(e.start_frame, e.end_frame) for e in psub.shift_events(
        [psub.SubtitleEvent(*e) for e in got], -11)] == \
        [(e.start_frame, e.end_frame) for e in jsub.shift_events(
            [jsub.SubtitleEvent(*e) for e in got], -11)]
    assert _events(psub, []) == []


def _track(mod, starts, dur=1.8, texts=None):
    return mod.SubtitleTrack(lines=[
        mod.SubtitleLine(i + 1, s, s + dur, texts[i] if texts else f"line {i + 1}",
                         (100, 400) if i % 2 else None)
        for i, s in enumerate(starts)])


def _lines(track):
    return [(ln.index, ln.start, ln.end, ln.text, ln.position) for ln in track.lines]


def test_srt_round_trip_and_adjustments_equal_jax():
    texts = ["Hello there.", "- Two\n- lines", "tail"]
    p, j = _track(psub, [1.04, 5.2, 3599.879], texts=texts), _track(jsub, [1.04, 5.2, 3599.879],
                                                                     texts=texts)
    assert psub.format_srt(p) == jsub.format_srt(j)
    srt = jsub.format_srt(j).replace("\n", "\r\n").replace(",", ".", 1)
    assert _lines(psub.parse_srt(srt)) == _lines(jsub.parse_srt(srt))
    S, J = psub.SubtitleTimeSync, jsub.SubtitleTimeSync
    for name, args in (("apply_offset", (-2.0,)), ("adjust_for_duration_change", (100.0, 104.0)),
                       ("adjust_for_speed_change", (1.25,)), ("correct_drift", (0.6,))):
        assert _lines(getattr(S, name)(p, *args)) == _lines(getattr(J, name)(j, *args)), name
    with pytest.raises(ValueError):
        S.adjust_for_speed_change(p, 0)


@pytest.mark.parametrize("case", ["drift", "spurious", "few"])
def test_sync_to_events_equals_jax(case):
    rng = np.random.default_rng(8)
    true = np.sort(rng.uniform(2.0, 110.0, 24))
    true = np.asarray([s for i, s in enumerate(true) if i == 0 or s - true[i - 1] > 2.5])
    if case == "few":
        true = true[:2]
    starts = list((true + 1.8) / 1.008)
    det = [int(round(s * FPS)) for s in true]
    if case == "spurious":
        det = sorted(det[::2] + [int(v * FPS) for v in rng.uniform(2, 110, 5)])
    got, want = (mod.SubtitleTimeSync.sync_to_events(
        _track(mod, starts), [mod.SubtitleEvent(i + 1, s, s + 40) for i, s in enumerate(det)],
        FPS) for mod in (psub, jsub))
    assert _lines(got) == _lines(want)
    sub, vid = starts, [d / FPS for d in det]
    assert psub.SubtitleTimeSync.estimate_alignment(sub, vid) == \
        jsub.SubtitleTimeSync.estimate_alignment(sub, vid)


def test_speech_onsets_and_audio_sync_equal_jax():
    sr = 16000
    rng = np.random.default_rng(9)
    audio = rng.normal(0, 0.002, sr * 40).astype(np.float32)
    starts = np.arange(2.0, 38.0, 3.1)
    for s in starts:
        i = int(s * sr)
        audio[i:i + int(0.8 * sr)] += 0.3 * np.sin(np.arange(int(0.8 * sr)) * 0.2)
    assert psub.speech_onsets(audio, sr) == jsub.speech_onsets(audio, sr)
    assert psub.speech_onsets(audio[:10], sr) == jsub.speech_onsets(audio[:10], sr) == []
    subs = list((starts - 0.7) / 1.004)
    got = psub.SubtitleTimeSync.sync_to_audio(_track(psub, subs), audio[:, None], sr)
    want = jsub.SubtitleTimeSync.sync_to_audio(_track(jsub, subs), audio[:, None], sr)
    assert _lines(got) == _lines(want)


def test_enhancer_equals_jax():
    texts = ["hel0lo  wor1d ,,quoted'' .", "lIne x  here..more", "- a\n-b", "q", "..."]
    for scale in (1.0, 2.0):
        got = psub.SubtitleEnhancer.enhance(_track(psub, [1, 3, 5, 7, 9], texts=texts), scale)
        want = jsub.SubtitleEnhancer.enhance(_track(jsub, [1, 3, 5, 7, 9], texts=texts), scale)
        assert _lines(got) == _lines(want)


# -- the verb --------------------------------------------------------------------------


def _clip_file(tmp_path, n=40, h=96, w=128):
    path = tmp_path / "subs.y4m"
    with Y4MWriter(path, w, h, fps=FPS) as wr:
        for f in _subtitle_clip(n, h, w, seed=10):
            wr.write_frame(f)
    return path


def _verb(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("mode", ["no-ocr", "ocr", "no-backend", "sync", "enhance", "sync+enhance"])
def test_subtitles_verb_as_jax(tmp_path, capsys, monkeypatch, fake_tess, mode):
    clip = _clip_file(tmp_path)
    srt = tmp_path / "in.srt"
    srt.write_text(jsub.format_srt(_track(jsub, [0.2, 1.0], texts=["hel0lo ,,x''", "b..c"])))
    if mode == "no-backend":
        monkeypatch.setenv("PATH", "/nonexistent")
    res = {}
    for name, main in (("jax", jcli.main), ("port", pcli.main)):
        out = tmp_path / f"{name}.srt"
        argv = ["subtitles", str(clip), "-o", str(out)]
        argv += {"no-ocr": ["--no-ocr"], "ocr": [], "no-backend": [],
                 "sync": ["--sync", str(srt)], "enhance": ["--enhance", str(srt), "--scale", "2"],
                 "sync+enhance": ["--sync", str(srt), "--enhance", str(srt)]}[mode]
        rc, stdout, stderr = _verb(main, argv, capsys)
        assert rc == 0
        res[name] = (stdout.replace(str(out), "<o>"), stderr.strip().splitlines()[-1:]
                     if mode == "no-backend" else [], out.read_text())
    assert res["port"] == res["jax"]
    if mode == "ocr":
        assert "HELLO ,, WORLD .." in res["port"][2]
    if mode == "no-ocr":
        assert res["port"][0].startswith("2 subtitle events")
