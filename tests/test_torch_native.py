"""The port's native host codec (``framewright_tpu_torch.native``, its
copy of ``native/fwcore.cpp``) against its numpy copies and the JAX
package's ``framewright_tpu.native``: bit for bit; the fallbacks; the
Y4M reader and writer on it."""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pytest

from framewright_tpu import native as jnative
from framewright_tpu.io import y4m as jy4m
from framewright_tpu.ops import dhash as jdhash
from framewright_tpu_torch import native
from framewright_tpu_torch.io import y4m
from framewright_tpu_torch.ops import dhash

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "the native host codec did not build (it needs g++)"
    return lib


@pytest.fixture(scope="module")
def jlib():
    if jnative.get_lib() is None:
        pytest.skip("framewright_tpu.native did not load")
    return jnative


@pytest.fixture
def no_native(monkeypatch):
    """The library as if never loaded, with FRAMEWRIGHT_NO_NATIVE set."""
    monkeypatch.setenv("FRAMEWRIGHT_NO_NATIVE", "1")
    for name, value in (("_LIB", None), ("_TRIED", False), ("_WARNED", False)):
        monkeypatch.setattr(native, name, value)
    yield
    monkeypatch.setattr(native, "_TRIED", False)


def _planes(rng, h, w):
    y = rng.integers(0, 256, (h, w), np.uint8)
    u, v = (rng.integers(0, 256, (h // 2, w // 2), np.uint8) for _ in range(2))
    return y, u, v


def test_builds_from_the_ports_source_into_its_build_directory(lib):
    """Never JAX's native/libfwcore.so: the port's copy of the source,
    built into framewright_tpu_torch/ops/_build/fwcore-<hash>/."""
    path = native.lib_path()
    assert path.is_file() and lib._name == str(path)
    assert path.parent.parent == ROOT / "framewright_tpu_torch" / "ops" / "_build"
    assert native.SOURCE == ROOT / "framewright_tpu_torch" / "native" / "fwcore.cpp"
    assert lib.fwcore_version() == 1 and native.codec() == "native"
    # the same C++ as the JAX package's, comments aside
    code = [ln for ln in native.SOURCE.read_text().splitlines()
            if ln.strip() and not ln.lstrip().startswith("//")]
    jcode = [ln for ln in (ROOT / "native" / "fwcore.cpp").read_text().splitlines()
             if ln.strip() and not ln.lstrip().startswith("//")]
    assert code == jcode


@pytest.mark.parametrize("full", [False, True], ids=["limited", "full"])
@pytest.mark.parametrize("hw", [(48, 64), (1080, 1920)], ids=["48x64", "1080p"])
def test_decode_equals_numpy_and_jax_native(lib, jlib, full, hw):
    y, u, v = _planes(np.random.default_rng(hw[0] + full), *hw)
    got = native.yuv420_to_rgb(y, u, v, full_range=full)
    np.testing.assert_array_equal(got, y4m.yuv_to_rgb(y, u, v, full_range=full))
    np.testing.assert_array_equal(got, jlib.yuv420_to_rgb(y, u, v, full_range=full))


@pytest.mark.parametrize("full", [False, True], ids=["limited", "full"])
@pytest.mark.parametrize("hw", [(48, 64), (1080, 1920)], ids=["48x64", "1080p"])
def test_encode_equals_numpy_and_jax_native(lib, jlib, full, hw):
    rgb = np.random.default_rng(hw[1] + full).integers(0, 256, (*hw, 3), np.uint8)
    got = native.rgb_to_yuv420(rgb, full_range=full)
    for a, b, c in zip(got, y4m.rgb_to_yuv420(rgb, full_range=full),
                       jlib.rgb_to_yuv420(rgb, full_range=full)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_odd_sizes_fall_back_to_numpy(lib):
    """An odd side never reaches the library: the numpy copy's bytes (the
    float math of a chroma that is not 4:2:0 at even sizes)."""
    rng = np.random.default_rng(3)
    y, u, v = (rng.integers(0, 256, (9, 13), np.uint8) for _ in range(3))
    for full in (False, True):
        np.testing.assert_array_equal(native.yuv420_to_rgb(y, u, v, full_range=full),
                                      y4m.yuv_to_rgb(y, u, v, full_range=full))


def test_no_native_env_runs_numpy_and_warns_once(no_native, caplog):
    rng = np.random.default_rng(4)
    y, u, v = _planes(rng, 16, 24)
    rgb = rng.integers(0, 256, (16, 24, 3), np.uint8)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.codec() == "numpy" and not native.available()
        np.testing.assert_array_equal(native.yuv420_to_rgb(y, u, v), y4m.yuv_to_rgb(y, u, v))
        for a, b in zip(native.rgb_to_yuv420(rgb), y4m.rgb_to_yuv420(rgb)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(native.dhash_batch(rgb[None]),
                                      dhash.dhash_batch(rgb[None]))
    warnings = [r for r in caplog.records if "numpy copy runs instead" in r.message]
    assert len(warnings) == 1


def test_reader_and_writer_say_which_codec_ran(tmp_path, lib, no_native, monkeypatch):
    frames = np.random.default_rng(5).integers(0, 256, (2, 8, 12, 3), np.uint8)
    with y4m.Y4MWriter(tmp_path / "n.y4m", 12, 8) as w:
        assert w.codec == "numpy"
        for f in frames:
            w.write_frame(f)
    with y4m.Y4MReader(tmp_path / "n.y4m") as r:
        assert r.codec == "numpy"
        slow = list(r)
    monkeypatch.delenv("FRAMEWRIGHT_NO_NATIVE")
    monkeypatch.setattr(native, "_TRIED", False)
    with y4m.Y4MWriter(tmp_path / "f.y4m", 12, 8) as w:
        assert w.codec == "native"
        for f in frames:
            w.write_frame(f)
    assert (tmp_path / "f.y4m").read_bytes() == (tmp_path / "n.y4m").read_bytes()
    with y4m.Y4MReader(tmp_path / "f.y4m") as r:
        assert r.codec == "native"
        for a, b in zip(r, slow):
            np.testing.assert_array_equal(a, b)
    # 4:4:4 does not take the 4:2:0 codec
    with y4m.Y4MWriter(tmp_path / "m.y4m", 12, 8, colorspace="444") as w:
        assert w.codec == "numpy"


@pytest.mark.parametrize("cs", ["420jpeg", "420mpeg2"])
def test_y4m_files_equal_the_jax_packages(tmp_path, lib, gradient_frame, cs):
    """The port's writer and reader on the native codec against the JAX
    ones on theirs: the same file, the same decoded frames."""
    frames = [gradient_frame(24, 32, t) for t in range(3)]
    for pkg, name in ((y4m, "port"), (jy4m, "jax")):
        with pkg.Y4MWriter(tmp_path / f"{name}.y4m", 32, 24, fps=24, colorspace=cs) as w:
            for f in frames:
                w.write_frame(f)
    assert (tmp_path / "port.y4m").read_bytes() == (tmp_path / "jax.y4m").read_bytes()
    with y4m.Y4MReader(tmp_path / "jax.y4m") as a, jy4m.Y4MReader(tmp_path / "jax.y4m") as b:
        assert a.codec == "native"
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(fa, fb)


@pytest.mark.parametrize("hash_size", [8, 16])
def test_dhash_native_equals_jax_native(lib, jlib, gradient_frame, hash_size):
    rng = np.random.default_rng(hash_size)
    frames = np.stack([gradient_frame(48, 64, t) for t in range(3)]
                      + [rng.integers(0, 256, (48, 64, 3), np.uint8) for _ in range(3)])
    np.testing.assert_array_equal(native.dhash_batch(frames, hash_size),
                                  jlib.dhash_batch(frames, hash_size))


@pytest.mark.parametrize("hw", [(48, 64), (45, 70)])
def test_dhash_numpy_equals_jax(gradient_frame, hw):
    rng = np.random.default_rng(hw[1])
    frames = np.stack([gradient_frame(*hw, t) for t in range(3)]
                      + [rng.integers(0, 256, (*hw, 3), np.uint8) for _ in range(3)])
    for hs in (4, 8):
        np.testing.assert_array_equal(dhash.dhash_batch(frames, hs),
                                      jdhash.dhash_batch(frames, hs))
    bits = dhash.dhash_batch(frames)
    np.testing.assert_array_equal(dhash.hamming_similarity(bits[1:], bits[:-1]),
                                  jdhash.hamming_similarity(bits[1:], bits[:-1]))
    np.testing.assert_array_equal(dhash.consecutive_similarity(bits),
                                  jdhash.consecutive_similarity(bits))
    assert len(dhash.consecutive_similarity(bits[:0])) == 0
