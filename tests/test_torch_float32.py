"""``compute_dtype="float32"`` in the PyTorch port against the JAX package
on the CPU.

What JAX does with it (``framewright_tpu/processors/super_resolution.py``):
the f32 masters are kept (no bf16 rounding); RRDB runs its fused path, the
head in f32 on u8 / 255 in f32, the body and tail on the bf16 kernels
with weights cast from the f32 masters (the f32 head output rounded to
bf16 at the body's entry and K1's skip); SRVGG runs its plain f32
forward. The JAX fused path runs in interpret mode (``FW_INTERPRET=1``).

Tolerances: RRDB uint8 within 1 LSB with no bound on the share (outputs
in [0, 1], where one bf16 step is about one LSB: tests/test_torch_int8.py),
its float output against JAX's f32 ``apply`` within 0.05 max and 0.005
mean (tests/test_fused_tail3.py); SRVGG's f32 forward within 1e-4 (f32
against f32, summation order only).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from framewright_tpu.models import rrdb as jrrdb
from framewright_tpu.models import srvgg as jsrvgg
from framewright_tpu.models import torch_port
from framewright_tpu.models.registry import init_model
from framewright_tpu.processors.super_resolution import SRConfig as JaxSRConfig
from framewright_tpu.processors.super_resolution import SuperResolution as JaxSR
from framewright_tpu_torch import cli, planner
from framewright_tpu_torch.models import rrdb, srvgg
from framewright_tpu_torch.models.registry import get_model, init_params, load_weights
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution

FAST6 = "FW_fast6_x2"
VGG = "realesr-animevideov3"


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _u8(n, h, w, seed):
    rng = np.random.default_rng(seed)
    coarse = rng.random((n, h // 4 + 2, w // 4 + 2, 3))
    big = np.repeat(np.repeat(coarse, 4, axis=1), 4, axis=2)[:, :h, :w]
    return np.clip(big * 255 + rng.normal(0, 6, big.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def fast6():
    """FW_fast6_x2's trained weights: the JAX f32 params and the port's
    model on the same f32 masters (not rounded to bf16)."""
    spec, params = init_model(FAST6, dtype=jnp.float32, device=False)
    params = jrrdb.stack_body(params)
    _, sd, _ = load_weights(FAST6, dtype=torch.float32)
    model = rrdb.RRDBNet.from_state_dict(spec.arch_config, sd, torch.device("cpu"))
    return spec.arch_config, params, model


def _lsb(got, want):
    return int(np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int)).max())


def test_rrdb_float32_kernel_path_matches_jax(fast6):
    cfg, params, model = fast6
    x = _u8(1, 24, 40, seed=1).astype(np.float32) / 255.0
    jfast = jrrdb.make_fast_params(params)
    # limited range, as the other parity tests hold uint8 planes (at full
    # range the bf16 paths' one step in [1, 2) is 2 LSB of Y, in bf16 too)
    want = jrrdb.apply_fast(params, jfast, jnp.asarray(x), cfg, interpret=True,
                            out_mode="yuv420_u8")
    got = model.apply_fast(torch.from_numpy(x), "yuv420_u8", f32_head=True)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        assert _lsb(g.numpy(), w) <= 1
    ref = np.asarray(jrrdb.apply(params, jnp.asarray(x), cfg), np.float32)
    img = model.apply_fast(torch.from_numpy(x), "bf16", f32_head=True).float().numpy()
    d = np.abs(img - ref)
    assert d.max() < 0.05 and d.mean() < 0.005, (d.max(), d.mean())


def test_rrdb_float32_head_is_f32(fast6):
    """The f32 head takes the unrounded input and weights: its output
    differs from the bf16 head's, and the kernel path's from bf16's."""
    _, _, model = fast6
    x = torch.from_numpy(_u8(1, 16, 16, seed=2).astype(np.float32) / 255.0)
    f32 = model._head(x)
    assert f32.dtype == torch.float32
    assert not torch.equal(f32.to(torch.bfloat16), model._head(x.to(torch.bfloat16)))


@pytest.fixture(scope="module")
def vgg_weights(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("w")
    torch_port.export_npz(init_params(get_model(VGG).arch_config, seed=0),
                          wdir / f"{VGG}.npz")
    return wdir


def test_srvgg_float32_forward_matches_jax_apply(vgg_weights):
    spec, params = init_model(VGG, weights_dir=vgg_weights, dtype=jnp.float32, device=False)
    _, sd, _ = load_weights(VGG, vgg_weights, dtype=torch.float32)
    model = srvgg.SRVGGNet.from_state_dict(spec.arch_config, sd, torch.device("cpu"))
    x = _u8(2, 20, 24, seed=3).astype(np.float32) / 255.0
    want = np.asarray(jsrvgg.apply(params, jnp.asarray(x), spec.arch_config), np.float32)
    got = model.apply(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 80, 96, 3)
    assert np.abs(got - want).max() < 1e-4


def _jax_processor(name, wdir, frames, monkeypatch):
    monkeypatch.setenv("FW_TAIL", "3")
    monkeypatch.setenv("FW_INTERPRET", "1")
    sr = JaxSR(JaxSRConfig(model_name=name, compute_dtype="float32",
                           use_fused_kernel=True if get_model(name).family == "rrdb" else None,
                           sharding="none", device_stats=True, output_color="yuv420",
                           weights_dir=str(wdir)))
    sr.setup(*frames.shape[1:3])
    handle = sr.dispatch(frames)
    return sr.materialize(handle), handle["stats_np"]


def _port_processor(name, wdir, frames):
    sr = SuperResolution(SRConfig(model_name=name, compute_dtype="float32", device="cpu",
                                  output_color="yuv420", device_stats=True,
                                  weights_dir=str(wdir)))
    sr.setup(*frames.shape[1:3])
    assert sr.plan.est_bytes == sr.plan.batch * planner.frame_bytes(
        *frames.shape[1:3], sr.scale, sr.family, "float32", stats=True)
    handle = sr.dispatch(frames)
    return sr, sr.materialize(handle), handle["stats_np"]


@pytest.mark.parametrize("name", [FAST6, VGG])
def test_float32_processor_matches_jax(name, vgg_weights, tmp_path, monkeypatch):
    """The processors end to end in float32 on the YUV path: planes within
    1 LSB, the quality stats within the gate's bounds."""
    frames = _u8(1, 24, 32, seed=4)
    wdir = vgg_weights if name == VGG else tmp_path
    (jplanes, jst) = _jax_processor(name, wdir, frames, monkeypatch)
    sr, planes, st = _port_processor(name, wdir, frames)
    if name == VGG:
        assert sr.model.int8_weights is None and sr.model._fast is None   # plain f32 path
    for g, w in zip(planes, jplanes):
        assert g.shape == np.asarray(w).shape and _lsb(g, w) <= 1
    for k, tol in (("psnr", 0.05), ("ssim", 2e-3), ("luma", 0.05), ("std", 0.05)):
        assert np.abs(st[k] - np.asarray(jst[k])).max() <= tol, k
    np.testing.assert_array_equal(st["finite"], np.asarray(jst["finite"]))


def test_processor_keeps_f32_masters(tmp_path):
    sr = SuperResolution(SRConfig(model_name=FAST6, compute_dtype="float32", device="cpu"))
    sr.setup(16, 16)
    w = sr.model.conv_first.weight
    assert not torch.equal(w, w.to(torch.bfloat16).float())      # not rounded to bf16
    sr16 = SuperResolution(SRConfig(model_name=FAST6, device="cpu"))
    sr16.setup(16, 16)
    w16 = sr16.model.conv_first.weight
    assert torch.equal(w16, w16.to(torch.bfloat16).float())


def test_planner_has_float32_rows():
    assert planner.peak_bytes_per_body_px("rrdb", 2, "float32") == 6800
    assert planner.peak_bytes_per_body_px("srvgg", 4, "float32") >= \
        planner.peak_bytes_per_body_px("srvgg", 4, "bfloat16")
    for fam, s in (("rrdb", 2), ("rrdb", 4), ("srvgg", 2), ("srvgg", 4)):
        for dtype in ("bfloat16", "float32", "int8"):
            assert planner.frame_bytes(540, 960, s, fam, dtype, stats=True) >= \
                planner.frame_bytes(540, 960, s, fam, dtype)


@pytest.mark.parametrize("model", [FAST6, "FW_fastvgg_x2"])
def test_cli_float32_restore(tmp_path, capsys, model):
    from framewright_tpu_torch.io import y4m

    src = tmp_path / "clip.y4m"
    with y4m.Y4MWriter(src, 32, 24, fps=24) as wr:
        for f in _u8(3, 24, 32, seed=6):
            wr.write_frame(f)
    assert cli.main(["restore", str(src), "-o", str(tmp_path / "o.y4m"), "--model", model,
                     "--dtype", "float32", "--device", "cpu",
                     "--project-dir", str(tmp_path / "p")]) == 0
    import json

    summary = json.loads(capsys.readouterr().out)
    assert summary["frames"] == 3 and summary["errors"] == 0
    assert summary["quality"]["samples"] == 3
    with y4m.Y4MReader(tmp_path / "o.y4m") as r:
        assert (r.width, r.height, r.count_frames()) == (64, 48, 3)
