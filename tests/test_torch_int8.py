"""The int8 restore of the PyTorch port (``--dtype int8``, static scales
calibrated on the first batch) against the JAX package, on the CPU.

Seeded numpy inputs and weights go to both packages. The port's int8
wrappers run their plain versions here (CPU tensors); the JAX int8
kernels run in interpret mode at the block size tests/conftest.py pins.
The CUDA kernels are held against these plain versions on the card
(chip_smoke.py, tests/test_torch_gpu.py).

Tolerances:
- weights, scales and biases: exact (the same float32 operations in the
  same order);
- calibration: rtol 2^-7 (one bf16 step of an activation range; both
  sides take max|.| of the same bf16 tensors, whose convolutions sum in
  another order);
- body and model outputs with the same ``act_amax`` on both sides: the
  rounding points are the same, but the JAX f32acc kernel sums per chunk
  of taps and XLA may contract the i32 requant into one rounding, so a
  code that lies on a rounding boundary moves by one int8 step. One step
  of a code moves a conv sum by |w| * sa (about 1e-3 here), far below a
  bf16 ulp of the outputs, so an output moves by the bf16 ulps of the
  rounding points it passes (at most 4 ulps: 2^-5 below 2) on a few
  percent of values, and the mean stays below 1e-4;
- uint8 outputs: 1 LSB (a bf16 ulp of the tail's input moves the uint8
  output by at most one step).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framewright_tpu.models import rrdb as jrrdb
from framewright_tpu.models.registry import packaged_weights_dir
from framewright_tpu.ops import fused_rrdb as jfr
from framewright_tpu_torch import cli
from framewright_tpu_torch.io import y4m
from framewright_tpu_torch.models import rrdb
from framewright_tpu_torch.models.registry import (
    bf16_masters,
    from_jax_params,
    init_params,
    read_npz,
)
from framewright_tpu_torch.ops import fused_rrdb
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution

BODY_MAX, BODY_MEAN, BODY_FRAC = 2.0 ** -5, 1e-4, 0.05
WIDE_KEYS = ("Wx", "W1", "W2", "W3", "W4")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf16_host(params):
    """The JAX processor's host params: every leaf cast to bf16."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a).astype(jnp.bfloat16), params)


def _model(params, num_block):
    cfg = rrdb.RRDBConfig(num_block=num_block, scale=2)
    return rrdb.RRDBNet.from_state_dict(
        cfg, bf16_masters(from_jax_params(params, torch.float32)), torch.device("cpu"))


@pytest.fixture(scope="module")
def nets():
    """A 2-block scale-2 model with seeded weights, its bf16 host params,
    and activation ranges calibrated by the JAX package on a seeded
    sample (fed to both packages wherever the test is not calibration)."""
    params = init_params(rrdb.RRDBConfig(num_block=2, scale=2), seed=1)
    host = _bf16_host(params)
    sample = np.random.default_rng(3).random((1, 64, 72, 3)).astype(np.float32)
    amax = np.array(jrrdb.calibrate_act_scales(
        host, jrrdb.RRDBConfig(num_block=2, scale=2), jnp.asarray(sample)))
    return host, _model(params, 2), amax, sample


def _wide(wts: fused_rrdb.RDBWeightsInt8) -> dict:
    """The port's per-conv int8 layout rearranged to the JAX wide form."""
    out = {"act_q": wts.act_q}
    for src, key in enumerate(WIDE_KEYS):
        off, n = fused_rrdb._SOURCES[src]
        out[key] = np.concatenate([wts.w[k].numpy()[..., off:off + n].reshape(
            wts.w[k].shape[0], -1) for k in range(src, 5)])
        if wts.scheme == "f32acc":
            out["s" + key[1:].lower()] = np.concatenate(
                [wts.wscale[k].numpy()[:, src] for k in range(src, 5)])[:, None]
    rows = lambda ts: np.concatenate([t.numpy() for t in ts])[:, None]   # noqa: E731
    if wts.scheme == "i32":
        out["oscale"], out["obias"] = rows(wts.scale), rows(wts.bias)
    else:
        out["b"] = rows(wts.bias)
    return out


def _assert_bridge(host, model, amax, scheme):
    jax_fn = jfr.rdb_wide_weights_int8_i32 if scheme == "i32" else jfr.rdb_wide_weights_int8
    fw = model.fast_weights_int8(amax, scheme)
    assert fw.int8_scheme == scheme
    body = host["body"]
    if not isinstance(body, list):                   # stacked (the .npz storage)
        n = jax.tree_util.tree_leaves(body)[0].shape[0]
        body = [jax.tree_util.tree_map(lambda a, i=i: a[i], body) for i in range(n)]
    for i, blk in enumerate(body):
        for j, name in enumerate(("rdb1", "rdb2", "rdb3")):
            want = jax_fn(blk[name], act_amax=amax[i, j])
            got = _wide(fw.body[i][j])
            assert set(got) == set(want), (set(got), set(want))
            for key, w in want.items():
                w = np.asarray(w)
                assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
                np.testing.assert_array_equal(got[key], w, err_msg=f"{i} {name} {key}")


class TestWeightBridge:
    @pytest.mark.parametrize("scheme", fused_rrdb.INT8_SCHEMES)
    def test_seeded_weights_equal_jax(self, nets, scheme):
        host, model, amax, _ = nets
        _assert_bridge(host, model, amax, scheme)

    @pytest.mark.parametrize("scheme", fused_rrdb.INT8_SCHEMES)
    def test_fw_fast6_weights_equal_jax(self, scheme):
        params = read_npz(packaged_weights_dir() / "FW_fast6_x2.npz")
        host = _bf16_host(params)
        amax = np.random.default_rng(2).uniform(0.2, 6.0, (6, 3, 5)).astype(np.float32)
        _assert_bridge(host, _model(params, 6), amax, scheme)

    def test_default_scheme_follows_fw_int8_scheme(self, nets, monkeypatch):
        _, model, amax, _ = nets
        monkeypatch.delenv("FW_INT8_SCHEME", raising=False)
        assert model.fast_weights_int8(amax).int8_scheme == "i32"
        monkeypatch.setenv("FW_INT8_SCHEME", "static")   # any other name: f32acc
        assert model.fast_weights_int8(amax).int8_scheme == "f32acc"
        with pytest.raises(ValueError, match="act_amax"):
            model.fast_weights_int8(amax[:1])


def test_calibration_matches_jax(nets):
    host, model, amax, sample = nets
    before = rrdb.calibrate_act_scales.calls
    got = rrdb.calibrate_act_scales(model, torch.from_numpy(sample), margin=1.25)
    assert rrdb.calibrate_act_scales.calls == before + 1
    assert got.shape == (2, 3, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, amax, rtol=2.0 ** -7)


def test_residual_scale_is_bf16_like_jax():
    """The RDB and RRDB residuals ``x5 * 0.2 + x`` of the bf16 forward,
    which calibration runs: JAX's weakly typed 0.2 against bf16 is
    bf16(0.2), and the product rounds to bf16. Slice 1 multiplied by the
    f32 0.2 there, which rounds differently on a share of values."""
    from framewright_tpu_torch.models.layers import mul_weak

    x = np.random.default_rng(9).normal(0, 4, (4096,)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jnp.asarray(x, jnp.bfloat16) * 0.2, np.float32)
    np.testing.assert_array_equal(mul_weak(xt, 0.2).float().numpy(), want)
    assert (((xt * 0.2).float().numpy()) != want).mean() > 0.05   # the slice-1 product
    np.testing.assert_array_equal(mul_weak(torch.from_numpy(x), 0.2).numpy(),
                                  np.asarray(jnp.asarray(x) * 0.2))


def _feat(b, h, w, seed):
    f = np.random.default_rng(seed).uniform(-1, 1, (b, h, w, 64)).astype(np.float32)
    t = torch.from_numpy(f).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _assert_body_close(got, want):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert d.max() <= BODY_MAX and d.mean() < BODY_MEAN and (d > 0).mean() < BODY_FRAC, \
        (d.max(), d.mean(), (d > 0).mean())


def _jax_one_rdb(feat_j, wide, scheme, carry):
    """One JAX merge-kernel sweep over a freshly extracted block grid."""
    b, h, w, _ = feat_j.shape
    nh, nw = jfr._grid_dims(h, w)
    nb = b * nh * nw
    blocks = jfr.extract_blocks(feat_j.transpose(0, 3, 1, 2), h, w).reshape(nb, 64, jfr.PX)
    ext = jnp.asarray(np.tile(jfr._block_extents(h, w, nh, nw), (b, 1)))
    cblocks = None
    if carry is not None:
        cblocks = jfr.extract_blocks(carry.transpose(0, 3, 1, 2), h, w).reshape(nb, 64, jfr.PX)
    if scheme == "i32":
        out = jfr.fused_rdb_blocks_merge_int8_i32(blocks, ext, wide, nw, interpret=True,
                                                  carry=cblocks)
    else:
        out = jfr.fused_rdb_blocks_merge_int8(blocks, ext, wide, nw, interpret=True)
        if cblocks is not None:                      # XLA residual, as rrdb_body_merge_blocks
            out = (0.2 * out).astype(jnp.bfloat16) + cblocks
    img = jfr.assemble_blocks(out.reshape(nb, 64, jfr.S, jfr.S), b, h, w)
    return np.asarray(img.transpose(0, 2, 3, 1), np.float32)


class TestBody:
    @pytest.mark.parametrize("residual", [False, True])
    @pytest.mark.parametrize("scheme", fused_rrdb.INT8_SCHEMES)
    def test_one_rdb_matches_jax_kernel(self, nets, scheme, residual):
        host, model, amax, _ = nets
        feat_t, feat_j = _feat(1, 60, 72, seed=2)
        carry_t, carry_j = _feat(1, 60, 72, seed=4) if residual else (None, None)
        wide_fn = jfr.rdb_wide_weights_int8_i32 if scheme == "i32" else jfr.rdb_wide_weights_int8
        want = _jax_one_rdb(feat_j, wide_fn(host["body"][1]["rdb3"], act_amax=amax[1, 2]),
                            scheme, carry_j)
        wts = model.fast_weights_int8(amax, scheme).body[1][2]
        q = torch.empty(1, 60, 72, 192, dtype=torch.int8)
        dst = torch.empty_like(feat_t) if carry_t is None else carry_t.clone()
        fused_rrdb.fused_rdb_int8(feat_t, q, dst, wts, carry=None if carry_t is None else dst)
        _assert_body_close(dst.float().numpy(), want)

    @pytest.mark.parametrize("scheme", fused_rrdb.INT8_SCHEMES)
    def test_body_matches_rrdb_body_merge(self, nets, scheme):
        # 2 blocks over a 2x2 grid of interpret-mode blocks, B=2
        host, model, amax, _ = nets
        feat_t, feat_j = _feat(2, 64, 72, seed=1)
        fast = jrrdb.make_fast_params(host, compute_dtype="int8", act_amax=amax,
                                      int8_scheme=scheme)
        want = np.asarray(jfr.rrdb_body_merge(feat_j, fast, interpret=True), np.float32)
        got = fused_rrdb.rrdb_body_int8(feat_t, model.fast_weights_int8(amax, scheme).body)
        assert got.shape == (2, 64, 72, 64) and got.dtype == torch.bfloat16
        _assert_body_close(got.float().numpy(), want)

    def test_plain_flag_and_counters(self, nets):
        _, model, amax, _ = nets
        body = model.fast_weights_int8(amax, "i32").body
        feat_t, _ = _feat(1, 16, 24, seed=5)
        before = (fused_rrdb.fused_rdb_i32.launches, fused_rrdb.fused_rdb_f32acc.launches)
        a = fused_rrdb.rrdb_body_int8(feat_t, body)
        b = fused_rrdb.rrdb_body_int8(feat_t, body, plain=True)
        assert torch.equal(a, b)
        # CPU tensors: the plain version ran, no kernel was launched
        assert (fused_rrdb.fused_rdb_i32.launches,
                fused_rrdb.fused_rdb_f32acc.launches) == before

    def test_wrapper_contract(self, nets):
        _, model, amax, _ = nets
        wts = model.fast_weights_int8(amax, "i32").body[0][0]
        feat_t, _ = _feat(1, 8, 8, seed=6)
        q = torch.empty(1, 8, 8, 192, dtype=torch.int8)
        with pytest.raises(ValueError, match="q must be"):
            fused_rrdb.fused_rdb_int8(feat_t, q[..., :64], torch.empty_like(feat_t), wts)
        with pytest.raises(ValueError, match="bf16"):
            fused_rrdb.fused_rdb_int8(feat_t.float(), q, torch.empty_like(feat_t), wts)
        with pytest.raises(ValueError, match="scheme"):
            fused_rrdb.fused_rdb_f32acc(feat_t, q, torch.empty_like(feat_t), wts)
        on_meta = fused_rrdb.RDBWeightsInt8(
            "i32", [w.to("meta") for w in wts.w], wts.scale, wts.bias, wts.wscale, wts.act_q)
        with pytest.raises(ValueError, match="device"):
            fused_rrdb.fused_rdb_int8(feat_t, q, torch.empty_like(feat_t), on_meta)


class TestModel:
    SHAPE = (1, 64, 72)

    @pytest.fixture(scope="class")
    def outputs(self, nets):
        """bf16 and yuv420_u8 outputs of both packages' int8 kernel paths
        (same act_amax), and both bf16 kernel paths, per scheme."""
        host, model, amax, _ = nets
        cfg = jrrdb.RRDBConfig(num_block=2, scale=2)
        x = np.random.default_rng(8).random((*self.SHAPE, 3)).astype(np.float32)
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = torch.from_numpy(x)
        fast16 = jrrdb.make_fast_params(host)
        out = {"jax_bf16": np.asarray(jrrdb.apply_fast(host, fast16, xj, cfg, interpret=True),
                                      np.float32)}
        fw16 = model.fast_weights()
        out["port_bf16"] = model.apply_fast(xt, weights=fw16).float().numpy()
        for scheme in fused_rrdb.INT8_SCHEMES:
            fast = jrrdb.make_fast_params(host, compute_dtype="int8", act_amax=amax,
                                          int8_scheme=scheme)
            fw = model.fast_weights_int8(amax, scheme)
            out[scheme] = {
                "jax": np.asarray(jrrdb.apply_fast(host, fast, xj, cfg, interpret=True),
                                  np.float32),
                "jax_yuv": [np.asarray(p) for p in jrrdb.apply_fast(
                    host, fast, xj, cfg, interpret=True, out_mode="yuv420_u8")],
                "port": model.apply_fast(xt, weights=fw).float().numpy(),
                "port_yuv": [p.numpy() for p in model.apply_fast(xt, "yuv420_u8",
                                                                  weights=fw)],
                "port_body": fused_rrdb.rrdb_body_int8(
                    model._head(xt.to(torch.bfloat16)).contiguous(), fw.body).float().numpy(),
            }
        out["port_body_bf16"] = fused_rrdb.rrdb_body(
            model._head(xt.to(torch.bfloat16)).contiguous(), fw16.body)[..., :64].float().numpy()
        return out

    @pytest.mark.parametrize("scheme", fused_rrdb.INT8_SCHEMES)
    def test_bf16_out_matches_jax_apply_fast(self, outputs, scheme):
        o = outputs[scheme]
        assert o["port"].shape == o["jax"].shape == (1, 128, 144, 3)
        d = np.abs(o["port"] - o["jax"])
        assert d.max() < 0.05 and d.mean() < 0.005, (d.max(), d.mean())

    @pytest.mark.parametrize("scheme", fused_rrdb.INT8_SCHEMES)
    def test_yuv420_matches_jax_apply_fast(self, outputs, scheme):
        o = outputs[scheme]
        for g, w in zip(o["port_yuv"], o["jax_yuv"]):
            assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1

    @pytest.mark.parametrize("scheme", fused_rrdb.INT8_SCHEMES)
    def test_int8_bounds_against_own_bf16(self, outputs, scheme):
        """The JAX package's own int8 bounds (tests/test_int8_mode.py):
        body max relative error < 10%, mean < 2%, model PSNR > 38 dB."""
        ref = outputs["port_body_bf16"]
        err = np.abs(outputs[scheme]["port_body"] - ref)
        scale = np.abs(ref).max() + 1e-3
        assert err.max() / scale < 0.10 and err.mean() / scale < 0.02
        mse = float(np.mean((outputs[scheme]["port"] - outputs["port_bf16"]) ** 2))
        assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 38.0


class TestSlice:
    def test_processor_calibrates_once_on_first_dispatch(self, gradient_frame):
        sr = SuperResolution(SRConfig(model_name="FW_fast6_x2", device="cpu",
                                      compute_dtype="int8", batch_size=2,
                                      output_color="yuv420"))
        sr.setup(24, 32)
        assert sr.model.int8_weights is None          # no int8 weights before the data
        frames = np.stack([gradient_frame(24, 32, t) for t in range(2)])
        before = rrdb.calibrate_act_scales.calls
        first = sr.materialize(sr.dispatch(frames))
        fw = sr.model.int8_weights
        assert fw.int8_scheme == "i32" and rrdb.calibrate_act_scales.calls == before + 1
        again = sr.materialize(sr.dispatch(frames))
        assert sr.model.int8_weights is fw and rrdb.calibrate_act_scales.calls == before + 1
        for a, b in zip(first, again):
            np.testing.assert_array_equal(a, b)

    def test_planes_match_the_jax_composition(self, gradient_frame):
        """The JAX processor cannot run its compiled kernel on the CPU, so
        its int8 path is composed from its public functions: calibration
        on the same crop, make_fast_params of the bf16 host params, then
        apply_fast in interpret mode with the YUV epilogue."""
        from framewright_tpu.models.registry import init_model

        h, w = 40, 56
        frames = np.stack([gradient_frame(h, w, t) for t in range(2)])
        sr = SuperResolution(SRConfig(model_name="FW_fast6_x2", device="cpu",
                                      compute_dtype="int8", output_color="yuv420"))
        sr.setup(h, w)
        got = sr.materialize(sr.dispatch(frames))
        spec, host = init_model("FW_fast6_x2", dtype=jnp.bfloat16, device=False)
        ch, cw = min(h, 256) & ~7, min(w, 256) & ~7
        r0, c0 = (h - ch) // 2, (w - cw) // 2
        sample = jnp.asarray(frames[:1, r0:r0 + ch, c0:c0 + cw].astype(np.float32) / 255.0)
        amax = np.asarray(jrrdb.calibrate_act_scales(host, spec.arch_config, sample))
        fast = jrrdb.make_fast_params(host, compute_dtype="int8", act_amax=amax)
        x = jnp.asarray(frames).astype(jnp.bfloat16) / jnp.asarray(255.0, jnp.bfloat16)
        want = jrrdb.apply_fast(host, fast, x, spec.arch_config, interpret=True,
                                out_mode="yuv420_u8")
        # Tolerance: max 6 LSB, mean 0.5 LSB. The calibrations agree to
        # a bf16 step (test_calibration_matches_jax), and each of the 90
        # requantizations per frame flips the codes that lie on a rounding
        # boundary; on the trained 6-block model that moves a few planes'
        # values by up to 4 LSB at a mean below 0.2 LSB even with the same
        # act_amax on both sides (the bf16 slice is held to 13 / 1.3 LSB:
        # tests/test_torch_slice.py::test_cli_restore_matches_jax_cli).
        for g, wp in zip(got, want):
            wp = np.asarray(wp)
            assert g.shape == wp.shape
            d = np.abs(g.astype(int) - wp.astype(int))
            assert d.max() <= 6 and d.mean() <= 0.5, (d.max(), d.mean())

    def test_cli_restore_int8_on_the_cpu(self, tmp_path, gradient_frame, capsys):
        src = tmp_path / "clip.y4m"
        with y4m.Y4MWriter(src, 32, 24, fps=12) as wr:
            for t in range(3):
                wr.write_frame(gradient_frame(24, 32, t))
        before = rrdb.calibrate_act_scales.calls
        assert cli.main(["restore", str(src), "-o", str(tmp_path / "o.y4m"),
                         "--model", "FW_fast6_x2", "--dtype", "int8", "--device", "cpu",
                         "--project-dir", str(tmp_path / "p")]) == 0
        summary = json.loads(capsys.readouterr().out)
        assert summary["frames"] == 3 and rrdb.calibrate_act_scales.calls == before + 1
        with y4m.Y4MReader(tmp_path / "o.y4m") as r:
            assert (r.width, r.height, r.count_frames()) == (64, 48, 3)

    def test_planner_counts_the_int8_bytes(self):
        from framewright_tpu_torch import planner

        bf16 = planner.frame_bytes(1080, 1920, 2)
        int8 = planner.frame_bytes(1080, 1920, 2, dtype="int8")
        assert int8 == 540 * 960 * 6000 and bf16 == 540 * 960 * 6800
        free = int(int8 * 5.5)
        assert planner.plan(1080, 1920, 2, free_bytes=free, utilization=1.0,
                            dtype="int8").batch == 5
        assert planner.plan(1080, 1920, 2, free_bytes=free, utilization=1.0).batch == 4

    def test_dynamic_scales_accepted(self):
        """Dynamic scales quantize the body in ``setup`` and calibrate
        nothing (tests/test_torch_dynamic.py holds the path to JAX)."""
        sr = SuperResolution(SRConfig(model_name="FW_fast6_x2", device="cpu",
                                      compute_dtype="int8", int8_scales="dynamic"))
        sr.setup(24, 32)
        assert sr.model.int8_weights.int8_scheme == "dynamic" and not sr._int8_calibrate

    def test_unknown_int8_scales_refused(self):
        from framewright_tpu_torch.errors import ConfigError

        sr = SuperResolution(SRConfig(model_name="FW_fast6_x2", device="cpu",
                                      compute_dtype="int8", int8_scales="per_block"))
        with pytest.raises(ConfigError, match="int8_scales"):
            sr.setup(24, 32)
