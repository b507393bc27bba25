"""The dynamic-scale int8 restore of the PyTorch port
(``SRConfig(compute_dtype="int8", int8_scales="dynamic")``) and the
round-trip RRDB body against the JAX package, on the CPU.

Seeded numpy inputs and weights go to both packages. The port's wrappers
run their plain versions here (CPU tensors); the JAX kernels run in
interpret mode at the block size tests/conftest.py pins (FW_RDB_S=64:
48-pixel windows with an 8-pixel halo). The CUDA kernels are held
against these plain versions on the card (chip_smoke.py,
tests/test_torch_gpu.py).

The port takes each activation range per frame; the JAX kernel takes it
per window, over a ring of wrapped-around values too (ROADMAP.md B7).
Where one window holds the whole frame (frames up to 48x48 here) the
two agree, and the port is held to the JAX kernel at the static int8
tolerances of tests/test_torch_int8.py. Elsewhere it is held to the JAX
package's own dynamic-int8 bounds against bf16
(tests/test_int8_mode.py:57-90): body max and mean error, divided by
max|bf16 body|, below 0.06 and 0.008; model PSNR above 40 dB.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framewright_tpu.models import rrdb as jrrdb
from framewright_tpu.models.registry import packaged_weights_dir
from framewright_tpu.ops import fused_rrdb as jfr
from framewright_tpu_torch.models import rrdb
from framewright_tpu_torch.models.registry import (
    bf16_masters,
    from_jax_params,
    init_params,
    read_npz,
)
from framewright_tpu_torch.ops import fused_rrdb
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution

# one RDB where one JAX window holds the frame: the static int8 tolerances
# (tests/test_torch_int8.py: a code on a rounding boundary moves one step)
BODY_MAX, BODY_MEAN, BODY_FRAC = 2.0 ** -5, 1e-4, 0.05
# the JAX package's dynamic-int8 bounds against bf16 (tests/test_int8_mode.py)
REL_MAX, REL_MEAN, PSNR_MIN = 0.06, 0.008, 40.0
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


def _model(params, num_block, scale=2):
    cfg = rrdb.RRDBConfig(num_block=num_block, scale=scale)
    return rrdb.RRDBNet.from_state_dict(
        cfg, bf16_masters(from_jax_params(params, torch.float32)), torch.device("cpu"))


@pytest.fixture(scope="module")
def nets():
    """A 1-block scale-2 model with seeded weights, its bf16 host params
    and both packages' fast weights (bf16 and dynamic int8)."""
    params = init_params(rrdb.RRDBConfig(num_block=1, scale=2), seed=4)
    host = _bf16_host(params)
    model = _model(params, 1)
    return {"host": host, "model": model,
            "jax16": jrrdb.make_fast_params(host),
            "jax8": jrrdb.make_fast_params(host, compute_dtype="int8"),
            "fw16": model.fast_weights(), "fw8": model.fast_weights_int8(None)}


def _feat(b, h, w, seed, scale=0.5):
    f = np.random.default_rng(seed).standard_normal((b, h, w, 64)).astype(np.float32) * scale
    t = torch.from_numpy(f).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _rel(got, ref):
    """Max and mean |got - ref| over max|ref| (tests/test_int8_mode.py)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err, scale = np.abs(got - ref), np.abs(ref).max() + 1e-3
    return err.max() / scale, err.mean() / scale


def _wide_dynamic(wts: fused_rrdb.RDBWeightsInt8) -> dict:
    """The port's per-conv dynamic layout rearranged to the JAX wide form."""
    out = {"b": np.concatenate([t.numpy() for t in wts.bias])[:, None]}
    for src, key in enumerate(WIDE_KEYS):
        off, n = fused_rrdb._SOURCES[src]
        out[key] = np.concatenate([wts.w[k].numpy()[..., off:off + n].reshape(
            wts.w[k].shape[0], -1) for k in range(src, 5)])
        out["s" + key[1:].lower()] = np.concatenate(
            [wts.wscale[k].numpy()[:, src] for k in range(src, 5)])[:, None]
        # the kernel's per-conv scale rows hold the same weight scales
        for k in range(src, 5):
            np.testing.assert_array_equal(wts.scale[k].numpy()[:, src],
                                          wts.wscale[k].numpy()[:, src])
    return out


class TestWeights:
    @pytest.mark.parametrize("which", ["seeded", "FW_fast6_x2"])
    def test_dynamic_weights_equal_jax(self, which):
        if which == "seeded":
            params, nb = init_params(rrdb.RRDBConfig(num_block=2, scale=2), seed=1), 2
        else:
            params, nb = read_npz(packaged_weights_dir() / "FW_fast6_x2.npz"), 6
        host = _bf16_host(params)
        fw = _model(params, nb).fast_weights_int8(None, "i32")   # the scheme is ignored
        assert fw.int8_scheme == "dynamic"
        body = host["body"]
        if not isinstance(body, list):                   # stacked (the .npz storage)
            body = [jax.tree_util.tree_map(lambda a, i=i: a[i], body) for i in range(nb)]
        for i, blk in enumerate(body):
            for j, name in enumerate(("rdb1", "rdb2", "rdb3")):
                wts = fw.body[i][j]
                assert wts.scheme == "dynamic" and wts.act_q is None
                want = jfr.rdb_wide_weights_int8(blk[name])
                got = _wide_dynamic(wts)
                assert set(got) == set(want), (set(got), set(want))
                for key, w in want.items():
                    w = np.asarray(w)
                    assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
                    np.testing.assert_array_equal(got[key], w, err_msg=f"{i} {name} {key}")


class TestDynamicRDB:
    @pytest.mark.parametrize("batch", [1, 2])
    def test_one_rdb_matches_jax_where_one_window_holds_the_frame(self, nets, batch):
        """A 40x48 frame fits one JAX window, whose amax is then the
        frame's (everything outside the frame is zero there)."""
        feat_t, feat_j = _feat(batch, 40, 48, seed=2 + batch)
        wide = jax.tree_util.tree_map(lambda v: v[0, 2], nets["jax8"]["body_wide"])
        want = np.asarray(jfr._fused_rdb_image(feat_j.transpose(0, 3, 1, 2), wide, 40, 48,
                                               interpret=True, int8=True), np.float32)
        q = torch.empty(batch, 40, 48, 192, dtype=torch.int8)
        dst = torch.empty_like(feat_t)
        before = fused_rrdb.fused_rdb_dynamic.launches
        fused_rrdb.fused_rdb_int8(feat_t, q, dst, nets["fw8"].body[0][2])
        assert fused_rrdb.fused_rdb_dynamic.launches == before   # CPU: the plain version ran
        d = np.abs(dst.float().numpy() - want.transpose(0, 2, 3, 1))
        assert d.max() <= BODY_MAX and d.mean() < BODY_MEAN and (d > 0).mean() < BODY_FRAC, \
            (d.max(), d.mean(), (d > 0).mean())

    def test_ranges_are_per_frame(self, nets):
        """amax (B, 5): each frame's own max|a| of x, x1..x4, whatever the
        other frames of the batch hold."""
        feat_t, _ = _feat(2, 20, 24, seed=7)
        feat_t[1] *= 4
        wts = nets["fw8"].body[0][0]
        q = torch.empty(2, 20, 24, 192, dtype=torch.int8)
        out = torch.empty_like(feat_t)
        amax = fused_rrdb.fused_rdb_dynamic(feat_t, q, out, wts)
        assert amax.shape == (2, 5) and amax.dtype == torch.float32
        assert amax[:, 0].tolist() == feat_t.float().abs().amax(dim=(1, 2, 3)).tolist()
        for i in range(2):
            q1, o1 = q[i:i + 1].clone(), torch.empty_like(out[i:i + 1])
            a1 = fused_rrdb.fused_rdb_dynamic_plain(feat_t[i:i + 1].contiguous(), q1, o1, wts)
            assert torch.equal(a1[0], amax[i]) and torch.equal(q1, q[i:i + 1])
            assert torch.equal(o1, out[i:i + 1])
        # the codes of x span the full range in each frame
        assert q[..., :64].abs().amax(dim=(1, 2, 3)).tolist() == [127, 127]

    def test_wrapper_contract(self, nets):
        feat_t, _ = _feat(1, 8, 8, seed=1)
        q = torch.empty(1, 8, 8, 192, dtype=torch.int8)
        with pytest.raises(ValueError, match="scheme"):
            fused_rrdb.fused_rdb_dynamic(feat_t, q, torch.empty_like(feat_t),
                                         nets["model"].fast_weights_int8(
                                             np.ones((1, 3, 5), np.float32), "f32acc").body[0][0])
        nets["model"].fast_weights_int8(None)               # restore the module's weights
        with pytest.raises(ValueError, match="q must be"):
            fused_rrdb.fused_rdb_dynamic(feat_t, q[..., :64], torch.empty_like(feat_t),
                                         nets["fw8"].body[0][0])


class TestBody:
    SHAPE = (1, 40, 48)

    @pytest.fixture(scope="class")
    def bodies(self, nets):
        """The test_int8_mode.py body input (40x48, 0.5 sigma) through the
        JAX bf16 and dynamic bodies and the port's dynamic body."""
        feat_t, feat_j = _feat(*self.SHAPE, seed=0)
        return {
            "jax16": np.asarray(jfr.rrdb_body_fast(feat_j, nets["jax16"], interpret=True),
                                np.float32),
            "jax8": np.asarray(jfr.rrdb_body_fast(feat_j, nets["jax8"], interpret=True),
                               np.float32),
            "port8": fused_rrdb.rrdb_body_fast(feat_t, nets["fw8"].body).float().numpy(),
        }

    def test_dynamic_body_within_jax_int8_bounds_of_bf16(self, bodies):
        mx, mean = _rel(bodies["port8"], bodies["jax16"])
        assert mx < REL_MAX and mean < REL_MEAN, (mx, mean)

    def test_dynamic_body_near_jax_dynamic_body(self, bodies):
        """One window holds this frame, so the two bodies differ only where
        a code sits on a rounding boundary (measured: 0.11% of values,
        max 0.0028 and mean 4.2e-7 relative; the port against the JAX bf16
        body 0.0056 / 0.00014, the JAX dynamic body 0.0056 / 0.00014).
        Held to the bound above."""
        mx, mean = _rel(bodies["port8"], bodies["jax8"])
        assert mx < REL_MAX and mean < REL_MEAN, (mx, mean)

    def test_dynamic_body_across_windows_within_bounds(self, nets):
        """A 2x100x90 batch spans 3x2 JAX windows, whose ranges are taken
        per window: the port's per-frame body against the JAX dynamic and
        bf16 bodies (measured: 30% of values differ from the JAX dynamic
        body, max 0.0046 and mean 0.00014 relative; against bf16 0.0046 /
        0.00013, where the JAX dynamic body is 0.0046 / 0.00012)."""
        feat_t, feat_j = _feat(2, 100, 90, seed=3)
        jax16 = np.asarray(jfr.rrdb_body_fast(feat_j, nets["jax16"], interpret=True),
                           np.float32)
        jax8 = np.asarray(jfr.rrdb_body_fast(feat_j, nets["jax8"], interpret=True),
                          np.float32)
        port8 = fused_rrdb.rrdb_body_fast(feat_t, nets["fw8"].body).float().numpy()
        for ref in (jax16, jax8):
            mx, mean = _rel(port8, ref)
            assert mx < REL_MAX and mean < REL_MEAN, (mx, mean)

    @pytest.mark.parametrize("kind", ["bf16", "f32acc"])
    def test_roundtrip_body_matches_jax_and_merge(self, nets, kind, monkeypatch):
        """FW_RDB_BODY=roundtrip: bf16 and static f32acc weights against JAX
        ``rrdb_body_fast_roundtrip`` at the tolerances of
        tests/test_torch_rrdb.py and tests/test_torch_int8.py, and equal to
        the port's merge body (the same loop on the card)."""
        host, model = nets["host"], nets["model"]
        feat_t, feat_j = _feat(2, 60, 70, seed=5, scale=0.7)
        if kind == "bf16":
            jax_fast, fw = nets["jax16"], nets["fw16"]
        else:
            amax = np.random.default_rng(6).uniform(0.5, 4.0, (1, 3, 5)).astype(np.float32)
            jax_fast = jrrdb.make_fast_params(host, compute_dtype="int8", act_amax=amax,
                                              int8_scheme="f32acc")
            fw = model.fast_weights_int8(amax, "f32acc")
            model.fast_weights_int8(None)                   # restore the module's weights
        want = np.asarray(jfr.rrdb_body_fast_roundtrip(feat_j, jax_fast, interpret=True),
                          np.float32)
        monkeypatch.setenv("FW_RDB_BODY", "roundtrip")
        got = fused_rrdb.rrdb_body_fast(feat_t, fw.body)
        monkeypatch.setenv("FW_RDB_BODY", "merge")
        assert torch.equal(got, fused_rrdb.rrdb_body_fast(feat_t, fw.body))
        assert got.shape == (2, 60, 70, 64) and got.dtype == torch.bfloat16
        d = np.abs(got.float().numpy() - want)
        if kind == "bf16":
            assert d.max() < 0.05 and d.mean() < 5e-4, (d.max(), d.mean())
        else:
            assert d.max() <= BODY_MAX and d.mean() < BODY_MEAN \
                and (d > 0).mean() < BODY_FRAC, (d.max(), d.mean(), (d > 0).mean())

    def test_body_selection(self, nets, monkeypatch):
        feat_t, _ = _feat(1, 8, 8, seed=9)
        amax = np.ones((1, 3, 5), np.float32)
        i32 = nets["model"].fast_weights_int8(amax, "i32").body
        nets["model"].fast_weights_int8(None)
        monkeypatch.setenv("FW_RDB_BODY", "roundtrip")     # i32 runs the merge body
        assert torch.equal(fused_rrdb.rrdb_body_fast(feat_t, i32),
                           fused_rrdb.rrdb_body_int8(feat_t, i32))
        with pytest.raises(ValueError, match="i32"):
            fused_rrdb.rrdb_body_roundtrip(feat_t, i32)
        # resident (either variable) runs the resident body, whose dynamic
        # ranges are the frame's: equal to the round-trip body; i32 weights
        # still run the merge body
        want = fused_rrdb.rrdb_body_roundtrip(feat_t, nets["fw8"].body)
        for env in (("FW_RDB_BODY", "resident"), ("FW_RDB_RESIDENT", "1")):
            monkeypatch.setenv(*env)
            assert torch.equal(fused_rrdb.rrdb_body_fast(feat_t, nets["fw8"].body), want)
            assert torch.equal(fused_rrdb.rrdb_body_fast(feat_t, i32),
                               fused_rrdb.rrdb_body_int8(feat_t, i32))


class TestModel:
    @pytest.fixture(scope="class")
    def fast1(self):
        """test_int8_mode.py's model: 1 block, scale 4, seeded weights."""
        params = init_params(rrdb.RRDBConfig(num_block=1, scale=4), seed=0)
        return _bf16_host(params), _model(params, 1, scale=4)

    def test_full_model_dynamic_psnr_vs_bf16(self, fast1):
        _, model = fast1
        x = torch.from_numpy(np.random.default_rng(1).random((1, 24, 32, 3), dtype=np.float32))
        y16 = model.apply_fast(x, weights=model.fast_weights()).float()
        y8 = model.apply_fast(x, weights=model.fast_weights_int8(None)).float()
        assert y8.shape == y16.shape == (1, 96, 128, 3)
        mse = float(((y16 - y8) ** 2).mean())
        assert 10 * np.log10(1.0 / max(mse, 1e-12)) > PSNR_MIN

    def test_yuv420_matches_jax_apply_fast(self, fast1):
        """The dynamic path to yuv420_u8 against JAX ``apply_fast`` in
        interpret mode. One window holds the 24x32 frame's body, so the
        ranges agree; the bodies still differ where a code lies on a
        rounding boundary (the flush order, ROADMAP.md C: 2.3% of body
        values by up to 2^-6, measured), which spreads through the tail to
        a quarter of the bf16 outputs by one step. This model's outputs
        span [-0.5, 1.5], where one bf16 step is up to 2 LSB and few values
        clip, so the "1 LSB on < 2%" bound of clipped outputs does not
        apply (ROADMAP.md C caveats): even the two packages' bf16 paths
        differ by 1 LSB on 12.5% of Y values here. Bound: max 2 LSB, mean
        0.15 LSB (measured 2 / 0.106 on Y, 1 / 0.048 and 1 / 0.070 on U, V)."""
        host, model = fast1
        cfg = jrrdb.RRDBConfig(num_block=1, scale=4)
        x = np.random.default_rng(2).random((2, 24, 32, 3)).astype(np.float32)
        fast8 = jrrdb.make_fast_params(host, compute_dtype="int8")
        want = jrrdb.apply_fast(host, fast8, jnp.asarray(x, jnp.bfloat16), cfg,
                                interpret=True, out_mode="yuv420_u8")
        got = model.apply_fast(torch.from_numpy(x), "yuv420_u8",
                               weights=model.fast_weights_int8(None))
        for g, w in zip(got, want):
            g, w = g.numpy().astype(int), np.asarray(w).astype(int)
            assert g.shape == w.shape
            d = np.abs(g - w)
            assert d.max() <= 2 and d.mean() < 0.15, (d.max(), d.mean())


class TestProcessor:
    def test_restores_with_dynamic_scales_and_no_calibration(self, gradient_frame):
        from framewright_tpu_torch.ops import fused_tail

        sr = SuperResolution(SRConfig(model_name="FW_fast6_x2", device="cpu",
                                      compute_dtype="int8", int8_scales="dynamic",
                                      batch_size=2, output_color="yuv420"))
        sr.setup(24, 32)
        fw = sr.model.int8_weights
        assert fw is not None and fw.int8_scheme == "dynamic"
        frames = np.stack([gradient_frame(24, 32, t) for t in range(2)])
        before = (rrdb.calibrate_act_scales.calls, fused_tail.fused_tail.launches)
        got = sr.materialize(sr.dispatch(frames))
        assert (rrdb.calibrate_act_scales.calls, fused_tail.fused_tail.launches) == before
        assert sr.model.int8_weights is fw
        want = sr.model.apply_fast(torch.from_numpy(frames).to(torch.bfloat16) / 255.0,
                                   "yuv420_u8", weights=fw)
        assert [p.shape for p in got] == [(2, 48, 64), (2, 24, 32), (2, 24, 32)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())

    def test_planner_counts_the_dynamic_path(self):
        from framewright_tpu_torch import planner

        sr = SuperResolution(SRConfig(model_name="FW_fast6_x2", device="cpu",
                                      compute_dtype="int8", int8_scales="dynamic"))
        sr.setup(1080, 1920)
        per_frame = planner.frame_bytes(1080, 1920, 2, dtype="int8-dynamic")
        assert per_frame == 540 * 960 * 5500 and sr.plan.est_bytes == sr.plan.batch * per_frame
