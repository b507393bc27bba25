"""The band conv (``ops/pallas_conv.py``: ``band_conv3x3``, ``FastTail``)
and the FW_TAIL=2 path (``RRDBNet.tail2``) of the PyTorch port against the
JAX package, on the CPU.

Seeded numpy inputs and weights go to both packages. The port's wrappers
run their plain versions here (CPU tensors); the JAX kernels run in
interpret mode (the band conv, and tail2 at the block size
tests/conftest.py pins, FW_TAIL2_S=32). The CUDA kernel is held against
the plain version on the card (chip_smoke.py, tests/test_torch_gpu.py).

Tolerances:
- one band conv: the same bf16 operands and rounding point, f32 sums in
  another order, so outputs sit at most one bf16 step apart, the step of
  max(|v|, 2^-6): below 2^-6 a 576-term f32 sum of unit-sized products
  carries more rounding of its own than a bf16 step of the result (a
  value of 1.67e-5 against 1.645e-5 is 4 of its own steps). Measured:
  0-0.015% of values one step apart; bound 0.1%.
- whole tails and models: the JAX package's 0.05 max / 0.005 mean against
  its own path and against the f32 ``apply`` (tests/test_fused_tail3.py);
  uint8 outputs within one LSB (tests/test_torch_int8.py), the share not
  bounded: this model's outputs lie inside [0, 1], where a bf16 step of
  the last conv's output is a fraction of an LSB and rounds either way
  (measured: 12.8% of the planes' values one LSB apart at 24x40).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framewright_tpu.models import rrdb as jrrdb
from framewright_tpu.models.registry import packaged_weights_dir
from framewright_tpu.ops import pallas_conv as jpc
from framewright_tpu_torch.models import rrdb
from framewright_tpu_torch.models.layers import conv2d, conv_init, out_epilogue
from framewright_tpu_torch.models.registry import (
    bf16_masters,
    from_jax_params,
    init_params,
    read_npz,
)
from framewright_tpu_torch.ops import fused_rrdb, fused_tail, pallas_conv

STEP_FLOOR, STEP_FRAC = 2.0 ** -6, 1e-3
MAX_ABS, MEAN_ABS = 0.05, 0.005


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _steps(got, want):
    """|got - want| in bf16 steps of max(|got|, |want|, STEP_FLOOR)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), STEP_FLOOR)
    return np.abs(got - want) / np.exp2(np.floor(np.log2(mag)) - 7)


def _conv(cin, cout, seed):
    """A seeded conv in both layouts: HWIO numpy params and nn.Conv2d."""
    p = conv_init(np.random.default_rng(seed), 3, cin, cout)
    conv = torch.nn.Conv2d(cin, cout, 3, padding=1)
    conv.weight.data = torch.from_numpy(p["w"].transpose(3, 2, 0, 1).copy())
    conv.bias.data = torch.from_numpy(p["b"])
    return p, conv


class TestBandConv:
    @pytest.mark.parametrize("cout", [64, 3])
    def test_weights_equal_jax(self, cout):
        p, conv = _conv(64, cout, seed=cout)
        wts = pallas_conv.conv_wide_weights(conv)
        wide, b, cpad = jpc.conv_wide_weights(p["w"], p["b"])
        assert wts.w.shape == (cpad, 3, 3, 64) and wts.cout == cout
        np.testing.assert_array_equal(wts.w.float().reshape(cpad, -1).numpy(),
                                      np.asarray(wide, np.float32))
        np.testing.assert_array_equal(wts.b.numpy(), np.asarray(b)[:, 0])

    @pytest.mark.parametrize("hw", [(13, 20), (17, 131)])
    @pytest.mark.parametrize("act", ["lrelu", None])
    @pytest.mark.parametrize("cout", [64, 3])
    def test_plain_matches_jax_band_conv3x3(self, cout, act, hw):
        """(17, 131) crosses the JAX kernel's 128-column padding."""
        p, conv = _conv(64, cout, seed=cout)
        wts = pallas_conv.conv_wide_weights(conv)
        wide, b, _ = jpc.conv_wide_weights(p["w"], p["b"])
        h, w = hw
        x = torch.from_numpy(np.random.default_rng(h).standard_normal(
            (2, h, w, 64)).astype(np.float32)).to(torch.bfloat16)
        want = np.stack([np.asarray(jpc.band_conv3x3(
            jnp.asarray(xi.float().numpy().transpose(2, 0, 1), jnp.bfloat16), wide, b, act=act,
            interpret=True), np.float32).transpose(1, 2, 0) for xi in x])
        got = pallas_conv.band_conv3x3_plain(x, wts, act=act == "lrelu")
        assert got.shape == (2, h, w, wts.w.shape[0]) and got.dtype == torch.bfloat16
        st = _steps(got.float().numpy(), want)
        assert st.max() <= 1 and (st > 0).mean() < STEP_FRAC, (st.max(), (st > 0).mean())

    @pytest.mark.parametrize("cout", [64, 3])
    def test_kernel_weights_are_the_chunk_major_copy(self, cout):
        """wk, the copy the kernel reads: fused_rrdb.wgmma_weights(w), and
        element (c, tap, k, n, e) is w[n, tap // 3, tap % 3, 16 c + 8 k + e]."""
        _, conv = _conv(64, cout, seed=cout + 1)
        wts = pallas_conv.conv_wide_weights(conv)
        cpad = wts.w.shape[0]
        assert wts.wk.shape == (4, 9, 2, cpad, 8) and wts.wk.dtype == torch.bfloat16
        assert torch.equal(wts.wk, fused_rrdb.wgmma_weights(wts.w))
        c, tap, k, n, e = np.indices(wts.wk.shape)
        w = wts.w.float().numpy()
        np.testing.assert_array_equal(wts.wk.float().numpy(),
                                      w[n, tap // 3, tap % 3, 16 * c + 8 * k + e])

    @pytest.mark.parametrize("cin,cout", [(24, 64), (40, 8), (64, 16), (64, 128)])
    def test_wrapper_refuses_what_the_kernel_does_not_take(self, cin, cout):
        """Cin not a multiple of 16, or Cout' other than 64 or 8: ValueError
        before any launch, on the CPU as on the card; conv_wide_weights
        refuses such a Cin too."""
        if cin % 16:
            with pytest.raises(ValueError, match="multiple of 16"):
                pallas_conv.conv_wide_weights(torch.nn.Conv2d(cin, cout, 3, padding=1))
        w = torch.zeros(cout, 3, 3, cin, dtype=torch.bfloat16)
        wts = pallas_conv.BandConvWeights(w, torch.zeros(cout), cout, w)
        x = torch.zeros(1, 5, 7, cin, dtype=torch.bfloat16)
        before = pallas_conv.band_conv3x3.launches
        with pytest.raises(ValueError, match="the kernel takes"):
            pallas_conv.band_conv3x3(x, wts)
        assert pallas_conv.band_conv3x3.launches == before
        assert pallas_conv.band_conv3x3_plain(x, wts).shape == (1, 5, 7, cout)

    def test_wrapper_runs_the_plain_version_on_the_cpu(self):
        _, conv = _conv(64, 64, seed=1)
        wts = pallas_conv.conv_wide_weights(conv)
        x = torch.randn(1, 9, 11, 64).to(torch.bfloat16)
        before = pallas_conv.band_conv3x3.launches
        assert torch.equal(pallas_conv.band_conv3x3(x, wts),
                           pallas_conv.band_conv3x3_plain(x, wts))
        assert pallas_conv.band_conv3x3.launches == before
        with pytest.raises(ValueError, match="bf16"):
            pallas_conv.band_conv3x3(x.float(), wts)
        with pytest.raises(ValueError, match="contiguous"):
            pallas_conv.band_conv3x3(x.transpose(1, 2), wts)
        with pytest.raises(ValueError, match="weights"):
            pallas_conv.band_conv3x3(x[..., :32].contiguous(), wts)


@pytest.fixture(scope="module")
def nets():
    """A 1-block scale-2 model with seeded weights, as the JAX processor
    holds them (bf16) and as the port's module does (bf16 masters)."""
    params = init_params(rrdb.RRDBConfig(num_block=1, scale=2), seed=5)
    host = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(jnp.bfloat16), params)
    model = rrdb.RRDBNet.from_state_dict(rrdb.RRDBConfig(num_block=1, scale=2),
                                         bf16_masters(from_jax_params(params, torch.float32)),
                                         torch.device("cpu"))
    return host, model


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(3).random((1, 24, 40, 3)).astype(np.float32)


class TestFastTail:
    def test_fast_tail_matches_jax(self, nets):
        host, model = nets
        g = np.random.default_rng(8)
        feat, body = (torch.from_numpy(g.uniform(-1, 1, (1, 12, 20, 64)).astype(np.float32))
                      .to(torch.bfloat16) for _ in range(2))
        want = np.asarray(jpc.FastTail(host, interpret=True)(
            jnp.asarray(feat.float().numpy(), jnp.bfloat16),
            jnp.asarray(body.float().numpy(), jnp.bfloat16)), np.float32)
        before = pallas_conv.band_conv3x3.launches
        got = pallas_conv.FastTail(model)(feat, body)
        assert pallas_conv.band_conv3x3.launches == before
        assert got.shape == want.shape == (1, 48, 80, 3) and got.dtype == torch.bfloat16
        d = np.abs(got.float().numpy() - want)
        assert d.max() < MAX_ABS and d.mean() < MEAN_ABS, (d.max(), d.mean())
        assert torch.equal(pallas_conv.FastTail(model, plain=True)(feat, body), got)

    @pytest.mark.parametrize("out_mode", ["bf16", "yuv420_u8"])
    def test_apply_fast_with_fast_tail_matches_jax(self, nets, x, out_mode):
        host, model = nets
        cfg = jrrdb.RRDBConfig(num_block=1, scale=2)
        want = jrrdb.apply_fast(host, jrrdb.make_fast_params(host), jnp.asarray(x, jnp.bfloat16),
                                cfg, interpret=True, fast_tail=jpc.FastTail(host, interpret=True),
                                out_mode=out_mode)
        got = model.apply_fast(torch.from_numpy(x), out_mode,
                               fast_tail=pallas_conv.FastTail(model))
        if out_mode == "bf16":
            assert got.shape == (1, 48, 80, 3)
            d = np.abs(got.float().numpy() - np.asarray(want, np.float32))
            assert d.max() < MAX_ABS and d.mean() < MEAN_ABS, (d.max(), d.mean())
            return
        for g_, w_ in zip(got, want):
            assert g_.shape == w_.shape and g_.dtype == torch.uint8
            d = np.abs(g_.numpy().astype(np.int16) - np.asarray(w_).astype(np.int16))
            assert d.max() <= 1, d.max()

    def test_fast_tail_skips_tail3_and_follows_fw_rdb_body(self, nets, x, monkeypatch):
        """With ``fast_tail`` the body runs by FW_RDB_BODY, then the
        band-conv tail, then the epilogue in PyTorch."""
        _, model = nets
        xt, tail, fw = torch.from_numpy(x), pallas_conv.FastTail(model), model.fast_weights()
        feat = model._head(xt.to(torch.bfloat16)).contiguous()
        img = model.apply_fast(xt, fast_tail=tail)
        assert torch.equal(img, tail(feat, fused_rrdb.rrdb_body(feat, fw.body)[..., :64]))
        assert not torch.equal(img, model.apply_fast(xt))          # K1 + K2 without it
        monkeypatch.setenv("FW_RDB_BODY", "resident")
        img = model.apply_fast(xt, fast_tail=tail)
        assert torch.equal(img, tail(feat, fused_rrdb.rrdb_body_resident(feat, fw.body)))
        for g_, w_ in zip(model.apply_fast(xt, "yuv420_u8", True, fast_tail=tail),
                          out_epilogue(img, "yuv420_u8", True)):
            assert torch.equal(g_, w_)


class TestTail2:
    @pytest.mark.parametrize("kind", ["bf16", "dynamic"])
    def test_apply_fast_tail2_matches_jax(self, nets, x, kind, monkeypatch):
        """FW_TAIL=2: the body, conv_body + skip as a plain conv, then K2
        with bf16 output, against JAX ``apply_fast`` on the same path."""
        host, model = nets
        cfg = jrrdb.RRDBConfig(num_block=1, scale=2)
        monkeypatch.setenv("FW_TAIL", "2")
        if kind == "bf16":
            jfast, fw = jrrdb.make_fast_params(host), model.fast_weights()
        else:
            jfast = jrrdb.make_fast_params(host, compute_dtype="int8")
            fw = model.fast_weights_int8(None)
        want = np.asarray(jrrdb.apply_fast(host, jfast, jnp.asarray(x, jnp.bfloat16), cfg,
                                           interpret=True), np.float32)
        before = fused_tail.fused_tail.launches
        got = model.apply_fast(torch.from_numpy(x), weights=fw)
        assert fused_tail.fused_tail.launches == before          # CPU: the plain version
        assert got.shape == want.shape == (1, 48, 80, 3) and got.dtype == torch.bfloat16
        d = np.abs(got.float().numpy() - want)
        assert d.max() < MAX_ABS and d.mean() < MEAN_ABS, (d.max(), d.mean())

    def test_tail2_is_conv_body_skip_then_k2(self, nets):
        _, model = nets
        g = np.random.default_rng(2)
        feat, body = (torch.from_numpy(g.uniform(-1, 1, (2, 10, 14, 64)).astype(np.float32))
                      .to(torch.bfloat16) for _ in range(2))
        fw = model.fast_weights()
        f = feat + conv2d(body, model.conv_body.weight, model.conv_body.bias)
        want = fused_tail.fused_tail_plain(f.contiguous(), fw.tail, "bf16")
        assert torch.equal(model.tail2(feat, body, fw.tail), want)
        assert torch.equal(model.tail2(feat, body, fw.tail, plain=True), want)


class TestTrainedWeights:
    """FW_fast6_x2, the repository's trained 6-block RRDB, on the new
    paths against the JAX f32 ``apply`` at the JAX package's tolerances."""

    @pytest.fixture(scope="class")
    def fast6(self):
        params = read_npz(packaged_weights_dir() / "FW_fast6_x2.npz")
        jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
        model = rrdb.RRDBNet.from_state_dict(
            rrdb.RRDBConfig(num_block=6, scale=2),
            bf16_masters(from_jax_params(jp, torch.float32)), torch.device("cpu"))
        x = np.random.default_rng(11).random((1, 48, 64, 3)).astype(np.float32)
        oracle = np.asarray(jrrdb.apply(jp, jnp.asarray(x), jrrdb.RRDBConfig(num_block=6,
                                                                              scale=2)),
                            np.float32)
        return model, x, oracle

    @pytest.mark.parametrize("path", ["fast_tail", "resident_tail2"])
    def test_new_paths_match_f32_apply(self, fast6, path, monkeypatch):
        model, x, oracle = fast6
        if path == "fast_tail":
            got = model.apply_fast(torch.from_numpy(x), fast_tail=pallas_conv.FastTail(model))
        else:
            monkeypatch.setenv("FW_RDB_BODY", "resident")
            monkeypatch.setenv("FW_TAIL", "2")
            got = model.apply_fast(torch.from_numpy(x))
        d = np.abs(got.float().numpy() - oracle)
        assert d.max() < MAX_ABS and d.mean() < MEAN_ABS, (d.max(), d.mean())
