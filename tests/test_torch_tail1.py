"""tail1 of the PyTorch port (``fused_tail1``, ``RRDBNet.tail1``) and the
FW_TAIL / FW_RDB_BODY selection of ``apply_fast`` against the JAX
package, on the CPU.

tail1 runs conv_up2 on the nearest 2x upsample, conv_hr and conv_last
from conv_up1's output, with bf16 rounding after each conv as the JAX
``_tail_kernel`` has it. Here the port's wrapper runs its plain version
(CPU tensors) and the JAX kernel runs in interpret mode; the CUDA kernels
are held against the plain version on the card (chip_smoke.py,
tests/test_torch_gpu.py).

Tolerances: bf16 outputs of the same rounding points whose f32 sums are
taken in another order: where an intermediate (conv_up2's or conv_hr's
bf16 output) rounds the other way, the step spreads through the next
convs as an absolute error of about one bf16 step of 0.5, whatever the
output's magnitude. So the outputs sit at most one bf16 step apart, the
step of max(|v|, 0.5), on a stated share of values; the output epilogue is
the same f32 operations in the same order, so equal; the whole path
against the f32 ``apply`` at the JAX package's 0.05 / 0.005
(tests/test_fused_tail3.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from framewright_tpu.models import rrdb as jrrdb
from framewright_tpu.ops import fused_tail as jft
from framewright_tpu_torch.models import rrdb
from framewright_tpu_torch.models.layers import out_epilogue
from framewright_tpu_torch.models.registry import from_jax_params, init_params
from framewright_tpu_torch.ops import fused_rrdb, fused_tail


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """A 2-block scale-2 model with seeded weights in f32 (both packages),
    and the JAX tail1 phase weights."""
    params = init_params(rrdb.RRDBConfig(num_block=2, scale=2), seed=3)
    model = rrdb.RRDBNet.from_state_dict(rrdb.RRDBConfig(num_block=2, scale=2),
                                         from_jax_params(params, torch.float32),
                                         torch.device("cpu"))
    phase = jft.tail_phase_weights(params["conv_up2"], params["conv_hr"],
                                   params["conv_last"])
    return params, model, phase


def _a0(b, h, w, seed):
    """Seeded conv_up1-like input: lrelu'd values, rounded to bf16."""
    f = np.random.default_rng(seed).uniform(-0.3, 1.0, (b, h, w, 64)).astype(np.float32)
    t = torch.from_numpy(f).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _bf16_steps(got, want):
    """|got - want| in bf16 steps of max(|got|, |want|, 0.5)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 0.5)
    return np.abs(got - want) / np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("shape", [(1, 40, 56), (2, 70, 62)])
def test_tail1_plain_matches_jax_fused_tail_image(nets, shape):
    """(1, 40, 56) fits one 58-pixel JAX window, (2, 70, 62) spans 2x2.
    Measured: 0.47% / 0.45% of values differ, by at most 2^-8 (half a
    step of the largest outputs, about 1.1)."""
    _, model, phase = nets
    a_t, a_j = _a0(*shape, seed=shape[1])
    b, h, w = shape
    want = np.asarray(jft.fused_tail_image(a_j.transpose(0, 3, 1, 2), phase, h, w,
                                           interpret=True), np.float32)
    wts = model.fast_weights().tail
    got = fused_tail.fused_tail1_plain(a_t, wts)
    assert got.shape == (b, 2 * h, 2 * w, 3) and got.dtype == torch.bfloat16
    steps = _bf16_steps(got.float().numpy(), want)
    assert steps.max() <= 1 and (steps > 0).mean() < 0.01, (steps.max(), (steps > 0).mean())


def test_tail1_wrapper_runs_the_plain_version_on_the_cpu(nets):
    _, model, _ = nets
    a_t, _ = _a0(1, 12, 20, seed=1)
    wts = model.fast_weights().tail
    before = fused_tail.fused_tail1.launches
    assert torch.equal(fused_tail.fused_tail1(a_t, wts), fused_tail.fused_tail1_plain(a_t, wts))
    assert fused_tail.fused_tail1.launches == before
    with pytest.raises(ValueError, match="bf16"):
        fused_tail.fused_tail1(a_t.float(), wts)
    with pytest.raises(ValueError, match="contiguous"):
        fused_tail.fused_tail1(a_t.permute(0, 2, 1, 3), wts)


@pytest.mark.parametrize("out_mode,full_range", [("rgb_u8", False), ("yuv420_u8", False),
                                                 ("yuv420_u8", True)])
def test_out_epilogue_equals_jax_on_bf16(out_mode, full_range):
    """The epilogue after tail1 takes the bf16 RGB image, as JAX's
    ``_out_epilogue`` does: the same f32 operations, equal outputs."""
    y = np.random.default_rng(4).uniform(-0.2, 1.2, (2, 32, 48, 3)).astype(np.float32)
    yb = torch.from_numpy(y).to(torch.bfloat16)
    want = jrrdb._out_epilogue(jnp.asarray(yb.float().numpy(), jnp.bfloat16), out_mode,
                               full_range)
    got = out_epilogue(yb, out_mode, full_range)
    if out_mode == "rgb_u8":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


class TestApplyFastTail1:
    SHAPE = (2, 40, 56)

    @pytest.fixture(scope="class")
    def x(self):
        return np.random.default_rng(7).random((*self.SHAPE, 3)).astype(np.float32)

    @pytest.mark.parametrize("body", ["merge", "roundtrip"])
    def test_bf16_tail1_matches_jax(self, nets, x, body, monkeypatch):
        """FW_TAIL=1 with the bf16 body: both packages run the body, then
        conv_body + skip and conv_up1 as plain convs, then tail1. Against
        JAX ``apply_fast`` (the same path, interpret mode) and the f32
        ``apply`` oracle."""
        params, model, _ = nets
        cfg = jrrdb.RRDBConfig(num_block=2, scale=2)
        monkeypatch.setenv("FW_TAIL", "1")
        monkeypatch.setenv("FW_RDB_BODY", body)
        want = np.asarray(jrrdb.apply_fast(params, jrrdb.make_fast_params(params),
                                           jnp.asarray(x, jnp.bfloat16), cfg,
                                           interpret=True), np.float32)
        got = model.apply_fast(torch.from_numpy(x), weights=model.fast_weights()).float().numpy()
        assert got.shape == want.shape == (2, 80, 112, 3)
        d = np.abs(got - want)
        assert d.max() < 0.05 and d.mean() < 0.005, (d.max(), d.mean())
        oracle = np.asarray(jrrdb.apply(params, jnp.asarray(x), cfg), np.float32)
        d = np.abs(got - oracle)
        assert d.max() < 0.05 and d.mean() < 0.005, (d.max(), d.mean())

    def test_uint8_modes_are_the_epilogue_of_bf16(self, nets, x, monkeypatch):
        _, model, _ = nets
        monkeypatch.setenv("FW_TAIL", "1")
        xt, fw = torch.from_numpy(x), model.fast_weights()
        img = model.apply_fast(xt, "bf16", weights=fw)
        assert torch.equal(model.apply_fast(xt, "rgb_u8", weights=fw),
                           out_epilogue(img, "rgb_u8", False))
        for g, w in zip(model.apply_fast(xt, "yuv420_u8", True, weights=fw),
                        out_epilogue(img, "yuv420_u8", True)):
            assert torch.equal(g, w)

    def test_fw_tail_selection(self, nets, x, monkeypatch):
        """FW_TAIL=3 and auto run the tail3 path (K1, K2) for bf16 weights
        and tail1 for dynamic ones, as in the JAX package; 2 runs tail2
        (conv_body + skip, then K2) for both."""
        _, model, _ = nets
        xt = torch.from_numpy(x[:1, :16, :24])
        fw16, fw8 = model.fast_weights(), model.fast_weights_int8(None)
        outs = {}
        for kind in ("auto", "3", "1"):
            monkeypatch.setenv("FW_TAIL", kind)
            outs[kind] = (model.apply_fast(xt, weights=fw16), model.apply_fast(xt, weights=fw8))
        assert torch.equal(outs["auto"][0], outs["3"][0])
        assert not torch.equal(outs["auto"][0], outs["1"][0])    # K2 against tail1
        assert torch.equal(outs["auto"][1], outs["1"][1]) and torch.equal(outs["3"][1],
                                                                          outs["1"][1])
        monkeypatch.setenv("FW_TAIL", "2")
        for fw in (fw16, fw8):
            got = model.apply_fast(xt, weights=fw)
            feat = model._head(xt.to(torch.bfloat16)).contiguous()
            want = model.tail2(feat, fused_rrdb.rrdb_body_fast(feat, fw.body), fw.tail)
            assert torch.equal(got, want)
            assert not torch.equal(got, outs["1"][fw is fw8])       # K2 against tail1
