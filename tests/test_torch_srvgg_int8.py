"""The SRVGG int8 restore of the PyTorch port (static scales calibrated on
the first batch) against the JAX package, on the CPU.

The same seeded and trained parameters as tests/test_torch_srvgg.py go
to both packages. The port's int8 chain runs its plain version here (the
exact integer sums per chunk of 4 taps and the kernel's f32 operations
in its order); the JAX int8 chain kernel runs in interpret mode. The
CUDA kernel is held against the plain version on the card
(chip_smoke.py, tests/test_torch_gpu.py: every code and output equal).

Tolerances:
- int8 weights, weight scales, biases, alphas, aq: exact (the same numpy
  float32 operations in the same order);
- calibration: exact (both take max|.| of the same bf16 tensors; measured
  equal on both models);
- the chain's output with the same act_amax on both sides: one bf16
  step on fewer than 0.01% of values. Measured: 2 of 57,600 values of a
  one-conv chain at 30x30, 6 of 167,232 of the 10-conv chain at 39x67,
  each one bf16 step apart; everything else equal. XLA's CPU code fuses
  some of the f32 operations that the port (and its CUDA kernel) rounds
  one by one as the JAX program writes them: emulating an FMA in the
  chunk flush removes one of the two differences of the one-conv case;
- the whole kernel path: 1e-4 absolute (the chain's few differences and
  conv_last's f32 summation order; measured <= 3.5e-5);
- int8 against the plain f32 forward: PSNR > 35 dB, the JAX package's
  bound (tests/test_fused_srvgg.py).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framewright_tpu.models import srvgg as js
from framewright_tpu.ops import fused_srvgg as jf
from framewright_tpu_torch import cli
from framewright_tpu_torch.io import y4m
from framewright_tpu_torch.models import srvgg
from framewright_tpu_torch.ops import fused_srvgg
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution

from test_torch_srvgg import SHAPES, jax_chain, port_chain, port_model  # noqa: F401
from test_torch_srvgg import fastvgg, net, seeded  # noqa: F401  (fixtures)

VGG_PSNR_MIN = 35.0


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sample(seed=3, hw=(28, 30)):
    return np.random.default_rng(seed).random((1, *hw, 3), dtype=np.float32)


def _jax_amax(host, jcfg, sample):
    return np.asarray(jf.calibrate_act_scales(host, jcfg, jnp.asarray(sample)))


def test_calibration_equals_jax(net):
    cfg, jcfg, params, host = net
    model = port_model(params, cfg)
    sample = _sample()
    n = srvgg.calibrate_act_scales.calls
    got = srvgg.calibrate_act_scales(model, torch.from_numpy(sample))
    assert srvgg.calibrate_act_scales.calls == n + 1
    assert got.shape == (cfg.num_conv + 1,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _jax_amax(host, jcfg, sample))


def test_int8_weights_equal_make_fast_params_int8(net):
    cfg, jcfg, params, host = net
    amax = _jax_amax(host, jcfg, _sample())
    want = jf.make_fast_params_int8(host, jcfg, amax)["groups"]
    got = port_model(params, cfg).fast_weights_int8(amax).groups
    assert len(got) == len(want)
    for g, (wq, ws, b, al, aq) in zip(got, want):
        for ours, theirs in ((g.wq, wq), (g.ws, ws), (g.b, b), (g.alpha, al)):
            theirs = np.asarray(theirs)
            assert ours.numpy().dtype == theirs.dtype and ours.shape == theirs.shape
            np.testing.assert_array_equal(ours.numpy(), theirs)
        np.testing.assert_array_equal(g.aq, np.asarray(aq))
        n = len(g.alpha)
        # dq: the TPU kernel's ws * sa_i, formed in float32
        np.testing.assert_array_equal(
            g.dq.numpy(), (np.asarray(ws)[:, :, 0] * np.asarray(aq)[:n, None]).astype(np.float32))


def test_fast_weights_int8_checks_the_ranges(seeded):
    cfg, _, params, _ = seeded
    with pytest.raises(ValueError):
        port_model(params, cfg).fast_weights_int8(np.ones(cfg.num_conv))


@pytest.mark.parametrize("hw", SHAPES)
def test_int8_chain_equals_the_jax_chain(seeded, hw):
    """With the same act_amax the port's int8 chain (plain version) and
    the JAX int8 kernel give the same bf16 chain output but for a few
    values one bf16 step apart (module docstring): the same codes (q0
    from the group input, then each conv's requantized output; the second
    group requantizes the first group's bf16 output), the same f32
    operations."""
    cfg, jcfg, params, host = seeded
    model = port_model(params, cfg)
    x = _sample(1, hw)
    amax = _jax_amax(host, jcfg, x)
    fast8 = jf.make_fast_params_int8(host, jcfg, amax)
    w8 = model.fast_weights_int8(amax)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got, want = port_chain(model, xt, w8), jax_chain(host, fast8, xb)
    d = np.abs(got - want)
    assert np.all(d <= 2.0 ** -7 * np.abs(want)) and (d > 0).mean() < 1e-4, (
        d.max(), (d > 0).sum())
    got = model.apply_fast(xt).numpy()            # the int8 weights it holds
    want = np.asarray(jf.apply_fast(host, fast8, xb, jcfg, interpret=True), np.float32)
    assert np.abs(got - want).max() <= 1e-4


def test_int8_against_the_plain_forward(seeded):
    """The JAX package's int8 bound (tests/test_fused_srvgg.py): PSNR over
    the output range > 35 dB against the plain f32 forward."""
    cfg, jcfg, params, host = seeded
    x = _sample(7)
    model = port_model(params, cfg)
    model.fast_weights_int8(srvgg.calibrate_act_scales(model, torch.from_numpy(x)))
    got = model.apply_fast(torch.from_numpy(x)).numpy()
    want = port_model(params, cfg, masters=False).apply(torch.from_numpy(x)).numpy()
    mse = float(np.mean((got - want) ** 2))
    psnr = 10 * np.log10(max(float(want.max() - want.min()), 1e-6) ** 2 / max(mse, 1e-12))
    assert psnr > VGG_PSNR_MIN, psnr


class TestInt8ChainWrapper:
    def test_codes_and_counter_on_the_cpu(self, seeded):
        cfg, _, params, _ = seeded
        model = port_model(params, cfg)
        w8 = model.fast_weights_int8(np.linspace(0.5, 3.0, cfg.num_conv + 1))
        x = torch.from_numpy(np.random.default_rng(8).uniform(
            -1, 1, (2, 11, 9, 64)).astype(np.float32)).to(torch.bfloat16)
        out, want = torch.empty_like(x), torch.empty_like(x)
        codes = []
        n = fused_srvgg.fused_conv_chain_int8.launches
        fused_srvgg.fused_conv_chain_int8(x, out, w8.groups[0], codes)
        fused_srvgg.fused_conv_chain_int8_plain(x, want, w8.groups[0])
        assert torch.equal(out, want) and fused_srvgg.fused_conv_chain_int8.launches == n
        assert len(codes) == fused_srvgg.GROUP
        assert all(c.dtype == torch.int8 and c.shape == x.shape for c in codes)
        inv0 = float(w8.groups[0].aq[fused_srvgg.GROUP + 1])
        assert torch.equal(codes[0], torch.round(x.float() * inv0).clamp(-127, 127)
                           .to(torch.int8))

    def test_conv_chain_picks_the_int8_wrapper(self, seeded):
        cfg, _, params, _ = seeded
        model = port_model(params, cfg)
        w8 = model.fast_weights_int8(np.linspace(0.5, 3.0, cfg.num_conv + 1))
        x = torch.zeros(1, 5, 6, 64, dtype=torch.bfloat16)
        got = fused_srvgg.conv_chain(x, w8.groups)
        want = fused_srvgg.conv_chain(x, w8.groups, plain=True)
        assert torch.equal(got, want) and got.shape == x.shape


class TestSlice:
    def test_processor_calibrates_once_on_first_dispatch(self, gradient_frame):
        """int8_scales is ignored for SRVGG, as the JAX processor ignores
        it: "dynamic" still calibrates static scales on the first batch."""
        sr = SuperResolution(SRConfig(model_name="FW_fastvgg_x2", device="cpu",
                                      compute_dtype="int8", int8_scales="dynamic",
                                      output_color="yuv420"))
        sr.setup(24, 32)
        assert sr.model.int8_weights is None
        frames = np.stack([gradient_frame(24, 32, t) for t in range(2)])
        n = srvgg.calibrate_act_scales.calls
        first = sr.materialize(sr.dispatch(frames))
        second = sr.materialize(sr.dispatch(frames))
        assert srvgg.calibrate_act_scales.calls == n + 1
        assert isinstance(sr.model.int8_weights.groups[0], fused_srvgg.ChainGroupInt8)
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a, b)
        # the scales come from the processor's crop (here the whole first
        # frame: 24x32 is within 256x256, sides multiples of 8)
        crop = frames[:1].astype(np.float32) / 255.0
        amax = srvgg.calibrate_act_scales(sr.model, torch.from_numpy(crop))
        np.testing.assert_array_equal(sr.model.int8_weights.groups[0].aq[:fused_srvgg.GROUP + 1],
                                      np.maximum(amax[:fused_srvgg.GROUP + 1], 1e-6) / 127.0)
        x = torch.from_numpy(frames).to(torch.bfloat16) / 255.0
        for g, w in zip(first, sr.model.apply_fast(x, "yuv420_u8", False)):
            np.testing.assert_array_equal(g, w.numpy())

    def test_cli_restore_int8_on_the_cpu(self, tmp_path, gradient_frame, capsys):
        """int8 against the port's own bf16 restore of the same clip, in
        uint8: PSNR > 35 dB (the JAX CLI's int8 for SRVGG runs plain bf16
        XLA, ROADMAP.md, so it is no int8 reference)."""
        src = tmp_path / "clip.y4m"
        with y4m.Y4MWriter(src, 32, 24, fps=12) as w:
            for t in range(3):
                w.write_frame(gradient_frame(24, 32, t))
        outs = {}
        for dtype in ("bfloat16", "int8"):
            n = srvgg.calibrate_act_scales.calls
            assert cli.main(["restore", str(src), "-o", str(tmp_path / f"{dtype}.y4m"),
                             "--model", "FW_fastvgg_x2", "--dtype", dtype, "--device", "cpu",
                             "--project-dir", str(tmp_path / "p")]) == 0
            assert json.loads(capsys.readouterr().out)["frames"] == 3
            assert srvgg.calibrate_act_scales.calls == n + (dtype == "int8")
            with y4m.Y4MReader(tmp_path / f"{dtype}.y4m") as r:
                assert (r.width, r.height) == (64, 48)
                outs[dtype] = np.stack(list(r)).astype(np.float64)
        mse = np.mean((outs["int8"] - outs["bfloat16"]) ** 2)
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) > VGG_PSNR_MIN
