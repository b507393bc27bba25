"""The SRVGG family of the PyTorch port (realesr-animevideov3,
realesr-general-x4v3, FW_fastvgg_x2/x4) in bf16 against the JAX
package, on the CPU.

Seeded numpy inputs and the same parameters go to both packages: the
JAX ``srvgg.init`` pytree at ``num_conv = GROUP + 2`` (an uneven
trailing group, as tests/test_fused_srvgg.py takes it) and the trained
``FW_fastvgg_x2.npz``. The port's chain wrappers run their plain
versions here (CPU tensors); the JAX chain kernels run in interpret mode
at the block size tests/conftest.py pins (``FW_VGG_S``). The CUDA
kernels are held against these plain versions on the card
(chip_smoke.py, tests/test_torch_gpu.py).

Tolerances:
- registry rows, fast weights: exact;
- ``apply`` in f32: 1e-5 (the same f32 convolutions, summed in another
  order; measured <= 1.4e-7 on the seeded model);
- ``apply_fast`` against ``fused_srvgg.apply_fast(interpret=True)``: the
  JAX package's own bounds against the plain forward, max and mean error
  over the output range < 0.05 / 0.005 (tests/test_fused_srvgg.py);
  measured 4.6e-4 / 7.3e-5 absolute on the seeded model, where the f32
  sums of a bf16 chain conv round to the other bf16 neighbour now and
  then and the difference propagates;
- the CLI against the JAX CLI: 1 LSB, mean <= 0.1 LSB (measured max 1,
  mean 0.0596-0.0859 per frame). The JAX CLI runs SRVGG through plain
  XLA bf16 on the CPU (its processor's auto rule), every conv and the
  last one rounded to bf16, where the port runs the kernel path with
  conv_last in f32.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framewright_tpu.cli import main as jax_main
from framewright_tpu.io import y4m as jy4m
from framewright_tpu.models import registry as jregistry
from framewright_tpu.models import srvgg as js
from framewright_tpu.models import torch_port
from framewright_tpu.models.layers import conv2d as jconv2d
from framewright_tpu.models.rrdb import _out_epilogue as jax_out_epilogue
from framewright_tpu.ops import fused_srvgg as jf
from framewright_tpu_torch import cli, planner
from framewright_tpu_torch.models import srvgg
from framewright_tpu_torch.models.layers import conv2d, out_epilogue, prelu
from framewright_tpu_torch.models.registry import (
    MODEL_SPECS,
    bf16_masters,
    from_jax_params,
    init_params,
    load_weights,
    packaged_weights_dir,
    read_npz,
)
from framewright_tpu_torch.ops import fused_srvgg
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution

SRVGG_NAMES = ("FW_fastvgg_x2", "FW_fastvgg_x4", "realesr-animevideov3",
               "realesr-general-x4v3")
FAST_MAX, FAST_MEAN = 0.05, 0.005
SHAPES = [(30, 30), (jf.BH_V + 7, 2 * jf.BH_V + 3)]    # one block; seams + ragged


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def bf16_host(params):
    """The JAX processor's host params: every leaf cast to bf16."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a).astype(jnp.bfloat16), params)


def port_model(params, cfg, masters=True):
    sd = from_jax_params(params, torch.float32)
    return srvgg.SRVGGNet.from_state_dict(cfg, bf16_masters(sd) if masters else sd,
                                          torch.device("cpu"))


def jax_chain(host, fast, x):
    """``fused_srvgg._apply_fast_impl`` up to the chain's output (NHWC
    float32): conv0 and PReLU in XLA, then every group through the
    interpret-mode kernel on the TPU block grid."""
    feat = jconv2d(host["body"][0], x)
    al0 = host["act"][0]["alpha"]
    feat = jnp.where(feat >= 0, feat, feat * al0.astype(feat.dtype))
    fcm = feat.transpose(0, 3, 1, 2).astype(jnp.bfloat16)
    b, h, w, _ = x.shape
    nh, nw = jf._grid_dims(h, w)
    ext = jnp.asarray(np.tile(jf._block_extents(h, w, nh, nw), (b, 1)))
    run = jf.fused_conv_chain_int8 if len(fast["groups"][0]) == 5 else jf.fused_conv_chain
    for group in fast["groups"]:
        fcm = jf._assemble(run(jf._extract(fcm, h, w), ext, group, interpret=True), b, h, w)
    return np.asarray(fcm.transpose(0, 2, 3, 1).astype(jnp.float32))


def port_chain(model, x, weights):
    """The port's apply_fast up to the chain's output (NHWC float32)."""
    c0 = model.convs[0]
    feat = prelu(conv2d(x, c0.weight, c0.bias), model.acts[0].weight)
    return fused_srvgg.conv_chain(feat.to(torch.bfloat16).contiguous(),
                                  weights.groups).float().numpy()


def _cfgs(num_conv=jf.GROUP + 2, scale=2):
    return srvgg.SRVGGConfig(num_conv=num_conv, scale=scale), js.SRVGGConfig(
        num_conv=num_conv, scale=scale)


@pytest.fixture(scope="module")
def seeded():
    """(port cfg, JAX cfg, f32 params, bf16 host params) of the JAX
    package's seeded 10-conv x2 test model."""
    cfg, jcfg = _cfgs()
    params = jax.tree_util.tree_map(np.asarray, js.init(jax.random.PRNGKey(0), jcfg))
    return cfg, jcfg, params, bf16_host(params)


@pytest.fixture(scope="module")
def fastvgg():
    cfg, jcfg = _cfgs(16, 2)
    params = read_npz(packaged_weights_dir() / "FW_fastvgg_x2.npz")
    return cfg, jcfg, params, bf16_host(params)


@pytest.fixture(params=["seeded", "fastvgg"])
def net(request):
    return request.getfixturevalue(request.param)


class TestRegistry:
    @pytest.mark.parametrize("name", SRVGG_NAMES)
    def test_rows_match_jax(self, name):
        ours, theirs = MODEL_SPECS[name], jregistry.get_model(name)
        assert (ours.family, ours.scale, ours.url) == (theirs.family, theirs.scale, theirs.url)
        for field in ("num_in_ch", "num_out_ch", "num_feat", "num_conv", "scale", "act_type"):
            assert getattr(ours.arch_config, field) == getattr(theirs.arch_config, field), field

    def test_init_params_shapes_match_jax(self):
        cfg, jcfg = _cfgs(5, 4)
        ours = init_params(cfg, seed=3)
        theirs = js.init(jax.random.PRNGKey(0), jcfg)
        assert (jax.tree_util.tree_structure(ours)
                == jax.tree_util.tree_structure(theirs))
        for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
            assert a.shape == b.shape and a.dtype == np.float32
        assert all(np.all(a["alpha"] == 0.25) for a in ours["act"])

    def test_read_npz_reads_fw_fastvgg_x2(self):
        params = read_npz(packaged_weights_dir() / "FW_fastvgg_x2.npz")
        assert len(params["body"]) == len(params["act"]) == 17
        sd = from_jax_params(params, torch.float32)
        assert len(sd) == 53 and sd["body.34.weight"].shape == (12, 64, 3, 3)
        assert sd["body.1.weight"].shape == (64,)

    def test_basicsr_state_dict_loads(self, tmp_path):
        """A state dict with the official SRVGGNetCompact names (as a
        ``.pth`` in the weights dir) loads with no renaming, and computes
        what the JAX package computes from it (``torch_port.port_srvgg``)."""
        cfg, jcfg = _cfgs(3, 4)
        sd = from_jax_params(init_params(cfg, seed=4), torch.float32)
        torch.save({"params": sd}, tmp_path / "realesr-animevideov3.pth")
        spec, loaded, source = load_weights("realesr-animevideov3", tmp_path)
        assert source.endswith(".pth") and set(loaded) == set(sd)
        # the .pth row has 16 convs; build the 3-conv model from the same names
        model = srvgg.SRVGGNet.from_state_dict(cfg, loaded, torch.device("cpu"))
        jparams = torch_port.port_srvgg({k: v.numpy() for k, v in sd.items()}, 3)
        x = np.random.default_rng(0).random((1, 9, 11, 3), dtype=np.float32)
        np.testing.assert_allclose(model.apply(torch.from_numpy(x)).numpy(),
                                   np.asarray(js.apply(jparams, jnp.asarray(x), jcfg)),
                                   atol=1e-5)


def test_apply_matches_jax_f32(net):
    cfg, jcfg, params, _ = net
    x = np.random.default_rng(1).random((1, 30, 26, 3), dtype=np.float32)
    got = port_model(params, cfg, masters=False).apply(torch.from_numpy(x)).numpy()
    want = np.asarray(js.apply(params, jnp.asarray(x), jcfg))
    assert got.shape == want.shape == (1, 60, 52, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fast_weights_equal_make_fast_params(net):
    cfg, jcfg, params, host = net
    want = jf.make_fast_params(host, jcfg)["groups"]
    got = port_model(params, cfg).fast_weights().groups
    assert len(got) == len(want) == -(-cfg.num_conv // fused_srvgg.GROUP)
    for g, (w, b, a) in zip(got, want):
        assert g.w.dtype == torch.bfloat16 and g.w.shape == w.shape
        np.testing.assert_array_equal(g.w.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))
        np.testing.assert_array_equal(g.b.numpy(), np.asarray(b))
        np.testing.assert_array_equal(g.alpha.numpy(), np.asarray(a))


@pytest.mark.parametrize("hw", SHAPES)
def test_apply_fast_matches_jax_interpret(seeded, hw):
    """The port's kernel path (plain chains on the CPU) against the JAX
    package's (interpret-mode chain kernels), on the restore's bf16
    input, and both against the plain f32 forward with the JAX bounds."""
    cfg, jcfg, params, host = seeded
    model = port_model(params, cfg)
    x = np.random.default_rng(1).random((1, *hw, 3), dtype=np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jf.apply_fast(host, jf.make_fast_params(host, jcfg), xb, jcfg,
                                    interpret=True), np.float32)
    got = model.apply_fast(torch.from_numpy(x).to(torch.bfloat16)).numpy()
    ref = np.asarray(js.apply(params, jnp.asarray(x), jcfg), np.float32)
    assert got.shape == want.shape == ref.shape == (1, 2 * hw[0], 2 * hw[1], 3)
    scale = np.abs(ref).max() + 1e-3
    for a, b in ((got, want), (got, ref), (want, ref)):
        err = np.abs(a - b)
        assert err.max() / scale < FAST_MAX and err.mean() / scale < FAST_MEAN


def test_chain_matches_jax_chain(seeded):
    """The bf16 chain output itself (two groups, the second of 2 convs)
    at the block seams: within a few bf16 steps of the JAX kernel's."""
    cfg, jcfg, params, host = seeded
    model = port_model(params, cfg)
    x = np.random.default_rng(2).random((1, *SHAPES[1], 3), dtype=np.float32)
    want = jax_chain(host, jf.make_fast_params(host, jcfg), jnp.asarray(x).astype(jnp.bfloat16))
    got = port_chain(model, torch.from_numpy(x).to(torch.bfloat16), model.fast_weights())
    d = np.abs(got - want)
    assert d.max() <= 2.0 ** -5 * max(1.0, np.abs(want).max()) and d.mean() < 1e-3, (
        d.max(), d.mean())


def test_fastvgg_apply_fast_within_the_jax_bounds(fastvgg):
    """The trained model: kernel path against the plain f32 forward,
    absolute max 0.05 / mean 0.005 (outputs in [0, 1])."""
    cfg, _, params, _ = fastvgg
    x = np.random.default_rng(3).random((1, 24, 32, 3), dtype=np.float32)
    model = port_model(params, cfg)
    got = model.apply_fast(torch.from_numpy(x).to(torch.bfloat16)).numpy()
    ref = port_model(params, cfg, masters=False).apply(torch.from_numpy(x)).numpy()
    err = np.abs(got - ref)
    assert err.max() < FAST_MAX and err.mean() < FAST_MEAN, (err.max(), err.mean())


@pytest.mark.parametrize("name", ["realesr-general-x4v3", "FW_fastvgg_x4"])
def test_four_group_models_match_jax(name):
    """The 32-conv x4 rows (four chain groups; no checkpoint in the
    repository): seeded weights through both packages' kernel paths."""
    spec = MODEL_SPECS[name]
    jcfg = jregistry.get_model(name).arch_config
    params = init_params(spec.arch_config, seed=5)
    host = bf16_host(params)
    model = port_model(params, spec.arch_config)
    assert len(model.fast_weights().groups) == 4
    x = np.random.default_rng(4).random((1, 12, 14, 3), dtype=np.float32)
    want = np.asarray(jf.apply_fast(host, jf.make_fast_params(host, jcfg),
                                    jnp.asarray(x).astype(jnp.bfloat16), jcfg,
                                    interpret=True), np.float32)
    got = model.apply_fast(torch.from_numpy(x).to(torch.bfloat16)).numpy()
    assert got.shape == want.shape == (1, 48, 56, 3)
    scale = np.abs(want).max() + 1e-3
    err = np.abs(got - want)
    assert err.max() / scale < FAST_MAX and err.mean() / scale < FAST_MEAN


@pytest.mark.parametrize("full_range", [False, True])
def test_out_modes_are_the_jax_epilogue(seeded, full_range):
    cfg, _, params, _ = seeded
    model = port_model(params, cfg)
    x = torch.from_numpy(np.random.default_rng(6).random((2, 12, 10, 3),
                                                         dtype=np.float32)).to(torch.bfloat16)
    f32 = model.apply_fast(x)
    planes = model.apply_fast(x, "yuv420_u8", full_range)
    want = jax.device_get(jax_out_epilogue(jnp.asarray(f32.numpy()), "yuv420_u8", full_range))
    for got, w, w2 in zip(planes, want, out_epilogue(f32, "yuv420_u8", full_range)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        assert torch.equal(got, w2)
    np.testing.assert_array_equal(
        model.apply_fast(x, "rgb_u8").numpy(),
        np.asarray(jax.device_get(jax_out_epilogue(jnp.asarray(f32.numpy()), "rgb_u8", False))))


class TestChainWrappers:
    def test_plain_on_the_cpu_and_no_count(self, seeded):
        cfg, _, params, _ = seeded
        group = port_model(params, cfg).fast_weights().groups[1]
        x = torch.from_numpy(np.random.default_rng(7).uniform(
            -1, 1, (2, 9, 13, 64)).astype(np.float32)).to(torch.bfloat16)
        out, want = torch.empty_like(x), torch.empty_like(x)
        n = fused_srvgg.fused_conv_chain.launches
        assert fused_srvgg.fused_conv_chain(x, out, group) is out
        fused_srvgg.fused_conv_chain_plain(x, want, group)
        assert torch.equal(out, want) and fused_srvgg.fused_conv_chain.launches == n

    def test_refuses_bad_inputs(self, seeded):
        cfg, _, params, _ = seeded
        group = port_model(params, cfg).fast_weights().groups[0]
        x = torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16)
        for bad in ((x, x), (x.float(), torch.empty_like(x)),
                    (x, torch.empty(1, 8, 9, 64, dtype=torch.bfloat16)),
                    (x[:, :, :4], torch.empty(1, 8, 4, 64, dtype=torch.bfloat16))):
            with pytest.raises(ValueError):
                fused_srvgg.fused_conv_chain(*bad, group)


class TestSlice:
    def test_processor_runs_the_kernel_path(self, gradient_frame):
        sr = SuperResolution(SRConfig(model_name="FW_fastvgg_x2", device="cpu",
                                      output_color="yuv420"))
        sr.setup(24, 32)
        assert isinstance(sr.model, srvgg.SRVGGNet) and sr.plan.body_divisor == 1
        frames = np.stack([gradient_frame(24, 32, t) for t in range(2)])
        got = sr.materialize(sr.dispatch(frames))
        x = torch.from_numpy(frames).to(torch.bfloat16) / 255.0
        for g, w in zip(got, sr.model.apply_fast(x, "yuv420_u8", False)):
            np.testing.assert_array_equal(g, w.numpy())

    def test_planner_counts_srvgg_by_scale(self):
        assert planner.peak_bytes_per_body_px("rrdb", 2) == 6800
        assert planner.peak_bytes_per_body_px("rrdb", 4, "int8") == 6000
        # the tail (conv_last in f32 at s^2) is the largest part at x2 and x4
        x4 = planner.peak_bytes_per_body_px("srvgg", 4)
        assert x4 == (640 + 24 * 16) * 11 // 10
        for dtype in ("bfloat16", "int8"):
            assert planner.peak_bytes_per_body_px("srvgg", 2, dtype) == (640 + 24 * 4) * 11 // 10
        assert planner.peak_bytes_per_body_px("srvgg", 1) == 664 * 11 // 10
        assert planner.frame_bytes(540, 960, 4, "srvgg") == 540 * 960 * x4
        # HAT has its row since A7; the video SR window is planned by
        # planner.vsr_bytes, not per body pixel
        for family in ("basicvsr", "tvsr"):
            with pytest.raises(ValueError):
                planner.peak_bytes_per_body_px(family, 4)

    @pytest.mark.parametrize("w,h,cs", [(64, 48, "420jpeg"), (33, 25, "mono")])
    def test_cli_restore_matches_jax_cli(self, tmp_path, gradient_frame, capsys, w, h, cs):
        src = tmp_path / "clip.y4m"
        with jy4m.Y4MWriter(src, w, h, fps=12, colorspace=cs) as wr:
            for t in range(3):
                wr.write_frame(gradient_frame(h, w, t))
        flags = ["--model", "FW_fastvgg_x2", "--device", "cpu"]
        assert jax_main(["restore", str(src), "-o", str(tmp_path / "jax.y4m"), *flags,
                         "--project-dir", str(tmp_path / "pj")]) == 0
        capsys.readouterr()
        assert cli.main(["restore", str(src), "-o", str(tmp_path / "port.y4m"), *flags,
                         "--project-dir", str(tmp_path / "pt")]) == 0
        summary = json.loads(capsys.readouterr().out)
        assert summary["frames"] == 3
        frames = []
        for name in ("jax.y4m", "port.y4m"):
            header, rest = (tmp_path / name).read_bytes().split(b"\n", 1)
            assert re.search(rb" W(\d+) H(\d+)", header).groups() == (b"%d" % (2 * w),
                                                                     b"%d" % (2 * h))
            frames.append([np.frombuffer(c, np.uint8) for c in rest.split(b"FRAME\n")[1:]])
        assert len(frames[0]) == len(frames[1]) == 3
        for a, b in zip(*frames):
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1 and d.mean() <= 0.1, (d.max(), d.mean())

    def test_cli_restore_four_group_model(self, tmp_path, gradient_frame, capsys):
        src = tmp_path / "clip.y4m"
        with jy4m.Y4MWriter(src, 16, 12, fps=12) as wr:
            for t in range(2):
                wr.write_frame(gradient_frame(12, 16, t))
        assert cli.main(["restore", str(src), "-o", str(tmp_path / "o.y4m"), "--model",
                         "realesr-general-x4v3", "--device", "cpu", "--weights-dir",
                         str(tmp_path / "none"), "--project-dir", str(tmp_path)]) == 0
        assert json.loads(capsys.readouterr().out)["frames"] == 2
        with jy4m.Y4MReader(tmp_path / "o.y4m") as r:
            assert (r.width, r.height, r.count_frames()) == (64, 48, 2)


def test_packaged_weights_path_is_the_jax_one():
    assert packaged_weights_dir() == Path(jregistry.__file__).resolve().parent / "weights"
