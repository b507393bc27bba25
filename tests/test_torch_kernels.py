"""The port's kernel modules against the JAX package's, on the CPU.

Each kernel module of framewright_tpu_torch.ops (fused_rrdb: the RDB;
fused_tail3: K1; fused_tail: K2) runs its plain PyTorch version here,
because its tensors lie on the CPU; the JAX functions run their Pallas
kernels in interpret mode at the block size tests/conftest.py pins.
The CUDA kernels are held against these plain versions on the card
(chip_smoke.py, tests/test_torch_gpu.py).
"""

import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from framewright_tpu.models import rrdb as jrrdb
from framewright_tpu.ops import fused_rrdb as jfr
from framewright_tpu.ops import fused_tail as jft
from framewright_tpu.ops import fused_tail3 as jft3
from framewright_tpu_torch.models import rrdb
from framewright_tpu_torch.models.registry import from_jax_params, init_params
from framewright_tpu_torch.ops import fused_rrdb, fused_tail, fused_tail3


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    # shared seeded weights, drawn with numpy (JAX's eager init is slow)
    params = init_params(rrdb.RRDBConfig(num_block=2, scale=2), seed=1)
    fast = jrrdb.make_fast_params(params)
    model = rrdb.RRDBNet.from_state_dict(rrdb.RRDBConfig(num_block=2, scale=2),
                                         from_jax_params(params, torch.float32),
                                         torch.device("cpu"))
    return params, fast, model


def _feat(b, h, w, seed=0):
    """Seeded (B, H, W, 64) features, rounded to bf16 for both sides."""
    f = np.random.default_rng(seed).uniform(-1, 1, (b, h, w, 64)).astype(np.float32)
    t = torch.from_numpy(f).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _err(got, want):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    return d.max(), d.mean()


class TestRDB:
    def test_body_matches_rrdb_body_merge(self, nets):
        # a 2-block body over a 2x2 grid of interpret-mode blocks, B=2
        _, fast, model = nets
        feat_t, feat_j = _feat(2, 60, 70, seed=1)
        want = np.asarray(jfr.rrdb_body_merge(feat_j, fast, interpret=True), np.float32)
        ws = fused_rrdb.rrdb_body(feat_t, model.fast_weights().body)
        got = ws[..., :64].float().numpy()
        mx, mean = _err(got, want)
        # same rounding points, summation order differs: a few bf16 ulps
        assert mx < 0.05 and mean < 5e-4, (mx, mean)

    def test_one_rdb_matches_rdb_forward(self, nets):
        params, _, model = nets
        feat_t, _ = _feat(1, 24, 40, seed=2)
        x = feat_t.float().numpy()
        want = np.asarray(jrrdb._rdb_forward(params["body"][0]["rdb2"], jnp.asarray(x)),
                          np.float32)
        ws = fused_rrdb.new_workspace(feat_t)
        dst = torch.zeros_like(ws)
        fused_rrdb.fused_rdb(ws, dst, model.fast_weights().body[0][1])
        mx, mean = _err(dst[..., :64].float().numpy(), want)
        assert mx < 0.05 and mean < 0.005, (mx, mean)

    def test_residual_variant(self, nets):
        _, _, model = nets
        feat_t, _ = _feat(1, 16, 20, seed=3)
        wts = model.fast_weights().body[0][2]
        ws = fused_rrdb.new_workspace(feat_t)
        plain = torch.empty_like(ws)
        fused_rrdb.fused_rdb(ws, plain, wts)
        carry = fused_rrdb.new_workspace(feat_t.flip(1).contiguous())
        want = ((fused_rrdb.BF16_0P2 * plain[..., :64].float()).to(torch.bfloat16).float()
                + carry[..., :64].float()).to(torch.bfloat16)
        fused_rrdb.fused_rdb(ws, carry, wts, carry=carry)    # in place over carry
        assert torch.equal(carry[..., :64], want)

    def test_wrapper_contract(self, nets):
        _, _, model = nets
        wts = model.fast_weights().body[0][0]
        feat_t, _ = _feat(1, 8, 8)
        ws = fused_rrdb.new_workspace(feat_t)
        before = fused_rrdb.fused_rdb.launches
        fused_rrdb.fused_rdb(ws, torch.empty_like(ws), wts)
        assert fused_rrdb.fused_rdb.launches == before      # CPU: plain version
        with pytest.raises(ValueError, match="dst must not be ws"):
            fused_rrdb.fused_rdb(ws, ws, wts)
        with pytest.raises(ValueError, match="bf16"):
            fused_rrdb.fused_rdb(ws.float(), torch.empty_like(ws).float(), wts)
        with pytest.raises(ValueError, match="contiguous"):
            t = ws.transpose(1, 2)
            fused_rrdb.fused_rdb(t, torch.empty_like(t), wts)


    @pytest.mark.parametrize("cin,cout", [(64, 32), (160, 32), (192, 64)])
    def test_wgmma_weights_layout(self, cin, cout):
        """The kernels' chunk-major weight copy: element (chunk c, tap,
        half k, row n, e) is OHWI w[n, tap // 3, tap % 3, 16 c + 8 k + e],
        each chunk contiguous; the copies of fast_weights match theirs."""
        w = torch.from_numpy(np.random.default_rng(cin).standard_normal(
            (cout, 3, 3, cin)).astype(np.float32)).to(torch.bfloat16)
        wk = fused_rrdb.wgmma_weights(w)
        assert wk.shape == (cin // 16, 9, 2, cout, 8) and wk.is_contiguous()
        c, tap, k, n, e = (np.random.default_rng(1).integers(0, d, 50) for d in wk.shape)
        for i in range(50):
            assert wk[c[i], tap[i], k[i], n[i], e[i]] == w[n[i], tap[i] // 3, tap[i] % 3,
                                                           16 * c[i] + 8 * k[i] + e[i]]

    def test_fast_weights_carry_the_kernel_copies(self, nets):
        _, _, model = nets
        fw = model.fast_weights()
        for wts in fw.body[0]:
            assert all(torch.equal(k, fused_rrdb.wgmma_weights(w)) for k, w in zip(wts.wk, wts.w))
        assert torch.equal(fw.cbody.wk, fused_rrdb.wgmma_weights(fw.cbody.w))


class TestTail:
    @pytest.fixture(scope="class")
    def body(self, nets):
        """JAX merge-body blocks over a multi-block grid, and the same
        body output assembled into an NHWC image for the port."""
        params, fast, model = nets
        x = np.random.default_rng(4).random((1, 120, 136, 3)).astype(np.float32)
        feat = jrrdb._head(params, jnp.asarray(x, jnp.bfloat16), jrrdb.RRDBConfig(
            num_block=2, scale=2))
        out_blocks, feat_blocks, ext, (b, nh, nw) = jfr.rrdb_body_merge_blocks(
            feat, fast, interpret=True)
        h, w = int(feat.shape[1]), int(feat.shape[2])
        body_img = jfr.assemble_blocks(out_blocks.reshape(b * nh * nw, 64, jfr.S, jfr.S),
                                       b, h, w).transpose(0, 2, 3, 1)
        to_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
        return (fast, model, (out_blocks, feat_blocks, ext, b, nh, nw, h, w),
                to_t(body_img).contiguous(), to_t(feat).contiguous())

    def _jax_tail(self, fast, blocks, out_mode, full_range=False):
        out_blocks, feat_blocks, ext, b, nh, nw, h, w = blocks
        return jft3.tail3_image(out_blocks, feat_blocks, ext, b, nh, nw, h, w,
                                fast["tail3_phase"], interpret=True,
                                out_mode=out_mode, full_range=full_range)

    def test_k1_k2_bf16_match_tail3_image(self, body):
        fast, model, blocks, body_t, feat_t = body
        want = np.asarray(self._jax_tail(fast, blocks, "bf16"), np.float32)
        fw = model.fast_weights()
        skip = fused_tail3.conv_body_skip(body_t, feat_t, fw.cbody)
        got = fused_tail.fused_tail(skip, fw.tail, "bf16").float().numpy()
        assert got.shape == want.shape == (1, 240, 272, 3)
        mx, mean = _err(got, want)
        assert mx < 0.02 and mean < 1e-3, (mx, mean)

    @pytest.mark.parametrize("out_mode,full_range", [("rgb_u8", False),
                                                      ("yuv420_u8", False),
                                                      ("yuv420_u8", True)])
    def test_k2_uint8_modes_match_tail3_image(self, body, out_mode, full_range):
        fast, model, blocks, body_t, feat_t = body
        want = self._jax_tail(fast, blocks, out_mode, full_range)
        fw = model.fast_weights()
        skip = fused_tail3.conv_body_skip(body_t, feat_t, fw.cbody)
        got = fused_tail.fused_tail(skip, fw.tail, out_mode, full_range)
        if out_mode == "rgb_u8":
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.dtype == torch.uint8 and tuple(g.shape) == w.shape
            d = np.abs(g.numpy().astype(np.float32) - w.astype(np.float32))
            assert d.max() <= 1 and (d > 0).mean() < 0.02, (d.max(), (d > 0).mean())

    def test_k1_matches_cbody_math(self, body):
        # K1 = bf16(conv_body(x) + b + feat) in f32, one rounding
        _, model, _, body_t, feat_t = body
        fw = model.fast_weights()
        got = fused_tail3.conv_body_skip(body_t, feat_t, fw.cbody)
        conv = model.conv_body
        acc = F.conv2d(body_t.permute(0, 3, 1, 2).float(),
                       conv.weight.to(torch.bfloat16).float(), padding=1)
        want = (acc + conv.bias.view(1, -1, 1, 1) + feat_t.permute(0, 3, 1, 2).float())
        want = want.permute(0, 2, 3, 1).to(torch.bfloat16)
        assert torch.equal(got, want)

    def test_phase_conv_equals_conv_after_nearest_upsample(self, nets):
        # f32 phase weights (before the bf16 cast) reproduce the 3x3 conv
        # over the nearest-2x image at 4/9 of its MACs
        _, _, model = nets
        w = model.conv_up1.weight.float()
        x = torch.from_numpy(np.random.default_rng(6).uniform(
            -1, 1, (1, 64, 9, 11)).astype(np.float32))
        want = F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), w, padding=1)
        wp = fused_tail.up2_phase_weights(w)
        xp = F.pad(x, (1, 1, 1, 1))
        for p in (0, 1):
            for q in (0, 1):
                k = wp[p * 2 + q].reshape(64, 2, 2, 64).permute(0, 3, 1, 2)
                got = F.conv2d(xp[:, :, p:p + 10, q:q + 12], k)
                torch.testing.assert_close(got, want[:, :, p::2, q::2],
                                           atol=1e-5, rtol=1e-5)

    # conv -> (passes, taps a pass reads: rows NU, columns NV), as
    # csrc/conv_wgmma.cuh's Taps3x3 and TapsUp2 walk them
    KERNEL_TAPS = {"up1": (4, 2, 2), "up2": (4, 2, 2), "hr": (1, 3, 3), "last": (1, 3, 3)}

    @pytest.mark.parametrize("conv", sorted(KERNEL_TAPS))
    def test_kernel_weights_reexpand_to_the_plain_convs(self, nets, conv):
        """The kernels' chunk-major copies ``<conv>_k``: element (pass p,
        chunk c, tap NV u + v, half k, row n, e) is tap (u, v) of the 3x3
        window whose top left is the pass's origin (phase p = 2 a + q:
        (a, q); one pass: (0, 0)), output channel n, input channel
        16 c + 8 k + e. Re-expanded so and summed over the padded input as
        the kernels' loop reads it, they give the plain versions'
        convolutions (float64: the sums agree to rounding)."""
        _, _, model = nets
        wts = model.fast_weights().tail
        npass, nu, nv = self.KERNEL_TAPS[conv]
        wk, plain = getattr(wts, f"{conv}_k"), getattr(wts, conv)
        want_k = (fused_tail.phase_wgmma_weights(plain) if npass == 4
                  else fused_rrdb.wgmma_weights(plain))
        assert torch.equal(wk, want_k) and wk.is_contiguous()
        cout = plain.shape[0] if npass == 1 else plain.shape[1]
        assert wk.shape == ((npass,) if npass > 1 else ()) + (4, nu * nv, 2, cout, 8)
        # (pass, tap, cout, cin)
        we = wk.reshape(npass, 4, nu * nv, 2, cout, 8).permute(0, 2, 4, 1, 3, 5).reshape(
            npass, nu * nv, cout, 64).double()
        h, w = 9, 13
        x = torch.from_numpy(np.random.default_rng(7).uniform(
            -1, 1, (2, 64, h, w))).to(torch.bfloat16).double()
        xp = F.pad(x, (1, 1, 1, 1))
        for p in range(npass):
            a, q = (p >> 1, p & 1) if npass == 4 else (0, 0)
            got = sum(torch.einsum("nchw,oc->nohw", xp[:, :, a + u:a + u + h, q + v:q + v + w],
                                   we[p, nv * u + v])
                      for u in range(nu) for v in range(nv))
            if npass == 4:   # the plain phase conv (_phase_conv_plain)
                k = plain[p].double().reshape(cout, 2, 2, 64).permute(0, 3, 1, 2)
                want = F.conv2d(xp[:, :, a:a + h + 1, q:q + w + 1], k)
            else:
                want = F.conv2d(x, plain.double().permute(0, 3, 1, 2), padding=1)
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)

    def test_phase_weights_match_jax(self, nets):
        params, fast, model = nets
        for name, key in (("conv_up1", "Wa0"), ("conv_up2", "Wa")):
            want = np.asarray(fast["tail2_phase"][key], np.float32)   # (4, 64, 256)
            got = (fused_tail.up2_phase_weights(getattr(model, name).weight)
                   .to(torch.bfloat16).float().reshape(4, 64, 256).numpy())
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("full_range", [False, True])
    def test_yuv_coefficients_match_yuv420_matrix(self, full_range):
        m, b = jft.yuv420_matrix(full_range)
        k = fused_tail.yuv420_coefficients(full_range)
        np.testing.assert_array_equal(k[0:3], m[0, 0:3])
        np.testing.assert_array_equal(k[3:6], m[16, 0:3])
        np.testing.assert_array_equal(k[6:9], m[20, 0:3])
        assert k[9] == b[0, 0] and k[10] == b[16, 0]

    def test_wrapper_contract(self, body):
        _, model, _, body_t, feat_t = body
        fw = model.fast_weights()
        before = (fused_tail3.conv_body_skip.launches, fused_tail.fused_tail.launches)
        skip = fused_tail3.conv_body_skip(body_t, feat_t, fw.cbody)
        fused_tail.fused_tail(skip[:, :8, :8].contiguous(), fw.tail, "rgb_u8")
        assert (fused_tail3.conv_body_skip.launches,
                fused_tail.fused_tail.launches) == before
        with pytest.raises(ValueError, match="out_mode"):
            fused_tail.fused_tail(skip, fw.tail, "rgb16")
        with pytest.raises(ValueError, match="feat"):
            fused_tail3.conv_body_skip(body_t, feat_t[:, 1:].contiguous(), fw.cbody)


class TestBuild:
    """ops/_build.py without a CUDA toolkit: a stand-in nvcc records its
    arguments and writes its output file, or fails for one source."""

    @pytest.fixture
    def fake_nvcc(self, tmp_path, monkeypatch):
        import subprocess

        from framewright_tpu_torch.ops import _build

        log = tmp_path / "calls.txt"
        nvcc = tmp_path / "nvcc.py"
        nvcc.write_text(
            "import os, sys\n"
            "args = sys.argv[1:]\n"
            "with open(os.environ['FAKE_NVCC_LOG'], 'a') as f:\n"
            "    f.write(' '.join(args) + '\\n')\n"
            "fail = os.environ.get('FAKE_NVCC_FAIL')\n"
            "if fail and any(a.endswith(fail) for a in args):\n"
            "    print('error: ' + fail)\n"
            "    sys.exit(2)\n"
            "open(args[args.index('-o') + 1], 'wb').write(b'lib')\n")
        real_popen = subprocess.Popen

        def popen(cmd, *args, **kwargs):     # run the stand-in with this Python
            if cmd and cmd[0] == str(nvcc):
                cmd = [sys.executable, *cmd]
            return real_popen(cmd, *args, **kwargs)

        monkeypatch.setattr(subprocess, "Popen", popen)
        monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
        monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
        monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_build")
        return _build, log

    def test_one_compile_per_source_then_one_link(self, fake_nvcc):
        _build, log = fake_nvcc
        info = _build.build(verbose=False)
        calls = log.read_text().splitlines()
        sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
        compiles = sorted(c.split(" -c ")[1].split()[0].rsplit("/", 1)[1]
                          for c in calls if " -c " in c)
        assert compiles == sources and "rdb_int8.cu" in sources
        links = [c for c in calls if c.startswith("-shared")]
        assert len(links) == 1 and links[0].count(".o") == len(sources)
        assert info.path.read_bytes() == b"lib"
        assert [p.name for p in info.path.parent.iterdir()] == [_build.LIB_NAME]
        assert _build.build(verbose=False).seconds == 0.0      # reused, no new call
        assert len(log.read_text().splitlines()) == len(calls)

    def test_a_failed_compile_raises_and_leaves_nothing(self, fake_nvcc, monkeypatch):
        _build, _ = fake_nvcc
        monkeypatch.setenv("FAKE_NVCC_FAIL", "rdb_int8.cu")
        with pytest.raises(RuntimeError, match="rdb_int8.cu"):
            _build.build(verbose=False)
        out_dir = _build.BUILD_ROOT / _build.source_hash()
        assert list(out_dir.iterdir()) == []
