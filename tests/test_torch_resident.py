"""The resident RRDB body of the PyTorch port (``FW_RDB_BODY=resident``):
halo blocks, their ring refresh and the RDB on blocks, against the JAX
package on the CPU.

Seeded numpy inputs go to both packages. The port's wrappers run their
plain versions here (CPU tensors); the JAX kernels run in interpret mode
at the block size tests/conftest.py pins (FW_RDB_S=64: 48-pixel interiors
with an 8-pixel halo). The port's blocks are NHWC (nb, S, S, C), the JAX
package's channel-major (nb, 64, S, S): they are compared after a
transpose, and must be equal.

Tolerances: geometry, refresh, the blocked RDBs on interiors and the
int8 bodies against the port's other bodies are exact (the same
per-pixel arithmetic on every path; int8 sums are exact integers). The
plain bf16 resident body is held to the plain merge body within one bf16
step of max(|v|, 2^-6), and uint8 planes within one level: both run
PyTorch's CPU f32 convolution, whose summation order may depend on the
input's shape (blocks or frame), CPU and thread count. On the card the
kernels' order does not, and the bodies are held equal there
(tests/test_torch_gpu.py, chip_smoke.py). Against
the JAX resident body: bf16 the merge body's (max 0.05, mean 5e-4,
tests/test_torch_kernels.py), f32acc the static int8 body's
(tests/test_torch_int8.py), dynamic the JAX package's dynamic-int8 bounds
against bf16 (tests/test_torch_dynamic.py), since the JAX kernel takes
its ranges per window and the port per frame.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framewright_tpu.models import rrdb as jrrdb
from framewright_tpu.ops import fused_rrdb as jfr
from framewright_tpu_torch.models import rrdb
from framewright_tpu_torch.models.registry import bf16_masters, from_jax_params, init_params
from framewright_tpu_torch.ops import fused_rrdb
from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(1, 70, 90), (2, 96, 96), (1, 54, 131)]
S, HALO = fused_rrdb.S, fused_rrdb.HALO
# tests/test_torch_int8.py (static int8 body) and test_torch_dynamic.py
BODY_MAX, BODY_MEAN, BODY_FRAC = 2.0 ** -5, 1e-4, 0.05
REL_MAX, REL_MEAN = 0.06, 0.008


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf16_host(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a).astype(jnp.bfloat16), params)


@pytest.fixture(scope="module")
def nets():
    """A 1-block scale-2 model with seeded weights and both packages'
    fast weights: bf16, static f32acc (seeded ranges) and dynamic int8."""
    params = init_params(rrdb.RRDBConfig(num_block=1, scale=2), seed=4)
    host = _bf16_host(params)
    model = rrdb.RRDBNet.from_state_dict(rrdb.RRDBConfig(num_block=1, scale=2),
                                         bf16_masters(from_jax_params(params, torch.float32)),
                                         torch.device("cpu"))
    amax = np.random.default_rng(6).uniform(0.5, 4.0, (1, 3, 5)).astype(np.float32)
    port = {"bf16": model.fast_weights(), "f32acc": model.fast_weights_int8(amax, "f32acc"),
            "dynamic": model.fast_weights_int8(None)}
    jax_fast = {"bf16": jrrdb.make_fast_params(host),
                "f32acc": jrrdb.make_fast_params(host, compute_dtype="int8", act_amax=amax,
                                                 int8_scheme="f32acc"),
                "dynamic": jrrdb.make_fast_params(host, compute_dtype="int8")}
    return {"model": model, "port": port, "jax": jax_fast}


def _feat(b, h, w, seed, scale=0.5):
    f = np.random.default_rng(seed).standard_normal((b, h, w, 64)).astype(np.float32) * scale
    t = torch.from_numpy(f).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _nhwc(blocks_j) -> np.ndarray:
    """JAX channel-major blocks (nb, 64, S, S) -> NHWC float32 numpy."""
    return np.asarray(blocks_j, np.float32).transpose(0, 2, 3, 1)


def _steps(got, want):
    """|got - want| in bf16 steps of max(|got|, |want|, 2^-6)."""
    got, want = got.float().numpy(), want.float().numpy()
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -6)
    return np.abs(got - want) / np.exp2(np.floor(np.log2(mag)) - 7)


def _owned_ring(b, h, w) -> torch.Tensor:
    """(nb, S, S) bool: ring pixels whose frame position lies in the grid
    of interiors (the pixels a refresh writes from a neighbour)."""
    nh, nw = fused_rrdb.grid_dims(h, w)
    bh = fused_rrdb.BH
    r = np.arange(S) - HALO
    out = np.zeros((b, nh, nw, S, S), bool)
    for i in range(nh):
        for j in range(nw):
            rows = (i * bh + r >= 0) & (i * bh + r < nh * bh)
            cols = (j * bh + r >= 0) & (j * bh + r < nw * bh)
            out[:, i, j] = rows[:, None] & cols[None, :]
    out[..., HALO:S - HALO, HALO:S - HALO] = False
    return torch.from_numpy(out.reshape(b * nh * nw, S, S))


class TestGeometry:
    @pytest.mark.parametrize("shape", SHAPES)
    def test_blocks_and_extents_equal_jax(self, shape):
        b, h, w = shape
        feat_t, feat_j = _feat(b, h, w, seed=h)
        nh, nw = fused_rrdb.grid_dims(h, w)
        assert (nh, nw) == jfr._grid_dims(h, w)
        np.testing.assert_array_equal(fused_rrdb.block_extents(h, w),
                                      jfr._block_extents(h, w, nh, nw))
        blocks_j = jfr.extract_blocks(feat_j.transpose(0, 3, 1, 2), h, w)
        blocks = fused_rrdb.extract_blocks(feat_t)
        assert blocks.shape == (b * nh * nw, S, S, 64) and blocks.dtype == torch.bfloat16
        np.testing.assert_array_equal(blocks.float().numpy(), _nhwc(blocks_j))
        # a 192-channel block workspace holds the same blocks in channels 0:64
        ws = fused_rrdb.extract_blocks(feat_t, fused_rrdb.WS_C)
        assert ws.shape[-1] == 192 and torch.equal(ws[..., :64], blocks)
        back = fused_rrdb.assemble_blocks(ws, b, h, w)
        want = np.asarray(jfr.assemble_blocks(blocks_j, b, h, w), np.float32)
        np.testing.assert_array_equal(back.float().numpy(), want.transpose(0, 2, 3, 1))
        assert torch.equal(back, feat_t)

    def test_bad_geometry_is_refused_at_import(self):
        code = "import framewright_tpu_torch.ops.fused_rrdb"
        for env in ({"FW_RDB_S": "64", "FW_RDB_HALO": "4"},
                    {"FW_RDB_S": "16", "FW_RDB_HALO": "8"}):
            res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                 env={**os.environ, **env}, timeout=120, cwd=ROOT)
            assert res.returncode != 0 and "ValueError" in res.stderr, res.stderr[-500:]


class TestHaloRefresh:
    @pytest.mark.parametrize("shape", SHAPES)
    def test_refresh_of_poisoned_rings_equals_jax(self, shape):
        """Every ring pixel that a neighbour's interior owns is poisoned;
        the refresh restores it, equal to JAX's halo_refresh_xla and
        halo_refresh, and to a re-extraction of the assembled frames."""
        b, h, w = shape
        nh, nw = fused_rrdb.grid_dims(h, w)
        feat_t, feat_j = _feat(b, h, w, seed=w)
        blocks_j = jfr.extract_blocks(feat_j.transpose(0, 3, 1, 2), h, w)
        owned = _owned_ring(b, h, w)
        poison = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (b * nh * nw, S, S, 64)).astype(np.float32) * 9).to(torch.bfloat16)
        blocks = fused_rrdb.extract_blocks(feat_t)
        blocks[owned] = poison[owned]
        poisoned_j = jnp.asarray(blocks.float().numpy().transpose(0, 3, 1, 2), jnp.bfloat16)
        before = fused_rrdb.halo_refresh.launches
        out = fused_rrdb.halo_refresh(blocks, b, nh, nw)
        assert out is blocks and fused_rrdb.halo_refresh.launches == before   # CPU: plain
        got = blocks.float().numpy()
        for ref in (jfr.halo_refresh_xla, jfr.halo_refresh):
            np.testing.assert_array_equal(got, _nhwc(ref(poisoned_j, b, nh, nw)))
        np.testing.assert_array_equal(got, _nhwc(blocks_j))
        assert torch.equal(blocks, fused_rrdb.extract_blocks(
            fused_rrdb.assemble_blocks(blocks, b, h, w)))

    def test_refresh_of_a_workspace_touches_channels_0_to_64_only(self):
        b, h, w = 1, 70, 90
        nh, nw = fused_rrdb.grid_dims(h, w)
        ws = fused_rrdb.extract_blocks(_feat(b, h, w, seed=3)[0], fused_rrdb.WS_C)
        ws[..., 64:] = 5.0
        want = fused_rrdb.extract_blocks(fused_rrdb.assemble_blocks(ws, b, h, w),
                                         fused_rrdb.WS_C)
        ring = torch.ones(S, S, dtype=torch.bool)
        ring[HALO:S - HALO, HALO:S - HALO] = False
        ws[:, ring, :64] = -3.0                  # every ring, also outside the grid
        fused_rrdb.halo_refresh_plain(ws, b, nh, nw)
        assert torch.equal(ws[..., :64], want[..., :64])
        assert bool((ws[..., 64:] == 5.0).all())

    def test_wrapper_contract(self):
        blocks = fused_rrdb.extract_blocks(_feat(1, 40, 40, seed=0)[0])
        with pytest.raises(ValueError, match="blocks must be"):
            fused_rrdb.halo_refresh(blocks, 1, 2, 1)
        with pytest.raises(ValueError, match="blocks must be"):
            fused_rrdb.halo_refresh(blocks.float(), 1, 1, 1)


class TestBlockedRDB:
    @pytest.mark.parametrize("kind", ["bf16", "f32acc", "dynamic"])
    def test_blocked_plain_rdb_equals_image_rdb_on_interiors(self, nets, kind):
        """One RDB (with the RRDB residual) on freshly extracted blocks with
        their extents, assembled, equals the image RDB exactly; the
        dynamic ranges per frame too."""
        b, h, w = 2, 54, 131
        wts = nets["port"][kind].body[0][2]
        feat_t, _ = _feat(b, h, w, seed=5)
        carry_t, _ = _feat(b, h, w, seed=6)
        ext = fused_rrdb.BlockExtents.of(b, h, w, "cpu")
        if kind == "bf16":
            ws, cw = fused_rrdb.new_workspace(feat_t), fused_rrdb.new_workspace(carry_t)
            fused_rrdb.fused_rdb(ws, cw, wts, carry=cw)
            bws = fused_rrdb.extract_blocks(feat_t, fused_rrdb.WS_C)
            bcw = fused_rrdb.extract_blocks(carry_t, fused_rrdb.WS_C)
            fused_rrdb.fused_rdb(bws, bcw, wts, carry=bcw, ext=ext)
            assert torch.equal(fused_rrdb.assemble_blocks(bcw, b, h, w), cw[..., :64])
            # x1..x4 are zero outside the frame
            outside = ~ext.valid()
            assert bool((bws[outside][:, 64:] == 0).all())
            return
        q = torch.empty(b, h, w, 192, dtype=torch.int8)
        dst = carry_t.clone()
        fused_rrdb.fused_rdb_int8_plain(feat_t, q, dst, wts, carry=dst)
        bx, bdst = fused_rrdb.extract_blocks(feat_t), fused_rrdb.extract_blocks(carry_t)
        bq = torch.empty(*bx.shape[:3], 192, dtype=torch.int8)
        fused_rrdb.fused_rdb_int8_plain(bx, bq, bdst, wts, carry=bdst, ext=ext)
        assert torch.equal(fused_rrdb.assemble_blocks(bdst, b, h, w), dst)
        if kind == "dynamic":
            amax = fused_rrdb.fused_rdb_dynamic_plain(feat_t, q, dst.clone(), wts)
            bamax = fused_rrdb.fused_rdb_dynamic_plain(bx, bq, bdst.clone(), wts, ext=ext)
            assert bamax.shape == (b, 5) and torch.equal(bamax, amax)
        assert bool((bq[~ext.valid()][:, 64:] == 0).all())

    def test_ext_contract(self, nets):
        feat_t, _ = _feat(1, 40, 40, seed=0)
        ws = fused_rrdb.extract_blocks(feat_t, fused_rrdb.WS_C)
        ext = fused_rrdb.BlockExtents.of(2, 40, 40, "cpu")          # two frames' rects
        with pytest.raises(ValueError, match="ext must be"):
            fused_rrdb.fused_rdb(ws, torch.empty_like(ws), nets["port"]["bf16"].body[0][0],
                                 ext=ext)
        img = fused_rrdb.new_workspace(feat_t)
        with pytest.raises(ValueError, match="ext must be"):        # not blocks
            fused_rrdb.fused_rdb(img, torch.empty_like(img), nets["port"]["bf16"].body[0][0],
                                 ext=fused_rrdb.BlockExtents.of(1, 40, 40, "cpu"))


    @pytest.mark.parametrize("with_carry", [False, True])
    def test_outside_the_valid_rectangle_the_output_is_x(self, nets, with_carry):
        """What the bf16 RDB leaves outside each block's valid rectangle,
        where its kernels run no product on a tile that lies wholly
        outside: x1..x4 zero, x itself in dst[..., :64] without carry, and
        bf16(bf16(bf16(0.2) x) + carry) with it. The blocks hold seeded
        values everywhere, rings and slack too, so x is not zero there."""
        b, h, w = 1, 54, 131
        ext = fused_rrdb.BlockExtents.of(b, h, w, "cpu")
        assert fused_rrdb.tile_count(ext, live=True) < fused_rrdb.tile_count(ext)
        g = np.random.default_rng(9)
        x, carry = (torch.from_numpy(g.standard_normal((ext.rects.shape[0], S, S, 64))
                                     .astype(np.float32)).to(torch.bfloat16) for _ in range(2))
        ws, dst = fused_rrdb.new_workspace(x), fused_rrdb.new_workspace(carry)
        fused_rrdb.fused_rdb_plain(ws, dst, nets["port"]["bf16"].body[0][2],
                                   carry=dst if with_carry else None, ext=ext)
        out = ~ext.valid()
        want = x
        if with_carry:
            want = ((fused_rrdb.BF16_0P2 * x.float()).to(torch.bfloat16).float()
                    + carry.float()).to(torch.bfloat16)
        assert torch.equal(dst[out][:, :64], want[out])
        assert bool((ws[out][:, 64:] == 0).all())

    @pytest.mark.parametrize("shape", SHAPES)
    def test_tile_count_matches_the_valid_pixels(self, shape):
        """tile_count: every 16x16 tile of every block, and the live ones,
        those holding a valid pixel."""
        ext = fused_rrdb.BlockExtents.of(*shape, "cpu")
        t = fused_rrdb.RDB_TILE
        n = -(-S // t)
        valid = torch.nn.functional.pad(ext.valid(), (0, n * t - S, 0, n * t - S))
        live = int(valid.view(-1, n, t, n, t).any(dim=4).any(dim=2).sum())
        assert fused_rrdb.tile_count(ext) == ext.rects.shape[0] * n * n
        assert fused_rrdb.tile_count(ext, live=True) == live


class TestResidentBody:
    @pytest.mark.parametrize("shape", [(1, 70, 90), (2, 54, 131)])
    @pytest.mark.parametrize("kind", ["bf16", "f32acc", "dynamic"])
    def test_equals_the_ports_other_bodies(self, nets, kind, shape):
        """bf16 is within one bf16 step of the merge body (the CPU
        convolution's order), f32acc and dynamic equal the round-trip body;
        every wrapper ran its plain version."""
        feat_t, _ = _feat(*shape, seed=shape[2])
        body = nets["port"][kind].body
        before = fused_rrdb.halo_refresh.launches
        got = fused_rrdb.rrdb_body_resident(feat_t, body)
        assert got.shape == (*shape, 64) and got.dtype == torch.bfloat16
        assert fused_rrdb.halo_refresh.launches == before
        want = (fused_rrdb.rrdb_body(feat_t, body)[..., :64] if kind == "bf16"
                else fused_rrdb.rrdb_body_roundtrip(feat_t, body))
        if kind == "bf16":
            assert _steps(got, want).max() <= 1
        else:
            assert torch.equal(got, want)
        assert torch.equal(fused_rrdb.rrdb_body_resident(feat_t, body, plain=True), got)

    @pytest.mark.parametrize("kind", ["bf16", "f32acc", "dynamic"])
    def test_matches_jax_rrdb_body_resident(self, nets, kind):
        """Against JAX ``rrdb_body_resident(interpret=True)`` over a 2x2
        grid of interpret-mode blocks, B=2."""
        feat_t, feat_j = _feat(2, 60, 70, seed=1)
        want = np.asarray(jfr.rrdb_body_resident(feat_j, nets["jax"][kind], interpret=True),
                          np.float32)
        got = fused_rrdb.rrdb_body_resident(feat_t, nets["port"][kind].body).float().numpy()
        d = np.abs(got - want)
        if kind == "bf16":
            assert d.max() < 0.05 and d.mean() < 5e-4, (d.max(), d.mean())
        elif kind == "f32acc":
            assert d.max() <= BODY_MAX and d.mean() < BODY_MEAN and (d > 0).mean() < BODY_FRAC, \
                (d.max(), d.mean(), (d > 0).mean())
        else:
            scale = np.abs(want).max() + 1e-3
            assert d.max() / scale < REL_MAX and d.mean() / scale < REL_MEAN, \
                (d.max() / scale, d.mean() / scale)

    def test_i32_weights_are_refused(self, nets):
        amax = np.ones((1, 3, 5), np.float32)
        i32 = nets["model"].fast_weights_int8(amax, "i32").body
        nets["model"].fast_weights_int8(None)             # restore the module's weights
        with pytest.raises(ValueError, match="i32"):
            fused_rrdb.rrdb_body_resident(_feat(1, 8, 8, seed=0)[0], i32)


class TestEntryPoints:
    def test_dynamic_resident_processor_equals_roundtrip(self, monkeypatch):
        """``SuperResolution`` with dynamic int8 under FW_RDB_BODY=resident
        (the entry point of the dynamic resident restore): the same planes
        as the round-trip body's."""
        frames = np.random.default_rng(2).integers(0, 256, (2, 24, 40, 3), dtype=np.uint8)
        planes = {}
        for body in ("roundtrip", "resident"):
            monkeypatch.setenv("FW_RDB_BODY", body)
            sr = SuperResolution(SRConfig(model_name="FW_fast6_x2", device="cpu",
                                          compute_dtype="int8", int8_scales="dynamic",
                                          output_color="yuv420"))
            sr.setup(24, 40)
            planes[body] = sr.materialize(sr.dispatch(frames))
            sr.teardown()
        assert [p.shape for p in planes["resident"]] == [(2, 48, 80), (2, 24, 40), (2, 24, 40)]
        for a, b in zip(planes["resident"], planes["roundtrip"]):
            np.testing.assert_array_equal(a, b)

    def test_cli_restore_resident_tail2(self, tmp_path, capsys, monkeypatch):
        """``FW_RDB_BODY=resident FW_TAIL=2 python -m framewright_tpu_torch.cli
        restore`` on the CPU: 3 frames at twice the size, within one level
        of the merge + tail2 restore's planes."""
        import json

        from framewright_tpu_torch import cli
        from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter

        g = np.random.default_rng(0)
        src = tmp_path / "clip.y4m"
        with Y4MWriter(src, 40, 24, fps=24) as wr:
            for _ in range(3):
                wr.write_frame(g.integers(0, 256, (24, 40, 3), dtype=np.uint8))
        monkeypatch.setenv("FW_TAIL", "2")
        outs = {}
        for body in ("merge", "resident"):
            monkeypatch.setenv("FW_RDB_BODY", body)
            out = tmp_path / f"{body}.y4m"
            assert cli.main(["restore", str(src), "-o", str(out), "--model", "FW_fast6_x2",
                             "--device", "cpu", "--project-dir", str(tmp_path / body)]) == 0
            assert json.loads(capsys.readouterr().out)["frames"] == 3
            with Y4MReader(out) as r:
                assert (r.width, r.height) == (80, 48)
                outs[body] = np.stack(list(r))
        assert outs["resident"].shape[0] == 3
        d = np.abs(outs["resident"].astype(np.int16) - outs["merge"].astype(np.int16))
        assert d.max() <= 1, d.max()
