"""The port's CUDA kernels on the card, against their plain versions,
and the restore through them (RRDB and SRVGG, bf16 and int8; RRDB int8
with dynamic scales through tail1; the resident body's halo refresh and
RDBs on blocks; the band conv of the FastTail).

Marked ``gpu``; each test asks for the ``cuda`` fixture, which skips
when no CUDA device is present (decided inside the fixture, never at
import). On the machine with the card, which has no JAX, run them
without the repository's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import json

import numpy as np
import pytest
import torch

from framewright_tpu_torch.models import rrdb
from framewright_tpu_torch.models.registry import from_jax_params, init_params
from framewright_tpu_torch.ops import fused_rrdb, fused_tail, fused_tail3

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False        # plain versions in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def model(cuda):
    cfg = rrdb.RRDBConfig(num_block=1, scale=2)
    sd = from_jax_params(init_params(cfg, seed=0), torch.float32)
    return rrdb.RRDBNet.from_state_dict(cfg, sd, cuda)


def _feat(cuda, b, h, w, seed=0):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.uniform(-1, 1, (b, h, w, 64)).astype(np.float32)).to(
        cuda).to(torch.bfloat16)


def _close_bf16(a, b):
    d = (a.float() - b.float()).abs()
    assert d.max().item() <= 2.0 ** -4 and d.mean().item() <= 1e-4, (d.max(), d.mean())


@pytest.mark.parametrize("shape", [(1, 20, 28), (2, 37, 45), (4, 540, 960)])
def test_rdb_kernel_matches_plain(model, cuda, shape):
    feat = _feat(cuda, *shape)
    wts = model.fast_weights().body[0]
    ws, ws_p = fused_rrdb.new_workspace(feat), fused_rrdb.new_workspace(feat)
    out, out_p = torch.empty_like(ws), torch.empty_like(ws)
    n = fused_rrdb.fused_rdb.launches
    fused_rrdb.fused_rdb(ws, out, wts[0])
    fused_rrdb.fused_rdb_plain(ws_p, out_p, wts[0])
    assert fused_rrdb.fused_rdb.launches == n + 1
    _close_bf16(ws[..., 64:], ws_p[..., 64:])
    _close_bf16(out[..., :64], out_p[..., :64])
    carry, carry_p = ws.clone(), ws.clone()
    fused_rrdb.fused_rdb(out, carry, wts[2], carry=carry)
    fused_rrdb.fused_rdb_plain(out.clone(), carry_p, wts[2], carry=carry_p)
    _close_bf16(carry[..., :64], carry_p[..., :64])


@pytest.mark.parametrize("shape", [(2, 33, 50), (1, 20, 28), (2, 37, 45), (4, 540, 960)])
def test_conv_body_skip_kernel_matches_plain(model, cuda, shape):
    feat = _feat(cuda, *shape, seed=1)
    ws = fused_rrdb.new_workspace(_feat(cuda, *shape, seed=2))
    n = fused_tail3.conv_body_skip.launches
    got = fused_tail3.conv_body_skip(ws, feat, model.fast_weights().cbody)
    assert fused_tail3.conv_body_skip.launches == n + 1
    _close_bf16(got, fused_tail3.conv_body_skip_plain(ws, feat, model.fast_weights().cbody))


@pytest.mark.parametrize("shape", [(2, 19, 30), (2, 21, 37)])
@pytest.mark.parametrize("out_mode", ["bf16", "rgb_u8", "yuv420_u8"])
def test_tail_kernel_matches_plain(model, cuda, out_mode, shape):
    # batches of 2; no side of x, a0, a or c a multiple of the 16-pixel tile
    # at (2, 21, 37) (84 x 148 out)
    x = _feat(cuda, *shape, seed=3)
    n = fused_tail.fused_tail.launches
    got = fused_tail.fused_tail(x, model.fast_weights().tail, out_mode, True)
    want = fused_tail.fused_tail_plain(x, model.fast_weights().tail, out_mode, True)
    assert fused_tail.fused_tail.launches == n + 1
    if out_mode == "bf16":
        _close_bf16(got, want)
        return
    for g, w in (zip(got, want) if out_mode == "yuv420_u8" else [(got, want)]):
        d = (g.float() - w.float()).abs()
        assert d.max().item() <= 1 and (d > 0).float().mean().item() < 0.02


@pytest.mark.parametrize("shape", [(2, 21, 37), (1, 68, 120)])
def test_k2_and_tail1_agree_bit_for_bit(model, cuda, shape):
    """tail1 on K2's own conv_up1 output (its first launch) equals K2's
    bf16 output exactly: the two run the same conv_up2, conv_hr and
    conv_last launches, and every sum has one order at any size."""
    from framewright_tpu_torch.ops import _build

    x = _feat(cuda, *shape, seed=5)
    wts = model.fast_weights().tail
    b, h, w, _ = x.shape
    a0 = torch.empty(b, 2 * h, 2 * w, 64, dtype=torch.bfloat16, device=cuda)
    _build.check(_build.library().fw_tail_up2(
        x.data_ptr(), b, h, w, wts.up1_k.data_ptr(), wts.up1_b.data_ptr(), a0.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "fw_tail_up2")
    a0_p = fused_tail._phase_conv_plain(x, wts.up1, wts.up1_b)
    torch.cuda.synchronize()
    _close_bf16(a0, a0_p)
    k2 = fused_tail.fused_tail(x, wts, "bf16")
    t1 = fused_tail.fused_tail1(a0, wts)
    torch.cuda.synchronize()
    assert torch.equal(k2, t1)


def test_wrappers_refuse_bad_inputs_on_the_card(model, cuda):
    feat = _feat(cuda, 1, 8, 8)
    ws = fused_rrdb.new_workspace(feat)
    with pytest.raises(ValueError):
        fused_rrdb.fused_rdb(ws, ws, model.fast_weights().body[0][0])
    with pytest.raises(ValueError):
        fused_tail.fused_tail(feat.float(), model.fast_weights().tail)


def test_cli_restore_on_the_card(cuda, tmp_path, capsys):
    from framewright_tpu_torch import cli
    from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter

    g = np.random.default_rng(0)
    src = tmp_path / "clip.y4m"
    with Y4MWriter(src, 64, 48, fps=24) as w:
        for _ in range(3):
            w.write_frame(g.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    n = fused_rrdb.fused_rdb.launches
    assert cli.main(["restore", str(src), "-o", str(tmp_path / "o.y4m"),
                     "--model", "FW_fast6_x2", "--project-dir", str(tmp_path)]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert fused_rrdb.fused_rdb.launches - n == 18 * summary["batches"]
    with Y4MReader(tmp_path / "o.y4m") as r:
        assert (r.width, r.height, r.count_frames()) == (128, 96, 3)


@pytest.fixture
def int8_weights(model, cuda):
    """Both schemes' int8 weights for the one-block model, calibrated on a
    seeded 64x64 sample."""
    sample = torch.from_numpy(np.random.default_rng(5).random((1, 64, 64, 3),
                                                             dtype=np.float32))
    amax = rrdb.calibrate_act_scales(model, sample)
    return {s: model.fast_weights_int8(amax, s).body[0] for s in fused_rrdb.INT8_SCHEMES}


@pytest.mark.parametrize("scheme", fused_rrdb.INT8_SCHEMES)
@pytest.mark.parametrize("shape", [(1, 540, 960), (2, 37, 53)])
def test_int8_rdb_kernel_matches_plain(int8_weights, cuda, scheme, shape):
    """Kernel and plain version do the same integer sums and the same f32
    operations in the same order: codes and outputs agree exactly."""
    wts = int8_weights[scheme]
    x = _feat(cuda, *shape)
    q = torch.zeros(*shape, 192, dtype=torch.int8, device=cuda)
    q_p = torch.zeros_like(q)
    out, out_p = torch.empty_like(x), torch.empty_like(x)
    counter = fused_rrdb.fused_rdb_i32 if scheme == "i32" else fused_rrdb.fused_rdb_f32acc
    n = counter.launches
    fused_rrdb.fused_rdb_int8(x, q, out, wts[0])
    fused_rrdb.fused_rdb_int8_plain(x, q_p, out_p, wts[0])
    torch.cuda.synchronize()
    assert counter.launches == n + 1
    assert torch.equal(q, q_p)
    assert torch.equal(out, out_p)
    carry = _feat(cuda, *shape, seed=7)
    c_k, c_p = carry.clone(), carry.clone()
    fused_rrdb.fused_rdb_int8(out, q, c_k, wts[2], carry=c_k)
    fused_rrdb.fused_rdb_int8_plain(out, q_p, c_p, wts[2], carry=c_p)
    torch.cuda.synchronize()
    assert torch.equal(q, q_p)
    assert torch.equal(c_k, c_p)


def test_cli_restore_int8_on_the_card(cuda, tmp_path, capsys):
    from framewright_tpu_torch import cli
    from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter

    g = np.random.default_rng(0)
    src = tmp_path / "clip.y4m"
    with Y4MWriter(src, 64, 48, fps=24) as w:
        for _ in range(3):
            w.write_frame(g.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    before = (rrdb.calibrate_act_scales.calls, fused_rrdb.fused_rdb_i32.launches,
              fused_rrdb.fused_rdb.launches)
    assert cli.main(["restore", str(src), "-o", str(tmp_path / "o.y4m"), "--dtype", "int8",
                     "--model", "FW_fast6_x2", "--project-dir", str(tmp_path)]) == 0
    summary = json.loads(capsys.readouterr().out)
    after = (rrdb.calibrate_act_scales.calls, fused_rrdb.fused_rdb_i32.launches,
             fused_rrdb.fused_rdb.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 18 * summary["batches"], 0]
    with Y4MReader(tmp_path / "o.y4m") as r:
        assert (r.width, r.height, r.count_frames()) == (128, 96, 3)


# --- dynamic-scale int8 RDB and tail1 ----------------------------------------

@pytest.mark.parametrize("shape", [(1, 540, 960), (2, 37, 53)])
def test_dynamic_rdb_kernel_matches_plain(model, cuda, shape):
    """The same integer sums and f32 operations in the same order, and the
    same per-frame maxima: codes within one step on < 0.01% (measured:
    equal), amax within 1e-6 relative, bf16 outputs within one step."""
    wts = model.fast_weights_int8(None).body[0]
    x = _feat(cuda, *shape)
    for k, carry in ((0, None), (2, _feat(cuda, *shape, seed=7))):
        q = torch.zeros(*shape, 192, dtype=torch.int8, device=cuda)
        q_p = torch.zeros_like(q)
        out = torch.empty_like(x) if carry is None else carry.clone()
        out_p = torch.empty_like(x) if carry is None else carry.clone()
        n = fused_rrdb.fused_rdb_dynamic.launches
        amax = fused_rrdb.fused_rdb_dynamic(x, q, out, wts[k],
                                            carry=None if carry is None else out)
        amax_p = fused_rrdb.fused_rdb_dynamic_plain(x, q_p, out_p, wts[k],
                                                    carry=None if carry is None else out_p)
        torch.cuda.synchronize()
        assert fused_rrdb.fused_rdb_dynamic.launches == n + 1
        d = (q.int() - q_p.int()).abs()
        assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-4
        assert torch.allclose(amax, amax_p, rtol=1e-6, atol=0)
        _close_bf16(out, out_p)


@pytest.mark.parametrize("shape", [(1, 540, 960), (2, 37, 53)])
def test_tail1_kernel_matches_plain(model, cuda, shape):
    x = _feat(cuda, *shape, seed=4)
    wts = model.fast_weights().tail
    n = fused_tail.fused_tail1.launches
    got = fused_tail.fused_tail1(x, wts)
    want = fused_tail.fused_tail1_plain(x, wts)
    torch.cuda.synchronize()
    assert fused_tail.fused_tail1.launches == n + 1
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], 3)
    _close_bf16(got, want)


def test_dynamic_restore_on_the_card(cuda):
    """The SR processor with int8_scales="dynamic": the dynamic RDB 18
    times and tail1 once per batch (FW_fast6_x2), no calibration, no K1,
    K2 or static int8 kernel; planes equal the kernel path."""
    from framewright_tpu_torch.processors.super_resolution import SRConfig, SuperResolution

    frames = np.random.default_rng(0).integers(0, 256, (3, 48, 64, 3), dtype=np.uint8)
    sr = SuperResolution(SRConfig(model_name="FW_fast6_x2", compute_dtype="int8",
                                  int8_scales="dynamic", output_color="yuv420"))
    sr.setup(48, 64)
    counters = (fused_rrdb.fused_rdb_dynamic, fused_tail.fused_tail1, fused_rrdb.fused_rdb,
                fused_rrdb.fused_rdb_i32, fused_rrdb.fused_rdb_f32acc, fused_tail.fused_tail,
                fused_tail3.conv_body_skip)
    before = [c.launches for c in counters] + [rrdb.calibrate_act_scales.calls]
    got = sr.materialize(sr.dispatch(frames))
    after = [c.launches for c in counters] + [rrdb.calibrate_act_scales.calls]
    batches = -(-len(frames) // sr.plan.batch)
    assert [a - b for a, b in zip(after, before)] == [18 * batches, batches, 0, 0, 0, 0, 0, 0]
    want = sr.model.apply_fast(torch.from_numpy(frames).to(cuda).to(torch.bfloat16) / 255.0,
                               "yuv420_u8", weights=sr.model.int8_weights)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.cpu().numpy())


# --- the resident body: halo refresh, RDBs on blocks; the band conv ----------

@pytest.mark.parametrize("channels", [64, 192])
def test_halo_refresh_kernel_matches_plain(cuda, channels):
    """Poisoned rings (every ring pixel, also outside the grid) come back
    equal to the plain version and to a re-extraction, exactly."""
    b, h, w = 2, 150, 230
    nh, nw = fused_rrdb.grid_dims(h, w)
    blocks = fused_rrdb.extract_blocks(_feat(cuda, b, h, w, seed=3), channels)
    blocks[..., 64:] = 1.0
    want = blocks.clone()
    s, halo = fused_rrdb.S, fused_rrdb.HALO
    ring = torch.ones(s, s, dtype=torch.bool, device=cuda)
    ring[halo:s - halo, halo:s - halo] = False
    blocks[:, ring, :64] = 9.0
    plain = fused_rrdb.halo_refresh_plain(blocks.clone(), b, nh, nw)
    n = fused_rrdb.halo_refresh.launches
    fused_rrdb.halo_refresh(blocks, b, nh, nw)
    torch.cuda.synchronize()
    assert fused_rrdb.halo_refresh.launches == n + 1
    assert torch.equal(blocks, plain) and torch.equal(blocks, want)


@pytest.mark.parametrize("kind", ["bf16", "f32acc", "dynamic"])
def test_blocked_rdb_kernels_match_plain(model, int8_weights, cuda, kind):
    """The RDB kernels on halo blocks with their extents, with the RRDB
    residual: bf16 within one step of the plain version, int8 codes and
    outputs (and the dynamic ranges per frame) equal."""
    b, h, w = 2, 150, 230
    ext = fused_rrdb.BlockExtents.of(b, h, w, cuda)
    x = fused_rrdb.extract_blocks(_feat(cuda, b, h, w, seed=5))
    carry = fused_rrdb.extract_blocks(_feat(cuda, b, h, w, seed=6))
    if kind == "bf16":
        wts = model.fast_weights().body[0][2]
        ws, ws_p = fused_rrdb.new_workspace(x), fused_rrdb.new_workspace(x)
        c_k, c_p = fused_rrdb.new_workspace(carry), fused_rrdb.new_workspace(carry)
        n = fused_rrdb.fused_rdb.launches
        fused_rrdb.fused_rdb(ws, c_k, wts, carry=c_k, ext=ext)
        fused_rrdb.fused_rdb_plain(ws_p, c_p, wts, carry=c_p, ext=ext)
        torch.cuda.synchronize()
        assert fused_rrdb.fused_rdb.launches == n + 1
        _close_bf16(ws[..., 64:], ws_p[..., 64:])
        _close_bf16(c_k[..., :64], c_p[..., :64])
        return
    wts = (int8_weights["f32acc"] if kind == "f32acc"
           else model.fast_weights_int8(None).body[0])[2]
    q = torch.zeros(*x.shape[:3], 192, dtype=torch.int8, device=cuda)
    q_p = torch.zeros_like(q)
    c_k, c_p = carry.clone(), carry.clone()
    if kind == "dynamic":
        amax = fused_rrdb.fused_rdb_dynamic(x, q, c_k, wts, carry=c_k, ext=ext)
        amax_p = fused_rrdb.fused_rdb_dynamic_plain(x, q_p, c_p, wts, carry=c_p, ext=ext)
        assert amax.shape == (b, 5) and torch.equal(amax, amax_p)
    else:
        fused_rrdb.fused_rdb_int8(x, q, c_k, wts, carry=c_k, ext=ext)
        fused_rrdb.fused_rdb_int8_plain(x, q_p, c_p, wts, carry=c_p, ext=ext)
    torch.cuda.synchronize()
    assert torch.equal(q, q_p) and torch.equal(c_k, c_p)


@pytest.mark.parametrize("with_carry", [False, True])
def test_blocked_rdb_skips_dead_tiles(model, cuda, with_carry):
    """The bf16 RDB on blocks whose grid has tiles wholly outside the valid
    rectangles (no product runs there): within one step of the plain
    version, and exactly x (or x with the RRDB residual) outside the
    rectangles, with x1..x4 zero. The blocks hold seeded values
    everywhere, rings and slack too."""
    b, h, w = 2, 150, 230
    ext = fused_rrdb.BlockExtents.of(b, h, w, cuda)
    assert fused_rrdb.tile_count(ext, live=True) < fused_rrdb.tile_count(ext)
    s = fused_rrdb.S
    x = _feat(cuda, ext.rects.shape[0], s, s, seed=11)
    carry = _feat(cuda, ext.rects.shape[0], s, s, seed=12)
    wts = model.fast_weights().body[0][2]
    ws, ws_p = fused_rrdb.new_workspace(x), fused_rrdb.new_workspace(x)
    c_k, c_p = fused_rrdb.new_workspace(carry), fused_rrdb.new_workspace(carry)
    fused_rrdb.fused_rdb(ws, c_k, wts, carry=c_k if with_carry else None, ext=ext)
    fused_rrdb.fused_rdb_plain(ws_p, c_p, wts, carry=c_p if with_carry else None, ext=ext)
    torch.cuda.synchronize()
    _close_bf16(ws[..., 64:], ws_p[..., 64:])
    _close_bf16(c_k[..., :64], c_p[..., :64])
    out = ~ext.valid()
    assert torch.equal(c_k[out][:, :64], c_p[out][:, :64])
    assert bool((ws[out][:, 64:] == 0).all())


def _int8_wts(model, int8_weights, kind, k):
    return (model.fast_weights_int8(None).body[0] if kind == "dynamic"
            else int8_weights[kind])[k]


def _int8_rdb_both(x, wts, dst, with_carry, ext=None):
    """One int8 RDB through the kernels and through the plain version, into
    copies of ``dst`` (the RRDB residual's carry too, ``with_carry``), on
    workspaces of seeded codes: (codes, out, ranges) of each, the ranges
    None for the static schemes."""
    q = torch.from_numpy(np.random.default_rng(25).integers(
        -127, 128, (*x.shape[:3], 192), dtype=np.int8)).to(x.device)
    q_p = q.clone()
    out, out_p = dst.clone(), dst.clone()
    c_k, c_p = (out, out_p) if with_carry else (None, None)
    if wts.scheme == "dynamic":
        a_k = fused_rrdb.fused_rdb_dynamic(x, q, out, wts, carry=c_k, ext=ext)
        a_p = fused_rrdb.fused_rdb_dynamic_plain(x, q_p, out_p, wts, carry=c_p, ext=ext)
    else:
        fused_rrdb.fused_rdb_int8(x, q, out, wts, carry=c_k, ext=ext)
        fused_rrdb.fused_rdb_int8_plain(x, q_p, out_p, wts, carry=c_p, ext=ext)
        a_k = a_p = None
    torch.cuda.synchronize()
    return (q, out, a_k), (q_p, out_p, a_p)


@pytest.mark.parametrize("kind", ["i32", "f32acc", "dynamic"])
@pytest.mark.parametrize("shape", [(2, 37, 53), (3, 33, 47), (1, 17, 100)])
def test_int8_wgmma_rdb_equals_plain_on_ragged_tiles(model, int8_weights, cuda, kind, shape):
    """The int8 RDBs on the s8 wgmma loop at sizes that cut partial tiles
    (H, W not multiples of 16), several images, and tile pairs whose
    second tile is missing (27 and 7 tiles): codes, outputs and the
    dynamic ranges equal the plain version exactly, with and without the
    RRDB residual."""
    x = _feat(cuda, *shape, seed=21)
    for k, with_carry in ((0, False), (2, True)):
        (q, out, a_k), (q_p, out_p, a_p) = _int8_rdb_both(
            x, _int8_wts(model, int8_weights, kind, k), _feat(cuda, *shape, seed=22),
            with_carry)
        assert torch.equal(q, q_p) and torch.equal(out, out_p), (kind, shape, k)
        if kind == "dynamic":
            assert torch.equal(a_k, a_p)


@pytest.mark.parametrize("kind", ["i32", "f32acc", "dynamic"])
def test_int8_wgmma_rdb_on_blocks_with_dead_tiles(model, int8_weights, cuda, kind):
    """The int8 RDBs on halo blocks of two frames whose grid has tiles
    wholly outside the valid rectangles (no product runs there), the
    blocks holding seeded values everywhere, with the RRDB residual:
    codes, outputs and the dynamic ranges equal the plain version
    exactly."""
    b, h, w = 2, 150, 230
    ext = fused_rrdb.BlockExtents.of(b, h, w, cuda)
    assert fused_rrdb.tile_count(ext, live=True) < fused_rrdb.tile_count(ext)
    s = fused_rrdb.S
    x = _feat(cuda, ext.rects.shape[0], s, s, seed=23)
    carry = _feat(cuda, ext.rects.shape[0], s, s, seed=24)
    (q, out, a_k), (q_p, out_p, a_p) = _int8_rdb_both(
        x, _int8_wts(model, int8_weights, kind, 2), carry, True, ext)
    assert torch.equal(q, q_p) and torch.equal(out, out_p)
    if kind == "dynamic":
        assert a_k.shape == (b, 5) and torch.equal(a_k, a_p)


@pytest.mark.parametrize("with_carry", [False, True])
def test_image_and_block_rdb_agree_bit_for_bit(model, cuda, with_carry):
    """One bf16 RDB on a batch of frames and on their halo blocks: equal
    on every valid interior pixel, x1..x4 and the output (each value's
    f32 sum runs in one order of taps and channels on both paths)."""
    b, h, w = 2, 150, 230
    s, halo, bh = fused_rrdb.S, fused_rrdb.HALO, fused_rrdb.BH
    nh, nw = fused_rrdb.grid_dims(h, w)
    feat, carry = _feat(cuda, b, h, w, seed=13), _feat(cuda, b, h, w, seed=14)
    wts = model.fast_weights().body[0][2]
    ws, cw = fused_rrdb.new_workspace(feat), fused_rrdb.new_workspace(carry)
    fused_rrdb.fused_rdb(ws, cw, wts, carry=cw if with_carry else None)
    ext = fused_rrdb.BlockExtents.of(b, h, w, cuda)
    bws = fused_rrdb.extract_blocks(feat, fused_rrdb.WS_C)
    bcw = fused_rrdb.extract_blocks(carry, fused_rrdb.WS_C)
    fused_rrdb.fused_rdb(bws, bcw, wts, carry=bcw if with_carry else None, ext=ext)
    torch.cuda.synchronize()
    assert torch.equal(fused_rrdb.assemble_blocks(bcw, b, h, w), cw[..., :64])
    dense = bws.view(b, nh, nw, s, s, -1)[:, :, :, halo:s - halo, halo:s - halo, 64:]
    dense = dense.permute(0, 1, 3, 2, 4, 5).reshape(b, nh * bh, nw * bh, -1)[:, :h, :w]
    assert torch.equal(dense, ws[..., 64:])


@pytest.mark.parametrize("kind", ["bf16", "f32acc", "dynamic"])
def test_resident_body_equals_merge_or_roundtrip_body(model, int8_weights, cuda, kind):
    """The kernels' arithmetic per pixel does not depend on the tile, so
    the resident body equals the merge body (bf16) or the round-trip body
    (f32acc, dynamic) exactly; 3 refreshes per RRDB."""
    feat = _feat(cuda, 2, 150, 230, seed=8)
    body = {"bf16": model.fast_weights().body,
            "f32acc": [int8_weights["f32acc"]],
            "dynamic": model.fast_weights_int8(None).body}[kind]
    n = fused_rrdb.halo_refresh.launches
    got = fused_rrdb.rrdb_body_resident(feat, body)
    torch.cuda.synchronize()
    assert fused_rrdb.halo_refresh.launches == n + 3
    want = (fused_rrdb.rrdb_body(feat, body)[..., :64] if kind == "bf16"
            else fused_rrdb.rrdb_body_roundtrip(feat, body))
    assert torch.equal(got, want)


def _bf16_steps(got, want):
    """|got - want| in bf16 steps of max(|got|, |want|, 2^-6) (the rule of
    tests/test_torch_fast_tail.py)."""
    g, w = got.float(), want.float()
    mag = g.abs().maximum(w.abs()).clamp_min(2.0 ** -6)
    return (g - w).abs() / (mag.log2().floor() - 7).exp2()


@pytest.mark.parametrize("cout,act", [(64, True), (64, False), (3, False)])
@pytest.mark.parametrize("shape", [(1, 540, 960), (2, 37, 53), (1, 19, 70)])
def test_band_conv_kernel_matches_plain(model, cuda, cout, act, shape):
    """Batch 2 and sides that are not multiples of the 16-pixel tile; the
    sums run in another order than cuDNN's, so at most one bf16 step apart,
    on < 0.1% of the values."""
    from framewright_tpu_torch.ops import pallas_conv

    conv = model.conv_hr if cout == 64 else model.conv_last
    wts = pallas_conv.conv_wide_weights(conv)
    x = _feat(cuda, *shape, seed=9)
    n = pallas_conv.band_conv3x3.launches
    got = pallas_conv.band_conv3x3(x, wts, act=act)
    want = pallas_conv.band_conv3x3_plain(x, wts, act=act)
    torch.cuda.synchronize()
    assert pallas_conv.band_conv3x3.launches == n + 1
    assert got.shape == (*shape, 64 if cout == 64 else 8)
    _close_bf16(got, want)
    st = _bf16_steps(got, want)
    assert st.max().item() <= 1 and (st > 0).float().mean().item() < 1e-3


@pytest.mark.parametrize("shape", [(1, 540, 960), (2, 37, 53), (1, 19, 70)])
def test_band_conv_equals_k2_conv_hr(model, cuda, shape):
    """The 64-channel lrelu band conv is K2's conv_hr launch (fw_tail_hr),
    the same kernel instance, on the same input and weights (wk = hr_k):
    bit-equal."""
    from framewright_tpu_torch.ops import _build, pallas_conv

    wts = pallas_conv.conv_wide_weights(model.conv_hr)
    tail = model.fast_weights().tail
    assert torch.equal(wts.wk, tail.hr_k) and torch.equal(wts.b, tail.hr_b)
    x = _feat(cuda, *shape, seed=10)
    b, h, w, _ = x.shape
    want = torch.empty_like(x)
    _build.check(_build.library().fw_tail_hr(
        x.data_ptr(), b, h, w, tail.hr_k.data_ptr(), tail.hr_b.data_ptr(), want.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "fw_tail_hr")
    got = pallas_conv.band_conv3x3(x, wts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_band_conv_launcher_refuses_other_shapes(cuda):
    """fw_band_conv returns an error code for Cin not a multiple of 16 or
    Cout' other than 64 or 8, and _build.check raises on it."""
    from framewright_tpu_torch.ops import _build

    x = torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(9 * 64 * 64, dtype=torch.bfloat16, device=cuda)
    bias = torch.zeros(64, device=cuda)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    for cin, cout in ((24, 64), (64, 16)):
        err = _build.library().fw_band_conv(x.data_ptr(), 1, 8, 8, cin, w.data_ptr(),
                                            bias.data_ptr(), cout, 1, out.data_ptr(), stream)
        assert err != 0
        with pytest.raises(RuntimeError, match="fw_band_conv"):
            _build.check(err, "fw_band_conv")


def test_fast_tail_and_tail2_on_the_card(model, cuda):
    """FastTail (5 band-conv launches) and tail2 (one K2 call) against
    their plain versions."""
    from framewright_tpu_torch.ops import pallas_conv

    feat, body = _feat(cuda, 1, 40, 56, seed=1), _feat(cuda, 1, 40, 56, seed=2)
    n = pallas_conv.band_conv3x3.launches
    got = pallas_conv.FastTail(model)(feat, body)
    assert pallas_conv.band_conv3x3.launches == n + 5
    want = pallas_conv.FastTail(model, plain=True)(feat, body)
    d = (got.float() - want.float()).abs()
    assert got.shape == (1, 160, 224, 3) and d.max().item() < 0.05 and d.mean().item() < 0.005
    fw = model.fast_weights()
    n = fused_tail.fused_tail.launches
    got = model.tail2(feat, body, fw.tail)
    assert fused_tail.fused_tail.launches == n + 1
    _close_bf16(got, model.tail2(feat, body, fw.tail, plain=True))


# --- the SRVGG conv chain ----------------------------------------------------

@pytest.fixture
def vgg(cuda):
    """A 10-conv SRVGG model (groups of 8 and 2) with seeded weights and
    both chains' weights, int8 calibrated on a seeded 64x64 sample."""
    from framewright_tpu_torch.models import srvgg
    from framewright_tpu_torch.models.registry import bf16_masters

    cfg = srvgg.SRVGGConfig(num_conv=10, scale=4)
    sd = bf16_masters(from_jax_params(init_params(cfg, seed=2), torch.float32))
    m = srvgg.SRVGGNet.from_state_dict(cfg, sd, cuda)
    sample = torch.from_numpy(np.random.default_rng(5).random((1, 64, 64, 3),
                                                             dtype=np.float32))
    return m, m.fast_weights(), m.fast_weights_int8(srvgg.calibrate_act_scales(m, sample))


# (shape, group, g): the main shape with a whole group of 8, the ragged
# batch-2 shape with the trailing group of 2, and one conv (for int8 the
# group's last conv alone) at a width that is not a multiple of 16
CHAIN_CASES = [((1, 540, 960), 0, 8), ((2, 37, 53), 1, 2), ((1, 19, 70), 0, 1)]


@pytest.mark.parametrize("shape,group,g", CHAIN_CASES)
def test_chain_kernel_matches_plain(vgg, cuda, shape, group, g):
    from framewright_tpu_torch.ops import fused_srvgg

    wts = vgg[1].groups[group].head(g)
    assert len(wts.alpha) == g
    x = _feat(cuda, *shape)
    out, out_p = torch.empty_like(x), torch.empty_like(x)
    n = fused_srvgg.fused_conv_chain.launches
    fused_srvgg.fused_conv_chain(x, out, wts)
    fused_srvgg.fused_conv_chain_plain(x, out_p, wts)
    torch.cuda.synchronize()
    assert fused_srvgg.fused_conv_chain.launches == n + 1
    _close_bf16(out, out_p)


@pytest.mark.parametrize("shape,group,g", CHAIN_CASES)
def test_int8_chain_kernel_matches_plain(vgg, cuda, shape, group, g):
    """The same integer sums and f32 operations in the same order: every
    code and every bf16 output agree exactly."""
    from framewright_tpu_torch.ops import fused_srvgg

    wts = vgg[2].groups[group].head(g)
    assert len(wts.alpha) == g
    x = _feat(cuda, *shape)
    out, out_p = torch.empty_like(x), torch.empty_like(x)
    codes, codes_p = [], []
    n = fused_srvgg.fused_conv_chain_int8.launches
    fused_srvgg.fused_conv_chain_int8(x, out, wts, codes)
    fused_srvgg.fused_conv_chain_int8_plain(x, out_p, wts, codes_p)
    torch.cuda.synchronize()
    assert fused_srvgg.fused_conv_chain_int8.launches == n + 1
    assert len(codes) == len(codes_p) == len(wts.alpha)
    for c, c_p in zip(codes, codes_p):
        assert torch.equal(c, c_p)
    assert torch.equal(out, out_p)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_cli_restore_srvgg_on_the_card(cuda, tmp_path, capsys, dtype):
    from framewright_tpu_torch import cli
    from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter
    from framewright_tpu_torch.models import srvgg
    from framewright_tpu_torch.ops import fused_srvgg

    g = np.random.default_rng(0)
    src = tmp_path / "clip.y4m"
    with Y4MWriter(src, 64, 48, fps=24) as w:
        for _ in range(3):
            w.write_frame(g.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    counters = (fused_srvgg.fused_conv_chain, fused_srvgg.fused_conv_chain_int8,
                fused_rrdb.fused_rdb, fused_rrdb.fused_rdb_i32)
    before = [c.launches for c in counters] + [srvgg.calibrate_act_scales.calls]
    assert cli.main(["restore", str(src), "-o", str(tmp_path / "o.y4m"), "--dtype", dtype,
                     "--model", "realesr-animevideov3", "--project-dir", str(tmp_path)]) == 0
    summary = json.loads(capsys.readouterr().out)
    after = [c.launches for c in counters] + [srvgg.calibrate_act_scales.calls]
    groups = 2 * summary["batches"]     # 16 convs: two groups of 8
    want = [groups, 0, 0, 0, 0] if dtype == "bfloat16" else [0, groups, 0, 0, 1]
    assert [a - b for a, b in zip(after, before)] == want
    with Y4MReader(tmp_path / "o.y4m") as r:
        assert (r.width, r.height, r.count_frames()) == (256, 192, 3)
