"""The port's CUDA kernels on the card, against their plain versions,
and the restore through them (RRDB and SRVGG, bf16 and int8).

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


@pytest.mark.parametrize("shape", [(1, 20, 28), (2, 37, 45)])
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


def test_conv_body_skip_kernel_matches_plain(model, cuda):
    feat = _feat(cuda, 2, 33, 50, seed=1)
    ws = fused_rrdb.new_workspace(_feat(cuda, 2, 33, 50, seed=2))
    n = fused_tail3.conv_body_skip.launches
    got = fused_tail3.conv_body_skip(ws, feat, model.fast_weights().cbody)
    assert fused_tail3.conv_body_skip.launches == n + 1
    _close_bf16(got, fused_tail3.conv_body_skip_plain(ws, feat, model.fast_weights().cbody))


@pytest.mark.parametrize("out_mode", ["bf16", "rgb_u8", "yuv420_u8"])
def test_tail_kernel_matches_plain(model, cuda, out_mode):
    x = _feat(cuda, 2, 19, 30, seed=3)
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


@pytest.mark.parametrize("shape,group", [((1, 540, 960), 0), ((2, 37, 53), 1)])
def test_chain_kernel_matches_plain(vgg, cuda, shape, group):
    from framewright_tpu_torch.ops import fused_srvgg

    wts = vgg[1].groups[group]
    x = _feat(cuda, *shape)
    out, out_p = torch.empty_like(x), torch.empty_like(x)
    n = fused_srvgg.fused_conv_chain.launches
    fused_srvgg.fused_conv_chain(x, out, wts)
    fused_srvgg.fused_conv_chain_plain(x, out_p, wts)
    torch.cuda.synchronize()
    assert fused_srvgg.fused_conv_chain.launches == n + 1
    _close_bf16(out, out_p)


@pytest.mark.parametrize("shape,group", [((1, 540, 960), 0), ((2, 37, 53), 1)])
def test_int8_chain_kernel_matches_plain(vgg, cuda, shape, group):
    """The same integer sums and f32 operations in the same order: every
    code and every bf16 output agree exactly."""
    from framewright_tpu_torch.ops import fused_srvgg

    wts = vgg[2].groups[group]
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
