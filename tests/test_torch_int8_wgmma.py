"""The int8 RDB kernels' chunk-major weights and the order of their sums,
on the CPU.

The int8 RDBs run on the s8 wgmma main loop (csrc/conv_wgmma.cuh,
csrc/rdb_int8.cuh): each 32-channel chunk of Q gives an exact int32
partial over the nine taps from the chunk-major copy ``wk`` of the
weights (``fused_rrdb.wgmma_weights_s8``); scheme i32 sums every chunk,
f32acc and dynamic flush each source's partial (x = chunks 0-1, x_k =
chunk k + 1) into an f32 sum in source order. The card is not here, so
these tests pin the layout and that order: ``wk`` against the OHWI
weights and the JAX package's quantized wide weights (exactly), and an
emulation of the kernels' sums that reads only ``wk`` against the plain
versions the card holds the kernels to (bit for bit, codes, outputs and
dynamic ranges, on a seeded 1x40x56 input).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from framewright_tpu.ops import fused_rrdb as jfr
from framewright_tpu_torch.models import rrdb
from framewright_tpu_torch.models.registry import bf16_masters, from_jax_params, init_params
from framewright_tpu_torch.ops import fused_rrdb

SCHEMES = ("i32", "f32acc", "dynamic")
WIDE_KEYS = ("Wx", "W1", "W2", "W3", "W4")


@pytest.fixture(scope="module")
def nets():
    """A 1-block scale-2 model's seeded params, the calibrated ranges, its
    first RDB's int8 weights of the three schemes (static ranges calibrated
    on a seeded sample), and a seeded 1x40x56 body input with a carry."""
    cfg = rrdb.RRDBConfig(num_block=1, scale=2)
    params = init_params(cfg, seed=2)
    model = rrdb.RRDBNet.from_state_dict(
        cfg, bf16_masters(from_jax_params(params, torch.float32)), torch.device("cpu"))
    sample = torch.from_numpy(np.random.default_rng(4).random((1, 48, 64, 3), dtype=np.float32))
    amax = rrdb.calibrate_act_scales(model, sample)
    weights = {s: model.fast_weights_int8(None if s == "dynamic" else amax, s).body[0][0]
               for s in SCHEMES}
    g = np.random.default_rng(6)
    x, carry = (torch.from_numpy(g.uniform(-1, 1, (1, 40, 56, 64)).astype(np.float32)).to(
        torch.bfloat16) for _ in range(2))
    return params, amax, weights, x, carry


@pytest.mark.parametrize("cin,cout", [(64, 32), (160, 32), (192, 64)])
def test_wgmma_weights_s8_layout(cin, cout):
    """Element (chunk c, tap, half k, row n, e) is OHWI w[n, tap // 3,
    tap % 3, 32 c + 16 k + e], each chunk contiguous."""
    w = torch.from_numpy(np.random.default_rng(cin + cout).integers(
        -127, 128, (cout, 3, 3, cin), dtype=np.int8))
    wk = fused_rrdb.wgmma_weights_s8(w)
    assert wk.shape == (cin // 32, 9, 2, cout, 16) and wk.dtype == torch.int8
    assert wk.is_contiguous()
    c, tap, k, n, e = (np.random.default_rng(1).integers(0, d, 200) for d in wk.shape)
    for i in range(200):
        assert wk[c[i], tap[i], k[i], n[i], e[i]] == w[n[i], tap[i] // 3, tap[i] % 3,
                                                       32 * c[i] + 16 * k[i] + e[i]]
    # the whole copy: every element once
    assert torch.equal(wk.permute(3, 1, 0, 2, 4).reshape(cout, 3, 3, cin), w)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_int8_weights_carry_the_kernel_copies(nets, scheme):
    wts = nets[2][scheme]
    assert wts.scheme == scheme and len(wts.wk) == 5
    for wk, w in zip(wts.wk, wts.w):
        assert torch.equal(wk, fused_rrdb.wgmma_weights_s8(w))
    # made from w when not given (weights built by hand)
    again = fused_rrdb.RDBWeightsInt8(wts.scheme, wts.w, wts.scale, wts.bias, wts.wscale,
                                      wts.act_q)
    assert all(torch.equal(a, b) for a, b in zip(again.wk, wts.wk))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_kernel_copies_hold_the_jax_codes(nets, scheme):
    """wk, read back into rows of sources, equals the JAX package's int8
    wide weights of the same RDB (same ranges for the static schemes)."""
    params, amax, weights, _, _ = nets
    wts = weights[scheme]
    blk = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(jnp.bfloat16),
                                 params)["body"]
    rdb1 = (blk[0] if isinstance(blk, list) else
            jax.tree_util.tree_map(lambda a: a[0], blk))["rdb1"]
    if scheme == "i32":
        want = jfr.rdb_wide_weights_int8_i32(rdb1, act_amax=amax[0, 0])
    else:
        want = jfr.rdb_wide_weights_int8(rdb1, act_amax=None if scheme == "dynamic"
                                         else amax[0, 0])
    ohwi = [wk.permute(3, 1, 0, 2, 4).reshape(wk.shape[3], 3, 3, -1).numpy() for wk in wts.wk]
    for src, key in enumerate(WIDE_KEYS):
        off, n = fused_rrdb._SOURCES[src]
        got = np.concatenate([ohwi[k][..., off:off + n].reshape(ohwi[k].shape[0], -1)
                              for k in range(src, 5)])
        np.testing.assert_array_equal(got, np.asarray(want[key]))


def _emulated_preact(q, k, wts, sa=None):
    """Conv k's f32 pre-activation (NCHW) as the int8 kernels form it,
    from the chunk-major copy wk[k] alone: per 32-channel chunk an exact
    integer partial over the nine taps; i32 sums every chunk, f32acc and
    dynamic flush each source's partial into the f32 sum in source order,
    with the plain version's float operations."""
    _emulated_preact.calls += 1
    wk = wts.wk[k]
    nchunk, cout = wk.shape[0], wk.shape[3]
    b, h, w, _ = q.shape
    qp = F.pad(q[..., :32 * nchunk].long(), (0, 0, 1, 1, 1, 1))
    parts = []
    for c in range(nchunk):
        wc = wk[c].permute(2, 0, 1, 3).reshape(cout, 9, 32).long()   # (n, tap, 16 k + e)
        acc = torch.zeros(b, h, w, cout, dtype=torch.long)
        for tap in range(9):
            u, v = divmod(tap, 3)
            acc += qp[:, u:u + h, v:v + w, 32 * c:32 * c + 32] @ wc[:, tap].t()
        parts.append(acc.permute(0, 3, 1, 2))
    sc, bias = wts.scale[k], wts.bias[k]
    if wts.scheme == "i32":
        return sum(parts).float() * sc.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    acc = None
    for src in range(k + 1):
        part = (parts[0] + parts[1] if src == 0 else parts[src + 1]).float()
        if acc is None:
            acc = torch.zeros_like(part)
        s = sc[:, src].view(1, -1) if sa is None else sc[:, src] * sa[:, src:src + 1]
        acc = acc + part * s.view(s.shape[0], -1, 1, 1)
    return acc + bias.view(1, -1, 1, 1)


_emulated_preact.calls = 0


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_chunk_sums_from_wk_equal_the_plain_version(nets, monkeypatch, scheme, with_carry):
    """The plain RDB with its convolutions replaced by the emulation of
    the kernels' chunk sums gives the same codes, outputs and dynamic
    ranges, bit for bit."""
    _, _, weights, x, carry = nets
    wts = weights[scheme]

    def run():
        q = torch.zeros(*x.shape[:3], 192, dtype=torch.int8)
        out = carry.clone()
        rdb = (fused_rrdb.fused_rdb_dynamic_plain if scheme == "dynamic"
               else fused_rrdb.fused_rdb_int8_plain)
        amax = rdb(x, q, out, wts, carry=out if with_carry else None)
        return q, out, amax

    want = run()
    monkeypatch.setattr(fused_rrdb, "_int8_preact", _emulated_preact)
    n = _emulated_preact.calls
    got = run()
    assert _emulated_preact.calls - n == 5
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if scheme == "dynamic":
        assert torch.equal(got[2], want[2])
