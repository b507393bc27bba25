"""The SRVGG chain kernels' weight copies and the int8 kernel's order of
sums, on the CPU.

Both chain kernels run on wgmma (csrc/srvgg.cu): the bf16 conv reads
``ChainGroup.wk``, the chunk-major copy ``fused_rrdb.wgmma_weights`` of
each conv; the int8 conv reads ``ChainGroupInt8.wk``, the pass-major copy
``fused_rrdb.wgmma_weights_s8_runs`` with runs of ``TPC_I8`` taps, and
makes one pass per run: an exact int32 partial over the run's taps and
all 64 input channels (two 32-channel chunks), folded into f32 sums in
pass order. The card is not here, so these tests pin the copies (against
the plain layouts, exactly), the passes (against the JAX package's tap
chunks, ``TAPS`` and ``TPC_I8`` of framewright_tpu/ops/fused_srvgg.py),
and an emulation of the kernel's sums that reads only the pass-major copy
against the plain version the card holds the kernel to (f32 sums, codes
and output bit for bit, on seeded inputs). The kernel itself is held to the plain
version on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from framewright_tpu.ops import fused_srvgg as jf
from framewright_tpu_torch.models import srvgg
from framewright_tpu_torch.models.registry import (
    MODEL_SPECS,
    bf16_masters,
    from_jax_params,
    init_params,
    packaged_weights_dir,
    read_npz,
)
from framewright_tpu_torch.ops import fused_rrdb, fused_srvgg

CPU = torch.device("cpu")
NF = fused_srvgg.NF
RUN = fused_srvgg.TPC_I8


def _model(name):
    if name == "seeded":      # 10 convs: groups of 8 and 2
        cfg = srvgg.SRVGGConfig(num_conv=10, scale=4)
        params = init_params(cfg, seed=2)
    else:
        cfg = MODEL_SPECS[name].arch_config
        params = read_npz(packaged_weights_dir() / f"{name}.npz")
    return srvgg.SRVGGNet.from_state_dict(
        cfg, bf16_masters(from_jax_params(params, torch.float32)), CPU)


@pytest.fixture(scope="module", params=["seeded", "FW_fastvgg_x2"])
def model(request):
    return _model(request.param)


def _amax(m):
    sample = torch.from_numpy(np.random.default_rng(5).random((1, 24, 28, 3), dtype=np.float32))
    return srvgg.calibrate_act_scales(m, sample)


def test_bf16_copy_is_wgmma_weights(model):
    for group in model.fast_weights().groups:
        g = len(group.alpha)
        assert group.wk.shape == (g, NF // 16, 9, 2, NF, 8) and group.wk.is_contiguous()
        for i in range(g):
            assert torch.equal(group.wk[i], fused_rrdb.wgmma_weights(group.w[i].view(NF, 3, 3, NF)))


def test_int8_copy_is_the_runs_copy(model):
    for group in model.fast_weights_int8(_amax(model)).groups:
        g = len(group.alpha)
        assert group.wk.shape == (g, 3, NF // 32, RUN, 2, NF, 16)
        assert group.wk.dtype == torch.int8 and group.wk.is_contiguous()
        for i in range(g):
            want = fused_rrdb.wgmma_weights_s8_runs(group.wq[i].view(NF, 3, 3, NF), RUN)
            assert torch.equal(group.wk[i], want)


@pytest.mark.parametrize("p", [0, 1, 2])
def test_runs_copy_layout(p):
    """Element (pass p, chunk c, slot s, half k, row n, e) is OHWI
    w[n, t // 3, t % 3, 32 c + 16 k + e] for tap t = RUN p + s < 9, and 0
    in the last run's unused slots; each (pass, chunk) is contiguous."""
    w = torch.from_numpy(np.random.default_rng(p).integers(
        -127, 128, (NF, 3, 3, NF), dtype=np.int8))
    wk = fused_rrdb.wgmma_weights_s8_runs(w, RUN)
    assert wk.shape == (3, NF // 32, RUN, 2, NF, 16) and wk.is_contiguous()
    g = np.random.default_rng(10 + p)
    for _ in range(300):
        c, s, k, n, e = (int(g.integers(0, d)) for d in wk.shape[1:])
        t = RUN * p + s
        want = w[n, t // 3, t % 3, 32 * c + 16 * k + e] if t < 9 else 0
        assert wk[p, c, s, k, n, e] == want
    for s in range(RUN):
        if RUN * p + s >= 9:
            assert not wk[p, :, s].any()


def test_passes_are_the_jax_tap_chunks():
    """The taps each pass of the copy holds, in slot order, are the JAX
    int8 chain kernel's chunks of TPC_I8 row-major taps."""
    # tap t of every weight row holds the code t + 1
    w = torch.arange(1, 10, dtype=torch.int8).view(1, 3, 3, 1).expand(NF, 3, 3, NF).contiguous()
    wk = fused_rrdb.wgmma_weights_s8_runs(w, RUN)
    got = [[int(wk[p, 0, s, 0, 0, 0]) - 1 for s in range(RUN) if wk[p, 0, s].any()]
           for p in range(wk.shape[0])]
    want = [[di * 3 + dj for di, dj in jf.TAPS[t:t + jf.TPC_I8]]
            for t in range(0, len(jf.TAPS), jf.TPC_I8)]
    assert RUN == jf.TPC_I8 and got == want
    assert [list(range(t0, t1)) for t0, t1 in fused_srvgg._TAP_CHUNKS] == want


def _emulated_chain(x, group):
    """The int8 chain kernel's arithmetic from the pass-major copy alone:
    the group input's codes; per conv and pass, an exact integer partial
    over the pass's taps and both 32-channel chunks, f = f32(p) dq at the
    first pass and f = f + f32(p) dq after (float32, one rounding each),
    then prelu(f + b) to the next codes or, at the last conv, to bf16.
    -> (codes of each conv's input, each conv's f32 sums f, output)."""
    g = len(group.alpha)
    inv = [float(v) for v in group.aq[g + 1:]]
    b, h, w, _ = x.shape
    q = torch.round(x.float() * inv[0]).clamp(-127, 127).to(torch.int8)
    codes, sums = [], []
    for i in range(g):
        codes.append(q)
        qp = F.pad(q.long(), (0, 0, 1, 1, 1, 1))
        f = None
        for p in range(group.wk.shape[1]):
            part = torch.zeros(b, h, w, NF, dtype=torch.long)
            for c in range(group.wk.shape[2]):
                for s in range(RUN):
                    t = RUN * p + s
                    if t >= 9:
                        continue
                    wt = group.wk[i, p, c, s].permute(1, 0, 2).reshape(NF, 32).long()   # (n, 32)
                    win = qp[:, t // 3:t // 3 + h, t % 3:t % 3 + w, 32 * c:32 * c + 32]
                    part += torch.einsum("bhwk,nk->bhwn", win, wt)
            v = part.float() * group.dq[i]
            f = v if f is None else f + v
        sums.append(f)
        v = f + group.b[i].view(NF)
        v = torch.where(v >= 0, v, v * group.alpha[i].view(NF))
        if i == g - 1:
            return codes, sums, v.to(torch.bfloat16)
        q = torch.round(v * inv[i + 1]).clamp(-127, 127).to(torch.int8)


@pytest.mark.parametrize("shape,g", [((1, 14, 22), 8), ((2, 9, 13), 2), ((1, 7, 19), 1)])
def test_pass_order_emulation_equals_plain(shape, g):
    """The emulated kernel's f32 sums equal the plain version's (its
    float32 operations over JAX's tap chunks, in chunk order) bit for bit,
    and so do every code and the bf16 output: summing per pass from the
    pass-major copy is the TPU kernel's order of sums."""
    m = _model("seeded")
    group = m.fast_weights_int8(_amax(m)).groups[0].head(g)
    rng = np.random.default_rng(sum(shape) + g)
    x = torch.from_numpy(rng.uniform(-1, 1, (*shape, NF)).astype(np.float32)).to(torch.bfloat16)
    out = torch.empty_like(x)
    want_codes = []
    fused_srvgg.fused_conv_chain_int8_plain(x, out, group, want_codes)
    codes, sums, got = _emulated_chain(x, group)
    assert len(codes) == len(want_codes) == g
    for i, (c, c_w) in enumerate(zip(codes, want_codes)):
        assert torch.equal(c, c_w)
        dq = group.dq[i].view(1, -1, 1, 1)
        acc = None
        for t0, t1 in fused_srvgg._TAP_CHUNKS:
            part = fused_srvgg._conv_codes_chunk(c_w, group.wq[i], t0, t1) * dq
            acc = part if acc is None else acc + part
        assert torch.equal(sums[i], acc.permute(0, 2, 3, 1))
    assert torch.equal(got, out)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("g", [1, 3])
def test_head_is_the_group_of_the_first_convs(int8, g):
    """``head(g)`` equals the group that the chain's first g convs make on
    their own (for int8 with their g + 1 activation ranges), the kernels'
    copies included."""
    m = _model("seeded")
    convs, acts = m.convs[1:-1], m.acts[1:]
    if int8:
        amax = _amax(m)
        got = m.fast_weights_int8(amax).groups[0].head(g)
        want = fused_srvgg.chain_weights_int8(convs[:g], acts[:g], amax[:g + 1])[0]
    else:
        got = m.fast_weights().groups[0].head(g)
        want = fused_srvgg.chain_weights(convs[:g], acts[:g])[0]
    for name in want.__dataclass_fields__:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert torch.equal(a, b), name
