"""The SR ensemble of the port (``testing.EnsembleSR``, ``sr_ensemble``,
``--ensemble``) held to ``framewright_tpu.testing.EnsembleSR``.

The votes on the same member outputs equal JAX's exactly (weighted,
median, max_sharpness), and the port's ensemble output is its vote of its
members' outputs, bit for bit. End to end, FW_fast6_x2 with
FW_fastvgg_x2 (the repository's trained x2 members) in float32 against
the JAX ensemble (its RRDB member on the fused path in interpret mode, as
``tests/test_torch_float32.py`` runs it): within 2 LSB, mean below 0.3
LSB. The RGB bytes of the RRDB member differ by up to one bf16 step of
its kernels' output, which in [1, 2) is 2 LSB (``test_torch_float32.py``
holds the YUV planes, where it is 1); the SRVGG member's f32 paths agree
exactly here.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from framewright_tpu.io import y4m as jy4m
from framewright_tpu.testing import EnsembleSR as JaxEnsemble
from framewright_tpu_torch import cli
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.io import y4m
from framewright_tpu_torch.restorer import build_sr
from framewright_tpu_torch.testing import STRATEGIES, EnsembleSR

MEMBERS = ["FW_fast6_x2", "FW_fastvgg_x2"]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(n=2, h=24, w=32, seed=0, noise=5.0):
    rng = np.random.default_rng(seed)
    coarse = rng.random((n, h // 4 + 1, w // 4 + 1, 3))
    big = np.repeat(np.repeat(coarse, 4, 1), 4, 2)[:, :h, :w]
    return np.clip(big * 255 + rng.normal(0, noise, big.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_votes_equal_jax(strategy):
    """Three members' outputs (one of them a sharper copy) through both
    votes, weights (1, 2, 0.5) for ``weighted``: the same bytes."""
    rng = np.random.default_rng(1)
    outs = rng.integers(0, 256, (3, 2, 16, 20, 3)).astype(np.float32)
    outs[2, 1] = np.clip(outs[2, 1] * 1.7 - 90, 0, 255)
    weights = [1.0, 2.0, 0.5]
    jens = JaxEnsemble.__new__(JaxEnsemble)
    jens.strategy, jens.weights, jens.members = strategy, weights, [None] * 3
    it = iter(outs)
    jens.members = [type("M", (), {"process_batch": lambda self, f, o=o: o})() for o in it]
    want = jens.process_batch(None)
    ens = EnsembleSR.__new__(EnsembleSR)
    ens.strategy, ens.weights, ens.members = strategy, weights, [None] * 3
    got = ens.vote(outs)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    """The JAX ensemble's members on the frames, float32: FW_fast6_x2 on
    its fused kernel path in interpret mode (``FW_INTERPRET=1``; the port's
    RRDB path is the kernel path), FW_fastvgg_x2 on its plain f32 path
    (the JAX default for SRVGG)."""
    frames = _frames()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FW_TAIL", "3")
        mp.setenv("FW_INTERPRET", "1")
        jens = JaxEnsemble(MEMBERS, weights_dir=str(tmp_path_factory.mktemp("w")),
                           compute_dtype="float32")
        jens.members[0].config.use_fused_kernel = True
        jens.setup(24, 32)
        outs = np.stack([m.process_batch(frames).astype(np.float32) for m in jens.members])
    return frames, jens, outs


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_ensemble_matches_jax(strategy, tmp_path, jax_outputs):
    frames, jens, outs = jax_outputs
    jens.strategy = strategy
    jens.members = [type("M", (), {"process_batch": lambda self, f, o=o: o})() for o in outs]
    want = jens.process_batch(frames)
    ens = EnsembleSR(MEMBERS, strategy=strategy, weights_dir=str(tmp_path),
                     compute_dtype="float32", device="cpu")
    ens.setup(24, 32)
    assert ens.scale == 2 and ens.plan.frames >= 1
    assert [m.config.hbm_utilization for m in ens.members] == [0.425, 0.425]
    got = ens.materialize(ens.dispatch(frames))
    assert got.shape == want.shape == (2, 48, 64, 3)
    d = np.abs(got.astype(np.int16) - want)
    assert d.max() <= 2 and d.mean() < 0.3, (d.max(), d.mean())
    members = np.stack([m.materialize(m.dispatch(frames)).astype(np.float32)
                        for m in ens.members])
    np.testing.assert_array_equal(got, ens.vote(members))
    for m in ens.members:
        assert m.dispatches == 2


def test_build_sr_shares_the_raft_reserve_with_the_members():
    """A ``--denoise --flow-model raft`` ensemble restore: the pre-SR
    reserve (RAFT's pairs) reaches the members, each planning beside its
    share of it, so their batches together fit the budget less the
    reserve."""
    from framewright_tpu_torch import planner
    from framewright_tpu_torch.restorer import pre_sr_reserve

    cfg = Config(sr_model="RealESRGAN_x2plus", sr_ensemble="FW_fast6_x2", denoise=True,
                 denoise_model="temporal", flow_model="raft", device_platform="cpu",
                 compute_dtype="bfloat16")
    h, w = 540, 960
    reserve = pre_sr_reserve(cfg, h, w)
    assert reserve >= planner.raft_pair_bytes(h, w)
    ens = build_sr(cfg, reserve)
    assert [m.config.reserved_bytes for m in ens.members] == [reserve // 2] * 2
    alone = build_sr(cfg)
    for e in (ens, alone):
        e.setup(h, w)
    budget = planner.budget_bytes(None, cfg.hbm_utilization)
    assert sum(m.plan.est_bytes for m in ens.members) <= budget - reserve
    assert ens.plan.frames < alone.plan.frames


def test_members_of_another_scale_are_refused():
    ens = EnsembleSR(["FW_fast6_x2", "realesr-animevideov3"], device="cpu")
    with pytest.raises(ConfigError, match="scale"):
        ens.setup(16, 16)
    with pytest.raises(ConfigError, match="strategy"):
        EnsembleSR(MEMBERS, strategy="mean")
    with pytest.raises(ConfigError, match="ensemble model"):
        Config(sr_model="FW_fast6_x2", sr_ensemble="nope_x2")


def test_cli_ensemble_restore(tmp_path, capsys):
    """``restore --model FW_fast6_x2 --ensemble FW_fastvgg_x2 --ensemble-strategy
    max_sharpness --device cpu``: the RGB path, every frame the vote of the
    members' outputs."""
    frames = _frames(4, 16, 24, seed=3, noise=0.0)    # progressive: no deinterlacing
    src = tmp_path / "c.y4m"
    with jy4m.Y4MWriter(src, 24, 16, fps=12) as w:
        for f in frames:
            w.write_frame(f)
    cfg = Config(sr_model="FW_fast6_x2", sr_ensemble="FW_fastvgg_x2",
                 ensemble_strategy="max_sharpness", device_platform="cpu")
    sr = build_sr(cfg)
    assert isinstance(sr, EnsembleSR) and [m.config.model_name for m in sr.members] == MEMBERS
    rc = cli.main(["restore", str(src), "-o", str(tmp_path / "o.y4m"), "--model", "FW_fast6_x2",
                   "--ensemble", "FW_fastvgg_x2", "--ensemble-strategy", "max_sharpness",
                   "--device", "cpu", "--project-dir", str(tmp_path / "p")])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["frames"] == 4 and out["errors"] == 0
    assert out["pre_sr"]["deinterlace"]["mode"] == "off"
    ens = EnsembleSR(MEMBERS, strategy="max_sharpness", compute_dtype="bfloat16", device="cpu")
    ens.setup(16, 24)
    with y4m.Y4MReader(src) as r:              # the source as the restore reads it
        want = ens.process_batch(np.stack(list(r)))
    # the restore's writer (the port's Y4M writer, 4:2:0) on the vote
    with y4m.Y4MWriter(tmp_path / "w.y4m", 48, 32, fps=12) as w:
        for f in want:
            w.write_frame(f)
    assert (tmp_path / "o.y4m").read_bytes() == (tmp_path / "w.y4m").read_bytes()
