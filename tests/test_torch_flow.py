"""Flow and frame generation in the port (``processors/flow.py``,
``processors/frame_generation.py``) held to the JAX package, and the
seeded IFNet draws they read.

Tolerances: ``models/weights/colorize_ifnet_key4.npz`` and
``gapfill_ifnet_key5.npz`` equal JAX's ``ifnet.init(PRNGKey(4))`` and
``PRNGKey(5)`` bit for bit; ``FlowEstimator`` (ifnet) flows within 1e-5
px of JAX's, the confidence within 1e-5 (it is ``exp(-err)`` of those
flows: equal on the same flows), ``check_flow_consistency`` and
``_consistency_confidence`` equal on the same flows, ``warp_frame`` within
1 LSB; ``GapFiller`` detections equal, frames within 1 LSB on at most 0.1%
of values; ``FrameExtender`` the same. A raft backend without
``raft-things.npz`` raises ``InputError`` naming the file and the
directory (JAX draws random RAFT weights).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from framewright_tpu.models import ifnet as jifnet
from framewright_tpu.processors import flow as jflow
from framewright_tpu.processors import frame_generation as jfg
from framewright_tpu_torch.errors import ConfigError, InputError
from framewright_tpu_torch.models import registry
from framewright_tpu_torch.models.ifnet import ALIGN_ARCH, COLORIZE_ARCH, IFNet
from framewright_tpu_torch.processors import flow as pflow
from framewright_tpu_torch.processors import frame_generation as pfg


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lsb(got, want, share=1e-3):
    d = np.abs(np.asarray(got).astype(np.int16) - np.asarray(want).astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= share, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("npz,key,arch,n_arrays", [
    ("COLORIZE_IFNET_NPZ", 4, COLORIZE_ARCH, 34),
    ("GAPFILL_IFNET_NPZ", 5, ALIGN_ARCH, 40)], ids=["key4", "key5"])
def test_seeded_ifnet_files_are_jax_draws(npz, key, arch, n_arrays):
    """Each file holds exactly JAX's draw (float32, bit for bit) and loads
    into the module under the Practical-RIFE names."""
    path = getattr(registry, npz)
    want = jifnet.init(jax.random.PRNGKey(key), jifnet.IFNetConfig(
        channels=arch.channels, scales=arch.scales, num_res_convs=arch.num_res_convs))
    flat_got, tree_got = jax.tree_util.tree_flatten(registry.read_npz(path))
    flat_want, tree_want = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, want))
    assert tree_got == tree_want and len(flat_got) == n_arrays
    for a, b in zip(flat_got, flat_want):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert path.stat().st_size < 3 * 2**20
    assert isinstance(registry.load_align_ifnet("cpu", path, arch), IFNet)


def test_missing_seeded_draw_raises(tmp_path):
    with pytest.raises(InputError, match="export_align_ifnet"):
        registry.load_align_ifnet("cpu", tmp_path / "gone.npz")


# -- FlowEstimator -----------------------------------------------------------------

def _shifted_pair(shift=3, h=40, w=56, seed=0):
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (h, w * 2), dtype=np.uint8)
    tex = ((tex.astype(np.float32) + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3).astype(np.uint8)
    return (np.stack([tex[:, :w]] * 3, -1), np.stack([tex[:, shift:w + shift]] * 3, -1))


@pytest.fixture(scope="module")
def estimators():
    return jflow.FlowEstimator(backend="ifnet"), pflow.FlowEstimator(backend="ifnet",
                                                                     device="cpu")


def test_estimate_matches_jax(estimators):
    je, pe = estimators
    f0, f1 = _shifted_pair()
    want, got = je.estimate(f0, f1), pe.estimate(f0, f1)
    assert got.flow.shape == (40, 56, 2) and got.iterations_used == want.iterations_used == 0
    np.testing.assert_allclose(got.flow, want.flow, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.magnitude, want.magnitude, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.confidence, want.confidence, atol=1e-5, rtol=0)
    nc = pe.estimate(f0, f1, with_confidence=False)
    np.testing.assert_array_equal(nc.flow, got.flow)
    assert (nc.confidence == 1).all()
    for g, w in zip(pe.estimate_bidirectional(f0, f1), je.estimate_bidirectional(f0, f1)):
        np.testing.assert_allclose(g.flow, w.flow, atol=1e-5, rtol=0)
        np.testing.assert_allclose(g.confidence, w.confidence, atol=1e-5, rtol=0)
    # float input is taken as it is (not divided by 255)
    a, b = f0.astype(np.float32) / 255, f1.astype(np.float32) / 255
    np.testing.assert_allclose(pe.estimate(a, b).flow, je.estimate(a, b).flow, atol=1e-5,
                               rtol=0)


def test_consistency_and_confidence_equal_jax():
    rng = np.random.default_rng(5)
    fw = rng.normal(0, 3, (24, 30, 2)).astype(np.float32)
    bw = (-fw + rng.normal(0, 0.5, fw.shape)).astype(np.float32)
    for alpha, beta in ((0.01, 0.5), (0.05, 0.1)):
        np.testing.assert_array_equal(
            pflow.FlowEstimator.check_flow_consistency(fw, bw, alpha, beta),
            jflow.FlowEstimator.check_flow_consistency(fw, bw, alpha, beta))
    np.testing.assert_array_equal(pflow.FlowEstimator._consistency_confidence(fw, bw),
                                  jflow.FlowEstimator._consistency_confidence(fw, bw))


def test_warp_frame_matches_jax(estimators):
    _, pe = estimators
    f0, _ = _shifted_pair()
    flow = np.random.default_rng(6).normal(0, 4, (40, 56, 2)).astype(np.float32)
    _lsb(pe.warp_frame(f0, flow), jflow.FlowEstimator.warp_frame(f0, flow))
    fl = f0.astype(np.float32) / 255
    np.testing.assert_allclose(pe.warp_frame(fl, flow),
                               jflow.FlowEstimator.warp_frame(fl, flow), atol=1e-6, rtol=0)


def test_bad_backend_and_raft_without_weights(tmp_path):
    with pytest.raises(ConfigError):
        pflow.FlowEstimator(backend="farneback")
    est = pflow.FlowEstimator(backend="raft", weights_dir=str(tmp_path), device="cpu")
    with pytest.raises(InputError, match=f"{tmp_path}/raft-things.npz"):
        est.estimate(*_shifted_pair())
    assert est._fn is None


# -- GapFiller and FrameExtender -------------------------------------------------------

def dropped_clip(n=12, drop=6):
    """``tests/test_scheduler_gapfill.py``'s smooth pan with frame ``drop``
    missing."""
    rng = np.random.default_rng(0)
    base = rng.random((48, 128)) * 255
    for _ in range(20):
        base = (base + np.roll(base, 1, 1) + np.roll(base, -1, 1)
                + np.roll(base, 1, 0) + np.roll(base, -1, 0)) / 5
    base = (base - base.min()) / (np.ptp(base) + 1e-6) * 255
    return [np.stack([np.roll(base, t * 2, axis=1)] * 3, -1).astype(np.uint8)
            for t in range(n) if t != drop]


def test_gap_filler_matches_jax():
    clip = dropped_clip()
    jg, pg = jfg.GapFiller(jump_ratio=1.5), pfg.GapFiller(jump_ratio=1.5, device="cpu")
    want, got = list(jg.process_stream(iter(clip))), list(pg.process_stream(iter(clip)))
    assert vars(pg.report) == vars(jg.report) and pg.report.frames_inserted == 1
    assert len(got) == len(want) == len(clip) + 1
    for g, w in zip(got, want):
        _lsb(g, w)
    gap = pg.report.gaps[0]
    assert pg.sources == list(range(gap)) + [gap - 1] + list(range(gap, len(clip)))
    assert pg.inserted_at == [gap]
    assert pg.source_of(gap) == (gap - 1, True) and pg.source_of(gap + 1) == (gap, False)
    assert pg.detect_gaps(clip) == jg.detect_gaps(clip)


@pytest.mark.parametrize("clip", ["no-gap", "cut"])
def test_gap_filler_inserts_nothing_like_jax(clip):
    if clip == "cut":
        frames = [np.full((48, 64, 3), 30, np.uint8)] * 5 + [np.full((48, 64, 3), 220,
                                                                    np.uint8)] * 5
    else:
        frames = dropped_clip(10, drop=99)
    jg, pg = jfg.GapFiller(), pfg.GapFiller(device="cpu")
    want, got = list(jg.process_stream(iter(frames))), list(pg.process_stream(iter(frames)))
    assert vars(pg.report) == vars(jg.report) and pg.report.frames_inserted == 0
    assert all(np.array_equal(g, w) for g, w in zip(got, want)) and len(got) == len(frames)
    assert pg.detect_gaps(frames) == jg.detect_gaps(frames)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_frame_extender_matches_jax(direction):
    clip = dropped_clip(5, drop=99)
    je, pe = jfg.FrameExtender(), pfg.FrameExtender(device="cpu")
    want = getattr(je, f"extend_{direction}")(clip, 3)
    got = getattr(pe, f"extend_{direction}")(clip, 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _lsb(g, w)
    assert pe.extend_forward(clip[:1], 2)[1].tobytes() == clip[0].tobytes()
    assert pe.extend_backward([], 2) == []
