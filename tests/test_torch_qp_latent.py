"""QP removal and the latent temporal model in the port
(``processors/qp_removal.py``, ``processors/latent_temporal.py``: their
card parts in f32) held to the JAX package.

Tolerances: the blockiness probe (numpy) equal; the DCT threshold and the
latent chunk uint8 within 1 LSB on at most 0.1% of the values (measured:
equal). The latent reconstruction is compared, not the eigenvectors:
LAPACK here and cuSOLVER on the card may flip a vector's sign or rotate
a degenerate eigenspace, which the reconstruction does not see (a frame
repeated three times gives a zero eigenvalue of multiplicity two).
"""

from __future__ import annotations

import numpy as np
import pytest

from framewright_tpu.processors import latent_temporal as jlt
from framewright_tpu.processors import qp_removal as jqp
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.processors import latent_temporal as plt
from framewright_tpu_torch.processors import qp_removal as pqp

from conftest import make_gradient_frame


def _within(got, want):
    d = np.abs(np.asarray(got).astype(np.int16) - np.asarray(want))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def blocky(n: int = 5, h: int = 37, w: int = 53, q: float = 24.0, seed: int = 0) -> np.ndarray:
    """Frames through an 8x8 DCT quantizer (visible block edges)."""
    rng = np.random.default_rng(seed)
    d = pqp._DCT8
    out = []
    for t in range(n):
        f = make_gradient_frame(h, w, t).astype(np.float32) + rng.normal(0, 4, (h, w, 3))
        ph, pw = (-h) % 8, (-w) % 8
        x = np.pad(f, ((0, ph), (0, pw), (0, 0)), mode="edge")
        b = x.reshape((h + ph) // 8, 8, (w + pw) // 8, 8, 3).transpose(0, 2, 4, 1, 3)
        c = np.round(d @ b @ d.T / q) * q
        y = (d.T @ c @ d).transpose(0, 3, 1, 4, 2).reshape(h + ph, w + pw, 3)
        out.append(np.clip(y[:h, :w], 0, 255).astype(np.uint8))
    return np.stack(out)


@pytest.mark.parametrize("q", [12.0, 24.0, 40.0])
def test_blockiness_equals_jax(q):
    for f in blocky(2, q=q):
        assert pqp.estimate_blockiness(f) == jqp.estimate_blockiness(f)
        assert pqp.estimate_blockiness(f[..., 0]) == jqp.estimate_blockiness(f[..., 0])


@pytest.mark.parametrize("shifts", [1, 2, 4])
@pytest.mark.parametrize("thr", [None, 1.5, 6.0], ids=["auto", "thr1.5", "thr6"])
def test_dct_filter_matches_jax(shifts, thr):
    frames = blocky()
    got = pqp.QPArtifactRemover(pqp.QPRemovalConfig(shifts=shifts), device="cpu") \
        .process_batch(frames, thr)
    want = jqp.QPArtifactRemover(jqp.QPRemovalConfig(shifts=shifts)).process_batch(frames, thr)
    assert got.shape == want.shape == frames.shape
    _within(got, want)


@pytest.mark.parametrize("strength", [0.0, 3.0])
def test_qp_stream_matches_jax(strength):
    """Batches of 8 (the last short), each at its first frame's
    threshold; a clean clip is passed through."""
    clip = list(blocky(11)) + [make_gradient_frame(37, 53, 9)] * 2
    cfg = dict(strength=strength)
    got = list(pqp.QPArtifactRemover(pqp.QPRemovalConfig(**cfg), device="cpu")
               .process_stream(iter(clip)))
    want = list(jqp.QPArtifactRemover(jqp.QPRemovalConfig(**cfg)).process_stream(iter(clip)))
    assert len(got) == len(want) == len(clip)
    _within(np.stack(got), np.stack(want))


def _flicker(n: int, seed: int = 1, cut: int = -1) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        f = make_gradient_frame(24, 32, t if t < cut or cut < 0 else t + 50).astype(np.float32)
        f *= 1.0 + 0.08 * rng.standard_normal()
        out.append(np.clip(f, 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("n,cut", [(2, -1), (7, -1), (16, -1), (16, 8)],
                         ids=["short", "padded-tail", "chunk", "chunk-with-cut"])
def test_latent_chunk_matches_jax(n, cut):
    frames = np.stack(_flicker(n, cut=cut))
    got = plt.LatentTemporalSmoother(device="cpu").process_chunk(frames)
    want = jlt.LatentTemporalSmoother().process_chunk(frames)
    assert got.shape == want.shape == frames.shape
    _within(got, want)


def test_latent_degenerate_eigenspace_matches_jax():
    """Frames repeated: a zero eigenvalue of multiplicity > 1."""
    base = _flicker(6)
    frames = np.stack([base[i // 3] for i in range(16)])
    _within(plt.LatentTemporalSmoother(device="cpu").process_chunk(frames),
            jlt.LatentTemporalSmoother().process_chunk(frames))


@pytest.mark.parametrize("n", [5, 16, 28, 29, 40], ids=lambda n: f"{n}-frames")
def test_latent_stream_matches_jax(n):
    """Chunks of 16 overlapping by 4 and crossfaded; a stream ending on a
    chunk boundary (28 = 16 + 12) emits its held overlap."""
    clip = _flicker(n, seed=n)
    got = list(plt.LatentTemporalSmoother(device="cpu").reduce_stream(iter(clip)))
    want = list(jlt.LatentTemporalSmoother().reduce_stream(iter(clip)))
    assert len(got) == len(want) == n
    _within(np.stack(got), np.stack(want))


def test_latent_config_runs_and_flags():
    cfg = Config(temporal_consistency=True, temporal_model="latent", qp_removal=True,
                 qp_strength=2.0)
    assert cfg.temporal_model == "latent" and cfg.qp_strength == 2.0
    with pytest.raises(ConfigError, match="temporal_model"):
        Config(temporal_model="vae")


PX_1080 = 1080 * 1920


@pytest.mark.parametrize("kwargs,want", [
    (dict(qp_removal=True), PX_1080 * 913),
    (dict(temporal_consistency=True, temporal_model="latent"), PX_1080 * 1394),
    (dict(watermark_removal=True, inpaint_model="diffusion"), PX_1080 * 102),
    (dict(subtitle_removal=True, qp_removal=True), PX_1080 * 1325 + 238_000_000),
    (dict(watermark_removal=True, inpaint_model="diffusion", qp_removal=True,
          temporal_consistency=True, temporal_model="latent"), PX_1080 * 1394)],
    ids=["qp", "latent", "heat", "lama-beside-qp", "heat-qp-latent"])
def test_pre_sr_reserve_counts_the_stream_stages(kwargs, want):
    """The stages run in turn: the reserve is the largest part's row (card
    readings at 1080p + 15%), and LaMa's weights beside it."""
    from framewright_tpu_torch.restorer import pre_sr_reserve

    assert pre_sr_reserve(Config(**kwargs), 1080, 1920) == want
