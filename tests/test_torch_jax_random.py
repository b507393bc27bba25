"""The port's draw of ``jax.random.normal(jax.random.PRNGKey(k), shape)``
(``framewright_tpu_torch/ops/jax_random.py``) held to JAX's.

Tolerances: the threefry bits and the uniforms in (nextafter(-1, 0), 1)
equal; the normals within 4 float32 ulps (measured: at most 3, on ~5% of
the values, where the CPU's ``torch.log1p`` and XLA's differ inside the
erfinv polynomial).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framewright_tpu_torch.ops import jax_random

KEYS = [0, 1, 3, 12345, 2 ** 31 - 1]
SHAPES = [(7,), (3, 5, 7, 3), (2, 33, 17, 3), (1, 48, 64, 3)]
MAX_ULP = 4


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", KEYS)
def test_bits_uniform_normal_match_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    bits = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(jax_random.random_bits(seed, shape).numpy(), bits)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, 1.0))
    np.testing.assert_array_equal(jax_random.uniform(seed, shape).numpy(), u)
    n = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = jax_random.normal(seed, shape).numpy()
    assert got.shape == n.shape and got.dtype == np.float32
    assert _ulps(got, n).max() <= MAX_ULP


def test_a_frame_draws_its_slice_whatever_the_batch():
    """Partitionable threefry: element j's bits depend on j alone, so
    frame i of a (B, H, W, 3) draw is slice i of any larger batch's draw."""
    four = jax_random.normal(0, (4, 9, 11, 3))
    two = jax_random.normal(0, (2, 9, 11, 3))
    torch.testing.assert_close(four[:2], two, rtol=0, atol=0)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 9, 11, 3)))[3]
    assert _ulps(four[3].numpy(), want).max() <= MAX_ULP


def test_chunks_give_the_unchunked_draw(monkeypatch):
    whole = jax_random.normal(5, (3, 10, 7))
    monkeypatch.setattr(jax_random, "_CHUNK", 16)
    torch.testing.assert_close(jax_random.normal(5, (3, 10, 7)), whole, rtol=0, atol=0)
    bits = jax_random.random_bits(5, (3, 10, 7))
    monkeypatch.undo()
    torch.testing.assert_close(bits, jax_random.random_bits(5, (3, 10, 7)), rtol=0, atol=0)


@pytest.mark.parametrize("x", [0.0, 0.5, -0.9999, 0.99999994, 1.0, -1.0])
def test_erfinv_edges_match_xla(x):
    want = np.asarray(jax.lax.erf_inv(jnp.float32(x)))
    got = jax_random.erfinv_xla(torch.tensor([x], dtype=torch.float32)).numpy()[0]
    if np.isinf(want):
        assert np.isinf(got) and np.sign(got) == np.sign(want)
    else:
        assert _ulps(np.float32([got]), np.float32([want])).max() <= MAX_ULP
