"""JAX's random draws on any device: ``jax.random.split``, ``uniform``
and ``normal`` (float32) of a key, ``PRNGKey(seed)`` or a key that
``split`` made (a key is a seed or the pair of its 32-bit words).

JAX's default generator with ``jax_threefry_partitionable`` on (the
default since JAX 0.5): the key of ``PRNGKey(seed)`` is the pair (0,
seed); element j of the draw (its flat row-major index) gets the 32 bits
``x0 ^ x1`` of ``threefry2x32(key, (j >> 32, j & 0xffffffff))``, so an
element's bits depend on its index alone, never on the shape around it
(frame i of a (B, H, W, C) draw is the same whatever B). The bits become
a float in [1, 2) through their top 23 bits, minus 1, scaled to
(nextafter(-1, 0), 1) for the normal, or (minval, maxval) for ``uniform``;
the normal is ``sqrt(2) * erfinv(u)``, with XLA's single-precision
``erfinv`` (Giles' polynomial, the one XLA lowers ``lax.erf_inv`` to).
``split(key, n)`` is the same threefry of (key, (0, i)) for i < n, new key
i the pair of its two output words (JAX's fold-like split under
``jax_threefry_partitionable``).

PyTorch has few unsigned 32-bit operations: the threefry rounds run on
int64 tensors masked to 32 bits. The draw runs in chunks of
``_CHUNK`` elements, so its int64 temporaries stay a fixed size.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 24
# XLA's ErfInv32 (xla/client/lib/math.cc; the chlo decomposition has the same)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


Key = Union[int, Tuple[int, int]]


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as its two 32-bit words (a seed is a
    32-bit integer there unless x64 is on: its high word is 0)."""
    return 0, int(seed) & _MASK


def _key(key: Key) -> Tuple[int, int]:
    if isinstance(key, (int, np.integer)):
        return prng_key(key)
    return int(key[0]) & _MASK, int(key[1]) & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: Tuple[int, int], x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (JAX's ``threefry2x32_p``) on int64
    tensors holding 32-bit words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def split(key: Key, num: int = 2) -> List[Tuple[int, int]]:
    """``jax.random.split(key, num)`` as a list of keys."""
    idx = torch.arange(num, dtype=torch.int64)
    x0, x1 = threefry2x32(_key(key), idx >> 32, idx & _MASK)
    return list(zip(x0.tolist(), x1.tolist()))


def random_bits(key: Key, shape: Sequence[int], device: Union[str, torch.device] = "cpu"
                ) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2**32)."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.int64, device=device)
    key = _key(key)
    for lo in range(0, n, _CHUNK):
        idx = torch.arange(lo, min(n, lo + _CHUNK), dtype=torch.int64, device=device)
        x0, x1 = threefry2x32(key, idx >> 32, idx & _MASK)
        out[lo:lo + len(idx)] = x0 ^ x1
    return out.view(tuple(shape))


def _uniform(bits: torch.Tensor, minval: Optional[float] = None,
             maxval: float = 1.0) -> torch.Tensor:
    """JAX's ``uniform(minval, maxval)`` of 32 random bits: the float in
    [1, 2) of their top 23 bits, minus 1, times (max - min), plus min, at
    least min; the bounds and their difference in f32, the product and sum
    rounded once to f32 as XLA's fused multiply-add does (the exact
    product fits f64) (minval None: nextafter(-1, 0), the normal's)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo32 = (np.nextafter(np.float32(-1.0), np.float32(0.0)) if minval is None
            else np.float32(minval))
    lo = torch.tensor(lo32, device=bits.device)
    span = torch.tensor(np.float32(maxval), device=bits.device) - lo
    return torch.maximum((f.double() * span.double() + lo.double()).float(), lo)


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erfinv``: w = -log1p(-x^2); Horner in w - 2.5 below
    5, in sqrt(w) - 3 above; times x; +-inf at +-1 (as XLA now gives)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, torch.tensor(_ERFINV_LT5[0], device=x.device),
                    torch.tensor(_ERFINV_GE5[0], device=x.device))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, torch.tensor(a, device=x.device),
                        torch.tensor(b, device=x.device)) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def uniform(key: Key, shape: Sequence[int], device: Union[str, torch.device] = "cpu",
            minval: Optional[float] = None, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` (the
    bounds rounded to f32 first, as JAX converts them); minval None: the
    draw in (nextafter(-1, 0), 1) that ``normal`` maps."""
    return _uniform(random_bits(key, shape, device), minval, maxval)


def normal(key: Key, shape: Sequence[int], device: Union[str, torch.device] = "cpu"
           ) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    key = _key(key)
    sqrt2 = torch.tensor(np.sqrt(2.0), dtype=torch.float32, device=device)
    for lo in range(0, n, _CHUNK):
        idx = torch.arange(lo, min(n, lo + _CHUNK), dtype=torch.int64, device=device)
        x0, x1 = threefry2x32(key, idx >> 32, idx & _MASK)
        out[lo:lo + len(idx)] = sqrt2 * erfinv_xla(_uniform(x0 ^ x1))
    return out.view(tuple(shape))
