"""Perceptual difference hash (dHash) for duplicate-frame detection: the
port's numpy copy of ``framewright_tpu.ops.dhash``.

A frame's grey image (BT.601 weights, float32) is box-resized to
(hash_size, hash_size + 1) cells by edge padding to multiples and block
means, and each cell compared with its right neighbour: hash_size**2
bits. The similarity of two hashes is 1 - (differing bits) / bits.
"""

from __future__ import annotations

import numpy as np


def _gray(frames: np.ndarray) -> np.ndarray:
    f = frames.astype(np.float32)
    return 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]


def _area_resize(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """(B, H, W) -> (B, oh, ow): edge-padded to multiples of (oh, ow),
    then the mean of each block."""
    b, h, w = img.shape
    ph, pw = -(-h // oh) * oh, -(-w // ow) * ow
    if ph != h or pw != w:
        img = np.pad(img, ((0, 0), (0, ph - h), (0, pw - w)), mode="edge")
    img = img.reshape(b, oh, ph // oh, ow, pw // ow)
    return img.mean(axis=(2, 4))


def dhash_batch(frames: np.ndarray, hash_size: int = 8) -> np.ndarray:
    """(B, H, W, 3) uint8 -> (B, hash_size * hash_size) bool."""
    g = _gray(frames)
    small = _area_resize(g, hash_size, hash_size + 1)
    bits = small[:, :, 1:] > small[:, :, :-1]
    return bits.reshape(frames.shape[0], hash_size * hash_size)


def hamming_similarity(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Similarity in [0, 1] of bit arrays along the last axis (1 = equal)."""
    diff = np.logical_xor(a, b).sum(axis=-1)
    return 1.0 - diff / a.shape[-1]


def consecutive_similarity(hashes: np.ndarray) -> np.ndarray:
    """Each hash's similarity to its predecessor; [0] = 0."""
    if len(hashes) == 0:
        return np.zeros(0)
    sims = np.zeros(len(hashes), dtype=np.float64)
    if len(hashes) > 1:
        sims[1:] = hamming_similarity(hashes[1:], hashes[:-1])
    return sims
