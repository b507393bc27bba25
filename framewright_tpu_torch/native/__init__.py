"""The native host codec: the port's copy of ``framewright_tpu.native``.

``fwcore.cpp`` beside this file (the JAX package's ``native/fwcore.cpp``,
the same code) is built by the host ``g++`` (``-O3 -fopenmp``, again
without OpenMP when that fails) at first use, into the port's build
directory ``framewright_tpu_torch/ops/_build/fwcore-<hash of the source
and flags>/``, linked under a temporary name and moved into place, and
bound with ctypes. ctypes releases the GIL for the call, so a decode in
the ring's producer thread and an encode in the writer's thread run
beside the main thread.

The wrappers fall back to the numpy copies of the same arithmetic
(``io/y4m.py``, ``ops/dhash.py``) for odd sizes and when the library is
not there: no compiler, a failed build, or ``FRAMEWRIGHT_NO_NATIVE`` set.
The first fallback for a missing library logs a warning; ``codec()``
says which codec runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "fwcore.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "ops" / "_build"
LIB_NAME = "libfwcore.so"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_WARNED = False
_LOCK = threading.Lock()


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_ROOT / f"fwcore-{h.hexdigest()[:16]}" / LIB_NAME


def build(force: bool = False) -> Optional[Path]:
    """Compile ``fwcore.cpp`` unless a build of this source exists ->
    the library's path, or None when the host cannot build it."""
    out = lib_path()
    if out.is_file() and not force:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0:
            # a toolchain without OpenMP: the same code on one thread
            cmd = [c for c in cmd if c != "-fopenmp"]
            res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0:
            logger.warning("fwcore build failed: %s", res.stderr.decode()[:400])
            return None
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.TimeoutExpired) as exc:
        logger.warning("fwcore build unavailable: %s", exc)
        return None
    finally:
        tmp.unlink(missing_ok=True)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built at the first call), or None."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("FRAMEWRIGHT_NO_NATIVE"):
            return None
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            logger.warning("fwcore load failed: %s", exc)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.yuv420_to_rgb.argtypes = [u8p, u8p, u8p, u8p,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.rgb_to_yuv420.argtypes = [u8p, u8p, u8p, u8p,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.dhash_batch.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
        lib.fwcore_version.restype = ctypes.c_int
        _LIB = lib
        logger.info("fwcore native codec loaded (v%d) from %s", lib.fwcore_version(), path)
        return _LIB


def available() -> bool:
    return get_lib() is not None


def _fallback_lib() -> Optional[ctypes.CDLL]:
    """``get_lib()``, warning once when the numpy copy has to stand in."""
    global _WARNED
    lib = get_lib()
    if lib is None and not _WARNED:
        _WARNED = True
        logger.warning("native host codec unavailable (no g++, a failed build or "
                       "FRAMEWRIGHT_NO_NATIVE): the numpy copy runs instead")
    return lib


def codec() -> str:
    """``"native"`` when the library is loaded, else ``"numpy"`` (warning
    once)."""
    return "numpy" if _fallback_lib() is None else "native"


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                  full_range: bool = False) -> np.ndarray:
    """4:2:0 planes -> RGB uint8 (H, W, 3), BT.601."""
    h, w = y.shape
    lib = _fallback_lib()
    if lib is not None and w % 2 == 0 and h % 2 == 0:
        y, u, v = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
        rgb = np.empty((h, w, 3), np.uint8)
        lib.yuv420_to_rgb(_ptr(y), _ptr(u), _ptr(v), _ptr(rgb), h, w, int(full_range))
        return rgb
    from framewright_tpu_torch.io.y4m import yuv_to_rgb

    return yuv_to_rgb(y, u, v, full_range=full_range)


def rgb_to_yuv420(rgb: np.ndarray, full_range: bool = False):
    """RGB uint8 (H, W, 3) -> 4:2:0 planes (Y, U, V), BT.601."""
    h, w = rgb.shape[:2]
    lib = _fallback_lib()
    if lib is not None and w % 2 == 0 and h % 2 == 0:
        rgb = np.ascontiguousarray(rgb, np.uint8)
        y = np.empty((h, w), np.uint8)
        u = np.empty((h // 2, w // 2), np.uint8)
        v = np.empty((h // 2, w // 2), np.uint8)
        lib.rgb_to_yuv420(_ptr(rgb), _ptr(y), _ptr(u), _ptr(v), h, w, int(full_range))
        return y, u, v
    from framewright_tpu_torch.io.y4m import rgb_to_yuv420 as numpy_rgb_to_yuv420

    return numpy_rgb_to_yuv420(rgb, full_range=full_range)


def dhash_batch(frames: np.ndarray, hash_size: int = 8) -> np.ndarray:
    """(B, H, W, 3) uint8 -> (B, hash_size**2) bool. The native hash
    averages in double and the numpy one in float32, so a bit on a tie
    may differ: the deduplicator hashes with ``ops.dhash``."""
    lib = _fallback_lib()
    if lib is not None and hash_size <= 64:
        frames = np.ascontiguousarray(frames, np.uint8)
        n, h, w = frames.shape[:3]
        bits = np.empty((n, hash_size * hash_size), np.uint8)
        lib.dhash_batch(_ptr(frames), _ptr(bits), n, h, w, hash_size)
        return bits.astype(bool)
    from framewright_tpu_torch.ops import dhash

    return dhash.dhash_batch(frames, hash_size)
