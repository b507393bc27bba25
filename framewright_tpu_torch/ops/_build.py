"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and one more ``nvcc`` links the objects
into a single shared library with a plain C interface (``extern "C"``
launchers, no PyTorch headers), loaded with ``ctypes``. Built at first
use into ``ops/_build/<hash of the sources>/``; the library is linked
under a temporary name and moved into place with ``os.replace``, so no
step waits on a lock file and an interrupted build leaves nothing that
the next one would trust.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libfw_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# launcher name -> argtypes (every launcher returns its cudaError_t as int)
_SIGNATURES = {
    "fw_rdb_dense": [_P, _I, _I, _I, _I, _P, _P, _P, _P],
    "fw_rdb_final": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "fw_halo_refresh": [_P, _I, _I, _I, _I, _I, _I, _P],
    "fw_band_conv": [_P, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P],
    "fw_conv_body_skip": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "fw_tail_up2": [_P, _I, _I, _I, _P, _P, _P, _P],
    "fw_tail_hr": [_P, _I, _I, _I, _P, _P, _P, _P],
    "fw_tail_last": [_P, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P],
    "fw_rdb_i8_quant": [_P, _P, _L, _F, _P],
    "fw_rdb_i8_dense": [_P, _I, _I, _I, _I, _P, _P, _P, _F, _I, _P, _P],
    "fw_rdb_i8_final": [_P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "fw_rdb_dyn_absmax": [_P, _I, _L, _P, _P],
    "fw_rdb_dyn_quant": [_P, _I, _I, _P, _I, _I, _L, _P, _I, _P],
    "fw_rdb_dyn_dense": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "fw_rdb_dyn_final": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "fw_vgg_conv": [_P, _I, _I, _I, _P, _P, _P, _P, _P],
    "fw_vgg_i8_quant": [_P, _P, _L, _F, _P],
    "fw_vgg_i8_conv": [_P, _I, _I, _I, _P, _P, _P, _P, _F, _P, _P, _P],
    "fw_wgmma_smem_bytes": [_I],
}


@dataclass
class BuildInfo:
    path: Path
    seconds: float            # 0.0 when an existing build was reused
    ptxas: List[str] = field(default_factory=list)   # register/spill/wgmma lines


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels are built on the machine with the card")
    return found


def build(verbose: bool = True) -> BuildInfo:
    """Compile the kernels unless a build of these sources exists: one
    ``nvcc -c`` per source, all running at once, then one link."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return BuildInfo(lib, 0.0)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.{threading.get_ident()}"
    obj_dir = out_dir / f"obj.{tag}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    t0 = time.perf_counter()
    try:
        jobs = []
        for src in _sources():
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj_dir / f"{src.stem}.o")]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        logs = []
        for cmd, proc in jobs:
            try:
                out, _ = proc.communicate(timeout=900)
            except subprocess.TimeoutExpired:
                for _, p in jobs:
                    p.kill()
                raise
            logs.append(out)
            if proc.returncode != 0:
                for _, p in jobs:
                    p.kill()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        cmd = [nvcc, "-shared", "-o", str(tmp), *sorted(map(str, obj_dir.glob("*.o")))]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(obj_dir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in "\n".join(logs).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln
             or "wgmma" in ln]
    if verbose:
        print(f"[fw-build] nvcc {len(jobs)} sources in parallel, {seconds:.2f} s "
              f"-> {lib}", file=sys.stderr)
        for ln in ptxas:
            print(f"[fw-build] {ln}", file=sys.stderr)
    return BuildInfo(lib, seconds, ptxas)


class _Library:
    """The loaded kernel library; built and loaded on first use."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(build().path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


_LIBRARY = _Library()


def library() -> ctypes.CDLL:
    return _LIBRARY.get()


def check(err: int, name: str) -> None:
    """Raise when a launcher reports a CUDA error (launch refused etc.)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
