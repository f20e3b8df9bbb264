"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Every ``*.cu`` file under ``csrc/`` is compiled for Hopper (``sm_90a``) into
one shared library with a plain C interface. The library lands in
``build/repro_torch/<hash>/`` under the repository root, keyed by a hash of
the sources and the flags, so a changed source rebuilds and an unchanged one
is loaded as it is. The build runs at the first launch of a kernel, never at
import: the CPU tests import every module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
#: seconds the last ``load()`` spent compiling (0.0 when the cache was hit)
BUILD_SECONDS = 0.0


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME``, else the toolkit's
    conventional install prefix."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the port's CUDA kernels are "
                       "built on the machine with the card")


def nvcc_command(nvcc: str, srcs: List[Path], out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, srcs)]


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build(nvcc: Optional[str] = None) -> Path:
    """Compile the sources unless a library for this hash exists; return
    its path. A failed build raises with nvcc's stderr."""
    global BUILD_SECONDS
    srcs = sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        BUILD_SECONDS = 0.0
        return lib
    nvcc = nvcc or find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(nvcc_command(nvcc, srcs, Path(tmp)),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_SECONDS = time.perf_counter() - t0
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use and loaded once."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.repro_dominance_matrix
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
