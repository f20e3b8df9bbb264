"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Every ``*.cu`` file under ``csrc/`` is compiled for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and the objects are
linked into one shared library with a plain C interface. The library lands
in ``build/repro_torch/<hash>/`` under the repository root, keyed by a hash
of the sources, the headers and the flags, so a changed source rebuilds and
an unchanged one is loaded as it is. The build runs at the first launch of a
kernel, never at import: the CPU tests import every module on machines
without ``nvcc``.
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
              "-Xcompiler", "-fPIC")

_I64 = ctypes.c_longlong
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# C symbol -> argument types (every function returns a cudaError_t as int)
SYMBOLS = {
    "repro_dominance_matrix": [_PTR, _PTR, _INT, _INT, _PTR],
    "repro_flash_attention": [_PTR] * 4 + [_INT] * 7 + [_I64] * 12 + [_PTR],
    "repro_gqa_decode": [_PTR] * 5 + [_INT] * 6 + [_I64] * 10 + [_PTR],
}

_LIB: Optional[ctypes.CDLL] = None
#: seconds the last ``load()`` spent compiling (0.0 when the cache was hit)
BUILD_SECONDS = 0.0


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


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


def compile_command(nvcc: str, src: Path, obj: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(nvcc: str, objs: List[Path], out: Path) -> List[str]:
    return [nvcc, "-shared", "-o", str(out), *map(str, objs)]


def _digest(files: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in files:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> None:
    """Run the commands side by side; raise with the stderr of each that
    failed, after all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errors = []
    for cmd, p in zip(cmds, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n-> exit {p.returncode}:\n{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def build(nvcc: Optional[str] = None) -> Path:
    """Compile the sources unless a library for this hash exists; return
    its path. A failed build raises with nvcc's stderr."""
    global BUILD_SECONDS
    srcs = sources()
    out_dir = BUILD_ROOT / _digest(srcs + headers())
    lib = out_dir / LIB_NAME
    if lib.is_file():
        BUILD_SECONDS = 0.0
        return lib
    nvcc = nvcc or find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        _run_all([compile_command(nvcc, s, o) for s, o in zip(srcs, objs)])
        so = Path(tmp) / LIB_NAME
        _run_all([link_command(nvcc, objs, so)])
        os.replace(so, lib)
    BUILD_SECONDS = time.perf_counter() - t0
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use and loaded once."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SYMBOLS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
