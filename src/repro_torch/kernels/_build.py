"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Every ``*.cu`` file under ``csrc/`` is compiled for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and the objects are
linked into one shared library with a plain C interface. The library lands
in ``build/repro_torch/<hash>/`` under the repository root, keyed by a hash
of the sources, the headers and the flags, so a changed source rebuilds and
an unchanged one is loaded as it is. The build runs at the first launch of a
kernel, never at import: the CPU tests import every module on machines
without ``nvcc``. The wrappers also take from here the device context and
the stream that a launch needs.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import ContextManager, List, Optional

import torch

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
    "repro_dominance_counts": [_PTR, _PTR] + [_INT] * 5 + [_PTR],
    "repro_dominance_matrix": [_PTR, _PTR] + [_INT] * 5 + [_PTR],
    "repro_flash_attention": [_PTR] * 7 + [_INT] * 9 + [_I64] * 18 + [_PTR],
    "repro_flash_attention_bwd_dq": [_PTR] * 8 + [_INT] * 7 + [_I64] * 18
    + [_PTR],
    "repro_flash_attention_bwd_dkdv": [_PTR] * 8 + [_INT] * 7 + [_I64] * 18
    + [_PTR],
    "repro_gqa_decode": [_PTR] * 7 + [_INT] * 8 + [_I64] * 10 + [_PTR],
    "repro_gqa_decode_partial": [_PTR] * 8 + [_INT] * 8 + [_I64] * 10
    + [_PTR],
    "repro_paged_gqa_decode": [_PTR] * 8 + [_INT] * 9 + [_I64] * 11 + [_PTR],
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


def on_device(device: torch.device) -> ContextManager:
    """A kernel launches on the current CUDA device: ``torch.cuda.device``
    for a tensor on another one, no context for one on the current."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C entry points take
    it: the raw handle, without building a ``torch.cuda.Stream`` (a few
    microseconds of host time a call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@functools.lru_cache(maxsize=None)
def n_sm(device: torch.device) -> int:
    """The card's streaming multiprocessors, which the grids are sized by."""
    return torch.cuda.get_device_properties(device).multi_processor_count
