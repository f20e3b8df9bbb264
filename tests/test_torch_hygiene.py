"""The port stands alone and hides no fallback: nothing in it imports JAX or
the JAX package, entry points demand CUDA unless the CPU is asked for, and a
tensor on a device the kernels do not serve raises instead of quietly taking
another path."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import _device
from repro_torch.cluster.spec import paper_testbed
from repro_torch.core.fitness import TraceEvaluator
from repro_torch.kernels import _build, dominance, ops
from repro_torch.quickstart import run_quickstart
from repro_torch.workload.trace import build_trace

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_port_modules_import_no_jax_at_runtime():
    code = ("import sys, repro_torch, repro_torch.quickstart, "
            "repro_torch.convert\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_require_cuda_without_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_quickstart()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TraceEvaluator(build_trace(8), paper_testbed())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paper_testbed().to_arrays()
    assert _device.resolve("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_kernel_dispatch_has_no_fallback():
    F = torch.rand(9, 3)
    before = dominance.LAUNCHES
    assert ops.dominance_matrix(F).dtype == torch.bool
    assert dominance.LAUNCHES == before
    # a device with no kernel and no plain path raises
    with pytest.raises(ValueError, match="no dominance_matrix"):
        ops.dominance_matrix(F.to("meta"))
    # the kernel's wrapper takes CUDA tensors only
    with pytest.raises(ValueError, match="CUDA tensor"):
        dominance.dominance_matrix_cuda(F)
    assert dominance.LAUNCHES == before


def test_kernel_build_targets_hopper_and_reports_failures(tmp_path,
                                                         monkeypatch):
    srcs = _build.sources()
    assert [s.name for s in srcs] == ["dominance.cu"]
    cmd = _build.nvcc_command("nvcc", srcs, tmp_path / "k.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert _build.BUILD_ROOT.parts[-2:] == ("build", "repro_torch")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(OSError):
        _build.build(nvcc=str(tmp_path / "no-nvcc"))
    assert not list((tmp_path / "build").rglob("*.so"))
