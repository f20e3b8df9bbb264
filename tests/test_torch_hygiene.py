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

from repro_torch import _device, serve
from repro_torch.cluster.spec import paper_testbed
from repro_torch.core.fitness import TraceEvaluator
from repro_torch.configs import get
from repro_torch.kernels import (_build, decode_attention, dominance,
                                 flash_attention, ops)
from repro_torch.models import lm
from repro_torch.quickstart import run_quickstart
from repro_torch.serving import EngineConfig, LLMEngine
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
            "repro_torch.convert, repro_torch.serve, "
            "repro_torch.serving.engine, repro_torch.models.lm\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_require_cuda_without_an_explicit_device(monkeypatch):
    cfg = get("qwen3-1.7b").smoke()
    model = lm.LM(cfg, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_quickstart()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(cfg, model, EngineConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run_serve(smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.LM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TraceEvaluator(build_trace(8), paper_testbed())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paper_testbed().to_arrays()
    assert _device.resolve("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def _launches():
    return (dominance.LAUNCHES, flash_attention.LAUNCHES,
            decode_attention.LAUNCHES)


def test_kernel_dispatch_has_no_fallback():
    F = torch.rand(9, 3)
    q, kv = torch.rand(1, 4, 5, 16), torch.rand(1, 2, 5, 16)
    qd, lens = torch.rand(1, 4, 16), torch.tensor([3], dtype=torch.int32)
    before = _launches()
    assert ops.dominance_matrix(F).dtype == torch.bool
    assert ops.flash_attention(q, kv, kv).shape == q.shape
    assert ops.gqa_decode_attention(qd, kv, kv, lens).shape == qd.shape
    assert _launches() == before
    # a device with no kernel and no plain path raises
    meta = lambda *ts: [t.to("meta") for t in ts]  # noqa: E731
    with pytest.raises(ValueError, match="no dominance_matrix"):
        ops.dominance_matrix(F.to("meta"))
    with pytest.raises(ValueError, match="no flash_attention"):
        ops.flash_attention(*meta(q, kv, kv))
    with pytest.raises(ValueError, match="no gqa_decode_attention"):
        ops.gqa_decode_attention(*meta(qd, kv, kv, lens))
    # the kernels' wrappers take CUDA tensors only
    with pytest.raises(ValueError, match="CUDA tensor"):
        dominance.dominance_matrix_cuda(F)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention.flash_attention_cuda(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_attention.gqa_decode_attention_cuda(qd, kv, kv, lens)
    assert _launches() == before


def test_kernel_build_targets_hopper_and_reports_failures(tmp_path,
                                                         monkeypatch):
    srcs = _build.sources()
    assert [s.name for s in srcs] == ["decode_attention.cu", "dominance.cu",
                                      "flash_attention.cu"]
    assert [h.name for h in _build.headers()] == ["attention_tile.cuh"]
    for s in srcs:
        cmd = _build.compile_command("nvcc", s, tmp_path / "k.o")
        assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
    assert "-shared" in _build.link_command("nvcc", [tmp_path / "k.o"],
                                            tmp_path / "k.so")
    assert set(_build.SYMBOLS) == {"repro_dominance_matrix",
                                   "repro_flash_attention",
                                   "repro_gqa_decode"}
    for name in _build.SYMBOLS:   # every C symbol is defined in a source
        assert any(f'extern "C" int {name}(' in s.read_text() for s in srcs)
    assert _build.BUILD_ROOT.parts[-2:] == ("build", "repro_torch")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(OSError):
        _build.build(nvcc=str(tmp_path / "no-nvcc"))
    assert not list((tmp_path / "build").rglob("*.so"))
