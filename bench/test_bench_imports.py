"""Nothing the benchmark runs may load JAX or the JAX package, and the
reference may load nothing of the program: each is checked on the
imports the sources name (whole top-level names) and on the modules a
fresh interpreter holds after importing the benchmark."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if not p.name.startswith("test_"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_no_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & (FORBIDDEN | {"repro_torch", "bench"}), tops


def test_loaded_modules():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import bench.reference.models, bench.reference.router\n"
        "ref = sorted({n.split('.')[0] for n in sys.modules})\n"
        "import bench.harness.main, bench.sweep, bench.control\n"
        "from bench.harness import cells\n"
        "for m in cells.benchmark()['per_layer'] + "
        "cells.benchmark()['end_to_end']:\n"
        "    cells.reader(m['name'])\n"
        "import repro_torch.serving, repro_torch.models.lm\n"
        "print(json.dumps([ref, bench.harness.main.forbidden_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    ref, bad = json.loads(out.strip().splitlines()[-1])
    assert bad == []
    assert "repro_torch" not in ref and not set(ref) & FORBIDDEN
