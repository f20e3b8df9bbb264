"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``bench/configs/<config>.json``), its traffic
(``bench/traffic/<traffic>.json``), its correctness limits
(``bench/limits/<config>.json``) and the readers of its per-layer metrics
(``bench/metrics/<metric>.py``)."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def limits(config_name: str) -> Dict[str, float]:
    return json.loads((BENCH / "limits" / f"{config_name}.json").read_text())


def metrics_of(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell_name``
    reports."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str) -> Callable:
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    mod_name = "bench.metrics." + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(
        mod_name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
