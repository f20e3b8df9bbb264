"""On the card: each configuration at its own sizes, one short window at
its traffic's load (``testbed-dense`` too, whose cell is not in
``BENCHMARK.json``: its limits still hold). The program's gaps stay
inside the limits, and the control (the reference in float8 e4m3 in the
program's place) lands outside at least one of them. ``bench/control.py`` reads the same
numbers over many seeds; these tests hold one seed of each."""
import json
import time

import pytest

from bench.gen import traffic as T
from bench.harness import cells, main as M


@pytest.mark.card
@pytest.mark.parametrize("config,traffic", [
    ("testbed-dense", "paper-mix.over-dense"),
    ("testbed-jamba", "paper-mix.over-jamba")])
def test_control_fails_where_the_program_passes(config, traffic, card):
    lim = cells.limits(config)
    conf = json.loads((cells.BENCH / "configs" / f"{config}.json").read_text())
    out = M.run_cell(conf, T.load(traffic), lim, 2**31 + 101, 4.0, False,
                     card, time.perf_counter(), {}, {}, control=True)
    assert out["correct"], out["checks"]
    ctl = out["_control"]
    assert any(ctl[role]["control"][stat] > limit for role in ctl
               for stat, limit in lim[role].items()), ctl
