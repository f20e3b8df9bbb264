"""The port's routing loop end to end on the CPU, held against the JAX
package: the baselines must score the same, and the genome the port's
NSGA-II picks, re-scored by the reference evaluator, must give the port's
own Table II row."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.cluster.spec import paper_testbed as ref_testbed
from repro.core import baselines as ref_baselines
from repro.core.fitness import EvalConfig as RefEvalConfig
from repro.core.fitness import TraceEvaluator as RefEvaluator
from repro.workload.trace import build_trace as ref_build_trace
from repro_torch.kernels import dominance
from repro_torch.quickstart import format_table, run_quickstart

N_REQ, POP, GENS = 60, 16, 3
RTOL = 1e-5   # f32 means taken in another order than XLA's
KEYS = ("avg_quality", "avg_response_time", "avg_cost", "RQ", "violation",
        "avg_ttft", "avg_tpot")


@functools.lru_cache(maxsize=None)
def _runs():
    before = dominance.LAUNCHES
    res = run_quickstart(device="cpu", n_requests=N_REQ, pop_size=POP,
                         n_generations=GENS)
    assert dominance.LAUNCHES == before     # CPU: the plain version ran
    tr = ref_build_trace(N_REQ, seed=0)
    return res, tr, RefEvaluator(tr, ref_testbed(),
                                 RefEvalConfig(concurrency=1))


def _close(row, ref_row):
    for k in KEYS:
        np.testing.assert_allclose(row[k], ref_row[k], rtol=RTOL, atol=1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("name,fn", [
    ("Cloud Only", "cloud_only"), ("Edge Only", "edge_only"),
    ("Random Router", "random_router"),
    ("Round Robin Router", "round_robin")])
def test_baseline_rows_match_reference(name, fn):
    res, tr, ref = _runs()
    assign = getattr(ref_baselines, fn)(tr, ref_testbed())
    _close(res.rows[name], ref.summarize(ref.run_assignment(
        jnp.asarray(assign))))


def test_chosen_genome_rescored_by_reference():
    res, _, ref = _runs()
    want = ref.summarize(ref.run_thresholds(jnp.asarray(res.genome,
                                                        jnp.float32)))
    _close(res.rows["Proposed Router"], want)


def test_quickstart_shape_and_choice():
    res, _, _ = _runs()
    assert list(res.rows) == ["Cloud Only", "Edge Only", "Random Router",
                              "Round Robin Router", "Proposed Router"]
    assert res.state.generation == GENS
    assert res.state.genomes.shape == (POP, 6)
    assert int(res.state.rank[res.index]) == 0
    assert float(res.state.violation[res.index]) <= 0
    assert np.isfinite(res.state.F_raw.numpy()).all()
    assert set(res.overall) == set(res.rows)
    assert len(format_table(res).splitlines()) == 6
