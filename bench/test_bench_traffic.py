"""The benchmark's frozen copies held bit for bit to the program's
originals: the request mix, the Poisson arrivals, the server's tokenizer,
and the routing reference (classifier, complexity score, Algorithm 2,
the testbed's pair table); and the traffic generator's seeds changing the
order of the work, never its size."""
import dataclasses
from collections import Counter

import numpy as np
import pytest

from bench.gen import paper_mix, traffic
from bench.reference import router as R
from bench.reference.tokenizer import tokenize

SEEDS = (0, 1, 7, 2**31 + 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_mix_equals_build_trace(seed):
    from repro_torch.workload.trace import build_trace

    mine = paper_mix.round_robin(203, seed=seed)
    theirs = build_trace(203, seed=seed).requests
    assert [dataclasses.asdict(r) for r in mine] == \
        [dataclasses.asdict(r) for r in theirs]


@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_equals_arrivals(seed):
    from repro_torch.workload.arrivals import poisson_arrivals

    a = paper_mix.poisson_arrivals(500, 7.5, seed=seed)
    b = poisson_arrivals(500, 7.5, seed=seed)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_tokenizer_equals_servers():
    from repro_torch.serving.scheduler import PROMPT_CAP, tokenize as theirs
    from repro_torch.workload.datasets import Request

    for r in paper_mix.round_robin(120, seed=3):
        for vocab in (512, 50304, 151936):
            got = tokenize(r.text, r.prompt_tokens, vocab, PROMPT_CAP)
            want = theirs(Request(**dataclasses.asdict(r)), vocab,
                          PROMPT_CAP).tolist()
            assert got == want


def test_testbed_equals_paper_testbed():
    import json
    from pathlib import Path

    from repro_torch.cluster.spec import paper_testbed

    tb = json.loads((Path(__file__).parent / "configs" /
                     "testbed-dense.json").read_text())["testbed"]
    bed = R.Testbed(tb)
    arr = paper_testbed().arrays_numpy()
    assert bed.pair_node == arr["pair_node"].tolist()
    assert bed.fallback == int(arr["cloud_fallback_pair"])
    ebt = arr["edge_pairs_by_type"]
    for t in range(len(R.TYPES)):
        assert bed.edge_by_type[t] == [p for p in ebt[t].tolist() if p >= 0]


def test_routing_reference_equals_router():
    """Algorithm 2 on the same requests, queues and classifier stream."""
    from repro_torch.cluster.spec import ClusterArrays, paper_testbed
    from repro_torch.core.policies.threshold import (PAPER_DEFAULTS,
                                                     decide_pair_py)
    from repro_torch.workload.classifier import classify
    from repro_torch.workload.features import complexity_score

    import json
    from pathlib import Path

    tb = json.loads((Path(__file__).parent / "configs" /
                     "testbed-jamba.json").read_text())["testbed"]
    assert np.asarray(tb["thresholds"], np.float32).tobytes() == \
        PAPER_DEFAULTS.tobytes()
    bed = R.Testbed(tb)
    arrays = ClusterArrays(**paper_testbed().arrays_numpy())
    mine, theirs = np.random.default_rng(0), np.random.default_rng(0)
    qrng = np.random.default_rng(11)
    for r in paper_mix.round_robin(400, seed=5):
        queue = tuple(int(x) for x in qrng.integers(0, 9, size=4))
        cat, conf = classify(r, theirs)
        want = decide_pair_py(
            PAPER_DEFAULTS, complexity=float(np.float32(
                complexity_score(r, cat))), pred_category=cat,
            pred_conf=float(np.float32(conf)), queue_len=queue,
            arrays=arrays)
        assert R.decide(bed, r, queue, mine) == want


def test_seeds_permute_the_same_work():
    spec = dict(traffic.load("paper-mix.over-dense"), pool=400)
    a, b = traffic.schedule(spec, 1), traffic.schedule(spec, 2**31 + 9)
    assert a == traffic.schedule(spec, 1)
    key = lambda s: Counter((x.req.text, x.max_new_tokens) for x in s)
    assert key(a) == key(b)
    assert [x.due_s for x in a] == [x.due_s for x in b]
    assert [x.req.dataset for x in a] == [x.req.dataset for x in b]
    assert [x.req.text for x in a] != [x.req.text for x in b]


@pytest.mark.parametrize("name", ["paper-mix.over-dense",
                                  "paper-mix.over-jamba",
                                  "paper-mix.knee80-jamba"])
def test_traffic_files_load(name):
    spec = traffic.load(name)
    s = traffic.schedule(dict(spec, pool=64), 3)
    assert all(1 <= x.max_new_tokens <= spec["max_new_tokens"] for x in s)
    assert all(x.due_s > 0 for x in s)
