"""The benchmark's arithmetic on hand-made runs: percentiles over every
request with the unfinished counted, the window's accounting of tokens
and spans, the program's counters, the decode kernel's bytes, the
models' FLOPs, and the shares read from a trace."""
import math
from types import SimpleNamespace

import pytest

from bench.gen.traffic import Arrival
from bench.harness.drive import Loop, Progress, Rec, Span
from bench.harness.main import Run
from bench.metrics import _count as C
from bench.metrics import _read
from bench.reference import spec as S

DENSE = S.Model(d=8, d_ff=16, n_layers=2, n_heads=4, n_kv_heads=2,
                head_dim=2, vocab=10, eps=1e-5, rope_theta=1e4,
                qk_norm=False, tie=False, layers=(("attn", "dense"),) * 2)


def _rec(i, due, L, first=None, done=None, ntok=0, budget=3):
    r = Rec(Arrival(i, due, None, budget), L)
    r.t_first, r.t_done, r.ntok = first, done, ntok
    return r


def _run(recs, n_due, seconds, progress=(), spans=(), c0=None, c1=None,
         trace=None, traced=None):
    loop = Loop(recs=recs, n_due=n_due, seconds=seconds,
                spans=list(spans), progress=list(progress))
    loop.counters0, loop.counters1 = c0 or {}, c1 or {}
    loop.traced = traced
    return Run(loop, 1.5, trace, {"cloud": DENSE, "edge": DENSE},
               ["cloud", "edge"])


@pytest.mark.parametrize("vals,q,want", [
    ([1.0], 95, 1.0), (list(range(1, 21)), 95, 19), (list(range(1, 21)), 50,
                                                        10),
    ([5.0, 1.0, math.inf, 2.0], 95, math.inf), ([3.0, 1.0, 2.0], 0, 1.0)])
def test_percentile_nearest_rank(vals, q, want):
    assert C.percentile(vals, q) == want


def test_ttft_counts_every_request_due_unfinished_as_infinite():
    recs = [_rec(i, 0.1 * i, 4, first=0.1 * i + 0.05 * (i + 1))
            for i in range(19)] + [_rec(19, 1.9, 4)]
    run = _run(recs + [_rec(20, 2.5, 4, first=9.0)], 20, 2.0)
    assert _read.ttft_p95_ms(run) == pytest.approx(950.0)   # 19th of 20
    recs[18].t_first = None
    assert _read.ttft_p95_ms(run) == math.inf


def test_tpot_over_tokens_after_the_first():
    recs = [_rec(0, 0.0, 4, first=1.0, done=2.0, ntok=5),
            _rec(1, 0.0, 4, first=1.0, done=1.5, ntok=2)]
    run = _run(recs, 2, 5.0)
    assert _read.tpot_p95_ms(run) == pytest.approx(500.0)
    recs[1].t_done = None
    assert _read.tpot_p95_ms(run) == math.inf


def test_tokens_in_window_take_each_requests_best_copy():
    prog = [Progress(0.5, 0, 0, 0, 1), Progress(1.0, 0, 0, 1, 5),
            Progress(1.2, 3, 0, 0, 3),          # a hedged copy, behind
            Progress(1.9, 1, 1, 0, 4), Progress(2.1, 1, 1, 4, 9)]
    run = _run([_rec(0, 0, 4), _rec(1, 0, 4)], 2, 2.0, progress=prog)
    assert _read.tokens_per_s(run) == pytest.approx((5 + 4) / 2.0)


def test_spans_in_the_window():
    spans = [Span("submit", 0.0, 0.001), Span("submit", 0.1, 0.103),
             Span("submit", 0.2, 0.202), Span("step", 0.3, 0.4),
             Span("step", 0.5, 0.7), Span("step", 0.9, 1.2)]
    run = _run([], 0, 1.0, spans=spans)
    assert _read.submit_us(run) == pytest.approx(2000.0)
    assert _read.tick_ms(run) == pytest.approx(150.0)


def test_admission_from_the_programs_counters():
    run = _run([], 0, 1.0, c0={"prefill_seconds": 1.0, "admissions": 10},
               c1={"prefill_seconds": 1.6, "admissions": 22})
    assert _read.admission_ms(run) == pytest.approx(50.0)
    same = _run([], 0, 1.0, c0={"prefill_seconds": 1.0, "admissions": 10},
                c1={"prefill_seconds": 1.0, "admissions": 10})
    assert _read.admission_ms(same) is None


def test_decode_bytes_by_hand():
    # 2 layers x (K and V: 2 x 7 positions x 2 heads x 2 dims x 2 bytes
    # + q and o: 2 x 4 heads x 2 dims x 2 bytes)
    assert C.decode_attn_bytes(DENSE, 7) == 2 * (2 * 7 * 2 * 2 * 2
                                                 + 2 * 4 * 2 * 2)
    # tokens 1 and 2 of a 4-token prompt attend 5 and 6 positions
    assert C.copy_work(DENSE, 4, 0, 3, "bytes") == \
        C.decode_attn_bytes(DENSE, 5) + C.decode_attn_bytes(DENSE, 6)


def test_flops_by_hand():
    # a layer: q 8x8, k and v 8x4 each, o 8x8; the FFN 3 x 8x16
    macs = 2 * (8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16)
    assert C.body_macs(DENSE) == macs
    assert C.decode_flops(DENSE, 5) == 2 * macs + 2 * 10 * 8 + \
        4 * 2 * 5 * 4 * 2
    assert C.prefill_flops(DENSE, 3) == 3 * 2 * macs + 2 * 10 * 8 + \
        sum(4 * 2 * p * 4 * 2 for p in (1, 2, 3))


def test_body_macs_match_the_ports_parameter_count():
    from repro_torch.configs import get

    cfg = get("qwen3-1.7b").config()
    m = S.model({"hidden_size": 2048, "intermediate_size": 6144,
                 "num_hidden_layers": 28, "num_attention_heads": 16,
                 "num_key_value_heads": 8, "head_dim": 128,
                 "vocab_size": 151936, "rms_norm_eps": 1e-5,
                 "rope_theta": 1e6, "tie_word_embeddings": False,
                 "qk_norm": True})
    pc = cfg.param_counts()
    norms = 28 * (2 * 2048 + 2 * 128)
    assert C.body_macs(m) == pc["active"] - pc["embed"] - pc["head"] - norms


def test_jamba_macs_by_hand():
    import json
    from pathlib import Path

    conf = json.loads((Path(__file__).parent / "configs" /
                       "testbed-jamba.json").read_text())
    m = S.model(conf)
    d, di, ff = 4096, 8192, 14336
    attn = d * 128 * (32 + 16) + 32 * 128 * d
    mamba = d * 2 * di + di * 4 + di * (256 + 32) + 256 * di + di * d
    moe = d * 16 + 2 * 3 * d * ff
    assert [x for x, _ in m.layers].count("attn") == 1
    assert C.body_macs(m) == attn + 7 * mamba + 4 * moe + 4 * 3 * d * ff


def test_mfu_over_the_window():
    prog = [Progress(0.5, 0, 0, 0, 2), Progress(3.0, 0, 0, 2, 3)]
    run = _run([_rec(0, 0, 4)], 1, 2.0, progress=prog)
    want = (C.prefill_flops(DENSE, 4) + C.decode_flops(DENSE, 5)) / 2.0
    assert _read.mfu(run) == pytest.approx(100 * want / C.PEAK_BF16_FLOPS)


def test_trace_shares():
    tr = {"window_s": 2.0, "busy_s": 0.5,
          "per_kernel": {"void split_decode_kernel<bf16>": 1e-6,
                         "gemm": 0.4}}
    prog = [Progress(1.0, 0, 0, 1, 3), Progress(5.0, 0, 0, 3, 4)]
    run = _run([_rec(0, 0, 4)], 1, 10.0, progress=prog, trace=tr,
               traced=(0.5, 2.5))
    assert _read.idle_share(run) == pytest.approx(75.0)
    need = C.copy_work(DENSE, 4, 1, 3, "bytes") / C.PEAK_HBM_BYTES
    assert _read.decode_attn_roofline(run) == pytest.approx(
        100 * need / 1e-6)
    untraced = _run([_rec(0, 0, 4)], 1, 10.0, progress=prog)
    assert _read.idle_share(untraced) is None
    assert _read.decode_attn_roofline(untraced) is None


def test_gap_statistics():
    from bench.harness.check import Gaps, quantiles, stat

    gap = [0.0] * 90 + [0.5] * 9 + [3.0]
    g = Gaps(gap, [0] * 100, [(0, i % 4) for i in range(100)])
    assert stat(g, "max") == 3.0
    assert stat(g, "p90") == 0.0 and stat(g, "p95") == 0.5
    q = quantiles(g)
    assert (q["p50"], q["p99"], q["max"], q["n"]) == (0.0, 0.5, 3.0, 100)
    assert (q["slot_p50"], q["slots"]) == (0.0, 4)
    # one slot's tokens wrong: under a fifth of all tokens, so the median
    # and p80 of the whole stay at 0, but that slot's median does not
    g = Gaps([0.0] * 90 + [2.0] * 10, [0] * 100,
             [(0, 0)] * 80 + [(0, 1)] * 10 + [(0, 2)] * 10)
    assert stat(g, "p50") == 0.0 and stat(g, "p80") == 0.0
    assert stat(g, "slot_p50") == 2.0


def test_sample_fills_each_slot_of_a_lone_engine():
    from bench.harness.check import SLOT_TOKENS, sample

    # the cloud (pair 0) serves 3-token requests from 4 slots, the edge
    # (pairs 1, 2) 20-token ones; the cloud's slot 3 served only two
    recs, fin = [], {}
    for i in range(80):
        cloud = i % 2 == 0
        slot = (0, (i // 2) % 4) if cloud else (1 + i % 3 % 2, i % 8)
        if cloud and slot[1] == 3 and i > 20:
            slot = (0, 0)
        r = Rec(Arrival(i, 0.0, SimpleNamespace(text="two plus two is",
                                                prompt_tokens=4), 3), 4)
        r.slot = slot
        recs.append(r)
        fin[i] = ("cloud" if cloud else "edge", [7] * (3 if cloud else 20))
    items = sample(fin, recs, 11, 24, {"cloud": 64, "edge": 64})
    held = {}
    for s in items:
        if s.role == "cloud":
            held[s.slot] = held.get(s.slot, 0) + len(s.tokens)
    assert held[(0, 3)] == 6
    assert all(held[(0, k)] >= SLOT_TOKENS for k in range(3)), held
    assert len({s.rid for s in items}) == len(items)


def test_queue_counted_from_the_harness_record():
    """A node's queue is the requests routed to it and not yet finished, as
    the harness sees them; the reference routes from that count, and the
    monitor's reading is held against it."""
    from types import SimpleNamespace

    from bench.harness import check
    from bench.harness.drive import Watch

    srv = SimpleNamespace(engines={}, done={})
    recs = [_rec(i, 0.1 * i, 4) for i in range(3)]
    w = Watch(srv, recs, [0, 1, 1, 1])
    for r, pair in zip(recs, (0, 2, 3)):
        r.queue = tuple(w.queue)
        r.monitor_queue = (0, 0)
        r.pair = pair
        w.routed(r)
    assert [r.queue for r in recs] == [(0, 0), (1, 0), (1, 1)]
    srv.done[1] = {"tokens": [1]}
    w.scan(1.0, [])
    assert w.queue == [1, 1] and recs[1].t_done == 1.0
    recs[0].monitor_queue = (0, 0)
    recs[1].monitor_queue = (1, 0)
    recs[2].monitor_queue = (1, 2)
    assert check.queue_wrong(recs, 3) == 1


def test_profiler_stop_is_taken_out():
    recs = [_rec(0, 1.0, 4, first=5.0, done=9.0, ntok=5),
            _rec(1, 6.0, 4, first=6.5, done=7.0, ntok=2)]
    run = _run(recs, 2, 10.0,
               progress=[Progress(5.0, 0, 0, 0, 1), Progress(9.0, 0, 0, 1, 5)])
    run.loop.pause = (2.0, 4.0)
    assert run.loop.paused(1.0, 5.0) == 2.0 and run.loop.paused(6.0, 7) == 0
    assert _read.ttft_p95_ms(run) == pytest.approx(2000.0)   # 4 s - 2 s
    assert _read.tpot_p95_ms(run) == pytest.approx(1000.0)
    want = (C.prefill_flops(DENSE, 4) + sum(C.decode_flops(DENSE, 4 + j)
                                            for j in range(1, 5))) / 8.0
    assert _read.mfu(run) == pytest.approx(100 * want / C.PEAK_BF16_FLOPS)
