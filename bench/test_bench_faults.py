"""The harness's own run, on the CPU at a tiny size (the port's smoke
widths, ``bench/testdata``), with the timed path broken underneath:
``correct`` must come out false for each fault a serving cell can have,
and true without one. The harness's look for a card is skipped: the run
is driven through ``run_cell`` on the CPU.

``tiny-jamba`` puts the faults in the code only its cloud model runs (the
MoE and the Mamba decode step), and each must fail one of the statistics
that hold that model in the shipped cell (``p50``, ``p80``, ``slot_p50``
of its gaps): a fault confined to one slot of eight, or to half the
batch, moves no median of the whole."""
import json
import time
from pathlib import Path

import pytest
import torch

from bench.gen import traffic as T
from bench.harness import main as M

DATA = Path(__file__).parent / "testdata"


@pytest.fixture(autouse=True)
def _one_thread():
    """The tiny model's ops are small: one thread keeps the run short when
    other test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(config="tiny-dense", limits="tiny-limits",
         traffic="paper-mix.over-dense"):
    conf = json.loads((DATA / f"{config}.json").read_text())
    lim = json.loads((DATA / f"{limits}.json").read_text())
    # enough requests at once to fill the upper half of every batch, with
    # budgets cut to 8 tokens so the run stays short on a loaded CPU
    spec = dict(T.load(traffic), rate_rps=30.0, pool=128, max_new_tokens=8)
    return M.run_cell(conf, spec, lim, 2**31 + 17, 1.5, False,
                      torch.device("cpu"), time.perf_counter(),
                      {"tokens_per_s": "tokens/s"}, {}, follow_cap=300.0)


def _state_unchanged(orig):
    def step(model, cfg, token, cache, materialize=None):
        logits, _ = orig(model, cfg, token, cache, materialize)
        return logits, cache            # kv_len not advanced
    return step


def _half_batch(orig):
    def step(model, cfg, token, cache, materialize=None):
        logits, new = orig(model, cfg, token, cache, materialize)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:] = logits[:1]         # the second half left out
        return logits, new
    return step


def _token_altered(orig):
    calls = [0]

    def step(model, cfg, token, cache, materialize=None):
        logits, new = orig(model, cfg, token, cache, materialize)
        calls[0] += 1
        if calls[0] % 3 == 0:
            logits = logits.clone()
            logits[:, 7] = logits.max() + 1.0
        return logits, new
    return step


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch",
                                   "token_altered", "route_altered"])
def test_correct_only_without_a_fault(fault, monkeypatch):
    from repro_torch.core import router
    from repro_torch.models import lm

    faults = {"state_unchanged": _state_unchanged,
              "half_batch": _half_batch, "token_altered": _token_altered}
    if fault in faults:
        monkeypatch.setattr(lm, "decode_step", faults[fault](lm.decode_step))
    elif fault == "route_altered":
        orig = router.RequestRouter.route

        def route(self, req, *a, **k):
            d = orig(self, req, *a, **k)
            if self._n_routed % 4 == 0:
                d.pair = (d.pair + 3) % len(self._pair_node)
            return d
        monkeypatch.setattr(router.RequestRouter, "route", route)
    out = _run()
    assert out["correct"] is (fault is None), out["checks"]
    assert out["attempted"] > 0


def _mamba_state_unchanged(orig):
    def step(p, cfg, x, state):
        y, _ = orig(p, cfg, x, state)
        return y, tuple(t.clone() for t in state)   # the state not advanced
    return step


def _moe_decode(rows):
    """The MoE's output at a decode step (one token a row) with ``rows``
    of the batch broken."""
    from repro_torch.models import moe

    orig = moe.moe_apply

    def apply(p, cfg, x):
        y, aux = orig(p, cfg, x)
        if x.shape[1] == 1 and x.shape[0] > 1:
            y = rows(y.clone())
        return y, aux
    return apply


def _half_batch_mean(y):
    h = y.shape[0] // 2
    y[h:] = y[:h].mean(0, keepdim=True)     # half left out, the rest's mean
    return y


def _one_slot(y):
    y[0] = 0                                # slot 0's experts left out
    return y


@pytest.mark.parametrize("fault", [None, "mamba_state_unchanged",
                                   "moe_half_batch", "moe_one_slot"])
def test_cloud_faults_fail_the_cloud_statistic(fault, monkeypatch):
    from repro_torch.models import lm, moe

    if fault == "mamba_state_unchanged":
        monkeypatch.setitem(lm._STEP, "mamba",
                            _mamba_state_unchanged(lm._STEP["mamba"]))
    elif fault == "moe_half_batch":
        monkeypatch.setattr(moe, "moe_apply", _moe_decode(_half_batch_mean))
    elif fault == "moe_one_slot":
        monkeypatch.setattr(moe, "moe_apply", _moe_decode(_one_slot))
    out = _run("tiny-jamba", "tiny-jamba-limits", "paper-mix.over-jamba")
    cloud = {k: c for k, c in out["checks"].items() if k.endswith(".cloud")}
    assert set(cloud) == {"gap_p50.cloud", "gap_p80.cloud",
                          "gap_slot_p50.cloud"}
    failed = {k for k, c in cloud.items() if c["value"] > c["limit"]}
    assert bool(failed) is (fault is not None), out["checks"]
    if fault == "moe_one_slot":
        # one slot of eight: the median of the whole stays, the slot's not
        # (the p80 may or may not move, by how many of its tokens were read)
        assert "gap_slot_p50.cloud" in failed, out["checks"]
        assert "gap_p50.cloud" not in failed, out["checks"]
    assert out["correct"] is (fault is None), out["checks"]
