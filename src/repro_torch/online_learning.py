"""Online-learned estimators against static priors under drift and
stragglers, on the port: the counterpart of ``benchmarks/online_learning.py``.

The static pair tables the router plans with know nothing about runtime
conditions: a straggling node serves every token 3-4x slower than its
table entry. Per-(node, category) online estimators (``learn/``) observe
realized TTFT and TPOT, learn multiplicative residuals and override the
estimate rows every policy reads. This measures what closing that loop is
worth.

Scenario: calm code-heavy window 0, then math-heavy longer-prompt windows
at a higher rate, with unannounced stragglers (the cloud node at 3x, the
first edge node at 4x). The windows are served back to back through the
DES (``cluster.simulator``) with the learner state carried across windows
(``SimResult.learn_state`` -> ``run(learn_state=)``), for ``slo`` x
{static, learned (EWMA)} and ``bandit`` x {static, learned (BLR)}.

Reported per (policy, variant, window): mean quality, cost and RT, SLO
attainment and the estimator error (MAE of the prefill and TPOT estimates
each decision acted on against the realized values; ``nan`` for static
variants); per policy the post-drift min-max composite of the two variants
and whether the learned MAE fell over the run.

    PYTHONPATH=src python -m repro_torch.online_learning [--smoke]
        [--write DIR]

The DES is numpy on the host: nothing here runs on a device. It prints the
reference's rows and writes ``online_learning.csv`` and
``BENCH_learning.json`` only into ``--write DIR``.
"""
from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .cluster.simulator import ClusterSimulator
from .cluster.spec import paper_testbed
from .core.policies import get_policy
from .faults import FaultSchedule, Straggler
from .learn import LearnConfig
from .workload.arrivals import PhaseSpec, build_open_loop_trace
from .workload.slo import attach_slos

# (policy, learner kind): the EWMA pairs with the deadline-feasibility
# policy, the BLR with the bandit (its LinUCB width is the BLR posterior's)
VARIANTS = (("slo", "ewma"), ("bandit", "blr"))

# the cloud node and the first edge node straggle; static tables see neither
STRAGGLERS = FaultSchedule(stragglers=(Straggler(0, 0.0, 1e9, 3.0),
                                       Straggler(1, 0.0, 1e9, 4.0)))


def sizes(smoke: bool) -> Tuple[int, int]:
    """(requests a window, windows): the reference's --smoke sizes or its
    full ones."""
    return (20, 3) if smoke else (60, 4)


def phases(n_windows: int) -> List[PhaseSpec]:
    """A calm code-heavy window, then math-heavy longer prompts at a
    moderate rate (below saturation, so routing decides outcomes)."""
    return [PhaseSpec(rate=1.5, duration=1e9, mix=(0.70, 0.10, 0.10, 0.10))
            ] + [PhaseSpec(rate=2.5, duration=1e9,
                           mix=(0.10, 0.70, 0.10, 0.10),
                           length_scale=1.5)] * (n_windows - 1)


def _windows(seed: int, smoke: bool):
    n, w = sizes(smoke)
    out = []
    for k, ph in enumerate(phases(w)):
        tr = build_open_loop_trace(n, (ph,), seed=seed * 100 + k)
        attach_slos(tr, tightness=1.0, seed=seed * 100 + k)
        out.append(tr)
    return out


def run_variant(policy: str, learned: bool, kind: str, seed: int = 0,
                smoke: bool = False):
    """Serve all windows back to back, carrying learner state across them;
    per window (quality, cost, rt, attainment, mae_ttft, mae_tpot)."""
    cluster = paper_testbed()
    genome = get_policy(policy).genome_spec.defaults
    state = None
    rows = []
    for tr in _windows(seed, smoke):
        sim = ClusterSimulator(tr, cluster, faults=STRAGGLERS,
                               learned=learned, learner=LearnConfig(kind=kind))
        res = sim.run(policy=policy, genome=genome, learn_state=state)
        if learned:
            state = res.learn_state
        if res.est_prefill is None:
            mae_p = mae_t = float("nan")
        else:
            mae_p = float(np.mean(np.abs(np.asarray(res.est_prefill)
                                         - np.asarray(res.real_prefill))))
            mae_t = float(np.mean(np.abs(np.asarray(res.est_tpot)
                                         - np.asarray(res.real_tpot))))
        rows.append((float(res.q.mean()), float(res.cost.mean()),
                     float(res.rt.mean()),
                     res.slo_attainment(tr.ttft_deadline, tr.tpot_deadline),
                     mae_p, mae_t))
    return rows


def _post_drift_mean(rows):
    """Mean (quality, cost, rt, attainment) over the post-drift windows."""
    return np.mean(np.asarray(rows, np.float64)[1:, :4], axis=0)


def _composite(static_m, learned_m):
    """Min-max composite over (quality up, cost down, rt down, attainment
    up) between the two variants of one policy."""
    arr = np.stack([static_m, learned_m])

    def norm(col, larger_better):
        rng = col.max() - col.min()
        if rng <= 1e-12:
            return np.full_like(col, 0.5)
        n = (col - col.min()) / rng
        return n if larger_better else 1.0 - n

    comp = (norm(arr[:, 0], True) + norm(arr[:, 1], False)
            + norm(arr[:, 2], False) + norm(arr[:, 3], True)) / 4.0
    return float(comp[0]), float(comp[1])


HEADER = ["policy", "variant", "learner", "window", "avg_quality",
          "avg_cost", "avg_rt_s", "slo_attainment", "mae_ttft", "mae_tpot"]


def run(seed: int = 0, smoke: bool = False,
        write: Optional[Path] = None) -> Tuple[List[List[str]], Dict]:
    """(csv rows, verdicts per policy), as the reference's ``run``; with
    ``write`` the CSV and the JSON record go into that directory."""
    csv_rows = []
    verdicts = {}
    for policy, kind in VARIANTS:
        per = {}
        for learned in (False, True):
            rows = run_variant(policy, learned, kind, seed=seed, smoke=smoke)
            per[learned] = rows
            variant = "learned" if learned else "static"
            for k, r in enumerate(rows):
                csv_rows.append([policy, variant, kind if learned else "-", k,
                                 f"{r[0]:.4f}", f"{r[1]:.4e}", f"{r[2]:.4f}",
                                 f"{r[3]:.4f}", f"{r[4]:.4f}", f"{r[5]:.4f}"])
        c_static, c_learned = _composite(_post_drift_mean(per[False]),
                                         _post_drift_mean(per[True]))
        maes_p = [r[4] for r in per[True]]
        maes_t = [r[5] for r in per[True]]
        verdicts[policy] = {
            "kind": kind,
            "composite_static": c_static,
            "composite_learned": c_learned,
            "learned_beats_static": c_learned > c_static,
            "attainment_static": float(_post_drift_mean(per[False])[3]),
            "attainment_learned": float(_post_drift_mean(per[True])[3]),
            "mae_ttft_by_window": maes_p,
            "mae_tpot_by_window": maes_t,
            "mae_ttft_decreasing": maes_p[-1] < maes_p[0],
        }
    if write is not None:
        n, w = sizes(smoke)
        suffix = "_smoke" if smoke else ""
        write = Path(write)
        write.mkdir(parents=True, exist_ok=True)
        with open(write / f"online_learning{suffix}.csv", "w",
                  newline="") as f:
            csv.writer(f).writerows([HEADER] + csv_rows)
        with open(write / f"BENCH_learning{suffix}.json", "w") as f:
            json.dump({"window_requests": n, "n_windows": w,
                       "stragglers": [[s.node, s.factor]
                                      for s in STRAGGLERS.stragglers],
                       "policies": verdicts}, f, indent=2, sort_keys=True)
            f.write("\n")
    return csv_rows, verdicts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's --smoke sizes (3 windows of 20)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--write", type=Path, default=None,
                    help="directory for the CSV and the JSON record")
    args = ap.parse_args(argv)
    rows, verdicts = run(args.seed, args.smoke, args.write)
    print(",".join(HEADER))
    for r in rows:
        print(",".join(str(x) for x in r))
    for policy, v in verdicts.items():
        print(f"online_learning.{policy}.composite,,"
              f"static={v['composite_static']:.4f} "
              f"learned={v['composite_learned']:.4f} "
              f"attain={v['attainment_static']:.3f}->"
              f"{v['attainment_learned']:.3f}")
        print(f"online_learning.{policy}.mae_ttft,,"
              + " ".join(f"{m:.4f}" for m in v["mae_ttft_by_window"]))
    # the estimator must converge (its error falls), even at tiny sizes
    for policy, v in verdicts.items():
        assert v["mae_ttft_decreasing"], \
            f"{policy} estimator error did not decrease over the run"
    if not args.smoke:   # tiny windows: the composite verdicts are unstable
        for policy in ("bandit", "slo"):
            assert verdicts[policy]["learned_beats_static"], \
                f"{policy} with learned estimates did not beat its static prior"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
