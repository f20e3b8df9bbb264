"""The readings that the correctness limits are set from, on the card at
a cell's own size: for each seed one run of the cell (a short window at
its own load), the widest gap of the served tokens of each model (the
program's reading), and on the same sample the widest gap of the tokens
that the reference computed in float8 e4m3 puts first (the control's).
All seeds run in one process.

    python3 bench/control.py --workload jamba.mix.over --seconds 8 \
        --seeds 11,12,13 [--control 11,12,13] [--raw gaps.jsonl]

Prints one JSON line a seed: {"seed", "correct", "checks" (each number
compared), "gaps": {role: {"program": quantiles, "control": quantiles}}
(for the seeds in --control)}. ``--raw`` also writes, for those seeds,
every sampled token's gap, the control's gap, its request and its
engine slot, one JSON line a seed, to the file named.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--raw", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench.gen import traffic as T
    from bench.harness import cells, main as M

    dev = torch.device("cuda", 0)
    bench = cells.benchmark()
    cell = cells.cell(bench, args.workload)
    conf = cells.config(bench, cell["config"])
    traffic = T.load(cell["traffic"])
    lim = cells.limits(cell["config"])
    ctl = {int(s) for s in args.control.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        out = M.run_cell(conf, traffic, lim, seed, args.seconds, False, dev,
                         time.perf_counter(), {}, {}, control=seed in ctl)
        row = {"seed": seed, "correct": out["correct"],
               "gaps": out.get("_control", {}),
               "checks": {k: v["value"] for k, v in out["checks"].items()},
               "notes": out["_notes"]}
        print(json.dumps(row), flush=True)
        if args.raw and "_raw" in out:
            with open(args.raw, "a") as f:
                f.write(json.dumps({"seed": seed, **out["_raw"]}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
