"""Find a configuration's knee: the highest Poisson rate its cluster
serves with no growing backlog over the window.

    python3 bench/sweep.py --config testbed-dense --traffic paper-mix.over-dense \
        --rates 6,8,10,12 --seconds 20 [--seed 1]

One process builds the models once and runs the open loop at each rate
on a fresh server; for each it prints the served tokens/s, the backlog
(requests submitted and not finished) at half the window and at its
close, and the p95 times to first token and per output token. A rate's
backlog grows when the close holds more than ``GROWTH`` of the requests
due in the window beyond what the half held. Write the knee's rate, times
the cell's factor, into the cell's traffic file.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GROWTH = 0.05


def backlog(recs, t):
    sub = sum(r.t_submit >= 0 and r.t_submit <= t for r in recs)
    done = sum(r.t_done is not None and r.t_done <= t for r in recs)
    return sub - done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench.gen import traffic as T
    from bench.harness import cells, drive, main as M, port
    from bench.metrics import _read
    from bench.reference.tokenizer import tokenize

    dev = torch.device("cuda", 0)
    bench = cells.benchmark()
    conf = cells.config(bench, args.config)
    tb = conf["testbed"]
    rates = [float(r) for r in args.rates.split(",")]
    base = T.load(args.traffic)
    sides = port.build_models(conf, args.seed, dev)
    scheds = {r: T.schedule(dict(base, rate_rps=r), args.seed)
              for r in rates}
    M._warm(conf, sides, [a for r in rates for a in scheds[r]
                          if a.due_s < args.seconds], dev)
    pair_role = [tb["served_by"][n] for n in M._pair_models(tb)]
    print("rate_rps,due,tokens_per_s,backlog_half,backlog_close,grows,"
          "ttft_p95_ms,tpot_p95_ms,tick_ms,follow_s")
    for r in rates:
        srv = port.build_server(conf, sides, dev)
        sched = scheds[r]
        reqs = [M._request(a, a.index) for a in sched]
        recs = [drive.Rec(a, len(tokenize(a.req.text, a.req.prompt_tokens,
                                          2, tb["prompt_cap_words"])))
                for a in sched]
        loop = drive.run(srv, recs, args.seconds, tb["chunk"],
                         lambda q: reqs[q.arrival.index], M.pair_node(tb),
                         follow_cap=20.0)
        run = M.Run(loop, 0.0, None, {k: s.m for k, s in sides.items()},
                    pair_role)
        half = backlog(recs, args.seconds / 2)
        close = backlog(recs, args.seconds)
        grows = close - half > GROWTH * loop.n_due
        print(f"{r},{loop.n_due},{_read.tokens_per_s(run):.4f},{half},"
              f"{close},{int(grows)},{_read.ttft_p95_ms(run):.4f},"
              f"{_read.tpot_p95_ms(run):.4f},{_read.tick_ms(run):.4f},"
              f"{loop.follow_s:.3f}", flush=True)
        del srv
        time.sleep(0.5)
    print(json.dumps({"device": torch.cuda.get_device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
