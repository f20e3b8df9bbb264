"""Whether a MoE model's wide gaps come from expert choices that turn on
rounding. The port's engine serves the first requests of a cell's
traffic on the cell's cloud model (prefill, then one decode step at a
time over its slots) with its MoE routing recorded
(``repro_torch.models.moe.ROUTING``); the float32 reference is then run
teacher forced over the served tokens twice: with its own top-k, and
with the program's expert choices forced. At every served token it
reads the gap (the reference's best logit less the served token's).

    python3 bench/witness_moe.py --workload jamba.mix.over --seeds 1,2,3 \
        --n 24

Prints one JSON line a seed: the widest gap with the reference's own
experts and with the program's, the positions where the two choose
other experts (``differ``: at the rows whose logits are read;
``differ_prompt``: at the prompt's earlier positions, a count over the MoE
layers), how many gaps over ``--wide`` there are and how many of those
sit at such a row, and the largest router margin among the rows whose
choices differ.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def serve(side, prompts, budgets, ecfg, dev):
    """The engine's tokens for each prompt and, per request, {MoE layer:
    (positions, k) expert ids} at every position the reference runs."""
    import numpy as np
    import torch

    from repro_torch.models import lm, moe
    from repro_torch.serving import LLMEngine

    moe_layers = [i for i, (_, f) in enumerate(side.m.layers) if f == "moe"]
    eng = LLMEngine(side.cfg, side.lm, ecfg, device=dev)
    log = []
    orig_p, orig_d = lm.prefill, lm.decode_step

    def prefill(model, cfg, tokens, *a, **k):
        i0 = len(moe.ROUTING)
        out = orig_p(model, cfg, tokens, *a, **k)
        log.append(("prefill", tokens[0].tolist(), i0))
        return out

    def decode_step(model, cfg, token, cache, *a, **k):
        rows = [(s.request_id, len(s.generated)) for s in eng.slots]
        i0 = len(moe.ROUTING)
        out = orig_d(model, cfg, token, cache, *a, **k)
        log.append(("decode", rows, i0))
        return out

    moe.ROUTING = []
    lm.prefill, lm.decode_step = prefill, decode_step
    try:
        for rid, (p, b) in enumerate(zip(prompts, budgets)):
            eng.submit(rid, np.asarray(p, np.int32), max_new_tokens=b)
        eng.run_to_completion(chunk=1)
        torch.cuda.synchronize(dev)
        routing = [(e.cpu(), int(d)) for e, d in moe.ROUTING]
    finally:
        lm.prefill, lm.decode_step = orig_p, orig_d
        moe.ROUTING = None
    tokens = [list(eng.results[r]["tokens"]) for r in range(len(prompts))]
    k = side.m.moe.top_k
    forced = [{l: torch.zeros(len(p) + len(t) - 1, k, dtype=torch.int64)
               for l in moe_layers} for p, t in zip(prompts, tokens)]
    done = set()
    drops = 0
    for kind, info, i0 in log:
        entries = routing[i0:i0 + len(moe_layers)]
        drops += sum(d for _, d in entries) if kind == "decode" else 0
        if kind == "prefill":
            rid = next(r for r, p in enumerate(prompts)
                       if r not in done and p == info[:len(p)])
            done.add(rid)
            for layer, (e, _) in zip(moe_layers, entries):
                forced[rid][layer][:len(prompts[rid])] = e[:len(prompts[rid])]
            continue
        for row, (rid, g) in enumerate(info):
            if rid is None:
                continue
            pos = len(prompts[rid]) + g - 1
            if pos < forced[rid][moe_layers[0]].shape[0]:
                for layer, (e, _) in zip(moe_layers, entries):
                    forced[rid][layer][pos] = e[row]
    return tokens, forced, drops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--wide", type=float, default=0.18)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import gc

    import torch

    from repro_torch.serving import EngineConfig
    from bench.gen import traffic as T
    from bench.harness import cells, port
    from bench.reference.models import Ref
    from bench.reference.tokenizer import tokenize

    dev = torch.device("cuda", 0)
    bench = cells.benchmark()
    cell = cells.cell(bench, args.workload)
    conf = cells.config(bench, cell["config"])
    traffic = T.load(cell["traffic"])
    tb = conf["testbed"]
    e = tb["engine"]
    ecfg = EngineConfig(max_slots=e["max_slots"], max_seq=e["max_seq"],
                        prefill_bucket=e["prefill_bucket"])
    for seed in (int(s) for s in args.seeds.split(",")):
        sides = port.build_models(conf, seed, dev)
        side = sides["cloud"]
        sched = T.schedule(traffic, seed)[:args.n]
        prompts = [tokenize(a.req.text, a.req.prompt_tokens, side.m.vocab,
                            tb["prompt_cap_words"]) for a in sched]
        budgets = [a.max_new_tokens for a in sched]
        tokens, forced, drops = serve(side, prompts, budgets, ecfg, dev)
        side.lm = None
        del sides["edge"]
        gc.collect()
        torch.cuda.empty_cache()
        row = {"seed": seed, "requests": len(prompts),
               "tokens": sum(map(len, tokens)), "decode_drops": drops}
        gaps = {"own": [], "forced": []}
        differ, margin = [], []
        for b in range(0, len(prompts), 8):
            ids = range(b, min(b + 8, len(prompts)))
            seqs = [prompts[i] + tokens[i][:-1] for i in ids]
            lens = [len(prompts[i]) for i in ids]
            S = max(map(len, seqs))
            for mode in ("own", "forced"):
                ref = Ref(side.m, side.W, "f32", dev)
                if mode == "forced":
                    ref.force = {}
                    for layer in forced[0]:
                        f = torch.tensor([0, 1]).repeat(len(seqs), S, 1)
                        for j, i in enumerate(ids):
                            f[j, :len(seqs[j])] = forced[i][layer]
                        ref.force[layer] = f
                with torch.no_grad():
                    lg = ref.logits(seqs, lens)
                for j, i in enumerate(ids):
                    pick = torch.tensor(tokens[i], device=dev)
                    best = lg[j].max(-1).values
                    got = lg[j].gather(1, pick[:, None])[:, 0]
                    gaps[mode] += (best - got).tolist()
                if mode == "own":
                    margin += [x for j in range(len(seqs))
                               for x in ref.margins[j].tolist()]
                    # the reference's own top-k at every row it reads
                    for j, i in enumerate(ids):
                        rows = range(lens[j] - 1, len(seqs[j]))
                        d = [False] * len(rows)
                        for layer in forced[i]:
                            mine = ref.topk[layer][j, list(rows)].tolist()
                            prog = forced[i][layer][list(rows)]
                            for r in range(len(rows)):
                                if set(mine[r]) != set(prog[r].tolist()):
                                    d[r] = True
                        differ += d
                        for layer in forced[i]:
                            mine = ref.topk[layer][j, :lens[j] - 1].tolist()
                            prog = forced[i][layer][:lens[j] - 1].tolist()
                            row["differ_prompt"] = row.get(
                                "differ_prompt", 0) + sum(
                                set(a) != set(c) for a, c in zip(mine, prog))
        wide = [k for k, g in enumerate(gaps["own"]) if g > args.wide]
        row.update({
            "max_own": max(gaps["own"]), "max_forced": max(gaps["forced"]),
            "max_own_where_same": max([g for g, d in zip(gaps["own"], differ)
                                       if not d], default=0.0),
            "positions": len(differ), "differ": sum(differ),
            "wide": len(wide), "wide_at_differ": sum(differ[k] for k in wide),
            "max_margin_where_differ": max(
                [m for m, d in zip(margin, differ) if d], default=0.0),
            "max_forced_where_differ": max(
                [g for g, d in zip(gaps["forced"], differ) if d],
                default=0.0)})
        print(json.dumps(row), flush=True)
        del side
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
