"""Whether what the timed path produced is right, judged once the window
has closed and the server's state is freed.

* **Tokens**: a sample of the requests due in the window that finished,
  drawn from the seed, the longest of each model among them and, for a
  model that one engine serves, from each of its slots requests until
  that slot holds ``SLOT_TOKENS`` served tokens (so that a slot's median
  is not the median of one short request's two or three tokens), at
  least ``SAMPLE_TOKENS`` served tokens in all. The reference runs each prompt (its
  tokens derived again from the text) with its served tokens, teacher
  forced, on the model that served it; at each served token it reads the
  gap by which that token's logit lies below its best logit. Each model's
  gaps are held by the statistics its limits file names (``max``, a
  nearest-rank ``p<q>``, or ``slot_p50``: the largest, over the engine
  slots that served its sampled requests, of the median gap of the tokens
  served from that slot), each to its limit. Every finished request must
  also have exactly its budget of tokens.
* **Routes**: every request due in the window was routed by Algorithm 2
  to the pair the routing reference picks from the request and the node
  queue lengths at that moment, as the harness counts them from its own
  record (the requests it saw routed to a node and not yet finished);
  and the server's monitor held those same lengths.
* **Answers**: every request due in the window finished.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..metrics._count import percentile
from ..reference import router as R
from ..reference.models import Ref
from ..reference.tokenizer import tokenize

SAMPLE_TOKENS = 384
SLOT_TOKENS = 16    # served tokens sampled from each slot of a lone engine
SAMPLE_MAX = 64
BLOCK = 16          # sequences the reference runs at once


@dataclasses.dataclass
class Served:
    rid: int
    role: str           # "cloud" | "edge": the model that served it
    prompt: List[int]
    tokens: List[int]
    slot: Optional[Tuple[int, int]] = None   # (pair, engine slot)


def served(srv, recs, n_due: int, pair_role: List[str]) -> Dict[int, Tuple[str, List[int]]]:
    """{request id: (role of the engine that finished it, its tokens)} for
    every request due in the window that finished."""
    out = {}
    for rid in range(n_due):
        res = srv.done.get(rid)
        if res is None or "tokens" not in res:
            continue
        pair = next(p for p, e in srv.engines.items()
                    if e.results.get(rid) is res)
        out[rid] = (pair_role[pair], list(res["tokens"]))
    return out


def sample(fin: Dict[int, Tuple[str, List[int]]], recs, seed: int,
           cap: int, vocab: Dict[str, int]) -> List[Served]:
    """The seed's sample of finished requests: the longest of each model,
    for a model that one engine serves requests of each of its slots (in
    the seed's order) until the slot holds ``SLOT_TOKENS`` served tokens
    or has no more, then others in the seed's order up to
    ``SAMPLE_TOKENS`` served tokens."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 3]))
    ids = sorted(fin)
    order = [ids[i] for i in rng.permutation(len(ids))]
    pick: List[int] = []
    for role in ("cloud", "edge"):
        mine = [i for i in ids if fin[i][0] == role]
        if not mine:
            continue
        pick.append(max(mine, key=lambda i: (len(fin[i][1])
                                             + recs[i].prompt_len, -i)))
        slots = {recs[i].slot for i in mine if recs[i].slot is not None}
        if len({pair for pair, _ in slots}) == 1:
            held = {slot: 0 for slot in slots}
            for i in pick:
                if recs[i].slot in held:
                    held[recs[i].slot] += len(fin[i][1])
            for i in order:
                slot = recs[i].slot
                if fin[i][0] == role and slot in held and i not in pick \
                        and held[slot] < SLOT_TOKENS:
                    pick.append(i)
                    held[slot] += len(fin[i][1])
    n_tok = sum(len(fin[i][1]) for i in pick)
    for i in order:
        if n_tok >= SAMPLE_TOKENS or len(pick) >= SAMPLE_MAX:
            break
        if i not in pick:
            pick.append(i)
            n_tok += len(fin[i][1])
    out = []
    for i in sorted(pick):
        role, toks = fin[i]
        a = recs[i].arrival.req
        out.append(Served(i, role, tokenize(a.text, a.prompt_tokens,
                                            vocab[role], cap), toks,
                          recs[i].slot))
    return out


@dataclasses.dataclass
class Gaps:
    """Per sampled token: the gap, its request and the engine slot that
    served it."""
    gap: List[float]
    rid: List[int]
    slot: List[Optional[Tuple[int, int]]]


def gaps(model, W, items: List[Served], prec: str, device) -> Gaps:
    """Per sampled token, the reference's best logit minus the served
    token's; with ``prec`` "fp8" (the control) the served token is
    replaced by the token the control puts first."""
    ref = Ref(model, W, "f32", device)
    ctl = Ref(model, W, prec, device) if prec != "f32" else None
    out = Gaps([], [], [])
    for b in range(0, len(items), BLOCK):
        blk = items[b:b + BLOCK]
        seqs = [s.prompt + s.tokens[:-1] for s in blk]
        lens = [len(s.prompt) for s in blk]
        with torch.no_grad():
            lg = ref.logits(seqs, lens)
            lc = ctl.logits(seqs, lens) if ctl is not None else None
        for k, s in enumerate(blk):
            if lc is None:
                pick = torch.tensor(s.tokens, device=lg[k].device)
            else:
                pick = lc[k].argmax(-1)
            best = lg[k].max(-1).values
            got = lg[k].gather(1, pick[:, None])[:, 0]
            out.gap += (best - got).tolist()
            out.rid += [s.rid] * len(s.tokens)
            out.slot += [s.slot] * len(s.tokens)
    return out


def stat(g: Gaps, name: str) -> float:
    """``max``, ``p<q>`` (nearest rank), or ``slot_p50``: the largest, over
    the slots that served the sampled tokens, of the median gap of that
    slot's tokens (tokens of no known slot pooled as one)."""
    if name == "max":
        return max(g.gap)
    if name == "slot_p50":
        by: Dict[object, List[float]] = {}
        for x, slot in zip(g.gap, g.slot):
            by.setdefault(slot, []).append(x)
        return max(percentile(v, 50.0) for v in by.values())
    return percentile(g.gap, float(name[1:]))


def quantiles(g: Gaps) -> Dict[str, float]:
    """The median, p80, p90, p95, p99, widest and slot median of a list of
    gaps."""
    out = {k: stat(g, k) for k in ("p50", "p80", "p90", "p95", "p99", "max",
                                   "slot_p50")}
    out["n"] = len(g.gap)
    out["slots"] = len(set(g.slot))
    return out


def queue_wrong(recs, n_due: int) -> int:
    """Requests due in the window at whose routing the server's monitor
    held other node queue lengths than the harness counted."""
    return sum(r.queue != r.monitor_queue for r in recs[:n_due])


def routes_wrong(tb: dict, recs, n_due: int) -> int:
    """Requests due in the window whose first route differs from the
    routing reference's, which reads the harness's queue counts."""
    bed = R.Testbed(tb)
    rng = np.random.default_rng(0)
    wrong = 0
    for r in recs[:n_due]:
        if R.decide(bed, r.arrival.req, r.queue, rng) != r.pair:
            wrong += 1
    return wrong
