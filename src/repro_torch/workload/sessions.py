"""Multi-turn session workloads: chat conversations and agent loops.

A copy of ``repro.workload.sessions`` (the port imports nothing of
``repro``); it must build the same trace bit for bit.

Production traffic is dominated by **sessions** — chat conversations and
agent loops whose turn *t+1* prompt is turn *t*'s prompt plus the assistant
reply and the next user message, and **agent fleets** whose sessions all
share one of a few long system prompts. Both shapes are what a prefix cache
(``serving.kvcache``) exploits: the shared prefix of a later turn is already
resident where the earlier one was served.

:func:`build_session_trace` generates such a workload as an open-loop
``Trace`` (sessions start at Poisson instants and turns follow after
exponential think times):

* turn prompts **extend** earlier turns verbatim (``text`` is a strict
  string prefix of the next turn's, so token streams share prefixes under
  any prefix-stable tokenizer);
* each session draws its task from the standard dataset mix; the *latest*
  user message determines category/difficulty/response length (the earlier
  turns are context);
* every request carries ``session_id`` / ``turn`` / ``sys_id`` /
  ``sys_tokens``, lifted into ``Trace.group_id`` / ``sys_id`` /
  ``sys_tokens``.

Everything is deterministic given ``seed``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from . import datasets as ds
from .tokenizer import count_tokens, text_bytes
from .trace import Trace, trace_from_requests

_SYS_TOPICS = ("inventory triage", "travel planning", "code review",
               "incident response", "literature search", "budget audits")
_ASSISTANT_FILLER = (
    "Here is a step by step answer with the key quantities worked out.",
    "The result follows from the stated constraints applied in order.",
    "I verified each intermediate value before composing the final reply.",
    "The answer accounts for every clause in the request above.",
)
_FOLLOWUPS = ("Now also handle the edge case where the input is empty.",
              "Can you redo that with the second quantity doubled?",
              "Explain the same result but more concisely.",
              "Apply the identical procedure to the next example.",
              "What changes if the last constraint is dropped?")


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Shape of the session workload.

    n_sessions / mean_turns — how many conversations and their geometric
    mean length (1.0 degenerates to single-shot traffic);
    session_rate — Poisson rate (sessions/s) of new-session starts;
    think_time_s — mean exponential gap between a session's turns;
    n_system_prompts — size of the shared system-prompt pool (agent
    workloads: many sessions reuse the same long preamble); 0 disables;
    system_prompt_sentences — length of each shared preamble.
    """

    n_sessions: int = 16
    mean_turns: float = 3.0
    session_rate: float = 0.5
    think_time_s: float = 4.0
    n_system_prompts: int = 2
    system_prompt_sentences: int = 6

    def __post_init__(self):
        assert self.n_sessions > 0 and self.mean_turns >= 1.0
        assert self.session_rate > 0 and self.think_time_s > 0


def _system_prompts(cfg: SessionConfig,
                    rng: np.random.Generator) -> List[str]:
    out = []
    for k in range(cfg.n_system_prompts):
        topic = _SYS_TOPICS[k % len(_SYS_TOPICS)]
        body = " ".join(
            f"Rule {j + 1}: when assisting with {topic}, respond with "
            f"{int(rng.integers(1, 9))} numbered points and cite the "
            "relevant clause." for j in range(cfg.system_prompt_sentences))
        out.append(f"System: you are agent {k} for {topic}. {body}")
    return out


def _turn_request(base: ds.Request, text: str, sid: int, turn: int,
                  sys_id: int, sys_tok: int) -> ds.Request:
    return dataclasses.replace(
        base, text=text, prompt_tokens=count_tokens(text),
        query_bytes=text_bytes(text),
        sentence_count=max(1, text.count(".") + text.count("?")),
        session_id=sid, turn=turn, sys_id=sys_id, sys_tokens=sys_tok)


def session_requests(cfg: SessionConfig, seed: int = 0
                     ) -> List[Tuple[float, ds.Request]]:
    """(arrival_time, request) pairs, unsorted (sessions interleave)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 23]))
    sys_prompts = _system_prompts(cfg, rng)
    # oversized per-dataset pools: each turn consumes one base request
    pool = {name: ds.generate(name, cfg.n_sessions * 8, seed=seed)
            for name in ds.DATASETS}
    cursor = {name: 0 for name in ds.DATASETS}

    out: List[Tuple[float, ds.Request]] = []
    start = 0.0
    p_more = 1.0 - 1.0 / cfg.mean_turns    # geometric continuation
    for sid in range(cfg.n_sessions):
        start += float(rng.exponential(1.0 / cfg.session_rate))
        sys_id = (int(rng.integers(0, len(sys_prompts)))
                  if sys_prompts else -1)
        sys_text = sys_prompts[sys_id] if sys_prompts else ""
        sys_tok = count_tokens(sys_text) if sys_text else 0
        name = ds.DATASETS[sid % len(ds.DATASETS)]

        context = sys_text
        t = start
        turn = 0
        while True:
            base = pool[name][cursor[name]]
            cursor[name] += 1
            user = (base.text if turn == 0
                    else f"{base.text} {_FOLLOWUPS[int(rng.integers(0, len(_FOLLOWUPS)))]}")
            context = (context + " " + user).strip()
            out.append((t, _turn_request(base, context, sid, turn,
                                         sys_id, sys_tok)))
            if rng.random() >= p_more:
                break
            # the assistant reply becomes carried context for the next turn
            context += " Assistant: " + str(rng.choice(_ASSISTANT_FILLER))
            t += float(rng.exponential(cfg.think_time_s))
            turn += 1
    return out


def build_session_trace(cfg: SessionConfig = SessionConfig(), seed: int = 0,
                        n_requests: Optional[int] = None) -> Trace:
    """Open-loop session trace, sorted by arrival, with session arrays set.

    ``n_requests`` truncates (sessions cut mid-way keep their early turns —
    prefix structure is preserved).
    """
    items = sorted(session_requests(cfg, seed=seed), key=lambda it: it[0])
    if n_requests is not None:
        items = items[:n_requests]
    assert items, "session workload generated no requests"
    times = np.asarray([t for t, _ in items], np.float32)
    return trace_from_requests([r for _, r in items], seed=seed,
                               arrival_time=times)
