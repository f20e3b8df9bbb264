"""Synthetic generators statistically matching the paper's four datasets.

A copy of ``repro.workload.datasets`` (the port imports nothing of
``repro``), without the multi-turn session fields, which the port does not
model yet. It must generate the same requests bit for bit.

The paper mixes MBPP (code generation), GSM8K (grade-school math), SQuAD
(extractive QA) and HellaSwag (commonsense MC completion) into one 500-request
trace (§V-B/C). The real datasets are not shipped in this container, so each
generator emits *synthetic requests with real text* whose statistics (prompt
token length, response length, task phrasing, constraint phrases, difficulty
spread) match the published datasets. All downstream machinery — tokenizer,
feature extraction, classifier, cost/latency accounting — operates on the
generated text exactly as it would on the originals.

Each generated request carries a latent ``difficulty`` in [0, 1] (used by the
quality model only — the router never sees it, it must infer difficulty from
observable features, which correlate by construction: harder problems have
longer, more clause-heavy prompts).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .tokenizer import count_tokens, text_bytes

DATASETS = ("mbpp", "gsm8k", "squad", "hellaswag")

_NOUNS = ("list", "string", "matrix", "graph", "tree", "array", "number",
          "interval", "sequence", "dictionary", "window", "queue", "stack",
          "polygon", "vector", "substring", "digit", "prime", "factor", "path")
_VERBS = ("compute", "return", "find", "merge", "sort", "count", "reverse",
          "partition", "validate", "transform", "encode", "filter", "rotate",
          "flatten", "search")
_TOPICS = ("the river festival", "a school fundraiser", "the bake sale",
           "a train journey", "the orchard harvest", "a paint job",
           "the reading challenge", "a cycling trip", "the garden fence",
           "a grocery run")
_ENTITIES = ("the Amazon basin", "the 1896 Olympics", "photosynthesis",
             "the printing press", "plate tectonics", "the Roman senate",
             "migratory birds", "the telegraph", "alpine glaciers",
             "the cotton trade")
_SCENES = ("a man is waxing a car", "a woman ties her climbing harness",
           "two chefs plate a dessert", "a child stacks wooden blocks",
           "a runner stretches at the track", "a barista steams milk",
           "a violinist tunes her strings", "a diver checks his gauge")

_CONSTRAINTS = ("You must output only the final answer.",
                "Output must be a single integer.",
                "Only return the function body.",
                "The answer must be given in meters.",
                "You must respond with the letter of the ending only.")


@dataclasses.dataclass
class Request:
    """One inference request r_i with its observable and latent attributes."""

    dataset: str
    index: int
    text: str
    prompt_tokens: int
    query_bytes: int
    resp_tokens_mean: float   # task-typical response length (model-agnostic)
    difficulty: float         # latent, drives realized quality
    sentence_count: int
    has_constraint: bool

    @property
    def task_id(self) -> int:
        return DATASETS.index(self.dataset)


def _sentences(rng: np.random.Generator, n: int, maker) -> str:
    return " ".join(maker(rng) for _ in range(n))


def _mbpp(rng: np.random.Generator, i: int) -> Request:
    difficulty = float(rng.beta(2.6, 2.4))
    n_clauses = 1 + int(round(difficulty * 4)) + int(rng.integers(0, 2))
    body = []
    for _ in range(n_clauses):
        body.append(f"The function should {rng.choice(_VERBS)} the "
                    f"{rng.choice(_NOUNS)} of a given {rng.choice(_NOUNS)}.")
    has_constraint = bool(rng.random() < 0.55)
    text = (f"Write a python function to {rng.choice(_VERBS)} a "
            f"{rng.choice(_NOUNS)}. " + " ".join(body)
            + (" " + str(rng.choice(_CONSTRAINTS)) if has_constraint else "")
            + " Your code should pass these tests: assert f(" +
            ", ".join(str(int(rng.integers(0, 99))) for _ in range(3)) + ")")
    resp = 20 + 16 * difficulty
    return _pack("mbpp", i, text, resp, difficulty)


def _gsm8k(rng: np.random.Generator, i: int) -> Request:
    difficulty = float(rng.beta(3.0, 2.2))  # skews harder
    steps = 2 + int(round(difficulty * 5))
    topic = rng.choice(_TOPICS)
    body = [f"For {topic}, Maya buys {int(rng.integers(2, 60))} items at "
            f"{int(rng.integers(1, 15))} dollars each."]
    for _ in range(steps - 1):
        body.append(f"Then she {rng.choice(['sells', 'adds', 'returns', 'splits'])} "
                    f"{int(rng.integers(1, 40))} of them with "
                    f"{int(rng.integers(2, 9))} friends.")
    has_constraint = bool(rng.random() < 0.35)
    text = (" ".join(body) + " How many does she have left?"
            + (" " + str(rng.choice(_CONSTRAINTS)) if has_constraint else ""))
    resp = 18 + 14 * difficulty  # concise worked solutions
    return _pack("gsm8k", i, text, resp, difficulty)


def _squad(rng: np.random.Generator, i: int) -> Request:
    difficulty = float(rng.beta(2.0, 3.2))  # skews easier
    ctx_sent = 3 + int(round(difficulty * 6)) + int(rng.integers(0, 3))
    ent = rng.choice(_ENTITIES)
    ctx = []
    for _ in range(ctx_sent):
        ctx.append(f"Historians note that {ent} influenced "
                   f"{rng.choice(_ENTITIES)} during the period of "
                   f"{int(rng.integers(1700, 1990))}.")
    has_constraint = bool(rng.random() < 0.2)
    text = ("Context: " + " ".join(ctx) +
            f" Question: When did {ent} influence the region?"
            + (" " + str(rng.choice(_CONSTRAINTS)) if has_constraint else ""))
    resp = 7 + 8 * difficulty  # extractive short answers
    return _pack("squad", i, text, resp, difficulty)


def _hellaswag(rng: np.random.Generator, i: int) -> Request:
    difficulty = float(rng.beta(2.5, 2.5))
    scene = rng.choice(_SCENES)
    endings = [f"({c}) then {rng.choice(_SCENES)}." for c in "ABCD"]
    has_constraint = bool(rng.random() < 0.6)
    text = (f"Complete the scenario: {scene}. Choose the most plausible "
            "ending: " + " ".join(endings)
            + (" " + str(rng.choice(_CONSTRAINTS)) if has_constraint else ""))
    resp = 3 + 3 * difficulty  # a letter + short justification
    return _pack("hellaswag", i, text, resp, difficulty)


def _pack(ds: str, i: int, text: str, resp_mean: float, difficulty: float
          ) -> Request:
    return Request(
        dataset=ds, index=i, text=text,
        prompt_tokens=count_tokens(text), query_bytes=text_bytes(text),
        resp_tokens_mean=float(resp_mean), difficulty=difficulty,
        sentence_count=max(1, text.count(".") + text.count("?")),
        has_constraint=any(k in text for k in ("must", "only", "Output", "output")),
    )


_GENERATORS = {"mbpp": _mbpp, "gsm8k": _gsm8k, "squad": _squad,
               "hellaswag": _hellaswag}


def generate(dataset: str, n: int, seed: int = 0) -> List[Request]:
    rng = np.random.default_rng(np.random.SeedSequence([seed, DATASETS.index(dataset)]))
    return [_GENERATORS[dataset](rng, i) for i in range(n)]
