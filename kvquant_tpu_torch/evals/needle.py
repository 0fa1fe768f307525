"""Needle-in-a-haystack evaluation harness.

Reference: lwm/eval_haystack_pytorch_quant.py:35-392 — a needle sentence is
inserted at a grid of (context length x depth percent) positions inside
haystack text; the model is asked to retrieve it; results are saved to a
resumable JSON so interrupted runs continue where they left off
(:206-212, 294-295). Per-sample cache reset (:266-277) is inherent here:
the engine's generate() starts from a fresh functional cache.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, asdict

import numpy as np

# Varied filler text (vs the reference's real-text corpus,
# eval_haystack_pytorch_quant.py:59-121 — zero egress here): a seeded
# template grammar yields hundreds of distinct sentences, so retrieval is
# not measured against pathologically repetitive filler (a single repeated
# sentence overstates accuracy — the needle is the only novel content).
_SUBJ = ["the ferry", "a carpenter", "the night market", "an old lighthouse",
         "the orchard", "a traveling violinist", "the tide pool",
         "the archive", "a beekeeper", "the tram line", "the observatory",
         "a glassblower"]
_VERB = ["drifted past", "reopened near", "overlooked", "hummed beside",
         "sheltered", "wound through", "brightened", "outlasted",
         "bordered", "echoed across"]
_OBJ = ["the harbor wall", "a row of plane trees", "the winter fair",
        "the flooded meadow", "an unused platform", "the chalk cliffs",
        "a terraced garden", "the printing house", "the reservoir",
        "a cobbled square"]
_TAIL = ["before dawn", "after the rains", "through early spring",
         "for another season", "despite the wind", "until the bells rang",
         "as the fog lifted", "long after closing"]


def haystack_sentence(i: int) -> str:
    """Deterministic varied filler sentence #i."""
    r = np.random.default_rng(i * 2654435761 % (2**32))
    return (f"{_SUBJ[r.integers(len(_SUBJ))]} "
            f"{_VERB[r.integers(len(_VERB))]} "
            f"{_OBJ[r.integers(len(_OBJ))]} "
            f"{_TAIL[r.integers(len(_TAIL))]}. ").capitalize()
NEEDLE = (
    "The secret ingredient for the winning recipe is {answer}. "
)
QUESTION = (
    " Question: what is the secret ingredient for the winning recipe? "
    "Answer: the secret ingredient is"
)
ANSWERS = [
    "roasted figs", "smoked paprika", "candied ginger", "toasted fennel",
    "black garlic", "preserved lemon", "wild thyme", "burnt honey",
]


@dataclass
class NeedleTrial:
    ctx_tokens: int
    depth_percent: float
    round: int
    answer: str
    response: str
    correct: bool


def build_needle_prompt(tokenizer, ctx_tokens: int, depth_percent: float,
                        answer: str):
    needle_ids = tokenizer.encode(NEEDLE.format(answer=answer))
    q_ids = tokenizer.encode(QUESTION)

    budget = ctx_tokens - len(needle_ids) - len(q_ids)
    fill_ids: list = []
    sent_ids = []
    i = 0
    while True:
        s = tokenizer.encode(haystack_sentence(i))
        if len(fill_ids) + len(s) > budget:
            break
        fill_ids.extend(s)
        sent_ids.append(len(s))
        i += 1
    assert len(sent_ids) >= 2, "context too small"
    # insert the needle at the sentence boundary closest to depth_percent
    n_before_tokens = int(len(fill_ids) * depth_percent / 100.0)
    cut, acc = 0, 0
    for n in sent_ids:
        if acc + n > n_before_tokens:
            break
        acc += n
        cut += 1
    split = sum(sent_ids[:cut])
    ids = fill_ids[:split] + needle_ids + fill_ids[split:] + q_ids
    return np.asarray(ids, np.int32)


class NeedleHaystackTester:
    """Grid runner with resumable JSON results (one file per run)."""

    def __init__(
        self,
        generate_fn,  # (prompt_ids (1, T), max_new_tokens) -> token ids
        tokenizer,
        *,
        context_lengths=(2048, 4096, 8192, 16384),
        depth_percents=(0, 25, 50, 75, 100),
        rounds: int = 1,
        results_path: str | None = None,
        seed: int = 0,
        verbose: bool = True,
    ):
        self.generate_fn = generate_fn
        self.tokenizer = tokenizer
        self.context_lengths = context_lengths
        self.depth_percents = depth_percents
        self.rounds = rounds
        self.results_path = results_path
        self.seed = seed
        self.verbose = verbose

    def _load(self) -> list[dict]:
        if self.results_path and os.path.exists(self.results_path):
            with open(self.results_path) as f:
                return json.load(f)
        return []

    def _save(self, results: list[dict]):
        if self.results_path:
            tmp = self.results_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(results, f, indent=1)
            os.replace(tmp, self.results_path)

    def run(self) -> list[NeedleTrial]:
        results = self._load()
        done = {(r["ctx_tokens"], r["depth_percent"], r["round"])
                for r in results}
        rng = np.random.default_rng(self.seed)

        for ctx in self.context_lengths:
            for depth in self.depth_percents:
                for rd in range(self.rounds):
                    if (ctx, depth, rd) in done:
                        continue
                    answer = ANSWERS[int(rng.integers(len(ANSWERS)))]
                    ids = build_needle_prompt(self.tokenizer, ctx, depth, answer)
                    ans_len = len(self.tokenizer.encode(" " + answer))
                    out = np.asarray(
                        self.generate_fn(ids[None], max_new_tokens=ans_len + 4)
                    ).reshape(-1)
                    response = self.tokenizer.decode([int(t) for t in out])
                    trial = NeedleTrial(
                        ctx_tokens=ctx, depth_percent=depth, round=rd,
                        answer=answer, response=response,
                        correct=answer in response,
                    )
                    results.append(asdict(trial))
                    self._save(results)
                    if self.verbose:
                        print(f"needle ctx={ctx} depth={depth}% "
                              f"round={rd}: {'OK' if trial.correct else 'MISS'}")
        return [NeedleTrial(**r) for r in results]


def accuracy_grid(trials: list[NeedleTrial]):
    """{(ctx, depth): accuracy} summary."""
    agg: dict = {}
    for t in trials:
        key = (t.ctx_tokens, t.depth_percent)
        n, c = agg.get(key, (0, 0))
        agg[key] = (n + 1, c + int(t.correct))
    return {k: c / n for k, (n, c) in agg.items()}
