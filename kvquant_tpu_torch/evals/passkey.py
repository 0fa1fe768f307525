"""Synthetic passkey-retrieval evaluation.

Reference: quant/eval_passkey_simquant.py:40-179 — a hidden numeric passkey
is buried at a random depth inside filler text; the model must reproduce it.
Accuracy per context length over N trials. This implementation is
tokenizer- and engine-agnostic: pass any ``generate_fn(prompt_ids,
max_new_tokens) -> token ids`` (simulated forward argmax, deployed engine
generate, fp16 baseline, ...).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FILLER = (
    "The sky was clear and the grass was green. People walked along the "
    "path and time went quietly by. "
)
PREAMBLE = (
    "Below is a long document. Somewhere inside it hides an important "
    "pass key. Read carefully and remember the pass key. "
)
NEEDLE_FMT = "The pass key is {key}. Keep {key} in mind; it is the pass key. "
QUESTION = " What is the pass key? The pass key is"


def build_passkey_prompt(tokenizer, ctx_tokens: int, key: int, depth: float):
    """Token ids of a prompt of ~ctx_tokens with the needle at ``depth`` in
    [0, 1]. Returns (ids, answer_ids)."""
    filler_ids = tokenizer.encode(FILLER)
    needle_ids = tokenizer.encode(NEEDLE_FMT.format(key=key))
    pre_ids = tokenizer.encode(PREAMBLE)
    q_ids = tokenizer.encode(QUESTION)

    budget = ctx_tokens - len(pre_ids) - len(needle_ids) - len(q_ids)
    assert budget > 2 * len(filler_ids), "context too small for the harness"
    n_fill = budget // len(filler_ids)
    n_before = int(n_fill * depth)
    body = (
        filler_ids * n_before + needle_ids + filler_ids * (n_fill - n_before)
    )
    ids = pre_ids + body + q_ids
    answer_ids = tokenizer.encode(f" {key}")
    return np.asarray(ids, np.int32), np.asarray(answer_ids, np.int32)


@dataclass
class PasskeyResult:
    ctx_tokens: int
    n_trials: int
    n_correct: int

    @property
    def accuracy(self) -> float:
        return self.n_correct / max(1, self.n_trials)


def eval_passkey(
    generate_fn,
    tokenizer,
    *,
    ctx_lengths=(2048, 4096, 8192, 16384, 32768),
    n_trials: int = 50,
    seed: int = 0,
    verbose: bool = True,
) -> list[PasskeyResult]:
    """Reference main loop (eval_passkey_simquant.py:162-179): per context
    length, N trials with random 5-digit keys and uniform depths."""
    rng = np.random.default_rng(seed)
    results = []
    for ctx in ctx_lengths:
        correct = 0
        for _ in range(n_trials):
            key = int(rng.integers(10000, 100000))
            depth = float(rng.random())
            ids, answer = build_passkey_prompt(tokenizer, ctx, key, depth)
            out = np.asarray(
                generate_fn(ids[None], max_new_tokens=len(answer) + 4)
            ).reshape(-1)
            text = tokenizer.decode([int(t) for t in out])
            correct += int(str(key) in text)
        results.append(PasskeyResult(ctx, n_trials, correct))
        if verbose:
            print(f"passkey ctx={ctx}: {correct}/{n_trials}")
    return results
