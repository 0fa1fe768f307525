"""Calibration / evaluation data loaders (port of kvquant_tpu/data.py; numpy
only, so the same seeds give the same windows in both packages).

The reference's loader surface (get_wikitext2 / get_ptb / get_c4 /
get_loaders: seeded random calibration windows plus a full test encoding)
without network access: corpora are read from local files, and a
deterministic synthetic stream stands in when no corpus is given.

Sources:
  - name="synthetic": seeded Zipfian token stream (always available)
  - any other name with ``path``: a local UTF-8 text file encoded by
    ``tokenizer``; windows are drawn as the reference draws them (random
    offsets into the concatenated encoding).
"""

from __future__ import annotations

import numpy as np


def synthetic_stream(vocab_size: int, n_tokens: int, seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-text: a Zipfian token stream with local repeats
    (more realistic ppl behavior than uniform noise)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(vocab_size, size=n_tokens, p=probs).astype(np.int32)
    # local repetition: with p=0.15 copy a recent token (burstiness)
    rep = rng.random(n_tokens) < 0.15
    back = rng.integers(1, 32, n_tokens)
    idx = np.arange(n_tokens)
    src = np.maximum(idx - back, 0)
    toks[rep] = toks[src[rep]]
    return toks


def _encode_file(path: str, tokenizer, max_chars: int | None = None) -> np.ndarray:
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        text = f.read(max_chars) if max_chars else f.read()
    return np.asarray(tokenizer.encode(text), np.int32)


def calibration_windows(stream: np.ndarray, nsamples: int, seqlen: int,
                        seed: int = 0) -> np.ndarray:
    """(nsamples, seqlen) int32 windows at seeded uniform random offsets."""
    rng = np.random.default_rng(seed)
    assert len(stream) > seqlen, (len(stream), seqlen)
    starts = rng.integers(0, len(stream) - seqlen, nsamples)
    return np.stack([stream[s:s + seqlen] for s in starts]).astype(np.int32)


def eval_windows(stream: np.ndarray, seqlen: int,
                 max_windows: int | None = None) -> np.ndarray:
    """Non-overlapping (N, seqlen) eval windows."""
    n = len(stream) // seqlen
    if max_windows is not None:
        n = min(n, max_windows)
    return stream[: n * seqlen].reshape(n, seqlen).astype(np.int32)


def get_loaders(name: str, *, nsamples: int = 16, seed: int = 0,
                seqlen: int = 2048, vocab_size: int = 32000,
                tokenizer=None, path: str | None = None,
                eval_tokens: int = 2 ** 18):
    """Returns (train_windows (nsamples, seqlen), eval_windows (N, seqlen))."""
    if name == "synthetic" or path is None:
        stream = synthetic_stream(
            vocab_size, max(eval_tokens, (nsamples + 2) * seqlen) * 2, seed
        )
    else:
        if tokenizer is None:
            raise ValueError(f"loader '{name}' from {path} needs a tokenizer")
        stream = _encode_file(path, tokenizer)
    mid = len(stream) // 2
    train = calibration_windows(stream[:mid], nsamples, seqlen, seed)
    test = eval_windows(stream[mid:], seqlen, max_windows=eval_tokens // seqlen)
    return train, test
