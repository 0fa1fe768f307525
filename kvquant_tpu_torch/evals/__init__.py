"""Evaluations: perplexity (the simulated-quantization oracle) and the
retrieval evaluations (passkey, needle-in-a-haystack; numpy and tokenizer
code, engine-agnostic)."""

from .ppl import perplexity
