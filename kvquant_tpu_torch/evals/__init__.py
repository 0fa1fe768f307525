"""Retrieval evaluations (passkey, needle-in-a-haystack); numpy and
tokenizer code, engine-agnostic."""
