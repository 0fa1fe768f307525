"""Median device time of the engine.decode spans of the untraced window (CUDA events from the DecodeGraph replay's launch, after its input copies, to its end: its kernels, the gaps between them and the launch latency)."""

from pbench import program_spans


def read(run):
    return program_spans.replay_ms(run, "engine.decode")
