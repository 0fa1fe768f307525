"""Median device time of the engine.chunk spans of the untraced window (CUDA events from the ChunkGraph replay's launch, after its input copy, to its end: its kernels, the gaps between them and the launch latency)."""

from pbench import program_spans


def read(run):
    return program_spans.replay_ms(run, "engine.chunk")
