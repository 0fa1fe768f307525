"""Device kernels in the traced steps (profiler) over those server steps: the DecodeGraph and ChunkGraph replays' kernels."""

from pbench import layers


def read(run):
    return layers.kernels_per_step(run)
