"""K1's prompt-chunk bound over its fd_chunk time in the traced steps."""

from pbench import layers


def read(run):
    return layers.k1_chunk_pct(run)
