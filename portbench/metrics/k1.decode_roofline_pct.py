"""K1's decode bound (the larger of bytes at 3.35 TB/s and FLOPs at 989 TFLOP/s) over its fd_gqa time, in the traced steps."""

from pbench import layers


def read(run):
    return layers.k1_decode_pct(run)
