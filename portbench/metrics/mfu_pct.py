"""Model FLOPs of the useful tokens of the steps before the first traced group over their wall seconds at 989 TFLOP/s."""

from pbench import layers


def read(run):
    return layers.mfu_pct(run)
