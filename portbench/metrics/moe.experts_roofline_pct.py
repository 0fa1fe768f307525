"""All 16 experts' weight bytes per traced decode step at 3.35 TB/s over moe_glu + moe_down time."""

from pbench import layers


def read(run):
    return layers.experts_pct(run)
