"""1 - the traced steps' kernel time (union of their intervals, device trace) over the wall the same steps take untraced (median untraced loop iteration of each step's kind, host clock)."""

from pbench import layers


def read(run):
    return layers.idle_pct(run)
