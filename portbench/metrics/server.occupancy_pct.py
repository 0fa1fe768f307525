"""Mean over the decode steps before the first traced group of serve.Server's active slots over its slots."""

from pbench import layers


def read(run):
    return layers.occupancy_pct(run)
