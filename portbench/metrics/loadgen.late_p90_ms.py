"""How late the open loop's submissions ran behind their due times, 90th percentile over the requests due before the first traced group (host clock)."""

from pbench import layers


def read(run):
    return layers.late_p90_ms(run)
