"""Due time to the step that moved the request out of serve.Server's queue, 90th percentile over the requests due before the first traced group."""

from pbench import layers


def read(run):
    return layers.queue_wait_p90_ms(run)
