"""The host gaps over the wall of the untraced window (program spans): from each blocking device-to-host read of serve.Server to its next reset, slot write or replay launch, the stream empty (the host's input copies before a launch count as gap)."""

from pbench import program_spans


def read(run):
    return program_spans.host_gap_pct(run)
