"""The program's ``host_sync`` counts in the window (every call that makes the host wait for the card) over its
``forward`` spans in the window, syncs a batch."""

from benchmark import program_spans


def read(trace):
    return program_spans.counts_per_span(trace, "host_sync", "forward")
