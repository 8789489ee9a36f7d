"""Median, over the window's batches, of the stream's wait on a batch's copy-done event (the program's
``stream.wait_device`` span), ms."""

from benchmark import program_spans


def read(trace):
    return program_spans.median_span_ms(trace, "stream.wait_device")
