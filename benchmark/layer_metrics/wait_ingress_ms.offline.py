"""Median, over the window's batches, of the stream's wait for its ingress worker (the program's
``stream.wait_ingress`` span), ms."""

from benchmark import program_spans


def read(trace):
    return program_spans.median_span_ms(trace, "stream.wait_ingress")
