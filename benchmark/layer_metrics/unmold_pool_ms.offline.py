"""Median, over the window's batches, of the time the stream waits for a batch's copies out of K8's ring run
side by side on the predictor's unmold pool (the program's ``unmold.pool`` span), ms."""

from benchmark import program_spans


def read(trace):
    return program_spans.median_span_ms(trace, "unmold.pool")
